// Row-tiled Swin window attention over pre-partitioned windows (kernels 7
// and 9 for windows the whole-tile body of window_attn.cu cannot hold):
//   out = proj(attention(x_windows))   per window of N tokens.
//
// Replaces vadcl_tpu/ops/pallas_attn.py:_attn_kernel (kernel 7, entry
// fused_window_attention) and _attn_kernel_packed (kernel 9, entry
// fused_window_attention_packed) at every N: the wrappers
// (ops/window_attn.py) send a window here when the whole-tile body's plan
// exceeds 227 KB of shared memory, e.g. N = 196 and N = 392 (windows (4, 7, 7)
// and (8, 7, 7) of 8-frame reconstruction clips).  One body behind the PACKED
// template flag, as in window_attn.cu, with the same cast boundaries:
// qkv = round(x . W_qkv + b_qkv) (kernel 9: q = round((x . W_qkv + b)[:, :C]
// * scale)); s = q . k^T (* scale, kernel 7) + bias[h] + mask[w % nW] in fp32;
// p = round(softmax(s)) (kernel 7: e divided by the row sum, kernel 9:
// e * (1 / sum e)); o = round(p . v) per head; out = round(o . W_proj + b).
//
// Three launches on the caller's stream:
//   1. qkv of every token into a workspace (bf16: window_attn_rows_mma.cu,
//      fp32: window_rows.cuh);
//   2. the attention core.  bf16 at head width 16, 32, 48 or 64 and C a
//      multiple of 16: window_attn_rows_mma.cu (one block per head, mask
//      index and group of windows sharing it, the strip's bias and mask
//      staged once in shared memory; above the largest window that layout
//      holds, one block per window and head reading them from device
//      memory).  fp32 (the exact comparisons), and bf16 at every other width,
//      here: rows_attn_f32_kernel<PACKED, T>, one block per (window, head), K
//      and V of that head in shared memory, one query row per warp on CUDA
//      cores, a running max and sum over the keys, then p = e / l by fa_div
//      (kernel 9: e * (1 / l)), rounded to T, and p . v.  Where K and V of
//      one head outgrow 227 KB (a head of 281 channels or wider at N = 98,
//      544 at N = 49), rows_attn_stream_kernel<PACKED, T> streams the head's
//      channels too: one block per (window, head) walks the queries eight
//      rows at a time (a row a warp); per pass it builds the rows' scores
//      over chunks of kRsDepth channels of K (each chunk in shared memory,
//      the partial dot products kept per row and key, in channel order, so
//      each score is the same chain of fmas as the whole-head core's), takes
//      the softmax as above, and forms p . v chunk by chunk over V.  Its
//      block holds one chunk tile, the pass's query chunk and one score row
//      a warp: 164 N + 1024 bytes whatever the head width (N up to 1411);
//   3. the projection out = round(o . W_proj + b_proj), as launch 1.
//
// What bounds it: the qkv and o workspaces add 8 C bytes a token of device
// traffic (bf16) on top of x and out; the streamed core reads K and V of its
// head once per eight query rows (from L2).  Left on the table: one fused
// launch, wgmma for the products, tensor-core cores for heads wider than 64.
#include "reduce.cuh"  // align256
#include "window_attn_rows_mma.cuh"

namespace vadcl {

struct RowsFwdArgs {
  const void* qkv;    // (Bn * N, 3C) compute dtype
  void* o;            // (Bn * N, C) compute dtype
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  int Bn, N, C, nh, nW;
  float scale;
};

// The CUDA-core cores' shared memory: K and V of the whole head (the
// whole-head core), or one chunk of kRsDepth channels, the query rows' chunk
// and a score row a warp (the streamed core).
inline size_t rows_f32_fwd_smem(int n, int hd) {
  return sizeof(float) * (2 * (size_t)n * (hd + 1) + (size_t)kRowsWarps * (n + hd));
}
inline size_t rows_stream_fwd_smem(int n) {
  return sizeof(float) * ((size_t)n * (kRsDepth + 1) + (size_t)kRowsWarps * (kRsDepth + n));
}
// Whether the CUDA-core core streams the head's channels: where the
// whole-head core's block outgrows 227 KB.
inline bool rows_fwd_streams(int n, int hd) {
  return rows_f32_fwd_smem(n, hd) > (size_t)kMaxSmemBytes;
}

// Shared memory of one attention-core block (the bf16 tensor-core core: the
// direct layout, the least it needs; the CUDA-core core: the whole head, else
// the streamed layout).
inline size_t rows_fwd_smem(int n, int c, int nh, int is_bf16) {
  const int hd = c / nh;
  if (is_bf16 && rows_bf16_eligible(c, nh)) return rows_mma_layout(n, hd, 0).bytes;
  return rows_fwd_streams(n, hd) ? rows_stream_fwd_smem(n) : rows_f32_fwd_smem(n, hd);
}

template <bool PACKED, typename T>
__global__ void __launch_bounds__(kRowsThreads) rows_attn_f32_kernel(RowsFwdArgs a) {
  extern __shared__ __align__(16) float smf[];
  const int N = a.N, C = a.C, C3 = 3 * C, hd = C / a.nh, hdp = hd + 1;
  const int win = blockIdx.x / a.nh, h = blockIdx.x % a.nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  float* ks = smf;                                // N x hdp
  float* vs = ks + (size_t)N * hdp;               // N x hdp
  float* prow = vs + (size_t)N * hdp + warp * N;  // this warp's probabilities
  float* qrow = vs + (size_t)N * hdp + kRowsWarps * N + warp * hd;
  const T* qkv = static_cast<const T*>(a.qkv) + (size_t)win * N * C3;
  T* o = static_cast<T*>(a.o) + (size_t)win * N * C;
  for (int e = tid; e < 2 * N * hd; e += kRowsThreads) {
    const int part = e / (N * hd), r = (e / hd) % N, d = e % hd;
    (part ? vs : ks)[r * hdp + d] = to_f(qkv[(size_t)r * C3 + (1 + part) * C + h * hd + d]);
  }
  __syncthreads();
  const float* bias = a.bias + (size_t)h * N * N;
  const float* mask = a.mask != nullptr ? a.mask + (size_t)(win % a.nW) * N * N : nullptr;
  const float smul = PACKED ? 1.f : a.scale;
  for (int i = warp; i < N; i += kRowsWarps) {
    for (int d = lane; d < hd; d += kWarp) qrow[d] = to_f(qkv[(size_t)i * C3 + h * hd + d]);
    __syncwarp();
    auto score = [&](int j) {
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qrow[d] * ks[j * hdp + d];
      s = s * smul + bias[(size_t)i * N + j];
      if (mask != nullptr) s += mask[(size_t)i * N + j];
      return s;
    };
    float m = -INFINITY, l = 0.f;
    for (int j = lane; j < N; j += kWarp) {
      const float s = score(j), nm = fmaxf(m, s);
      l = l * expf(m - nm) + expf(s - nm);
      m = nm;
    }
    const float M = warp_max(m);
    const float L = warp_sum(m == -INFINITY ? 0.f : l * expf(m - M)), R = 1.f / L;
    for (int j = lane; j < N; j += kWarp) {
      const float e = expf(score(j) - M);
      prow[j] = round_to<T>(PACKED ? e * R : fa_div(e, L, R));
    }
    __syncwarp();
    for (int d = lane; d < hd; d += kWarp) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += prow[j] * vs[j * hdp + d];
      o[(size_t)i * C + h * hd + d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

// The same function with the head's channels streamed (see the header): the
// queries in passes of kRowsWarps rows, a row a warp; per pass the scores
// over K in chunks of kRsDepth channels, the softmax, then p . v over V in
// the same chunks.  Every loop that holds a __syncthreads is block-uniform.
template <bool PACKED, typename T>
__global__ void __launch_bounds__(kRowsThreads) rows_attn_stream_kernel(RowsFwdArgs a) {
  extern __shared__ __align__(16) float smf[];
  constexpr int kLd = kRsDepth + 1;  // chunk rows padded: lanes read keys 33 floats apart
  const int N = a.N, C = a.C, C3 = 3 * C, hd = C / a.nh;
  const int win = blockIdx.x / a.nh, h = blockIdx.x % a.nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  float* kv = smf;                                  // N x kLd: a chunk of K, then of V
  float* qc = kv + (size_t)N * kLd + warp * kRsDepth;  // this warp's query chunk
  float* srow = kv + (size_t)N * kLd + kRowsWarps * kRsDepth + (size_t)warp * N;
  const T* qkv = static_cast<const T*>(a.qkv) + (size_t)win * N * C3;
  T* o = static_cast<T*>(a.o) + (size_t)win * N * C;
  const float* bias = a.bias + (size_t)h * N * N;
  const float* mask = a.mask != nullptr ? a.mask + (size_t)(win % a.nW) * N * N : nullptr;
  const float smul = PACKED ? 1.f : a.scale;
  // a chunk of K (part 1) or V (part 2) of the head's rows, channels c0 .. c0 + dc
  auto load_chunk = [&](int part, int c0, int dc) {
    for (int e = tid; e < N * dc; e += kRowsThreads) {
      const int r = e / dc, d = e % dc;
      kv[r * kLd + d] = to_f(qkv[(size_t)r * C3 + part * C + h * hd + c0 + d]);
    }
  };
  for (int i0 = 0; i0 < N; i0 += kRowsWarps) {
    const int i = i0 + warp;  // this warp's query row (none past N)
    for (int c0 = 0; c0 < hd; c0 += kRsDepth) {
      const int dc = min(kRsDepth, hd - c0);
      __syncthreads();  // the chunk tile's last readers are done
      load_chunk(1, c0, dc);
      if (i < N)
        for (int d = lane; d < dc; d += kWarp) qc[d] = to_f(qkv[(size_t)i * C3 + h * hd + c0 + d]);
      __syncthreads();
      if (i < N)
        for (int j = lane; j < N; j += kWarp) {
          float s = c0 == 0 ? 0.f : srow[j];
          for (int d = 0; d < dc; ++d) s += qc[d] * kv[j * kLd + d];
          srow[j] = s;
        }
    }
    if (i < N) {
      float m = -INFINITY, l = 0.f;
      for (int j = lane; j < N; j += kWarp) {
        float s = srow[j] * smul + bias[(size_t)i * N + j];
        if (mask != nullptr) s += mask[(size_t)i * N + j];
        srow[j] = s;
        const float nm = fmaxf(m, s);
        l = l * expf(m - nm) + expf(s - nm);
        m = nm;
      }
      const float M = warp_max(m);
      const float L = warp_sum(m == -INFINITY ? 0.f : l * expf(m - M)), R = 1.f / L;
      for (int j = lane; j < N; j += kWarp) {
        const float e = expf(srow[j] - M);
        srow[j] = round_to<T>(PACKED ? e * R : fa_div(e, L, R));
      }
    }
    __syncwarp();  // (the row's probabilities are read by every lane below)
    for (int c0 = 0; c0 < hd; c0 += kRsDepth) {
      const int dc = min(kRsDepth, hd - c0);
      __syncthreads();
      load_chunk(2, c0, dc);
      __syncthreads();
      if (i < N)
        for (int d = lane; d < dc; d += kWarp) {
          float acc = 0.f;
          for (int j = 0; j < N; ++j) acc += srow[j] * kv[j * kLd + d];
          o[(size_t)i * C + h * hd + c0 + d] = from_f<T>(acc);
        }
    }
  }
}

struct RowsFwdWs {
  size_t qkv, o, bytes;
};

inline RowsFwdWs rows_fwd_ws(int Bn, int N, int C, int is_bf16) {
  const size_t T = (size_t)Bn * N, es = is_bf16 ? 2 : 4;
  RowsFwdWs l;
  l.qkv = 0;
  l.o = align256(T * 3 * C * es);
  l.bytes = align256(l.o + T * C * es);
  return l;
}

template <bool PACKED>
cudaError_t launch_window_attn_rows(const void* x, const void* qkv_w, const float* qkv_b,
                                    const void* proj_w, const float* proj_b, const float* bias,
                                    const float* mask, void* out, void* workspace, int Bn, int N,
                                    int C, int nh, int nW, float scale, int is_bf16,
                                    cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (Bn <= 0 || N <= 0 || nh <= 0 || C % nh != 0 || nW <= 0) return cudaErrorInvalidValue;
  const bool tc = is_bf16 && rows_bf16_eligible(C, nh);
  const size_t smem = rows_fwd_smem(N, C, nh, is_bf16);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const RowsFwdWs l = rows_fwd_ws(Bn, N, C, is_bf16);
  char* ws = static_cast<char*>(workspace);
  const int T = Bn * N;
  cudaError_t err;
  err = launch_rows_gemm(x, qkv_w, qkv_b, ws + l.qkv, T, C, 3 * C, PACKED ? C : 0, scale,
                         is_bf16, s);
  if (err != cudaSuccess) return err;
  const RowsFwdArgs a{ws + l.qkv, ws + l.o, bias, mask, Bn, N, C, nh, nW, scale};
  if (tc) {
    err = launch_rows_mma_core(a.qkv, a.o, bias, mask, Bn, N, C, nh, nW, scale, PACKED, s);
  } else {
    using Kernel = void (*)(RowsFwdArgs);
    const bool streams = rows_fwd_streams(N, C / nh);
    const Kernel kernel =
        is_bf16 ? (streams ? rows_attn_stream_kernel<PACKED, bf16> : rows_attn_f32_kernel<PACKED, bf16>)
                : (streams ? rows_attn_stream_kernel<PACKED, float> : rows_attn_f32_kernel<PACKED, float>);
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<(unsigned)(Bn * nh), kRowsThreads, smem, s>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return launch_rows_gemm(ws + l.o, proj_w, proj_b, out, T, C, C, 0, 1.f, is_bf16, s);
}

}  // namespace vadcl

extern "C" {

// Shared memory of one attention-core block (the same for kernels 7 and 9).
long long vadcl_window_attn_rows_smem_bytes(int n, int c, int nh, int is_bf16) {
  return (long long)vadcl::rows_fwd_smem(n, c, nh, is_bf16);
}

// Bytes of the qkv and o workspaces the caller allocates.
long long vadcl_window_attn_rows_workspace_bytes(int Bn, int N, int C, int is_bf16) {
  return (long long)vadcl::rows_fwd_ws(Bn, N, C, is_bf16).bytes;
}

// Kernel 7, row-tiled.
int vadcl_window_attn_rows(const void* x, const void* qkv_w, const float* qkv_b,
                           const void* proj_w, const float* proj_b, const float* bias,
                           const float* mask, void* out, void* workspace, int Bn, int N, int C,
                           int nh, int nW, float scale, int is_bf16, void* stream) {
  return vadcl::launch_window_attn_rows<false>(x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, out,
                                               workspace, Bn, N, C, nh, nW, scale, is_bf16,
                                               static_cast<cudaStream_t>(stream));
}

// Kernel 9, row-tiled.
int vadcl_window_attn_rows_packed(const void* x, const void* qkv_w, const float* qkv_b,
                                  const void* proj_w, const float* proj_b, const float* bias,
                                  const float* mask, void* out, void* workspace, int Bn, int N,
                                  int C, int nh, int nW, float scale, int is_bf16, void* stream) {
  return vadcl::launch_window_attn_rows<true>(x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, out,
                                              workspace, Bn, N, C, nh, nW, scale, is_bf16,
                                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
