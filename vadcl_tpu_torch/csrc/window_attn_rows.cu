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
//      (kernel 9: e * (1 / l)), rounded to T, and p . v;
//   3. the projection out = round(o . W_proj + b_proj), as launch 1.
//
// What bounds it: the qkv and o workspaces add 8 C bytes a token of device
// traffic (bf16) on top of x and out.  Left on the table: one fused launch,
// wgmma for the products.
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

// Shared memory of one attention-core block (the bf16 tensor-core core: the
// direct layout, the least it needs).
inline size_t rows_fwd_smem(int n, int c, int nh, int is_bf16) {
  const size_t hd = c / nh;
  if (is_bf16 && rows_bf16_eligible(c, nh)) return rows_mma_layout(n, (int)hd, 0).bytes;
  return sizeof(float) * (2 * (size_t)n * (hd + 1) + (size_t)kRowsWarps * (n + hd));
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
  } else if (is_bf16) {
    if ((err = allow_smem(rows_attn_f32_kernel<PACKED, bf16>, smem)) != cudaSuccess) return err;
    rows_attn_f32_kernel<PACKED, bf16><<<(unsigned)(Bn * nh), kRowsThreads, smem, s>>>(a);
    err = cudaGetLastError();
  } else {
    if ((err = allow_smem(rows_attn_f32_kernel<PACKED, float>, smem)) != cudaSuccess) return err;
    rows_attn_f32_kernel<PACKED, float><<<(unsigned)(Bn * nh), kRowsThreads, smem, s>>>(a);
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
