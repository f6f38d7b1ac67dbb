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
//   1. qkv of every token into a workspace (window_rows.cuh);
//   2. the attention core: one block per (window, head), eight warps.  K and
//      V of that head (N x hd each) are the only shared tiles (bf16: 4 x Np x
//      (hd + 8) bytes, 38.4 KB at N = 392, hd 16), so no whole (N, N) score
//      tile and not the window's x (150.5 KB at C = 192) ever sits in shared
//      memory: x is read once by launch 1.  A warp owns a strip of 16 query
//      rows at a time and walks the keys in blocks of 16 twice.  The first
//      walk carries a running row max and a running sum rescaled to it (the
//      FlashAttention rescale); the second recomputes the scores, forms
//      p = round(e / l) exactly at the contract's cast boundary and
//      accumulates p . v.  bf16 runs q . k^T and p . v as mma.sync.m16n8k16
//      with scores, probabilities and the output strip in registers (kernel
//      A's strip body, csrc/fold_attn_mma.cuh); e = ex2.approx.ftz (flushed to
//      zero below the smallest normal) and the division is fa_div, never
//      IEEE division's slow path.  fp32 (the exact comparisons): one query
//      row per warp on CUDA cores, expf and fa_div.  bf16 needs C and the head
//      width to be multiples of 16, the head width at most 64;
//   3. the projection out = round(o . W_proj + b_proj) (window_rows.cuh).
//
// What bounds it: the qkv and o workspaces add 8 C bytes a token of device
// traffic (bf16) on top of x and out; the core recomputes q . k^T once; the
// products are mma.sync, not wgmma.  Left on the table: one fused launch,
// wgmma, keeping the window's qkv in shared memory across heads.
#include "reduce.cuh"  // align256
#include "window_rows.cuh"

namespace vadcl {

struct RowsFwdArgs {
  const void* qkv;    // (Bn * N, 3C) compute dtype
  void* o;            // (Bn * N, C) compute dtype
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  int Bn, N, C, nh, nW;
  float scale;
};

// Shared memory of one attention-core block.
inline size_t rows_fwd_smem(int n, int c, int nh, int is_bf16) {
  const size_t hd = c / nh;
  if (is_bf16) return sizeof(__nv_bfloat16) * 2 * (size_t)rows_padded(n) * (hd + 8);
  return sizeof(float) * (2 * (size_t)n * (hd + 1) + (size_t)kRowsWarps * (n + hd));
}

template <int kHd, bool PACKED>
__global__ void __launch_bounds__(kRowsThreads) rows_attn_bf16_kernel(RowsFwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = kHd + 8, kKs = kHd / 16, kHt = kHd / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  const int N = a.N, C = a.C, C3 = 3 * C, Np = rows_padded(N), nblk = Np / 16;
  const int win = blockIdx.x / a.nh, h = blockIdx.x % a.nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  bf16* ks = reinterpret_cast<bf16*>(sm);
  bf16* vs = ks + (size_t)Np * kLd;
  const bf16* qkv = static_cast<const bf16*>(a.qkv) + (size_t)win * N * C3;
  bf16* o = static_cast<bf16*>(a.o) + (size_t)win * N * C;

  // K and V of this head; rows past the window are zero
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < 2 * Np * (kHd / 8); e += kRowsThreads) {
    const int part = e / (Np * (kHd / 8)), r = (e / (kHd / 8)) % Np, v = e % (kHd / 8);
    uint4 val = zero;
    if (r < N)
      val = *reinterpret_cast<const uint4*>(qkv + (size_t)r * C3 + (1 + part) * C + h * kHd +
                                            v * 8);
    *reinterpret_cast<uint4*>((part ? vs : ks) + (size_t)r * kLd + v * 8) = val;
  }
  __syncthreads();

  const float* bias = a.bias + (size_t)h * N * N;
  const float* mask = a.mask != nullptr ? a.mask + (size_t)(win % a.nW) * N * N : nullptr;
  const float smul = PACKED ? 1.f : a.scale;

  for (int strip = warp; strip < nblk; strip += kRowsWarps) {
    const int i0 = strip * 16 + g, i1 = i0 + 8;
    uint32_t qf[kKs][4];
    {
      const bf16* q0 = qkv + (size_t)i0 * C3 + h * kHd + 2 * t;
      const bf16* q1 = qkv + (size_t)i1 * C3 + h * kHd + 2 * t;
#pragma unroll
      for (int k = 0; k < kKs; ++k) {
        qf[k][0] = i0 < N ? *reinterpret_cast<const uint32_t*>(q0 + k * 16) : 0u;
        qf[k][1] = i1 < N ? *reinterpret_cast<const uint32_t*>(q1 + k * 16) : 0u;
        qf[k][2] = i0 < N ? *reinterpret_cast<const uint32_t*>(q0 + k * 16 + 8) : 0u;
        qf[k][3] = i1 < N ? *reinterpret_cast<const uint32_t*>(q1 + k * 16 + 8) : 0u;
      }
    }
    // walk 1: the rows' running max and sum; walk 2: p = round(e / l)
    // (kernel 9: e * (1 / l)) and O = p . V
    float m[2], l[2];
    rows_stats<kKs>(qf, ks, kLd, nblk, i0, i1, N, smul, bias, mask, lane, m, l);
    const float rinv[2] = {1.f / l[0], 1.f / l[1]};
    float oacc[kHt][4];
#pragma unroll
    for (int i = 0; i < kHt; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
    for (int kb = 0; kb < nblk; ++kb) {
      float s[2][4], p[2][4];
      rows_scores<kKs>(qf, ks, kLd, kb, i0, i1, N, smul, bias, mask, lane, s);
      rows_probs<PACKED>(s, m, l, rinv, p);
      uint32_t pf[4];
      rows_a_frag(p, pf);
#pragma unroll
      for (int nq = 0; nq < kKs; ++nq) {
        uint32_t vf[4];
        ldsm_x4_t(vf, b_frag_row_kn(vs + (size_t)kb * 16 * kLd + nq * 16, kLd, lane));
        mma_bf16(oacc[2 * nq], pf, vf[0], vf[1]);
        mma_bf16(oacc[2 * nq + 1], pf, vf[2], vf[3]);
      }
    }
    strip_store<kHt>(oacc, o, C, i0, i1, N, h * kHd, t);
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(kRowsThreads) rows_attn_f32_kernel(RowsFwdArgs a) {
  extern __shared__ __align__(16) float smf[];
  const int N = a.N, C = a.C, C3 = 3 * C, hd = C / a.nh, hdp = hd + 1;
  const int win = blockIdx.x / a.nh, h = blockIdx.x % a.nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  float* ks = smf;                                // N x hdp
  float* vs = ks + (size_t)N * hdp;               // N x hdp
  float* prow = vs + (size_t)N * hdp + warp * N;  // this warp's probabilities
  float* qrow = vs + (size_t)N * hdp + kRowsWarps * N + warp * hd;
  const float* qkv = static_cast<const float*>(a.qkv) + (size_t)win * N * C3;
  float* o = static_cast<float*>(a.o) + (size_t)win * N * C;
  for (int e = tid; e < 2 * N * hd; e += kRowsThreads) {
    const int part = e / (N * hd), r = (e / hd) % N, d = e % hd;
    (part ? vs : ks)[r * hdp + d] = qkv[(size_t)r * C3 + (1 + part) * C + h * hd + d];
  }
  __syncthreads();
  const float* bias = a.bias + (size_t)h * N * N;
  const float* mask = a.mask != nullptr ? a.mask + (size_t)(win % a.nW) * N * N : nullptr;
  const float smul = PACKED ? 1.f : a.scale;
  for (int i = warp; i < N; i += kRowsWarps) {
    for (int d = lane; d < hd; d += kWarp) qrow[d] = qkv[(size_t)i * C3 + h * hd + d];
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
      prow[j] = PACKED ? e * R : fa_div(e, L, R);
    }
    __syncwarp();
    for (int d = lane; d < hd; d += kWarp) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += prow[j] * vs[j * hdp + d];
      o[(size_t)i * C + h * hd + d] = acc;
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

template <int kHd, bool PACKED>
cudaError_t launch_rows_core_bf16(const RowsFwdArgs& a, size_t smem, cudaStream_t s) {
  const cudaError_t err = allow_smem(rows_attn_bf16_kernel<kHd, PACKED>, smem);
  if (err != cudaSuccess) return err;
  rows_attn_bf16_kernel<kHd, PACKED><<<(unsigned)(a.Bn * a.nh), kRowsThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_window_attn_rows(const void* x, const void* qkv_w, const float* qkv_b,
                                    const void* proj_w, const float* proj_b, const float* bias,
                                    const float* mask, void* out, void* workspace, int Bn, int N,
                                    int C, int nh, int nW, float scale, int is_bf16,
                                    cudaStream_t s) {
  if (Bn <= 0 || N <= 0 || nh <= 0 || C % nh != 0 || nW <= 0) return cudaErrorInvalidValue;
  if (is_bf16 && !rows_bf16_eligible(C, nh)) return cudaErrorInvalidValue;
  const size_t smem = rows_fwd_smem(N, C, nh, is_bf16);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const RowsFwdWs l = rows_fwd_ws(Bn, N, C, is_bf16);
  char* ws = static_cast<char*>(workspace);
  const int T = Bn * N;
  cudaError_t err;
  if ((err = launch_rows_gemm(x, qkv_w, qkv_b, ws + l.qkv, T, C, 3 * C, PACKED ? C : 0, scale,
                              is_bf16, s)))
    return err;
  const RowsFwdArgs a{ws + l.qkv, ws + l.o, bias, mask, Bn, N, C, nh, nW, scale};
  if (is_bf16) {
    switch (C / nh) {
      case 16: err = launch_rows_core_bf16<16, PACKED>(a, smem, s); break;
      case 32: err = launch_rows_core_bf16<32, PACKED>(a, smem, s); break;
      case 48: err = launch_rows_core_bf16<48, PACKED>(a, smem, s); break;
      default: err = launch_rows_core_bf16<64, PACKED>(a, smem, s); break;
    }
  } else {
    if ((err = allow_smem(rows_attn_f32_kernel<PACKED>, smem)) != cudaSuccess) return err;
    rows_attn_f32_kernel<PACKED><<<(unsigned)(Bn * nh), kRowsThreads, smem, s>>>(a);
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
