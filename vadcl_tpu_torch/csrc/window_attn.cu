// Swin window attention over pre-partitioned windows (kernels 7 and 9):
//   out = proj(attention(x_windows))   per window of N tokens, heads looped;
// no LayerNorm and no residual (the block does both around the call).
//
// Kernel 7 replaces vadcl_tpu/ops/pallas_attn.py:_attn_kernel (entry
// fused_window_attention, the attn_kernel="base" path); kernel 9 replaces
// _attn_kernel_packed (entry fused_window_attention_packed, "packed",
// inference only).  x_windows is (Bn, N, C), windows batch-major: window i
// of the flat axis takes mask[i % nW].
//
// Cast boundaries, kernel 7: qkv = round(x . W_qkv + b_qkv);
// s = (q . k^T) * scale + bias[h] + mask in fp32, the scale applied after
// the product; p = round(softmax(s)); o = round(p . v) per head;
// out = round(o . W_proj + b_proj).  Kernel 9 differs in three places:
// q = round((x . W_qkv + b_qkv)[:, :C] * scale) (scale before the rounding,
// none after the product), the row max is per head (it is here anyway: the
// heads are looped), and p = round(e * (1 / sum e)).  The head-packed
// block-diagonal K/V tiles of the TPU kernel fed its 128-lane matrix unit
// and have no counterpart here: both kernels share this file's device code
// behind the PACKED template flag, each with its own entry point.
//
// Two kernels per flag, as for the fold kernels.  bf16 at C and head_dim
// multiples of 16: window_attn_tc_kernel runs the four products (qkv, q.k,
// p.v, proj) as WMMA 16x16x16 bf16 tiles with fp32 accumulation; the window
// pads to Np = ceil(N/16)*16 rows inside the block (padded input rows are
// zero, padded key columns get probability 0, padded output rows are
// dropped).  fp32 (the exact comparisons), and bf16 at every other width
// (head width 12 of an embed_dim 24 or 72 model): window_attn_kernel<T>,
// CUDA-core loops in fp32 on T loads and stores, any width, rounding to T
// where the bf16 contract rounds (qkv, p, o, out).
//
// What bounds it: one block per SM (shared memory: the window, the
// pre-projection tile, one head's q/k/v, its N x N fp32 scores and their
// rounded copy), four block-wide barriers per head, the fp32 softmax
// between the score and value products, and the weight tiles read from L2
// by every block.  A block holds a whole (N, N) score tile, so it takes only
// windows whose plan fits 227 KB; the others (N = 196 and 392 of 8-frame
// reconstruction clips, and from N = 147 at C = 96 in bf16) run the row-tiled
// body of window_attn_rows.cu, which ops/window_attn.py:window_body picks.
// Left on the table: wgmma with TMA-staged weights, several windows per
// block at N = 49, bias + mask staged once per block.
//
// Where kernel A's tensor-core body takes the geometry (bf16, head width 16
// or 32, N <= 112, its block within 227 KB), kernel 7 does not come here:
// ops/window_attn.py:window_tile_core sends it to fold_attn_mma.cuh without
// LN and residual, on a view of the windows as one row of windows per batch
// (window_grid).  This file keeps kernel 7 in fp32 and at the other bf16
// widths (head width 12, 48, 64; C = 256 with 8 heads), kernel 7 where its
// whole-tile body is forced (window_attention_fused_tiles), and kernel 9.
// Softmax quotients go through fa_div (common.cuh).
#include <mma.h>

#include "common.cuh"

namespace vadcl {

constexpr int kWinThreads = 512;
constexpr int kWinWarps = kWinThreads / kWarp;

struct WinArgs {
  const void* x;       // (Bn, N, C) compute dtype
  const void* qkv_w;   // (C, 3C) compute dtype
  const float* qkv_b;  // (3C,)
  const void* proj_w;  // (C, C) compute dtype
  const float* proj_b;  // (C,)
  const float* bias;   // (nH, N, N)
  const float* mask;   // (nW, N, N) or null
  void* out;           // (Bn, N, C)
  int Bn, N, C, nh, nW;
  float scale;
};

inline size_t win_smem_bytes(int n, int c, int nh) {
  const int hdp = c / nh + 1;
  return sizeof(float) * (2 * (size_t)n * c + 3 * (size_t)n * hdp + (size_t)n * n);
}

template <bool PACKED, typename T>
__global__ void __launch_bounds__(kWinThreads) window_attn_kernel(WinArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, nh = a.nh, N = a.N;
  const int hd = C / nh, hdp = hd + 1, C3 = 3 * C;
  float* xs = smem;          // N*C
  float* ob = xs + N * C;    // N*C
  float* qs = ob + N * C;    // N*hdp
  float* ks = qs + N * hdp;  // N*hdp
  float* vs = ks + N * hdp;  // N*hdp
  float* sc = vs + N * hdp;  // N*N

  const int blk = blockIdx.x;
  const T* x = static_cast<const T*>(a.x) + (size_t)blk * N * C;
  const T* wqkv = static_cast<const T*>(a.qkv_w);
  const T* wproj = static_cast<const T*>(a.proj_w);
  T* out = static_cast<T*>(a.out) + (size_t)blk * N * C;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;

  for (int idx = tid; idx < N * C; idx += kWinThreads) xs[idx] = to_f(x[idx]);
  __syncthreads();

  // window i of the flat axis takes mask[i % nW]
  const float* mask = a.mask != nullptr ? a.mask + (size_t)(blk % a.nW) * N * N : nullptr;
  for (int hh = 0; hh < nh; ++hh) {
    for (int idx = tid; idx < N * 3 * hd; idx += kWinThreads) {
      const int i = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, dd = j % hd;
      const int col = part * C + hh * hd + dd;
      const float* xr = xs + i * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += xr[c] * to_f(wqkv[(size_t)c * C3 + col]);
      float v = acc + a.qkv_b[col];
      if (PACKED && part == 0) v *= a.scale;
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      dst[i * hdp + dd] = round_to<T>(v);
    }
    __syncthreads();

    const float* bias = a.bias + (size_t)hh * N * N;
    for (int idx = tid; idx < N * N; idx += kWinThreads) {
      const int i = idx / N, j = idx % N;
      const float* q = qs + i * hdp;
      const float* k = ks + j * hdp;
      float s = 0.f;
      for (int dd = 0; dd < hd; ++dd) s += q[dd] * k[dd];
      if (!PACKED) s *= a.scale;
      s += bias[idx];
      if (mask != nullptr) s += mask[idx];
      sc[idx] = s;
    }
    __syncthreads();

    for (int i = warp; i < N; i += kWinWarps) {
      float* row = sc + i * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += kWarp) s += expf(row[j] - m);
      s = warp_sum(s);
      const float inv = 1.f / s;
      for (int j = lane; j < N; j += kWarp) {
        const float e = expf(row[j] - m);
        row[j] = round_to<T>(PACKED ? e * inv : fa_div(e, s, inv));
      }
    }
    __syncthreads();

    for (int idx = tid; idx < N * hd; idx += kWinThreads) {
      const int i = idx / hd, dd = idx % hd;
      const float* p = sc + i * N;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += p[j] * vs[j * hdp + dd];
      ob[i * C + hh * hd + dd] = round_to<T>(acc);
    }
    __syncthreads();
  }

  for (int idx = tid; idx < N * C; idx += kWinThreads) {
    const int i = idx / C, c = idx % C;
    const float* o = ob + i * C;
    float acc = 0.f;
    for (int k = 0; k < C; ++k) acc += o[k] * to_f(wproj[(size_t)k * C + c]);
    out[idx] = from_f<T>(acc + a.proj_b[c]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (see the header).
// ---------------------------------------------------------------------------
struct WinTcLayout {
  size_t xs, ob, q, k, v, sc, p, stage, bytes;
};

__host__ __device__ inline size_t win_align(size_t v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline WinTcLayout win_tc_layout(int n, int c, int nh) {
  const size_t np = (n + 15) / 16 * 16, hd = c / nh, bf = sizeof(__nv_bfloat16);
  WinTcLayout l;
  size_t o = 0;
  l.xs = o;    o = win_align(o + bf * np * c);
  l.ob = o;    o = win_align(o + bf * np * c);
  l.q = o;     o = win_align(o + bf * np * hd);
  l.k = o;     o = win_align(o + bf * np * hd);
  l.v = o;     o = win_align(o + bf * np * hd);
  l.sc = o;    o = win_align(o + sizeof(float) * np * np);
  l.p = o;     o = win_align(o + bf * np * np);
  l.stage = o; o = win_align(o + sizeof(float) * 256 * kWinWarps);
  l.bytes = o;
  return l;
}

inline bool win_tc_eligible(int c, int nh) {
  return c % nh == 0 && c % 16 == 0 && (c / nh) % 16 == 0;
}

template <bool PACKED>
__global__ void __launch_bounds__(kWinThreads) window_attn_tc_kernel(WinArgs a) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

  extern __shared__ __align__(128) unsigned char sm[];
  const int C = a.C, nh = a.nh, hd = C / nh, N = a.N;
  const int Np = (N + 15) / 16 * 16, mt_n = Np / 16;
  const WinTcLayout L = win_tc_layout(N, C, nh);
  bf16* xs = reinterpret_cast<bf16*>(sm + L.xs);
  bf16* ob = reinterpret_cast<bf16*>(sm + L.ob);
  bf16* qs = reinterpret_cast<bf16*>(sm + L.q);
  bf16* ks = reinterpret_cast<bf16*>(sm + L.k);
  bf16* vs = reinterpret_cast<bf16*>(sm + L.v);
  float* sc = reinterpret_cast<float*>(sm + L.sc);
  bf16* ps = reinterpret_cast<bf16*>(sm + L.p);
  const int blk = blockIdx.x;
  const bf16* x = static_cast<const bf16*>(a.x) + (size_t)blk * N * C;
  const bf16* wqkv = static_cast<const bf16*>(a.qkv_w);
  const bf16* wproj = static_cast<const bf16*>(a.proj_w);
  bf16* out = static_cast<bf16*>(a.out) + (size_t)blk * N * C;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  float* stage = reinterpret_cast<float*>(sm + L.stage) + warp * 256;
  const bf16 zero = __float2bfloat16(0.f);

  for (int idx = tid; idx < Np * C; idx += kWinThreads) xs[idx] = idx < N * C ? x[idx] : zero;
  __syncthreads();

  const float* mask = a.mask != nullptr ? a.mask + (size_t)(blk % a.nW) * N * N : nullptr;
  const int C3 = 3 * C, hsub = hd / 16;
  for (int hh = 0; hh < nh; ++hh) {
    // q, k, v of this head: Np x hd each, (acc + bias) rounded to bf16
    for (int t = warp; t < mt_n * 3 * hsub; t += kWinWarps) {
      const int mt = t / (3 * hsub), nt = t % (3 * hsub);
      const int part = nt / hsub, sub = nt % hsub;
      const int col0 = part * C + hh * hd + sub * 16;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, xs + (size_t)mt * 16 * C + k0, C);
        wmma::load_matrix_sync(fb, wqkv + (size_t)k0 * C3 + col0, C3);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      bf16* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      const float mul = (PACKED && part == 0) ? a.scale : 1.f;
      for (int e = lane; e < 256; e += kWarp) {
        const int r = e / 16, cc = e % 16;
        dst[(size_t)(mt * 16 + r) * hd + sub * 16 + cc] =
            __float2bfloat16((stage[e] + a.qkv_b[col0 + cc]) * mul);
      }
      __syncwarp();
    }
    __syncthreads();

    // raw scores q . k^T (Np x Np, fp32)
    for (int t = warp; t < mt_n * mt_n; t += kWinWarps) {
      const int mt = t / mt_n, nt = t % mt_n;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < hd; k0 += 16) {
        FragA fa;
        FragBt fb;
        wmma::load_matrix_sync(fa, qs + (size_t)mt * 16 * hd + k0, hd);
        wmma::load_matrix_sync(fb, ks + (size_t)nt * 16 * hd + k0, hd);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sc + (size_t)mt * 16 * Np + nt * 16, acc, Np,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // (* scale) + bias + mask, fp32 softmax, probabilities rounded to bf16;
    // padded rows and key columns get probability 0
    const float* bias = a.bias + (size_t)hh * N * N;
    const float smul = PACKED ? 1.f : a.scale;
    for (int i = warp; i < Np; i += kWinWarps) {
      bf16* prow = ps + (size_t)i * Np;
      if (i >= N) {
        for (int j = lane; j < Np; j += kWarp) prow[j] = zero;
        continue;
      }
      float* row = sc + (size_t)i * Np;
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) {
        float s = row[j] * smul + bias[i * N + j];
        if (mask != nullptr) s += mask[i * N + j];
        row[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += kWarp) s += expf(row[j] - m);
      s = warp_sum(s);
      const float inv = 1.f / s;
      for (int j = lane; j < Np; j += kWarp) {
        float p = 0.f;
        if (j < N) {
          const float e = expf(row[j] - m);
          p = PACKED ? e * inv : fa_div(e, s, inv);
        }
        prow[j] = __float2bfloat16(p);
      }
    }
    __syncthreads();

    // p . v into this head's columns of the pre-projection tile
    for (int t = warp; t < mt_n * hsub; t += kWinWarps) {
      const int mt = t / hsub, sub = t % hsub;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < Np; k0 += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, ps + (size_t)mt * 16 * Np + k0, Np);
        wmma::load_matrix_sync(fb, vs + (size_t)k0 * hd + sub * 16, hd);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += kWarp) {
        const int r = e / 16, cc = e % 16;
        ob[(size_t)(mt * 16 + r) * C + hh * hd + sub * 16 + cc] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // projection + bias, the window's N real rows only
  for (int t = warp; t < mt_n * (C / 16); t += kWinWarps) {
    const int mt = t / (C / 16), nt = t % (C / 16);
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, ob + (size_t)mt * 16 * C + k0, C);
      wmma::load_matrix_sync(fb, wproj + (size_t)k0 * C + nt * 16, C);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += kWarp) {
      const int i = mt * 16 + e / 16, c = nt * 16 + e % 16;
      if (i < N) out[(size_t)i * C + c] = __float2bfloat16(stage[e] + a.proj_b[c]);
    }
    __syncwarp();
  }
}

// Shared memory of the kernel a launch runs: the tensor-core body's layout in
// bf16 at the widths it takes, window_attn_kernel's fp32 tiles otherwise.
inline size_t win_plan_smem(int n, int c, int nh, int is_bf16) {
  return is_bf16 && win_tc_eligible(c, nh) ? win_tc_layout(n, c, nh).bytes
                                           : win_smem_bytes(n, c, nh);
}

template <bool PACKED>
cudaError_t launch_window_attn(const WinArgs& a, int is_bf16, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (a.Bn <= 0 || a.N <= 0 || a.C % a.nh != 0 || a.nW <= 0) return cudaErrorInvalidValue;
  const size_t smem = win_plan_smem(a.N, a.C, a.nh, is_bf16);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err;
  if (is_bf16 && win_tc_eligible(a.C, a.nh)) {
    if ((err = allow_smem(window_attn_tc_kernel<PACKED>, smem)) != cudaSuccess) return err;
    window_attn_tc_kernel<PACKED><<<(unsigned)a.Bn, kWinThreads, smem, stream>>>(a);
  } else if (is_bf16) {
    if ((err = allow_smem(window_attn_kernel<PACKED, bf16>, smem)) != cudaSuccess) return err;
    window_attn_kernel<PACKED, bf16><<<(unsigned)a.Bn, kWinThreads, smem, stream>>>(a);
  } else {
    if ((err = allow_smem(window_attn_kernel<PACKED, float>, smem)) != cudaSuccess) return err;
    window_attn_kernel<PACKED, float><<<(unsigned)a.Bn, kWinThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

// Shared memory one block needs (the same for kernels 7 and 9); the wrapper
// refuses windows above the card's limit before launching.
long long vadcl_window_attn_smem_bytes(int n, int c, int nh, int is_bf16) {
  return (long long)vadcl::win_plan_smem(n, c, nh, is_bf16);
}

// Kernel 7.
int vadcl_window_attn(const void* x, const void* qkv_w, const float* qkv_b,
                      const void* proj_w, const float* proj_b, const float* bias,
                      const float* mask, void* out, int Bn, int N, int C, int nh, int nW,
                      float scale, int is_bf16, void* stream) {
  vadcl::WinArgs a{x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, out, Bn, N, C, nh, nW, scale};
  return vadcl::launch_window_attn<false>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// Kernel 9.
int vadcl_window_attn_packed(const void* x, const void* qkv_w, const float* qkv_b,
                             const void* proj_w, const float* proj_b, const float* bias,
                             const float* mask, void* out, int Bn, int N, int C, int nh,
                             int nW, float scale, int is_bf16, void* stream) {
  vadcl::WinArgs a{x, qkv_w, qkv_b, proj_w, proj_b, bias, mask, out, Bn, N, C, nh, nW, scale};
  return vadcl::launch_window_attn<true>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
