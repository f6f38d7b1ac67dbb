// Folded Swin window attention, block front half:
//   out = x + proj(attention(LN1(x)))   per (batch, window), heads looped.
//
// Replaces vadcl_tpu/ops/pallas_attn_fold.py:_fold_kernel (entry
// fused_window_attention_folded, called through
// folded_block_attention_trainable with ln_scale, residual=True, mlp=None).
//
// "Fold": the block reads its window's tokens straight from the
// unpartitioned (B, D, H, W, C) tensor by strides and writes the result back
// in place of the same tokens, so window_partition / window_reverse never
// exist as tensors in device memory.  The shifted blocks' cyclic roll is
// folded into the same addressing (token_offset), so it costs no pass
// either.
//
// Two kernels, one per compute dtype.  bf16 (the model's compute dtype on
// the card): fold_attn_tc_kernel runs the four products (qkv, q.k, p.v,
// proj) as WMMA 16x16x16 bf16 tiles with fp32 accumulation, bf16 tiles in
// shared memory (189 KB at the flagship geometry, N = 98, C = 192); it needs
// C and head_dim to be multiples of 16 and refuses other widths.  fp32 (the
// path the model's exact comparisons run): fold_attn_kernel, CUDA-core
// loops; the LN'd window, the pre-projection output, one head's q/k/v
// (N x hd, padded to hd+1 against bank conflicts) and its N x N scores sit
// in fp32 shared memory.
// Cast boundaries follow _fold_kernel: LN output, qkv, the softmax
// probabilities and the per-head output round to the compute dtype; scores
// are scaled after the q.k product; softmax, bias, mask and residual are
// fp32.
//
// What bounds it: one block per SM (shared memory), four block-wide barriers
// per head and the fp32 softmax between the score and value products; the
// weight tiles are read from L2 by every block.  At the encoder's stage 1
// (64 windows per 4 clips) there are fewer blocks than SMs.  Left on the
// table: wgmma with TMA-staged weights, two windows or heads in flight per
// block, bias + mask staged once per block.
#include <mma.h>

#include "common.cuh"

namespace vadcl {

constexpr int kFoldThreads = 512;

struct FoldArgs {
  const void* x;
  const float* ln_s;  // null: no LayerNorm
  const float* ln_b;
  const void* qkv_w;  // (C, 3C), compute dtype
  const float* qkv_b;  // (3C,)
  const void* proj_w;  // (C, C), compute dtype
  const float* proj_b;  // (C,)
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  void* out;
  int B, D, H, W, C, nh, wd, wh, ww;
  int sd, sh, sw;  // cyclic shift of the shifted-window blocks (0 when none)
  float scale;
  int residual;
};

inline size_t fold_smem_bytes(int n, int c, int nh) {
  const int hdp = c / nh + 1;
  return sizeof(float) * (2 * (size_t)n * c + 3 * (size_t)n * hdp + (size_t)n * n) +
         sizeof(long long) * n;
}

// Element offset of window token (d, h, w) of batch b.  The shift roll is
// folded in: the block reads, and writes back, the token that
// roll(x, -shift) would have put at (d, h, w), i.e. ((d + sd) % D, ...), so
// out = roll(attention(roll(x, -shift)), +shift) without either roll.
__device__ __forceinline__ long long token_offset(const FoldArgs& a, int b, int d,
                                                  int h, int w) {
  const long long dd = (d + a.sd) % a.D, hh = (h + a.sh) % a.H, ww = (w + a.sw) % a.W;
  return (((b * (long long)a.D + dd) * a.H + hh) * a.W + ww) * a.C;
}

__global__ void __launch_bounds__(kFoldThreads) fold_attn_kernel(FoldArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, nh = a.nh;
  const int hd = C / nh, hdp = hd + 1;
  const int N = a.wd * a.wh * a.ww;
  long long* tok = reinterpret_cast<long long*>(smem);  // N token offsets
  float* xn = smem + 2 * N;  // N*C
  float* ob = xn + N * C;    // N*C
  float* qs = ob + N * C;    // N*hdp
  float* ks = qs + N * hdp;  // N*hdp
  float* vs = ks + N * hdp;  // N*hdp
  float* sc = vs + N * hdp;  // N*N

  const float* x = static_cast<const float*>(a.x);
  const float* wqkv = static_cast<const float*>(a.qkv_w);
  const float* wproj = static_cast<const float*>(a.proj_w);
  float* out = static_cast<float*>(a.out);

  // window (d, h, w) enumeration order == window_partition's
  const int nwd = a.D / a.wd, nwh = a.H / a.wh, nww = a.W / a.ww;
  const int nw = nwd * nwh * nww;
  const int win = blockIdx.x % nw;
  const int b = blockIdx.x / nw;
  const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp, nwarps = nthr / kWarp;

  for (int i = tid; i < N; i += nthr) {
    const int ta = i / (a.wh * a.ww), tb = (i / a.ww) % a.wh, tc = i % a.ww;
    tok[i] = token_offset(a, b, wi_d * a.wd + ta, wi_h * a.wh + tb, wi_w * a.ww + tc);
  }
  __syncthreads();

  // LN1 (or a plain load)
  for (int i = warp; i < N; i += nwarps) {
    const float* xi = x + tok[i];
    if (a.ln_s != nullptr) {
      float mu, rstd;
      warp_ln_stats(xi, C, &mu, &rstd);
      for (int c = lane; c < C; c += kWarp)
        xn[i * C + c] = (xi[c] - mu) * rstd * a.ln_s[c] + a.ln_b[c];
    } else {
      for (int c = lane; c < C; c += kWarp) xn[i * C + c] = xi[c];
    }
  }
  __syncthreads();

  const float* bias_all = a.bias;
  const float* mask = a.mask != nullptr ? a.mask + (size_t)win * N * N : nullptr;
  const int C3 = 3 * C;
  for (int hh = 0; hh < nh; ++hh) {
    // q, k, v of this head: (N, hd) each
    for (int idx = tid; idx < N * 3 * hd; idx += nthr) {
      const int i = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, dd = j % hd;
      const int col = part * C + hh * hd + dd;
      const float* xr = xn + i * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += xr[c] * wqkv[(size_t)c * C3 + col];
      const float v = acc + a.qkv_b[col];
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      dst[i * hdp + dd] = v;
    }
    __syncthreads();

    // scores: (q . k) * scale + bias + mask, fp32
    const float* bias = bias_all + (size_t)hh * N * N;
    for (int idx = tid; idx < N * N; idx += nthr) {
      const int i = idx / N, j = idx % N;
      const float* q = qs + i * hdp;
      const float* k = ks + j * hdp;
      float s = 0.f;
      for (int dd = 0; dd < hd; ++dd) s += q[dd] * k[dd];
      s = s * a.scale + bias[idx];
      if (mask != nullptr) s += mask[idx];
      sc[idx] = s;
    }
    __syncthreads();

    // row softmax
    for (int i = warp; i < N; i += nwarps) {
      float* row = sc + i * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += kWarp) s += expf(row[j] - m);
      s = warp_sum(s);
      for (int j = lane; j < N; j += kWarp) row[j] = expf(row[j] - m) / s;
    }
    __syncthreads();

    // P . V into this head's columns of the pre-projection tile
    for (int idx = tid; idx < N * hd; idx += nthr) {
      const int i = idx / hd, dd = idx % hd;
      const float* p = sc + i * N;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += p[j] * vs[j * hdp + dd];
      ob[i * C + hh * hd + dd] = acc;
    }
    __syncthreads();
  }

  // projection + bias (+ residual), written back to the window's tokens
  for (int idx = tid; idx < N * C; idx += nthr) {
    const int i = idx / C, c = idx % C;
    const float* o = ob + i * C;
    float acc = 0.f;
    for (int k = 0; k < C; ++k) acc += o[k] * wproj[(size_t)k * C + c];
    float v = acc + a.proj_b[c];
    if (a.residual) v += x[tok[i] + c];
    out[tok[i] + c] = v;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.  The math of fold_attn_kernel with bf16 cast
// boundaries; its four products (qkv, q.k, p.v, proj) run as WMMA
// 16x16x16 bf16 tiles with fp32 accumulation.  The window's N tokens are
// padded to Np = ceil(N/16)*16 rows: padded rows of the LN tile are zero,
// padded score columns get probability 0, padded output rows are dropped.
// Needs C and head_dim to be multiples of 16 (flagship: C 96/192, hd 16;
// tiny: C 32/64, hd 16); other widths are refused.
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 512;
constexpr int kTcWarps = kTcThreads / kWarp;

struct TcLayout {
  size_t tok, xn, ob, q, k, v, sc, p, stage, bytes;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline TcLayout tc_layout(int n, int c, int nh) {
  const size_t np = (n + 15) / 16 * 16, hd = c / nh, bf = sizeof(__nv_bfloat16);
  TcLayout l;
  size_t o = 0;
  l.tok = o;   o = align128(o + sizeof(long long) * np);
  l.xn = o;    o = align128(o + bf * np * c);
  l.ob = o;    o = align128(o + bf * np * c);
  l.q = o;     o = align128(o + bf * np * hd);
  l.k = o;     o = align128(o + bf * np * hd);
  l.v = o;     o = align128(o + bf * np * hd);
  l.sc = o;    o = align128(o + sizeof(float) * np * np);
  l.p = o;     o = align128(o + bf * np * np);
  l.stage = o; o = align128(o + sizeof(float) * 256 * kTcWarps);
  l.bytes = o;
  return l;
}

inline bool tc_eligible(int c, int nh) {
  return c % nh == 0 && c % 16 == 0 && (c / nh) % 16 == 0;
}

__global__ void __launch_bounds__(kTcThreads) fold_attn_tc_kernel(FoldArgs a) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

  extern __shared__ __align__(128) unsigned char sm[];
  const int C = a.C, nh = a.nh, hd = C / nh;
  const int N = a.wd * a.wh * a.ww, Np = (N + 15) / 16 * 16, mt_n = Np / 16;
  const TcLayout L = tc_layout(N, C, nh);
  long long* tok = reinterpret_cast<long long*>(sm + L.tok);
  bf16* xn = reinterpret_cast<bf16*>(sm + L.xn);
  bf16* ob = reinterpret_cast<bf16*>(sm + L.ob);
  bf16* qs = reinterpret_cast<bf16*>(sm + L.q);
  bf16* ks = reinterpret_cast<bf16*>(sm + L.k);
  bf16* vs = reinterpret_cast<bf16*>(sm + L.v);
  float* sc = reinterpret_cast<float*>(sm + L.sc);
  bf16* ps = reinterpret_cast<bf16*>(sm + L.p);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* wqkv = static_cast<const bf16*>(a.qkv_w);
  const bf16* wproj = static_cast<const bf16*>(a.proj_w);
  bf16* out = static_cast<bf16*>(a.out);

  const int nwd = a.D / a.wd, nwh = a.H / a.wh, nww = a.W / a.ww;
  const int nw = nwd * nwh * nww;
  const int win = blockIdx.x % nw;
  const int b = blockIdx.x / nw;
  const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  float* stage = reinterpret_cast<float*>(sm + L.stage) + warp * 256;

  for (int i = tid; i < N; i += kTcThreads) {
    const int ta = i / (a.wh * a.ww), tb = (i / a.ww) % a.wh, tc = i % a.ww;
    tok[i] = token_offset(a, b, wi_d * a.wd + ta, wi_h * a.wh + tb, wi_w * a.ww + tc);
  }
  __syncthreads();
  for (int i = warp; i < Np; i += kTcWarps) {
    bf16* row = xn + (size_t)i * C;
    if (i >= N) {
      for (int c = lane; c < C; c += kWarp) row[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xi = x + tok[i];
    if (a.ln_s != nullptr) {
      float mu, rstd;
      warp_ln_stats(xi, C, &mu, &rstd);
      for (int c = lane; c < C; c += kWarp)
        row[c] = __float2bfloat16((to_f(xi[c]) - mu) * rstd * a.ln_s[c] + a.ln_b[c]);
    } else {
      for (int c = lane; c < C; c += kWarp) row[c] = xi[c];
    }
  }
  __syncthreads();

  const float* mask = a.mask != nullptr ? a.mask + (size_t)win * N * N : nullptr;
  const int C3 = 3 * C, hsub = hd / 16;
  for (int hh = 0; hh < nh; ++hh) {
    // q, k, v of this head: Np x hd each, (acc + bias) rounded to bf16
    for (int t = warp; t < mt_n * 3 * hsub; t += kTcWarps) {
      const int mt = t / (3 * hsub), nt = t % (3 * hsub);
      const int part = nt / hsub, sub = nt % hsub;
      const int col0 = part * C + hh * hd + sub * 16;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, xn + (size_t)mt * 16 * C + k0, C);
        wmma::load_matrix_sync(fb, wqkv + (size_t)k0 * C3 + col0, C3);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      bf16* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      for (int e = lane; e < 256; e += kWarp) {
        const int r = e / 16, cc = e % 16;
        dst[(size_t)(mt * 16 + r) * hd + sub * 16 + cc] =
            __float2bfloat16(stage[e] + a.qkv_b[col0 + cc]);
      }
      __syncwarp();
    }
    __syncthreads();

    // raw scores q . k^T (Np x Np, fp32)
    for (int t = warp; t < mt_n * mt_n; t += kTcWarps) {
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

    // * scale + bias + mask, fp32 softmax, probabilities rounded to bf16;
    // padded rows and columns get probability 0
    const float* bias = a.bias + (size_t)hh * N * N;
    for (int i = warp; i < Np; i += kTcWarps) {
      bf16* prow = ps + (size_t)i * Np;
      if (i >= N) {
        for (int j = lane; j < Np; j += kWarp) prow[j] = __float2bfloat16(0.f);
        continue;
      }
      float* row = sc + (size_t)i * Np;
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) {
        float s = row[j] * a.scale + bias[i * N + j];
        if (mask != nullptr) s += mask[i * N + j];
        row[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += kWarp) s += expf(row[j] - m);
      s = warp_sum(s);
      for (int j = lane; j < Np; j += kWarp)
        prow[j] = __float2bfloat16(j < N ? expf(row[j] - m) / s : 0.f);
    }
    __syncthreads();

    // p . v into this head's columns of the pre-projection tile
    for (int t = warp; t < mt_n * hsub; t += kTcWarps) {
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

  // projection + bias (+ residual), written back to the window's tokens
  for (int t = warp; t < mt_n * (C / 16); t += kTcWarps) {
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
      if (i < N) {
        float v = stage[e] + a.proj_b[c];
        if (a.residual) v += to_f(x[tok[i] + c]);
        out[tok[i] + c] = __float2bfloat16(v);
      }
    }
    __syncwarp();
  }
}

// Shared memory one block of the launch's kernel needs.
inline size_t fold_plan_smem(int n, int c, int nh, int is_bf16) {
  return is_bf16 ? tc_layout(n, c, nh).bytes : fold_smem_bytes(n, c, nh);
}

cudaError_t launch_fold(const FoldArgs& a, cudaStream_t stream) {
  const int n = a.wd * a.wh * a.ww;
  const size_t smem = fold_smem_bytes(n, a.C, a.nh);
  if (smem > (size_t)kMaxSmemBytes || a.C % a.nh != 0 || a.D % a.wd != 0 ||
      a.H % a.wh != 0 || a.W % a.ww != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fold_attn_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)a.B * (a.D / a.wd) * (a.H / a.wh) * (a.W / a.ww);
  fold_attn_kernel<<<(unsigned)blocks, kFoldThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_fold_tc(const FoldArgs& a, cudaStream_t stream) {
  const size_t smem = tc_layout(a.wd * a.wh * a.ww, a.C, a.nh).bytes;
  if (!tc_eligible(a.C, a.nh) || smem > (size_t)kMaxSmemBytes || a.D % a.wd != 0 ||
      a.H % a.wh != 0 || a.W % a.ww != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fold_attn_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)a.B * (a.D / a.wd) * (a.H / a.wh) * (a.W / a.ww);
  fold_attn_tc_kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

// Shared memory one block of the launch's kernel needs; the wrapper refuses
// geometries above the card's limit before launching.
long long vadcl_fold_attn_smem_bytes(int n, int c, int nh, int is_bf16) {
  return (long long)vadcl::fold_plan_smem(n, c, nh, is_bf16);
}

int vadcl_fold_attn(const void* x, const float* ln_s, const float* ln_b,
                    const void* qkv_w, const float* qkv_b, const void* proj_w,
                    const float* proj_b, const float* bias, const float* mask,
                    void* out, int B, int D, int H, int W, int C, int nh, int wd,
                    int wh, int ww, int sd, int sh, int sw, float scale,
                    int residual, int is_bf16, void* stream) {
  vadcl::FoldArgs a{x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, out,
                    B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? vadcl::launch_fold_tc(a, s) : vadcl::launch_fold(a, s);
}

}  // extern "C"
