// Device code of the folded Swin attention forward, shared by fold_attn.cu
// (kernel A, its head-packed variant and the whole-block kernel) and
// fold_attn_bwd.cu (whose whole-block backward recomputes the block's front
// half with the same code).  See fold_attn.cu for what it replaces and what
// bounds it.
//
// One block of kFoldThreads threads handles one window.  Two template flags:
//   kPacked: the arithmetic of _fold_packed_kernel (qkv kept fp32 until
//     q = round(q * scale) and k, v = round(.); no scale after q.k; per-head
//     row max; p = round(e * (1 / sum e))).
//   kTail: _fold_kernel's tail= mode.  y1 = round(x + proj(attention(LN1 x)))
//     stays in shared memory, and out = y1 + fc2(gelu(fc1(LN2 y1))) with the
//     cast boundaries of kernel B (mlp_tail.cuh), on tiles the attention no
//     longer needs.
#pragma once

#include <mma.h>

#include "mlp_tail.cuh"

namespace vadcl {

constexpr int kFoldThreads = 512;
constexpr int kFoldWarps = kFoldThreads / kWarp;
constexpr int kTailTokens = 32;  // tokens per tile of the fp32 tail

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
  // the MLP tail of the whole-block kernel (unused otherwise)
  const float* ln2_s;
  const float* ln2_b;
  const void* w1;  // (C, Ch), compute dtype
  const float* b1;  // (Ch,)
  const void* w2;  // (Ch, C), compute dtype
  const float* b2;  // (C,)
  int Ch;
};

// fp32 kernel: token offsets, the LN'd window xn (N x C; y1 in tail mode),
// then a region holding ob (N x C), one head's q/k/v (N x (hd+1)) and its
// scores (N x N); the tail reuses the region for a token tile's z, fc2 sums
// and GELU chunk.
inline size_t fold_smem_bytes(int n, int c, int nh, bool tail = false) {
  const size_t N = n, C = c, hdp = c / nh + 1;
  size_t region = N * C + 3 * N * hdp + N * N;
  const size_t t = 2 * (size_t)kTailTokens * C + (size_t)kTailTokens * kMlpChunk;
  if (tail && t > region) region = t;
  return sizeof(float) * (N * C + region) + sizeof(long long) * N;
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

template <bool kPacked, bool kTail>
__device__ __forceinline__ void fold_attn_body(const FoldArgs& a, float* smem) {
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
    // q, k, v of this head: (N, hd) each; the packed variant scales q here
    for (int idx = tid; idx < N * 3 * hd; idx += nthr) {
      const int i = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, dd = j % hd;
      const int col = part * C + hh * hd + dd;
      const float* xr = xn + i * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += xr[c] * wqkv[(size_t)c * C3 + col];
      float v = acc + a.qkv_b[col];
      if (kPacked && part == 0) v *= a.scale;
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      dst[i * hdp + dd] = v;
    }
    __syncthreads();

    // scores: (q . k) * scale + bias + mask, fp32 (packed: q is scaled already)
    const float* bias = bias_all + (size_t)hh * N * N;
    for (int idx = tid; idx < N * N; idx += nthr) {
      const int i = idx / N, j = idx % N;
      const float* q = qs + i * hdp;
      const float* k = ks + j * hdp;
      float s = 0.f;
      for (int dd = 0; dd < hd; ++dd) s += q[dd] * k[dd];
      s = (kPacked ? s : s * a.scale) + bias[idx];
      if (mask != nullptr) s += mask[idx];
      sc[idx] = s;
    }
    __syncthreads();

    // row softmax (packed: e * (1 / sum e) instead of e / sum e)
    for (int i = warp; i < N; i += nwarps) {
      float* row = sc + i * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += kWarp) s += expf(row[j] - m);
      s = warp_sum(s);
      const float inv = 1.f / s;
      for (int j = lane; j < N; j += kWarp)
        row[j] = kPacked ? expf(row[j] - m) * inv : expf(row[j] - m) / s;
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

  // projection + bias (+ residual): written back to the window's tokens, or
  // (tail mode) kept as y1 in xn, which no product reads any more
  for (int idx = tid; idx < N * C; idx += nthr) {
    const int i = idx / C, c = idx % C;
    const float* o = ob + i * C;
    float acc = 0.f;
    for (int k = 0; k < C; ++k) acc += o[k] * wproj[(size_t)k * C + c];
    float v = acc + a.proj_b[c];
    if (a.residual) v += x[tok[i] + c];
    if (kTail)
      xn[idx] = v;
    else
      out[tok[i] + c] = v;
  }
  if (!kTail) return;

  // the MLP tail over tiles of kTailTokens tokens, in the region ob.. (dead)
  __syncthreads();
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  float* z = ob;                       // kTailTokens*C
  float* acc2 = z + kTailTokens * C;   // kTailTokens*C
  float* g = acc2 + kTailTokens * C;   // kTailTokens*kMlpChunk
  for (int t0 = 0; t0 < N; t0 += kTailTokens) {
    const int nt = min(kTailTokens, N - t0);
    for (int t = warp; t < nt; t += nwarps) {
      const float* yi = xn + (t0 + t) * C;
      float mu, rstd;
      warp_ln_stats(yi, C, &mu, &rstd);
      for (int c = lane; c < C; c += kWarp)
        z[t * C + c] = (yi[c] - mu) * rstd * a.ln2_s[c] + a.ln2_b[c];
    }
    mlp_chunks_f32(z, acc2, g, w1, a.b1, w2, nt, C, a.Ch);
    for (int idx = tid; idx < nt * C; idx += nthr) {
      const int i = t0 + idx / C, c = idx % C;
      out[tok[i] + c] = xn[i * C + c] + (acc2[idx] + a.b2[c]);
    }
    __syncthreads();  // the next tile overwrites z and acc2
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.  The math of fold_attn_body with bf16 cast
// boundaries; its four products (qkv, q.k, p.v, proj) run as WMMA
// 16x16x16 bf16 tiles with fp32 accumulation.  The window's N tokens are
// padded to Np = ceil(N/16)*16 rows: padded rows of the LN tile are zero,
// padded score columns get probability 0, padded output rows are dropped.
// Needs C and head_dim to be multiples of 16 (flagship: C 96/192, hd 16;
// tiny: C 32/64, hd 16); other widths are refused.
//
// Tail mode: y1 rounds into xn, LN2(y1) into ob, and the region behind them
// (q, k, v, scores, probabilities, stage: all dead) holds first the fc1
// stage and the GELU chunk, then the fp32 fc2 sums; the fc2 accumulator
// lives in each warp's fragments (at most kTcAcc tiles a warp).
// ---------------------------------------------------------------------------
struct TcLayout {
  size_t tok, xn, ob, q, k, v, sc, p, stage, bytes;
  size_t hstage, g, ostage;  // tail mode, from `q` on
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline TcLayout tc_layout(int n, int c, int nh, bool tail = false) {
  const size_t np = (n + 15) / 16 * 16, hd = c / nh, bf = sizeof(__nv_bfloat16);
  TcLayout l;
  size_t o = 0;
  l.tok = o;   o = align128(o + sizeof(long long) * np);
  l.xn = o;    o = align128(o + bf * np * c);
  l.ob = o;    o = align128(o + bf * np * c);
  const size_t region = o;
  l.q = o;     o = align128(o + bf * np * hd);
  l.k = o;     o = align128(o + bf * np * hd);
  l.v = o;     o = align128(o + bf * np * hd);
  l.sc = o;    o = align128(o + sizeof(float) * np * np);
  l.p = o;     o = align128(o + bf * np * np);
  l.stage = o; o = align128(o + sizeof(float) * 256 * kFoldWarps);
  l.bytes = o;
  l.hstage = region;
  l.g = align128(l.hstage + sizeof(float) * np * kTcChunk);
  l.ostage = region;
  if (tail) {
    const size_t t1 = align128(l.g + bf * np * kTcChunk);
    const size_t t2 = align128(l.ostage + sizeof(float) * np * c);
    if (t1 > l.bytes) l.bytes = t1;
    if (t2 > l.bytes) l.bytes = t2;
  }
  return l;
}

inline bool tc_eligible(int c, int nh) {
  return c % nh == 0 && c % 16 == 0 && (c / nh) % 16 == 0;
}

// The tensor-core tail also needs the hidden width in whole chunks and no
// more output tiles than the warps' fragments hold.
inline bool tc_tail_eligible(int n, int c, int ch) {
  return ch > 0 && ch % kTcChunk == 0 && ((n + 15) / 16) * (c / 16) <= kTcAcc * kFoldWarps;
}

template <bool kPacked, bool kTail>
__device__ __forceinline__ void fold_attn_tc_body(const FoldArgs& a, unsigned char* sm) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

  const int C = a.C, nh = a.nh, hd = C / nh;
  const int N = a.wd * a.wh * a.ww, Np = (N + 15) / 16 * 16, mt_n = Np / 16;
  const TcLayout L = tc_layout(N, C, nh, kTail);
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

  for (int i = tid; i < N; i += kFoldThreads) {
    const int ta = i / (a.wh * a.ww), tb = (i / a.ww) % a.wh, tc = i % a.ww;
    tok[i] = token_offset(a, b, wi_d * a.wd + ta, wi_h * a.wh + tb, wi_w * a.ww + tc);
  }
  __syncthreads();
  for (int i = warp; i < Np; i += kFoldWarps) {
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
    // q, k, v of this head: Np x hd each, (acc + bias) rounded to bf16; the
    // packed variant rounds q after scaling it
    for (int t = warp; t < mt_n * 3 * hsub; t += kFoldWarps) {
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
      const float qscale = (kPacked && part == 0) ? a.scale : 1.f;
      for (int e = lane; e < 256; e += kWarp) {
        const int r = e / 16, cc = e % 16;
        float v = stage[e] + a.qkv_b[col0 + cc];
        if (kPacked) v *= qscale;
        dst[(size_t)(mt * 16 + r) * hd + sub * 16 + cc] = __float2bfloat16(v);
      }
      __syncwarp();
    }
    __syncthreads();

    // raw scores q . k^T (Np x Np, fp32)
    for (int t = warp; t < mt_n * mt_n; t += kFoldWarps) {
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
    // padded rows and columns get probability 0
    const float* bias = a.bias + (size_t)hh * N * N;
    for (int i = warp; i < Np; i += kFoldWarps) {
      bf16* prow = ps + (size_t)i * Np;
      if (i >= N) {
        for (int j = lane; j < Np; j += kWarp) prow[j] = __float2bfloat16(0.f);
        continue;
      }
      float* row = sc + (size_t)i * Np;
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) {
        float s = (kPacked ? row[j] : row[j] * a.scale) + bias[i * N + j];
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
        if (j < N) p = kPacked ? expf(row[j] - m) * inv : expf(row[j] - m) / s;
        prow[j] = __float2bfloat16(p);
      }
    }
    __syncthreads();

    // p . v into this head's columns of the pre-projection tile
    for (int t = warp; t < mt_n * hsub; t += kFoldWarps) {
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

  // projection + bias (+ residual): written back to the window's tokens, or
  // (tail mode) rounded into xn as y1; xn's padded rows stay zero
  for (int t = warp; t < mt_n * (C / 16); t += kFoldWarps) {
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
        if (kTail)
          xn[(size_t)i * C + c] = __float2bfloat16(v);
        else
          out[tok[i] + c] = __float2bfloat16(v);
      }
    }
    __syncwarp();
  }
  if (!kTail) return;

  // the MLP tail: z = round(LN2(y1)) into ob, then the chunk loop
  __syncthreads();
  for (int i = warp; i < Np; i += kFoldWarps) {
    bf16* row = ob + (size_t)i * C;
    if (i >= N) {
      for (int c = lane; c < C; c += kWarp) row[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* yi = xn + (size_t)i * C;
    float mu, rstd;
    warp_ln_stats(yi, C, &mu, &rstd);
    for (int c = lane; c < C; c += kWarp)
      row[c] = __float2bfloat16((to_f(yi[c]) - mu) * rstd * a.ln2_s[c] + a.ln2_b[c]);
  }
  __syncthreads();
  float* hstage = reinterpret_cast<float*>(sm + L.hstage);
  bf16* g = reinterpret_cast<bf16*>(sm + L.g);
  float* ostage = reinterpret_cast<float*>(sm + L.ostage);
  MlpFragC acc2[kTcAcc];
  mlp_chunks_tc<kFoldThreads>(ob, g, hstage, static_cast<const bf16*>(a.w1), a.b1,
                              static_cast<const bf16*>(a.w2), Np, C, a.Ch, acc2);
  __syncthreads();  // ostage overlaps g, which other warps were still reading
  mlp_store_acc<kFoldThreads>(ostage, acc2, Np, C);
  __syncthreads();
  for (int e = tid; e < N * C; e += kFoldThreads) {
    const int i = e / C, c = e % C;
    out[tok[i] + c] = __float2bfloat16(to_f(xn[e]) + (ostage[e] + a.b2[c]));
  }
}

// Whether the launch's geometry is one the kernels take.
inline bool fold_args_ok(const FoldArgs& a) {
  return a.C % a.nh == 0 && a.D % a.wd == 0 && a.H % a.wh == 0 && a.W % a.ww == 0;
}

inline long long fold_blocks(const FoldArgs& a) {
  return (long long)a.B * (a.D / a.wd) * (a.H / a.wh) * (a.W / a.ww);
}

}  // namespace vadcl
