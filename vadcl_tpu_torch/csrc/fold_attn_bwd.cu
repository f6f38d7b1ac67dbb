// Backward of the folded Swin attention front half (kernel 6):
//   out = x + proj(attention(LN1(x)))   ->   dx, dLN1, dqkv, dproj, d(bias)
//
// Replaces vadcl_tpu/ops/pallas_attn_fold.py:_fold_bwd_kernel (entry
// _fold_bwd_call, reached through _blk_bwd with fuse_ln=True,
// residual=True, no MLP tail), with or without the shift mask.  A second
// mode, ln_s == null and residual == 0, is _fold_bwd_call's fuse_ln=False,
// residual=False (the backward of folded_window_attention_trainable, which
// blocks at window-padded geometries run): the attention input is x itself,
// dx = round(dxa), and there are no LN gradients.
//
// Pass 1, fold_attn_bwd_kernel: one block per (batch, window), addressing
// the window's tokens in the unpartitioned (B, D, H, W, C) tensors by
// strides as the forward does; the shifted blocks' roll is folded into the
// same addressing, so dx of a token lands where the token came from.  The
// block recomputes LN1 (fast variance, fp32), the rounded LN output `row`,
// and per head q/k/v, the fp32 softmax P and the per-head output o, then
// runs the backward with _fold_bwd_kernel's order and cast boundaries:
//   doa = round(dout . proj_w^T);  dv = round(P)^T . doa;  dp = doa . v^T;
//   ds = P * (dp - rowsum(dp * P));  dq = round(ds * scale) . k;
//   dk = round(ds * scale)^T . q;  dxa = round(dqkv) . qkv_w^T;
//   dx = LN-vjp(dxa) + dout  (stored in the compute dtype).
// Two kernels, one per compute dtype, as for kernel A.  The model's bf16
// geometries (head width 16 or 32, at most 112 tokens) run the tensor-core
// body of fold_attn_bwd_mma.cu instead; the bf16 kernel here takes the other
// bf16 geometries whose block fits.  bf16: fold_attn_bwd_tc_kernel runs every product
// (qkv, q.k, p.v, dout.proj_w^T, p^T.doa, doa.v^T, dss.k, dss^T.q and
// dqkv.qkv_w^T) as WMMA 16x16x16 bf16 tiles with fp32 accumulation, the
// window padded to Np = ceil(N/16)*16 rows (padded rows and columns carry
// probability 0, so they add nothing); it needs C and head_dim to be
// multiples of 16 and refuses other widths.  fp32 (the path of the model's
// exact comparisons): fold_attn_bwd_kernel, CUDA-core loops, everything fp32
// in shared memory.
//
// The cross-window sums (the TPU grid carries them in VMEM) cannot be
// accumulated in parallel blocks without float atomics, so pass 1 writes
//   row, o (tokens x C) and round(dqkv) (tokens x 3C) in the compute dtype,
//   per block: the column sums of dqkv (3C), of dxa*xhat and dxa (2C), and
//   ds per head (nH x N x N),
// and pass 2 (reduce.cu) forms dqkv_w = row^T . dqkv, dproj_w = o^T . dout,
// dproj_b = colsum(dout) and sums the per-block partials, all in a fixed
// order with fp32 accumulation.
//
// What bounds it: one block per SM (up to 224 KB of shared memory at
// C=192, N=98 in bf16), nine block-wide barriers per head, the fp32 softmax
// backward between the products, and the weight tiles read from L2 by every
// block; at encoder stage 1 (64 windows per 4 clips) there are fewer blocks
// than SMs.  The d(bias) partials are the largest workspace (nH*N*N floats
// per window).  Left on the table: wgmma with TMA-staged weights, two heads
// in flight per block, summing d(bias) over a group of windows inside a
// block, tensor cores for the second pass.
//
// The whole-Swin-block backward (vadcl_fold_block_bwd) replaces
// _fold_bwd_kernel's tail= mode (entry _fold_bwd_call through _full_bwd, the
// custom VJP of folded_full_block_trainable).  One launch, one block per
// window, three steps on the window's own tokens with block barriers between:
//   1. the forward's front half (fold_attn.cuh, kernel A's device code)
//      recomputes y1 = round(x + proj(attention(LN1 x))) into a workspace;
//   2. the MLP tail's backward (mlp_bwd.cuh, kernel 5's device code) on y1
//      and the block's upstream gradient: groups of 128 threads, each on a
//      named barrier of its own, walk the window's 16-token tiles.  Like
//      _fold_bwd_kernel it recomputes with rounding (z before fc1, h before
//      GELU) and multiplies in fp32 on fp32 operands (dw1 from the unrounded
//      z, dw2 from the GELU of the rounded hidden); dy1 = dY + LN2-vjp(dz)
//      rounds to the compute dtype into a workspace;
//   3. the attention backward above with dy1 as its upstream gradient (the
//      residual branch carries dy1 too).
// The second pass adds kernel 5's six reductions (dw1, db1, dw2, db2, dLN2
// scale and bias) to the attention backward's, all through reduce.cu.
// Shared memory is the largest of the three steps' layouts (kernel 6's at
// the flagship geometries), so one predicate covers both directions.  The
// workspace is kernel 6's plus kernel 5's (z, and the fp32 GELU output and
// dh, tokens x 4C each) plus y1 and dy1.  What bounds it: step 2's fp32 FMA
// products with three or four thread groups per SM, then what bounds kernel 6.
#include <mma.h>

#include "fold_attn.cuh"
#include "mlp_bwd.cuh"
#include "reduce.cuh"

namespace vadcl {

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / kWarp;

struct FoldBwdArgs {
  const void* x;     // (B, D, H, W, C) compute dtype
  const void* dout;  // (B, D, H, W, C) compute dtype
  const float* ln_s;  // null: no LayerNorm (and then no residual)
  const float* ln_b;
  const void* qkv_w;  // (C, 3C) compute dtype
  const float* qkv_b;  // (3C,)
  const void* proj_w;  // (C, C) compute dtype
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  void* dx;
  void* row_ws;  // (T, C) compute dtype
  void* o_ws;    // (T, C) compute dtype
  void* dqkv_ws;  // (T, 3C) compute dtype
  float* dqkvb_part;  // (blocks, 3C)
  float* dln_part;    // (blocks, 2C): sum dxa*xhat, then sum dxa
  float* dbias_part;  // (blocks, nH, N, N)
  int B, D, H, W, C, nh, wd, wh, ww;
  int sd, sh, sw;
  float scale;
  int residual;
};

// Floats of the per-window region: phase 1 (the head loop) and phase 2 (the
// dxa product and the LN vjp) reuse the same shared memory.
inline size_t bwd_region_floats(int n, int c, int nh) {
  const size_t hdp = c / nh + 1, N = n, C = c;
  const size_t p1 = N * C + 5 * N * hdp + 2 * N * N;
  const size_t p2 = N * C + 33 * C + 33 * N + (size_t)kBwdWarps * 2 * C;
  return p1 > p2 ? p1 : p2;
}

inline size_t fold_bwd_smem_bytes(int n, int c, int nh) {
  return sizeof(long long) * n + sizeof(float) * (2 * (size_t)n + bwd_region_floats(n, c, nh));
}

// Token index (into B*D*H*W) of window token (d, h, w) of batch b, with the
// shift roll folded in as in the forward's token_offset.
__device__ __forceinline__ long long bwd_token(const FoldBwdArgs& a, int b, int d, int h,
                                               int w) {
  const long long dd = (d + a.sd) % a.D, hh = (h + a.sh) % a.H, ww = (w + a.sw) % a.W;
  return ((b * (long long)a.D + dd) * a.H + hh) * a.W + ww;
}

__device__ __forceinline__ void fold_attn_bwd_body(const FoldBwdArgs& a, float* smem) {
  using T = float;  // the fp32 path; the casts below are the bf16 path's boundaries
  const int C = a.C, nh = a.nh, hd = C / nh, hdp = hd + 1, C3 = 3 * C;
  const int N = a.wd * a.wh * a.ww;
  long long* tok = reinterpret_cast<long long*>(smem);  // N token indices
  float* mu = smem + 2 * N;
  float* rs = mu + N;
  float* reg = rs + N;
  // phase 1
  float* row = reg;             // N*C   rounded LN output
  float* qs = row + N * C;      // N*hdp q
  float* ks = qs + N * hdp;     // N*hdp k
  float* vs = ks + N * hdp;     // N*hdp v, then dq
  float* das = vs + N * hdp;    // N*hdp round(dout . proj_w^T) head slice, then dk
  float* dvs = das + N * hdp;   // N*hdp dv
  float* pb = dvs + N * hdp;    // N*N   scores, then fp32 probabilities
  float* sb = pb + N * N;       // N*N   dp, then round(ds * scale)
  // phase 2
  float* dxa = reg;             // N*C
  float* wsm = dxa + N * C;     // C*33  qkv_w[:, j0:j0+32]
  float* dqs = wsm + C * 33;    // N*33  round(dqkv)[:, j0:j0+32]
  float* wpart = dqs + N * 33;  // kBwdWarps*2C per-warp dln partials

  const T* x = static_cast<const T*>(a.x);
  const T* dout = static_cast<const T*>(a.dout);
  const T* wqkv = static_cast<const T*>(a.qkv_w);
  const T* wproj = static_cast<const T*>(a.proj_w);
  T* dx = static_cast<T*>(a.dx);
  T* row_ws = static_cast<T*>(a.row_ws);
  T* o_ws = static_cast<T*>(a.o_ws);
  T* dqkv_ws = static_cast<T*>(a.dqkv_ws);

  const int nwd = a.D / a.wd, nwh = a.H / a.wh, nww = a.W / a.ww;
  const int nw = nwd * nwh * nww;
  const int blk = blockIdx.x, win = blk % nw, b = blk / nw;
  const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;

  for (int i = tid; i < N; i += kBwdThreads) {
    const int ta = i / (a.wh * a.ww), tb = (i / a.ww) % a.wh, tc = i % a.ww;
    tok[i] = bwd_token(a, b, wi_d * a.wd + ta, wi_h * a.wh + tb, wi_w * a.ww + tc);
  }
  __syncthreads();

  // LN1 statistics and the rounded LN output (also kept for dqkv_w)
  for (int i = warp; i < N; i += kBwdWarps) {
    const T* xi = x + tok[i] * C;
    float m = 0.f, r = 1.f;
    if (a.ln_s != nullptr) warp_ln_stats(xi, C, &m, &r);
    if (lane == 0) {
      mu[i] = m;
      rs[i] = r;
    }
    for (int c = lane; c < C; c += kWarp) {
      const float v = a.ln_s != nullptr
                          ? round_to<T>((to_f(xi[c]) - m) * r * a.ln_s[c] + a.ln_b[c])
                          : to_f(xi[c]);
      row[i * C + c] = v;
      row_ws[tok[i] * C + c] = from_f<T>(v);
    }
  }
  __syncthreads();

  const float* mask = a.mask != nullptr ? a.mask + (size_t)win * N * N : nullptr;
  for (int h = 0; h < nh; ++h) {
    // q, k, v of this head (rounded) and the head slice of dout . proj_w^T
    for (int idx = tid; idx < N * 3 * hd; idx += kBwdThreads) {
      const int i = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, d = j % hd, col = part * C + h * hd + d;
      const float* ri = row + i * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += ri[c] * to_f(wqkv[(size_t)c * C3 + col]);
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      dst[i * hdp + d] = round_to<T>(acc + a.qkv_b[col]);
    }
    for (int idx = tid; idx < N * hd; idx += kBwdThreads) {
      const int i = idx / hd, d = idx % hd;
      const T* di = dout + tok[i] * C;
      const T* wp = wproj + (size_t)(h * hd + d) * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += to_f(di[c]) * to_f(wp[c]);
      das[i * hdp + d] = round_to<T>(acc);
    }
    __syncthreads();

    // scores (q . k) * scale + bias + mask, fp32
    const float* bias = a.bias + (size_t)h * N * N;
    for (int idx = tid; idx < N * N; idx += kBwdThreads) {
      const int i = idx / N, j = idx % N;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qs[i * hdp + d] * ks[j * hdp + d];
      s = s * a.scale + bias[idx];
      if (mask != nullptr) s += mask[idx];
      pb[idx] = s;
    }
    __syncthreads();
    for (int i = warp; i < N; i += kBwdWarps) {
      float* prow = pb + i * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) m = fmaxf(m, prow[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += kWarp) s += expf(prow[j] - m);
      s = warp_sum(s);
      for (int j = lane; j < N; j += kWarp) prow[j] = expf(prow[j] - m) / s;
    }
    __syncthreads();

    // o = round(P) . v (to the workspace), dv = round(P)^T . doa, dp = doa . v^T
    for (int idx = tid; idx < N * hd; idx += kBwdThreads) {
      const int i = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += round_to<T>(pb[i * N + j]) * vs[j * hdp + d];
      o_ws[tok[i] * C + h * hd + d] = from_f<T>(acc);
    }
    for (int idx = tid; idx < N * hd; idx += kBwdThreads) {
      const int j = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc += round_to<T>(pb[i * N + j]) * das[i * hdp + d];
      dvs[j * hdp + d] = acc;
    }
    for (int idx = tid; idx < N * N; idx += kBwdThreads) {
      const int i = idx / N, j = idx % N;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc += das[i * hdp + d] * vs[j * hdp + d];
      sb[idx] = acc;
    }
    __syncthreads();

    // softmax backward (fp32); ds is this window's share of d(bias)
    float* dbias = a.dbias_part + ((size_t)blk * nh + h) * N * N;
    for (int i = warp; i < N; i += kBwdWarps) {
      const float* prow = pb + i * N;
      float* srow = sb + i * N;
      float r = 0.f;
      for (int j = lane; j < N; j += kWarp) r += srow[j] * prow[j];
      r = warp_sum(r);
      for (int j = lane; j < N; j += kWarp) {
        const float ds = prow[j] * (srow[j] - r);
        dbias[i * N + j] = ds;
        srow[j] = round_to<T>(ds * a.scale);
      }
    }
    __syncthreads();

    // dq = dss . k (into vs), dk = dss^T . q (into das)
    for (int idx = tid; idx < N * hd; idx += kBwdThreads) {
      const int i = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += sb[i * N + j] * ks[j * hdp + d];
      vs[i * hdp + d] = acc;
    }
    for (int idx = tid; idx < N * hd; idx += kBwdThreads) {
      const int j = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc += sb[i * N + j] * qs[i * hdp + d];
      das[j * hdp + d] = acc;
    }
    __syncthreads();

    // round(dqkv) to the workspace; unrounded column sums for dqkv_b
    for (int idx = tid; idx < N * 3 * hd; idx += kBwdThreads) {
      const int i = idx / (3 * hd), j = idx % (3 * hd), part = j / hd, d = j % hd;
      const float* src = part == 0 ? vs : (part == 1 ? das : dvs);
      dqkv_ws[tok[i] * C3 + part * C + h * hd + d] = from_f<T>(src[i * hdp + d]);
    }
    for (int j = tid; j < 3 * hd; j += kBwdThreads) {
      const int part = j / hd, d = j % hd;
      const float* src = part == 0 ? vs : (part == 1 ? das : dvs);
      float s = 0.f;
      for (int i = 0; i < N; ++i) s += src[i * hdp + d];
      a.dqkvb_part[(size_t)blk * C3 + part * C + h * hd + d] = s;
    }
    __syncthreads();
  }

  // phase 2: dxa = round(dqkv) . qkv_w^T, over 32-column slices of dqkv (the
  // block's own workspace rows, visible after the barrier above)
  for (int idx = tid; idx < N * C; idx += kBwdThreads) dxa[idx] = 0.f;
  for (int idx = tid; idx < kBwdWarps * 2 * C; idx += kBwdThreads) wpart[idx] = 0.f;
  for (int j0 = 0; j0 < C3; j0 += 32) {
    const int jw = min(32, C3 - j0);
    for (int idx = tid; idx < C * 32; idx += kBwdThreads) {
      const int c = idx / 32, jj = idx % 32;
      wsm[c * 33 + jj] = jj < jw ? to_f(wqkv[(size_t)c * C3 + j0 + jj]) : 0.f;
    }
    for (int idx = tid; idx < N * 32; idx += kBwdThreads) {
      const int i = idx / 32, jj = idx % 32;
      dqs[i * 33 + jj] = jj < jw ? to_f(dqkv_ws[tok[i] * C3 + j0 + jj]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < N * C; idx += kBwdThreads) {
      const int i = idx / C, c = idx % C;
      const float* dq = dqs + i * 33;
      const float* w = wsm + c * 33;
      float acc = dxa[idx];
      for (int jj = 0; jj < 32; ++jj) acc += dq[jj] * w[jj];
      dxa[idx] = acc;
    }
    __syncthreads();
  }

  if (a.ln_s == nullptr) {  // no LN: dx = round(dxa) (+ dout with the residual)
    for (int idx = tid; idx < N * C; idx += kBwdThreads) {
      const long long o = tok[idx / C] * C + idx % C;
      dx[o] = from_f<T>(dxa[idx] + (a.residual ? to_f(dout[o]) : 0.f));
    }
    return;
  }
  // LN vjp + residual, one warp per token; per-warp dln partials
  for (int i = warp; i < N; i += kBwdWarps) {
    const T* xi = x + tok[i] * C;
    const float m = mu[i], r = rs[i];
    const float* g = dxa + i * C;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float dxhat = g[c] * a.ln_s[c];
      s1 += dxhat;
      s2 += dxhat * (to_f(xi[c]) - m) * r;
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    float* wp = wpart + warp * 2 * C;
    for (int c = lane; c < C; c += kWarp) {
      const float xh = (to_f(xi[c]) - m) * r;
      wp[c] += g[c] * xh;
      wp[C + c] += g[c];
      const float dxhat = g[c] * a.ln_s[c];
      const float v =
          r * (dxhat - s1 - xh * s2) + (a.residual ? to_f(dout[tok[i] * C + c]) : 0.f);
      dx[tok[i] * C + c] = from_f<T>(v);
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * C; c += kBwdThreads) {
    float s = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) s += wpart[w * 2 * C + c];
    a.dln_part[(size_t)blk * 2 * C + c] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the math of fold_attn_bwd_kernel with every
// product as WMMA 16x16x16 bf16 tiles and fp32 accumulation.  The window's
// N tokens are padded to Np = ceil(N/16)*16 rows: padded rows of the LN
// output, dout and the probabilities are zero, so padded rows and columns
// add nothing to any product; their outputs are dropped.  Sums that run
// over a staged slice of columns (dout . proj_w^T, dqkv . qkv_w^T)
// accumulate in fp32 shared memory across the slices.
// ---------------------------------------------------------------------------
constexpr int kTcBwdChunk = 64;  // columns of dout / dqkv staged at a time

__host__ __device__ inline size_t bwd_align(size_t v) { return (v + 127) / 128 * 128; }

struct TcBwdLayout {
  // phase 1; P, dp and pb are contiguous (dout's column slices are staged
  // there before the scores exist)
  size_t tok, mu, rs, row, q, k, v, da, P, dp, pb, dq, dk, dv, stage;
  size_t dqs, dxa, wpart;  // phase 2, from `row` on
  size_t bytes;
};

__host__ __device__ inline TcBwdLayout tc_bwd_layout(int n, int c, int nh) {
  const size_t np = (n + 15) / 16 * 16, hd = c / nh, bf = 2, f = 4;
  TcBwdLayout l;
  size_t o = 0;
  l.tok = o;   o = bwd_align(o + sizeof(long long) * np);
  l.mu = o;    o = bwd_align(o + f * np);
  l.rs = o;    o = bwd_align(o + f * np);
  const size_t region = o;
  l.row = o;   o = bwd_align(o + bf * np * c);
  l.q = o;     o = bwd_align(o + bf * np * hd);
  l.k = o;     o = bwd_align(o + bf * np * hd);
  l.v = o;     o = bwd_align(o + bf * np * hd);
  l.da = o;    o = bwd_align(o + bf * np * hd);
  l.P = o;     o = bwd_align(o + f * np * np);
  l.dp = o;    o = bwd_align(o + f * np * np);
  l.pb = o;    o = bwd_align(o + bf * np * np);
  l.dq = o;    o = bwd_align(o + f * np * hd);
  l.dk = o;    o = bwd_align(o + f * np * hd);
  l.dv = o;    o = bwd_align(o + f * np * hd);
  l.stage = o; o = bwd_align(o + f * 256 * kBwdWarps);
  const size_t p1 = o;
  o = region;
  l.dqs = o;   o = bwd_align(o + bf * np * kTcBwdChunk);
  l.dxa = o;   o = bwd_align(o + f * np * c);
  l.wpart = o; o = bwd_align(o + f * kBwdWarps * 2 * c);
  l.bytes = p1 > o ? p1 : o;
  return l;
}

inline bool tc_bwd_eligible(int c, int nh) {
  return c % nh == 0 && c % 16 == 0 && (c / nh) % 16 == 0;
}

__device__ __forceinline__ void fold_attn_bwd_tc_body(const FoldBwdArgs& a,
                                                      unsigned char* sm) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

  const int C = a.C, nh = a.nh, hd = C / nh, C3 = 3 * C;
  const int N = a.wd * a.wh * a.ww, Np = (N + 15) / 16 * 16, mt_n = Np / 16, hsub = hd / 16;
  const TcBwdLayout L = tc_bwd_layout(N, C, nh);
  long long* tok = reinterpret_cast<long long*>(sm + L.tok);
  float* mu = reinterpret_cast<float*>(sm + L.mu);
  float* rs = reinterpret_cast<float*>(sm + L.rs);
  bf16* row = reinterpret_cast<bf16*>(sm + L.row);
  bf16* qs = reinterpret_cast<bf16*>(sm + L.q);
  bf16* ks = reinterpret_cast<bf16*>(sm + L.k);
  bf16* vs = reinterpret_cast<bf16*>(sm + L.v);
  bf16* das = reinterpret_cast<bf16*>(sm + L.da);
  float* P = reinterpret_cast<float*>(sm + L.P);
  float* dp = reinterpret_cast<float*>(sm + L.dp);
  bf16* pb = reinterpret_cast<bf16*>(sm + L.pb);  // round(P), then round(ds * scale)
  float* dqf = reinterpret_cast<float*>(sm + L.dq);  // doa accumulator, then dq
  float* dkf = reinterpret_cast<float*>(sm + L.dk);
  float* dvf = reinterpret_cast<float*>(sm + L.dv);
  bf16* dstage = reinterpret_cast<bf16*>(sm + L.P);  // dout[:, c0:c0+64], before the scores
  bf16* dqs = reinterpret_cast<bf16*>(sm + L.dqs);
  float* dxa = reinterpret_cast<float*>(sm + L.dxa);
  float* wpart = reinterpret_cast<float*>(sm + L.wpart);

  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const bf16* wqkv = static_cast<const bf16*>(a.qkv_w);
  const bf16* wproj = static_cast<const bf16*>(a.proj_w);
  bf16* dx = static_cast<bf16*>(a.dx);
  bf16* row_ws = static_cast<bf16*>(a.row_ws);
  bf16* o_ws = static_cast<bf16*>(a.o_ws);
  bf16* dqkv_ws = static_cast<bf16*>(a.dqkv_ws);

  const int nwd = a.D / a.wd, nwh = a.H / a.wh, nww = a.W / a.ww;
  const int nw = nwd * nwh * nww;
  const int blk = blockIdx.x, win = blk % nw, b = blk / nw;
  const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  float* stage = reinterpret_cast<float*>(sm + L.stage) + warp * 256;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < N; i += kBwdThreads) {
    const int ta = i / (a.wh * a.ww), tb = (i / a.ww) % a.wh, tc = i % a.ww;
    tok[i] = bwd_token(a, b, wi_d * a.wd + ta, wi_h * a.wh + tb, wi_w * a.ww + tc);
  }
  __syncthreads();
  for (int i = warp; i < Np; i += kBwdWarps) {
    bf16* ri = row + (size_t)i * C;
    if (i >= N) {
      for (int c = lane; c < C; c += kWarp) ri[c] = zero;
      continue;
    }
    const bf16* xi = x + tok[i] * C;
    float m = 0.f, r = 1.f;
    if (a.ln_s != nullptr) warp_ln_stats(xi, C, &m, &r);
    if (lane == 0) {
      mu[i] = m;
      rs[i] = r;
    }
    for (int c = lane; c < C; c += kWarp) {
      const bf16 v =
          a.ln_s != nullptr
              ? __float2bfloat16((to_f(xi[c]) - m) * r * a.ln_s[c] + a.ln_b[c])
              : xi[c];
      ri[c] = v;
      row_ws[tok[i] * C + c] = v;
    }
  }
  __syncthreads();

  const float* mask = a.mask != nullptr ? a.mask + (size_t)win * N * N : nullptr;
  for (int h = 0; h < nh; ++h) {
    // q, k, v of this head: Np x hd each, round(acc + bias)
    for (int t = warp; t < mt_n * 3 * hsub; t += kBwdWarps) {
      const int mt = t / (3 * hsub), nt = t % (3 * hsub);
      const int part = nt / hsub, sub = nt % hsub;
      const int col0 = part * C + h * hd + sub * 16;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, row + (size_t)mt * 16 * C + k0, C);
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
    for (int idx = tid; idx < Np * hd; idx += kBwdThreads) dqf[idx] = 0.f;
    // doa = round(dout . proj_w[head cols]^T), dout staged kTcBwdChunk columns at a time
    for (int c0 = 0; c0 < C; c0 += kTcBwdChunk) {
      const int cw = min(kTcBwdChunk, C - c0);
      for (int idx = tid; idx < Np * kTcBwdChunk; idx += kBwdThreads) {
        const int i = idx / kTcBwdChunk, cc = idx % kTcBwdChunk;
        dstage[idx] = (i < N && cc < cw) ? dout[tok[i] * C + c0 + cc] : zero;
      }
      __syncthreads();
      for (int t = warp; t < mt_n * hsub; t += kBwdWarps) {
        const int mt = t / hsub, sub = t % hsub;
        float* dst = dqf + (size_t)mt * 16 * hd + sub * 16;
        FragC acc;
        wmma::load_matrix_sync(acc, dst, hd, wmma::mem_row_major);
        for (int k0 = 0; k0 < cw; k0 += 16) {
          FragA fa;
          FragBt fb;  // B[c][d] = proj_w[h*hd + sub*16 + d][c0 + k0 + c]
          wmma::load_matrix_sync(fa, dstage + (size_t)mt * 16 * kTcBwdChunk + k0, kTcBwdChunk);
          wmma::load_matrix_sync(fb, wproj + (size_t)(h * hd + sub * 16) * C + c0 + k0, C);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dst, acc, hd, wmma::mem_row_major);
      }
      __syncthreads();
    }
    for (int idx = tid; idx < Np * hd; idx += kBwdThreads) das[idx] = __float2bfloat16(dqf[idx]);
    __syncthreads();

    // raw scores q . k^T (Np x Np, fp32)
    for (int t = warp; t < mt_n * mt_n; t += kBwdWarps) {
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
      wmma::store_matrix_sync(P + (size_t)mt * 16 * Np + nt * 16, acc, Np, wmma::mem_row_major);
    }
    __syncthreads();
    // * scale + bias + mask, fp32 softmax; P keeps fp32, pb the rounded copy;
    // padded rows and columns get probability 0
    const float* bias = a.bias + (size_t)h * N * N;
    for (int i = warp; i < Np; i += kBwdWarps) {
      float* prow = P + (size_t)i * Np;
      bf16* brow = pb + (size_t)i * Np;
      if (i >= N) {
        for (int j = lane; j < Np; j += kWarp) {
          prow[j] = 0.f;
          brow[j] = zero;
        }
        continue;
      }
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) {
        float s = prow[j] * a.scale + bias[i * N + j];
        if (mask != nullptr) s += mask[i * N + j];
        prow[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += kWarp) s += expf(prow[j] - m);
      s = warp_sum(s);
      for (int j = lane; j < Np; j += kWarp) {
        const float p = j < N ? expf(prow[j] - m) / s : 0.f;
        prow[j] = p;
        brow[j] = __float2bfloat16(p);
      }
    }
    __syncthreads();

    // o = round(P) . v (to the workspace), dv = round(P)^T . doa, dp = doa . v^T
    const int t_o = mt_n * hsub, t_dp = mt_n * mt_n;
    for (int t = warp; t < 2 * t_o + t_dp; t += kBwdWarps) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      if (t < t_o) {
        const int mt = t / hsub, sub = t % hsub;
        for (int k0 = 0; k0 < Np; k0 += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, pb + (size_t)mt * 16 * Np + k0, Np);
          wmma::load_matrix_sync(fb, vs + (size_t)k0 * hd + sub * 16, hd);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += kWarp) {
          const int i = mt * 16 + e / 16;
          if (i < N) o_ws[tok[i] * C + h * hd + sub * 16 + e % 16] = __float2bfloat16(stage[e]);
        }
        __syncwarp();
      } else if (t < 2 * t_o) {
        const int mt = (t - t_o) / hsub, sub = (t - t_o) % hsub;
        for (int k0 = 0; k0 < Np; k0 += 16) {
          FragAt fa;  // A[j][i] = round(P)[i][j]
          FragB fb;
          wmma::load_matrix_sync(fa, pb + (size_t)k0 * Np + mt * 16, Np);
          wmma::load_matrix_sync(fb, das + (size_t)k0 * hd + sub * 16, hd);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dvf + (size_t)mt * 16 * hd + sub * 16, acc, hd,
                                wmma::mem_row_major);
      } else {
        const int mt = (t - 2 * t_o) / mt_n, nt = (t - 2 * t_o) % mt_n;
        for (int k0 = 0; k0 < hd; k0 += 16) {
          FragA fa;
          FragBt fb;
          wmma::load_matrix_sync(fa, das + (size_t)mt * 16 * hd + k0, hd);
          wmma::load_matrix_sync(fb, vs + (size_t)nt * 16 * hd + k0, hd);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dp + (size_t)mt * 16 * Np + nt * 16, acc, Np,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // softmax backward (fp32); ds is this window's share of d(bias); pb
    // becomes round(ds * scale) (zero in padded rows, already, and columns)
    float* dbias = a.dbias_part + ((size_t)blk * nh + h) * N * N;
    for (int i = warp; i < N; i += kBwdWarps) {
      const float* prow = P + (size_t)i * Np;
      const float* drow = dp + (size_t)i * Np;
      bf16* brow = pb + (size_t)i * Np;
      float r = 0.f;
      for (int j = lane; j < N; j += kWarp) r += drow[j] * prow[j];
      r = warp_sum(r);
      for (int j = lane; j < Np; j += kWarp) {
        const float ds = j < N ? prow[j] * (drow[j] - r) : 0.f;
        if (j < N) dbias[i * N + j] = ds;
        brow[j] = __float2bfloat16(ds * a.scale);
      }
    }
    __syncthreads();

    // dq = dss . k, dk = dss^T . q
    for (int t = warp; t < 2 * t_o; t += kBwdWarps) {
      const bool is_dk = t >= t_o;
      const int mt = (t % t_o) / hsub, sub = (t % t_o) % hsub;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < Np; k0 += 16) {
        FragB fb;
        if (is_dk) {
          FragAt fa;  // A[j][i] = dss[i][j]
          wmma::load_matrix_sync(fa, pb + (size_t)k0 * Np + mt * 16, Np);
          wmma::load_matrix_sync(fb, qs + (size_t)k0 * hd + sub * 16, hd);
          wmma::mma_sync(acc, fa, fb, acc);
        } else {
          FragA fa;
          wmma::load_matrix_sync(fa, pb + (size_t)mt * 16 * Np + k0, Np);
          wmma::load_matrix_sync(fb, ks + (size_t)k0 * hd + sub * 16, hd);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
      wmma::store_matrix_sync((is_dk ? dkf : dqf) + (size_t)mt * 16 * hd + sub * 16, acc, hd,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // round(dqkv) to the workspace; unrounded column sums for dqkv_b
    for (int idx = tid; idx < N * 3 * hd; idx += kBwdThreads) {
      const int i = idx / (3 * hd), j = idx % (3 * hd), part = j / hd, d = j % hd;
      const float* src = part == 0 ? dqf : (part == 1 ? dkf : dvf);
      dqkv_ws[tok[i] * C3 + part * C + h * hd + d] = __float2bfloat16(src[i * hd + d]);
    }
    for (int j = tid; j < 3 * hd; j += kBwdThreads) {
      const int part = j / hd, d = j % hd;
      const float* src = part == 0 ? dqf : (part == 1 ? dkf : dvf);
      float s = 0.f;
      for (int i = 0; i < N; ++i) s += src[i * hd + d];
      a.dqkvb_part[(size_t)blk * C3 + part * C + h * hd + d] = s;
    }
    __syncthreads();
  }

  // phase 2: dxa = round(dqkv) . qkv_w^T over staged column slices of dqkv
  // (the block's own workspace rows, visible after the barrier above)
  for (int idx = tid; idx < Np * C; idx += kBwdThreads) dxa[idx] = 0.f;
  for (int idx = tid; idx < kBwdWarps * 2 * C; idx += kBwdThreads) wpart[idx] = 0.f;
  for (int j0 = 0; j0 < C3; j0 += kTcBwdChunk) {
    const int jw = min(kTcBwdChunk, C3 - j0);
    for (int idx = tid; idx < Np * kTcBwdChunk; idx += kBwdThreads) {
      const int i = idx / kTcBwdChunk, jj = idx % kTcBwdChunk;
      dqs[idx] = (i < N && jj < jw) ? dqkv_ws[tok[i] * C3 + j0 + jj] : zero;
    }
    __syncthreads();
    for (int t = warp; t < mt_n * (C / 16); t += kBwdWarps) {
      const int mt = t / (C / 16), nt = t % (C / 16);
      float* dst = dxa + (size_t)mt * 16 * C + nt * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, dst, C, wmma::mem_row_major);
      for (int k0 = 0; k0 < jw; k0 += 16) {
        FragA fa;
        FragBt fb;  // B[j][c] = qkv_w[nt*16 + c][j0 + k0 + j]
        wmma::load_matrix_sync(fa, dqs + (size_t)mt * 16 * kTcBwdChunk + k0, kTcBwdChunk);
        wmma::load_matrix_sync(fb, wqkv + (size_t)nt * 16 * C3 + j0 + k0, C3);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(dst, acc, C, wmma::mem_row_major);
    }
    __syncthreads();
  }

  if (a.ln_s == nullptr) {  // no LN: dx = round(dxa) (+ dout with the residual)
    for (int idx = tid; idx < N * C; idx += kBwdThreads) {
      const long long o = tok[idx / C] * C + idx % C;
      dx[o] = __float2bfloat16(dxa[idx] + (a.residual ? to_f(dout[o]) : 0.f));
    }
    return;
  }
  // LN vjp + residual, one warp per token; per-warp dln partials
  for (int i = warp; i < N; i += kBwdWarps) {
    const bf16* xi = x + tok[i] * C;
    const float m = mu[i], r = rs[i];
    const float* g = dxa + (size_t)i * C;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float dxhat = g[c] * a.ln_s[c];
      s1 += dxhat;
      s2 += dxhat * (to_f(xi[c]) - m) * r;
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    float* wp = wpart + warp * 2 * C;
    for (int c = lane; c < C; c += kWarp) {
      const float xh = (to_f(xi[c]) - m) * r;
      wp[c] += g[c] * xh;
      wp[C + c] += g[c];
      const float dxhat = g[c] * a.ln_s[c];
      dx[tok[i] * C + c] = __float2bfloat16(
          r * (dxhat - s1 - xh * s2) + (a.residual ? to_f(dout[tok[i] * C + c]) : 0.f));
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * C; c += kBwdThreads) {
    float s = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) s += wpart[w * 2 * C + c];
    a.dln_part[(size_t)blk * 2 * C + c] = s;
  }
}

__global__ void __launch_bounds__(kBwdThreads) fold_attn_bwd_kernel(FoldBwdArgs a) {
  extern __shared__ __align__(128) unsigned char sm[];
  fold_attn_bwd_body(a, reinterpret_cast<float*>(sm));
}

__global__ void __launch_bounds__(kBwdThreads) fold_attn_bwd_tc_kernel(FoldBwdArgs a) {
  extern __shared__ __align__(128) unsigned char sm[];
  fold_attn_bwd_tc_body(a, sm);
}

// ---------------------------------------------------------------------------
// The whole-Swin-block backward (see the header): front half forward, MLP
// tail backward, attention backward, per window.
// ---------------------------------------------------------------------------
static_assert(kBwdThreads == kFoldThreads, "the block backward runs the forward's body");
constexpr int kTailGroupsMax = kBwdThreads / kMbThreads;

struct BlockTailArgs {
  const void* dout;  // (B, D, H, W, C) the block's upstream gradient
  const float* ln2_s;
  const float* ln2_b;
  const void* w1;  // (C, Ch) compute dtype
  const float* b1;
  const void* w2;  // (Ch, C) compute dtype
  void* y1_ws;   // (T, C) compute dtype: step 1's output, step 2's input
  void* dy1_ws;  // (T, C) compute dtype: step 2's output, step 3's upstream
  float* z_ws;   // (T, C)
  float* g_ws;   // (T, Ch)
  float* dh_ws;  // (T, Ch)
  float* dln2_part;  // (blocks * tiles, 2C)
  int Ch, groups;
};

// Thread groups of step 2 that fit beside the window's token list.
__host__ __device__ inline int tail_groups(int n, int c) {
  const size_t room = (size_t)kMaxSmemBytes - bwd_align(sizeof(long long) * n);
  const size_t g = room / mlp_bwd_smem_bytes(c);
  return g < 1 ? 1 : (g > (size_t)kTailGroupsMax ? kTailGroupsMax : (int)g);
}

inline size_t fold_block_bwd_smem_bytes(int n, int c, int nh, int is_bf16) {
  const size_t fwd = is_bf16 ? tc_layout(n, c, nh).bytes : fold_smem_bytes(n, c, nh);
  const size_t bwd = is_bf16 ? tc_bwd_layout(n, c, nh).bytes : fold_bwd_smem_bytes(n, c, nh);
  const size_t tail =
      bwd_align(sizeof(long long) * n) + tail_groups(n, c) * mlp_bwd_smem_bytes(c);
  const size_t m = fwd > bwd ? fwd : bwd;
  return m > tail ? m : tail;
}

template <typename T, bool kTc>
__global__ void __launch_bounds__(kBwdThreads)
    fold_block_bwd_kernel(FoldArgs f, BlockTailArgs m, FoldBwdArgs a) {
  extern __shared__ __align__(128) unsigned char sm[];
  // 1. y1 into the workspace (f.out)
  if (kTc)
    fold_attn_tc_body<false, false>(f, sm);
  else
    fold_attn_body<false, false>(f, reinterpret_cast<float*>(sm));
  __syncthreads();

  // 2. the MLP tail's backward over the window's tiles of kMbTok tokens
  const int C = a.C, N = a.wd * a.wh * a.ww;
  const int nwd = a.D / a.wd, nwh = a.H / a.wh, nww = a.W / a.ww;
  const int nw = nwd * nwh * nww;
  const int blk = blockIdx.x, win = blk % nw, b = blk / nw;
  const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;
  const int tid = threadIdx.x, grp = tid / kMbThreads;
  long long* tok = reinterpret_cast<long long*>(sm);
  for (int i = tid; i < N; i += kBwdThreads) {
    const int ta = i / (a.wh * a.ww), tb = (i / a.ww) % a.wh, tc = i % a.ww;
    tok[i] = bwd_token(a, b, wi_d * a.wd + ta, wi_h * a.wh + tb, wi_w * a.ww + tc);
  }
  __syncthreads();
  if (grp < m.groups) {
    float* gs = reinterpret_cast<float*>(sm + bwd_align(sizeof(long long) * N) +
                                         (size_t)grp * mlp_bwd_smem_bytes(C));
    const int ntiles = (N + kMbTok - 1) / kMbTok;
    const GroupBarrier bar{grp + 1};
    for (int tile = grp; tile < ntiles; tile += m.groups) {
      mlp_bwd_tile<T>(gs, static_cast<const T*>(m.y1_ws), static_cast<const T*>(m.dout),
                      m.ln2_s, m.ln2_b, static_cast<const T*>(m.w1), m.b1,
                      static_cast<const T*>(m.w2), static_cast<T*>(m.dy1_ws), m.z_ws, m.g_ws,
                      m.dh_ws, m.dln2_part + ((size_t)blk * ntiles + tile) * 2 * C,
                      tok + tile * kMbTok, 0, min(kMbTok, N - tile * kMbTok), C, m.Ch,
                      tid % kMbThreads, bar);
      bar();  // the next tile overwrites what the last sums read
    }
  }
  __syncthreads();

  // 3. the attention backward with dy1 (a.dout) as upstream
  if (kTc)
    fold_attn_bwd_tc_body(a, sm);
  else
    fold_attn_bwd_body(a, reinterpret_cast<float*>(sm));
}

struct FoldBwdLayout {
  size_t row, o, dqkv, dqkvb, dln, dbias, atb, bytes;
};

inline FoldBwdLayout fold_bwd_layout(int B, int D, int H, int W, int C, int nh, int n,
                                     int nwin, int is_bf16) {
  const size_t T = (size_t)B * D * H * W, es = is_bf16 ? 2 : 4;
  const size_t blocks = (size_t)B * nwin;
  FoldBwdLayout l;
  size_t o = 0;
  l.row = o;   o = align256(o + T * C * es);
  l.o = o;     o = align256(o + T * C * es);
  l.dqkv = o;  o = align256(o + T * 3 * C * es);
  l.dqkvb = o; o = align256(o + sizeof(float) * blocks * 3 * C);
  l.dln = o;   o = align256(o + sizeof(float) * blocks * 2 * C);
  l.dbias = o; o = align256(o + sizeof(float) * blocks * nh * n * n);
  l.atb = o;   o = align256(o + sizeof(float) * atb_partial_floats((int)T, C, 3 * C));
  l.bytes = o;
  return l;
}

// Workspace of the whole-block backward: kernel 6's (with room for kernel
// 5's larger A^T.B partials), then y1, dy1 and kernel 5's operands.
struct FoldBlockBwdLayout {
  FoldBwdLayout attn;
  size_t y1, dy1, z, g, dh, dln2, bytes;
};

inline FoldBlockBwdLayout fold_block_bwd_layout(int B, int D, int H, int W, int C, int nh,
                                                int Ch, int n, int nwin, int is_bf16) {
  const size_t T = (size_t)B * D * H * W, es = is_bf16 ? 2 : 4;
  const size_t tiles = (size_t)B * nwin * ((n + kMbTok - 1) / kMbTok);
  FoldBlockBwdLayout l;
  l.attn = fold_bwd_layout(B, D, H, W, C, nh, n, nwin, is_bf16);
  size_t o = align256(l.attn.atb + sizeof(float) * atb_partial_floats((int)T, C, Ch));
  if (o < l.attn.bytes) o = l.attn.bytes;
  l.y1 = o;   o = align256(o + T * C * es);
  l.dy1 = o;  o = align256(o + T * C * es);
  l.z = o;    o = align256(o + sizeof(float) * T * C);
  l.g = o;    o = align256(o + sizeof(float) * T * Ch);
  l.dh = o;   o = align256(o + sizeof(float) * T * Ch);
  l.dln2 = o; o = align256(o + sizeof(float) * tiles * 2 * C);
  l.bytes = o;
  return l;
}

// Kernel 6's second pass: the cross-window sums of the attention backward.
inline cudaError_t fold_bwd_second_pass(const FoldBwdArgs& a, const FoldBwdLayout& l, char* ws,
                                        int blocks, int is_bf16, float* dln_s, float* dln_b,
                                        float* dqkv_w, float* dqkv_b, float* dproj_w,
                                        float* dproj_b, float* dbias, cudaStream_t s) {
  const int C = a.C, T = a.B * a.D * a.H * a.W, n = a.wd * a.wh * a.ww;
  float* part = reinterpret_cast<float*>(ws + l.atb);
  cudaError_t err;
  if ((err = launch_atb(a.row_ws, is_bf16, a.dqkv_ws, is_bf16, T, C, 3 * C, part, dqkv_w, s)))
    return err;
  if ((err = launch_atb(a.o_ws, is_bf16, a.dout, is_bf16, T, C, C, part, dproj_w, s))) return err;
  if ((err = launch_atb(nullptr, 0, a.dout, is_bf16, T, 1, C, part, dproj_b, s))) return err;
  if ((err = launch_sum_rows(a.dqkvb_part, dqkv_b, blocks, 3 * C, 3 * C, s))) return err;
  if (a.ln_s != nullptr) {
    if ((err = launch_sum_rows(a.dln_part, dln_s, blocks, C, 2 * C, s))) return err;
    if ((err = launch_sum_rows(a.dln_part + C, dln_b, blocks, C, 2 * C, s))) return err;
  }
  return launch_sum_rows(a.dbias_part, dbias, blocks, (long long)a.nh * n * n,
                         (long long)a.nh * n * n, s);
}

}  // namespace vadcl

extern "C" {

// Shared memory one block of the dtype's kernel needs; the wrapper refuses
// geometries above the card's limit before launching.
long long vadcl_fold_attn_bwd_smem_bytes(int n, int c, int nh, int is_bf16) {
  return (long long)(is_bf16 ? vadcl::tc_bwd_layout(n, c, nh).bytes
                             : vadcl::fold_bwd_smem_bytes(n, c, nh));
}

long long vadcl_fold_attn_bwd_workspace_bytes(int B, int D, int H, int W, int C, int nh,
                                              int wd, int wh, int ww, int is_bf16) {
  const int nwin = (D / wd) * (H / wh) * (W / ww);
  return (long long)vadcl::fold_bwd_layout(B, D, H, W, C, nh, wd * wh * ww, nwin, is_bf16)
      .bytes;
}

int vadcl_fold_attn_bwd(const void* x, const void* dout, const float* ln_s,
                        const float* ln_b, const void* qkv_w, const float* qkv_b,
                        const void* proj_w, const float* bias, const float* mask, void* dx,
                        float* dln_s, float* dln_b, float* dqkv_w, float* dqkv_b,
                        float* dproj_w, float* dproj_b, float* dbias, void* workspace,
                        int B, int D, int H, int W, int C, int nh, int wd, int wh, int ww,
                        int sd, int sh, int sw, float scale, int residual, int is_bf16,
                        void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = wd * wh * ww;
  if (C % nh != 0 || D % wd != 0 || H % wh != 0 || W % ww != 0) return cudaErrorInvalidValue;
  // the two modes the reference has: LN1 + residual, or neither
  if ((ln_s != nullptr) != (residual != 0)) return cudaErrorInvalidValue;
  if (is_bf16 && !tc_bwd_eligible(C, nh)) return cudaErrorInvalidValue;
  const size_t smem = is_bf16 ? tc_bwd_layout(n, C, nh).bytes : fold_bwd_smem_bytes(n, C, nh);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const int nwin = (D / wd) * (H / wh) * (W / ww);
  const FoldBwdLayout l = fold_bwd_layout(B, D, H, W, C, nh, n, nwin, is_bf16);
  char* ws = static_cast<char*>(workspace);
  FoldBwdArgs a{x, dout, ln_s, ln_b, qkv_w, qkv_b, proj_w, bias, mask, dx,
                ws + l.row, ws + l.o, ws + l.dqkv,
                reinterpret_cast<float*>(ws + l.dqkvb), reinterpret_cast<float*>(ws + l.dln),
                reinterpret_cast<float*>(ws + l.dbias),
                B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, residual};
  const int blocks = B * nwin;
  cudaError_t err;
  if (is_bf16) {
    err = allow_smem(fold_attn_bwd_tc_kernel, smem);
    if (err != cudaSuccess) return err;
    fold_attn_bwd_tc_kernel<<<blocks, kBwdThreads, smem, s>>>(a);
  } else {
    err = allow_smem(fold_attn_bwd_kernel, smem);
    if (err != cudaSuccess) return err;
    fold_attn_bwd_kernel<<<blocks, kBwdThreads, smem, s>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return fold_bwd_second_pass(a, l, ws, blocks, is_bf16, dln_s, dln_b, dqkv_w, dqkv_b, dproj_w,
                              dproj_b, dbias, s);
}

// Shared memory and workspace of the whole-block backward.
long long vadcl_fold_block_bwd_smem_bytes(int n, int c, int nh, int is_bf16) {
  return (long long)vadcl::fold_block_bwd_smem_bytes(n, c, nh, is_bf16);
}

long long vadcl_fold_block_bwd_workspace_bytes(int B, int D, int H, int W, int C, int nh,
                                               int Ch, int wd, int wh, int ww, int is_bf16) {
  const int nwin = (D / wd) * (H / wh) * (W / ww);
  return (long long)vadcl::fold_block_bwd_layout(B, D, H, W, C, nh, Ch, wd * wh * ww, nwin,
                                                 is_bf16)
      .bytes;
}

// The backward of vadcl_fold_block: 14 gradients.
int vadcl_fold_block_bwd(const void* x, const void* dout, const float* ln_s, const float* ln_b,
                         const void* qkv_w, const float* qkv_b, const void* proj_w,
                         const float* proj_b, const float* bias, const float* mask,
                         const float* ln2_s, const float* ln2_b, const void* w1,
                         const float* b1, const void* w2, void* dx, float* dln_s,
                         float* dln_b, float* dqkv_w, float* dqkv_b, float* dproj_w,
                         float* dproj_b, float* dbias, float* dln2_s, float* dln2_b,
                         float* dw1, float* db1, float* dw2, float* db2, void* workspace,
                         int B, int D, int H, int W, int C, int nh, int Ch, int wd, int wh,
                         int ww, int sd, int sh, int sw, float scale, int is_bf16,
                         void* stream) {
  using namespace vadcl;
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = wd * wh * ww;
  if (C % nh != 0 || D % wd != 0 || H % wh != 0 || W % ww != 0) return cudaErrorInvalidValue;
  if (ln_s == nullptr || ln_b == nullptr || !mlp_bwd_eligible(C, Ch))
    return cudaErrorInvalidValue;
  if (is_bf16 && !tc_bwd_eligible(C, nh)) return cudaErrorInvalidValue;
  const size_t smem = fold_block_bwd_smem_bytes(n, C, nh, is_bf16);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const int nwin = (D / wd) * (H / wh) * (W / ww);
  const FoldBlockBwdLayout l = fold_block_bwd_layout(B, D, H, W, C, nh, Ch, n, nwin, is_bf16);
  char* ws = static_cast<char*>(workspace);
  FoldArgs f{x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, ws + l.y1,
             B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, 1};
  BlockTailArgs m{dout, ln2_s, ln2_b, w1, b1, w2, ws + l.y1, ws + l.dy1,
                  reinterpret_cast<float*>(ws + l.z), reinterpret_cast<float*>(ws + l.g),
                  reinterpret_cast<float*>(ws + l.dh), reinterpret_cast<float*>(ws + l.dln2),
                  Ch, tail_groups(n, C)};
  FoldBwdArgs a{x, ws + l.dy1, ln_s, ln_b, qkv_w, qkv_b, proj_w, bias, mask, dx,
                ws + l.attn.row, ws + l.attn.o, ws + l.attn.dqkv,
                reinterpret_cast<float*>(ws + l.attn.dqkvb),
                reinterpret_cast<float*>(ws + l.attn.dln),
                reinterpret_cast<float*>(ws + l.attn.dbias),
                B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, 1};
  const int blocks = B * nwin;
  cudaError_t err;
  if (is_bf16) {
    if ((err = allow_smem(fold_block_bwd_kernel<bf16, true>, smem)) != cudaSuccess) return err;
    fold_block_bwd_kernel<bf16, true><<<blocks, kBwdThreads, smem, s>>>(f, m, a);
  } else {
    if ((err = allow_smem(fold_block_bwd_kernel<float, false>, smem)) != cudaSuccess) return err;
    fold_block_bwd_kernel<float, false><<<blocks, kBwdThreads, smem, s>>>(f, m, a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = fold_bwd_second_pass(a, l.attn, ws, blocks, is_bf16, dln_s, dln_b, dqkv_w, dqkv_b,
                                  dproj_w, dproj_b, dbias, s)))
    return err;
  // kernel 5's second pass: the MLP tail's sums over tokens
  const int T = B * D * H * W, tiles = blocks * ((n + kMbTok - 1) / kMbTok);
  float* part = reinterpret_cast<float*>(ws + l.attn.atb);
  if ((err = launch_atb(m.g_ws, 0, dout, is_bf16, T, Ch, C, part, dw2, s))) return err;
  if ((err = launch_atb(m.z_ws, 0, m.dh_ws, 0, T, C, Ch, part, dw1, s))) return err;
  if ((err = launch_atb(nullptr, 0, m.dh_ws, 0, T, 1, Ch, part, db1, s))) return err;
  if ((err = launch_atb(nullptr, 0, dout, is_bf16, T, 1, C, part, db2, s))) return err;
  if ((err = launch_sum_rows(m.dln2_part, dln2_s, tiles, C, 2 * C, s))) return err;
  return launch_sum_rows(m.dln2_part + C, dln2_b, tiles, C, 2 * C, s);
}

}  // extern "C"
