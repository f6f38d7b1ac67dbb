// Backward of Swin window attention over pre-partitioned windows (kernel 8):
//   out = proj(attention(x_windows))  ->  dx, dqkv_w, dqkv_b, dproj_w,
//   dproj_b, d(bias)
//
// Replaces vadcl_tpu/ops/pallas_attn_bwd.py:_bwd_kernel (entry _bwd_call,
// reached through the custom VJP of fused_window_attention_trainable).  The
// forward saved only its inputs; this kernel recomputes it.
//
// Pass 1, window_attn_bwd_kernel: one block per window of the (Bn, N, C)
// tensors; window i takes mask[i % nW].  The block recomputes per head
// q/k/v = round(x . W_qkv + b), the fp32 softmax P and p = round(P), and the
// per-head output o = round(p . v), then runs the backward with
// _bwd_kernel's order and cast boundaries:
//   do = round(dout . proj_w^T);  dv = p^T . do;  dp = do . v^T;
//   ds = P * (dp - rowsum(dp * P));  dss = round(ds * scale);
//   dq = dss . k;  dk = dss^T . q;  dx = round(round(dqkv) . qkv_w^T).
// Two kernels: bf16 at C and head_dim multiples of 16 on WMMA 16x16x16 tiles
// with fp32 accumulation, the window padded to Np = ceil(N/16)*16 rows
// inside the block (padded rows and columns carry zeros and are dropped);
// fp32, and bf16 at every other width, window_attn_bwd_kernel<T> on CUDA
// cores for any width, fp32 arithmetic on T loads and stores, rounding to T
// where the bf16 contract rounds (qkv, do, p in p.v and p^T.do, o, ds *
// scale, the stored dqkv, dx; dqkv_b sums the unrounded dqkv).
//
// The TPU grid runs in order and adds dqkv_w, dqkv_b, dproj_w, dproj_b and
// d(bias) into constant-index output blocks.  Blocks here run in any order,
// so pass 1 writes o (tokens x C) and round(dqkv) (tokens x 3C) in the
// compute dtype and, per window, the column sums of dqkv (3C) and ds per head
// (nH x N x N); pass 2 (reduce.cu) forms dqkv_w = x^T . dqkv,
// dproj_w = o^T . dout, dproj_b = colsum(dout) and sums the per-window
// partials in a fixed order with fp32 accumulation: no float atomics.
//
// What bounds it: as kernel 6, one block per SM, nine block-wide barriers
// per head and the fp32 softmax backward between the products; the d(bias)
// partials are the largest workspace (nH*N*N floats per window).  A block
// holds whole (N, N) tiles, so it takes only windows whose plan fits 227 KB;
// the others (N = 196 and 392 of 8-frame reconstruction clips, N = 147 in
// bf16) run the row-tiled body of window_attn_bwd_rows.cu, which
// ops/window_attn.py:window_body picks.
//
// Where kernel 6's tensor-core body takes the geometry (ops/fold_attn.py:
// fold_bwd_body says "mma"), kernel 8 runs that body in its no-LN,
// no-residual mode on the windows viewed as one row of windows per batch
// (ops/window_attn.py:window_tile_core, window_grid).  This file keeps fp32,
// the other bf16 widths and the forced whole-tile body
// (window_attention_fused_bwd_tiles).  Softmax quotients go through fa_div
// (common.cuh).
#include <mma.h>

#include "reduce.cuh"

namespace vadcl {

constexpr int kWbThreads = 512;
constexpr int kWbWarps = kWbThreads / kWarp;

struct WinBwdArgs {
  const void* x;      // (Bn, N, C) compute dtype
  const void* dout;   // (Bn, N, C) compute dtype
  const void* qkv_w;  // (C, 3C) compute dtype
  const float* qkv_b;  // (3C,)
  const void* proj_w;  // (C, C) compute dtype
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  void* dx;           // (Bn, N, C)
  void* o_ws;         // (T, C) compute dtype
  void* dqkv_ws;      // (T, 3C) compute dtype
  float* dqkvb_part;  // (Bn, 3C)
  float* dbias_part;  // (Bn, nH, N, N)
  int Bn, N, C, nh, nW;
  float scale;
};

inline size_t win_bwd_smem_bytes(int n, int c, int nh) {
  const size_t hdp = c / nh + 1, N = n, C = c;
  const size_t p1 = N * C + 5 * N * hdp + 2 * N * N;
  const size_t p2 = N * C + 33 * C + 33 * N;
  return sizeof(float) * (p1 > p2 ? p1 : p2);
}

template <typename T>
__global__ void __launch_bounds__(kWbThreads) window_attn_bwd_kernel(WinBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, nh = a.nh, hd = C / nh, hdp = hd + 1, C3 = 3 * C, N = a.N;
  // phase 1
  float* row = smem;            // N*C   the window's input
  float* qs = row + N * C;      // N*hdp q
  float* ks = qs + N * hdp;     // N*hdp k
  float* vs = ks + N * hdp;     // N*hdp v, then dq
  float* das = vs + N * hdp;    // N*hdp round(dout . proj_w^T) head slice, then dk
  float* dvs = das + N * hdp;   // N*hdp dv
  float* pb = dvs + N * hdp;    // N*N   scores, then fp32 probabilities
  float* sb = pb + N * N;       // N*N   dp, then ds * scale
  // phase 2
  float* dxa = smem;            // N*C
  float* wsm = dxa + N * C;     // C*33  qkv_w[:, j0:j0+32]
  float* dqs = wsm + C * 33;    // N*33  dqkv[:, j0:j0+32]

  const int blk = blockIdx.x;
  const size_t t0 = (size_t)blk * N;  // first token of this window
  const T* x = static_cast<const T*>(a.x) + t0 * C;
  const T* dout = static_cast<const T*>(a.dout) + t0 * C;
  const T* wqkv = static_cast<const T*>(a.qkv_w);
  const T* wproj = static_cast<const T*>(a.proj_w);
  T* dx = static_cast<T*>(a.dx) + t0 * C;
  T* o_ws = static_cast<T*>(a.o_ws) + t0 * C;
  T* dqkv_ws = static_cast<T*>(a.dqkv_ws) + t0 * C3;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;

  for (int idx = tid; idx < N * C; idx += kWbThreads) row[idx] = to_f(x[idx]);
  __syncthreads();

  const float* mask = a.mask != nullptr ? a.mask + (size_t)(blk % a.nW) * N * N : nullptr;
  for (int h = 0; h < nh; ++h) {
    // q, k, v of this head and the head slice of dout . proj_w^T
    for (int idx = tid; idx < N * 3 * hd; idx += kWbThreads) {
      const int i = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, d = j % hd, col = part * C + h * hd + d;
      const float* ri = row + i * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += ri[c] * to_f(wqkv[(size_t)c * C3 + col]);
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
      dst[i * hdp + d] = round_to<T>(acc + a.qkv_b[col]);
    }
    for (int idx = tid; idx < N * hd; idx += kWbThreads) {
      const int i = idx / hd, d = idx % hd;
      const T* di = dout + (size_t)i * C;
      const T* wp = wproj + (size_t)(h * hd + d) * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += to_f(di[c]) * to_f(wp[c]);
      das[i * hdp + d] = round_to<T>(acc);
    }
    __syncthreads();

    const float* bias = a.bias + (size_t)h * N * N;
    for (int idx = tid; idx < N * N; idx += kWbThreads) {
      const int i = idx / N, j = idx % N;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qs[i * hdp + d] * ks[j * hdp + d];
      s = s * a.scale + bias[idx];
      if (mask != nullptr) s += mask[idx];
      pb[idx] = s;
    }
    __syncthreads();
    for (int i = warp; i < N; i += kWbWarps) {
      float* prow = pb + i * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += kWarp) m = fmaxf(m, prow[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += kWarp) s += expf(prow[j] - m);
      s = warp_sum(s);
      const float inv = 1.f / s;
      for (int j = lane; j < N; j += kWarp) prow[j] = fa_div(expf(prow[j] - m), s, inv);
    }
    __syncthreads();

    // o = p . v (to the workspace), dv = p^T . do, dp = do . v^T, p = round(P)
    for (int idx = tid; idx < N * hd; idx += kWbThreads) {
      const int i = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += round_to<T>(pb[i * N + j]) * vs[j * hdp + d];
      o_ws[(size_t)i * C + h * hd + d] = from_f<T>(acc);
    }
    for (int idx = tid; idx < N * hd; idx += kWbThreads) {
      const int j = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc += round_to<T>(pb[i * N + j]) * das[i * hdp + d];
      dvs[j * hdp + d] = acc;
    }
    for (int idx = tid; idx < N * N; idx += kWbThreads) {
      const int i = idx / N, j = idx % N;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc += das[i * hdp + d] * vs[j * hdp + d];
      sb[idx] = acc;
    }
    __syncthreads();

    // softmax backward (fp32); ds is this window's share of d(bias)
    float* dbias = a.dbias_part + ((size_t)blk * nh + h) * N * N;
    for (int i = warp; i < N; i += kWbWarps) {
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
    for (int idx = tid; idx < N * hd; idx += kWbThreads) {
      const int i = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += sb[i * N + j] * ks[j * hdp + d];
      vs[i * hdp + d] = acc;
    }
    for (int idx = tid; idx < N * hd; idx += kWbThreads) {
      const int j = idx / hd, d = idx % hd;
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc += sb[i * N + j] * qs[i * hdp + d];
      das[j * hdp + d] = acc;
    }
    __syncthreads();

    // dqkv to the workspace; its column sums for dqkv_b
    for (int idx = tid; idx < N * 3 * hd; idx += kWbThreads) {
      const int i = idx / (3 * hd), j = idx % (3 * hd), part = j / hd, d = j % hd;
      const float* src = part == 0 ? vs : (part == 1 ? das : dvs);
      dqkv_ws[(size_t)i * C3 + part * C + h * hd + d] = from_f<T>(src[i * hdp + d]);
    }
    for (int j = tid; j < 3 * hd; j += kWbThreads) {
      const int part = j / hd, d = j % hd;
      const float* src = part == 0 ? vs : (part == 1 ? das : dvs);
      float s = 0.f;
      for (int i = 0; i < N; ++i) s += src[i * hdp + d];
      a.dqkvb_part[(size_t)blk * C3 + part * C + h * hd + d] = s;
    }
    __syncthreads();
  }

  // phase 2: dx = dqkv . qkv_w^T, over 32-column slices of dqkv (the block's
  // own workspace rows, visible after the barrier above)
  for (int idx = tid; idx < N * C; idx += kWbThreads) dxa[idx] = 0.f;
  for (int j0 = 0; j0 < C3; j0 += 32) {
    const int jw = min(32, C3 - j0);
    for (int idx = tid; idx < C * 32; idx += kWbThreads) {
      const int c = idx / 32, jj = idx % 32;
      wsm[c * 33 + jj] = jj < jw ? to_f(wqkv[(size_t)c * C3 + j0 + jj]) : 0.f;
    }
    for (int idx = tid; idx < N * 32; idx += kWbThreads) {
      const int i = idx / 32, jj = idx % 32;
      dqs[i * 33 + jj] = jj < jw ? to_f(dqkv_ws[(size_t)i * C3 + j0 + jj]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < N * C; idx += kWbThreads) {
      const int i = idx / C, c = idx % C;
      const float* dq = dqs + i * 33;
      const float* w = wsm + c * 33;
      float acc = dxa[idx];
      for (int jj = 0; jj < 32; ++jj) acc += dq[jj] * w[jj];
      dxa[idx] = acc;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < N * C; idx += kWbThreads) dx[idx] = from_f<T>(dxa[idx]);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the math above with bf16 cast boundaries, every
// product as WMMA 16x16x16 tiles with fp32 accumulation.  Sums that run over
// a staged slice of columns (dout . proj_w^T, dqkv . qkv_w^T) accumulate in
// fp32 shared memory across the slices.
// ---------------------------------------------------------------------------
constexpr int kWbChunk = 64;  // columns of dout / dqkv staged at a time

__host__ __device__ inline size_t wb_align(size_t v) { return (v + 127) / 128 * 128; }

struct WinBwdTcLayout {
  // phase 1; P, dp and pb are contiguous (dout's column slices are staged
  // there before the scores exist)
  size_t row, q, k, v, da, P, dp, pb, dq, dk, dv, stage;
  size_t dqs, dxa;  // phase 2, from the start
  size_t bytes;
};

__host__ __device__ inline WinBwdTcLayout win_bwd_tc_layout(int n, int c, int nh) {
  const size_t np = (n + 15) / 16 * 16, hd = c / nh, bf = 2, f = 4;
  WinBwdTcLayout l;
  size_t o = 0;
  l.row = o;   o = wb_align(o + bf * np * c);
  l.q = o;     o = wb_align(o + bf * np * hd);
  l.k = o;     o = wb_align(o + bf * np * hd);
  l.v = o;     o = wb_align(o + bf * np * hd);
  l.da = o;    o = wb_align(o + bf * np * hd);
  l.P = o;     o = wb_align(o + f * np * np);
  l.dp = o;    o = wb_align(o + f * np * np);
  l.pb = o;    o = wb_align(o + bf * np * np);
  l.dq = o;    o = wb_align(o + f * np * hd);
  l.dk = o;    o = wb_align(o + f * np * hd);
  l.dv = o;    o = wb_align(o + f * np * hd);
  l.stage = o; o = wb_align(o + f * 256 * kWbWarps);
  const size_t p1 = o;
  o = 0;
  l.dqs = o;   o = wb_align(o + bf * np * kWbChunk);
  l.dxa = o;   o = wb_align(o + f * np * c);
  l.bytes = p1 > o ? p1 : o;
  return l;
}

inline bool win_bwd_tc_eligible(int c, int nh) {
  return c % nh == 0 && c % 16 == 0 && (c / nh) % 16 == 0;
}

__global__ void __launch_bounds__(kWbThreads) window_attn_bwd_tc_kernel(WinBwdArgs a) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

  extern __shared__ __align__(128) unsigned char sm[];
  const int C = a.C, nh = a.nh, hd = C / nh, C3 = 3 * C, N = a.N;
  const int Np = (N + 15) / 16 * 16, mt_n = Np / 16, hsub = hd / 16;
  const WinBwdTcLayout L = win_bwd_tc_layout(N, C, nh);
  bf16* row = reinterpret_cast<bf16*>(sm + L.row);
  bf16* qs = reinterpret_cast<bf16*>(sm + L.q);
  bf16* ks = reinterpret_cast<bf16*>(sm + L.k);
  bf16* vs = reinterpret_cast<bf16*>(sm + L.v);
  bf16* das = reinterpret_cast<bf16*>(sm + L.da);
  float* P = reinterpret_cast<float*>(sm + L.P);
  float* dp = reinterpret_cast<float*>(sm + L.dp);
  bf16* pb = reinterpret_cast<bf16*>(sm + L.pb);  // round(P), then round(ds * scale)
  float* dqf = reinterpret_cast<float*>(sm + L.dq);  // do accumulator, then dq
  float* dkf = reinterpret_cast<float*>(sm + L.dk);
  float* dvf = reinterpret_cast<float*>(sm + L.dv);
  bf16* dstage = reinterpret_cast<bf16*>(sm + L.P);  // dout[:, c0:c0+64], before the scores
  bf16* dqs = reinterpret_cast<bf16*>(sm + L.dqs);
  float* dxa = reinterpret_cast<float*>(sm + L.dxa);

  const int blk = blockIdx.x;
  const size_t t0 = (size_t)blk * N;
  const bf16* x = static_cast<const bf16*>(a.x) + t0 * C;
  const bf16* dout = static_cast<const bf16*>(a.dout) + t0 * C;
  const bf16* wqkv = static_cast<const bf16*>(a.qkv_w);
  const bf16* wproj = static_cast<const bf16*>(a.proj_w);
  bf16* dx = static_cast<bf16*>(a.dx) + t0 * C;
  bf16* o_ws = static_cast<bf16*>(a.o_ws) + t0 * C;
  bf16* dqkv_ws = static_cast<bf16*>(a.dqkv_ws) + t0 * C3;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  float* stage = reinterpret_cast<float*>(sm + L.stage) + warp * 256;
  const bf16 zero = __float2bfloat16(0.f);

  for (int idx = tid; idx < Np * C; idx += kWbThreads) row[idx] = idx < N * C ? x[idx] : zero;
  __syncthreads();

  const float* mask = a.mask != nullptr ? a.mask + (size_t)(blk % a.nW) * N * N : nullptr;
  for (int h = 0; h < nh; ++h) {
    // q, k, v of this head: Np x hd each, round(acc + bias)
    for (int t = warp; t < mt_n * 3 * hsub; t += kWbWarps) {
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
    for (int idx = tid; idx < Np * hd; idx += kWbThreads) dqf[idx] = 0.f;
    // do = round(dout . proj_w[head cols]^T), dout staged kWbChunk columns at a time
    for (int c0 = 0; c0 < C; c0 += kWbChunk) {
      const int cw = min(kWbChunk, C - c0);
      for (int idx = tid; idx < Np * kWbChunk; idx += kWbThreads) {
        const int i = idx / kWbChunk, cc = idx % kWbChunk;
        dstage[idx] = (i < N && cc < cw) ? dout[(size_t)i * C + c0 + cc] : zero;
      }
      __syncthreads();
      for (int t = warp; t < mt_n * hsub; t += kWbWarps) {
        const int mt = t / hsub, sub = t % hsub;
        float* dst = dqf + (size_t)mt * 16 * hd + sub * 16;
        FragC acc;
        wmma::load_matrix_sync(acc, dst, hd, wmma::mem_row_major);
        for (int k0 = 0; k0 < cw; k0 += 16) {
          FragA fa;
          FragBt fb;  // B[c][d] = proj_w[h*hd + sub*16 + d][c0 + k0 + c]
          wmma::load_matrix_sync(fa, dstage + (size_t)mt * 16 * kWbChunk + k0, kWbChunk);
          wmma::load_matrix_sync(fb, wproj + (size_t)(h * hd + sub * 16) * C + c0 + k0, C);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dst, acc, hd, wmma::mem_row_major);
      }
      __syncthreads();
    }
    for (int idx = tid; idx < Np * hd; idx += kWbThreads) das[idx] = __float2bfloat16(dqf[idx]);
    __syncthreads();

    // raw scores q . k^T (Np x Np, fp32)
    for (int t = warp; t < mt_n * mt_n; t += kWbWarps) {
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
    for (int i = warp; i < Np; i += kWbWarps) {
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
      const float inv = 1.f / s;
      for (int j = lane; j < Np; j += kWarp) {
        const float p = j < N ? fa_div(expf(prow[j] - m), s, inv) : 0.f;
        prow[j] = p;
        brow[j] = __float2bfloat16(p);
      }
    }
    __syncthreads();

    // o = round(P) . v (to the workspace), dv = round(P)^T . do, dp = do . v^T
    const int t_o = mt_n * hsub, t_dp = mt_n * mt_n;
    for (int t = warp; t < 2 * t_o + t_dp; t += kWbWarps) {
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
          if (i < N)
            o_ws[(size_t)i * C + h * hd + sub * 16 + e % 16] = __float2bfloat16(stage[e]);
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
    for (int i = warp; i < N; i += kWbWarps) {
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
    for (int t = warp; t < 2 * t_o; t += kWbWarps) {
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
    for (int idx = tid; idx < N * 3 * hd; idx += kWbThreads) {
      const int i = idx / (3 * hd), j = idx % (3 * hd), part = j / hd, d = j % hd;
      const float* src = part == 0 ? dqf : (part == 1 ? dkf : dvf);
      dqkv_ws[(size_t)i * C3 + part * C + h * hd + d] = __float2bfloat16(src[i * hd + d]);
    }
    for (int j = tid; j < 3 * hd; j += kWbThreads) {
      const int part = j / hd, d = j % hd;
      const float* src = part == 0 ? dqf : (part == 1 ? dkf : dvf);
      float s = 0.f;
      for (int i = 0; i < N; ++i) s += src[i * hd + d];
      a.dqkvb_part[(size_t)blk * C3 + part * C + h * hd + d] = s;
    }
    __syncthreads();
  }

  // phase 2: dx = round(round(dqkv) . qkv_w^T) over staged column slices of
  // dqkv (the block's own workspace rows, visible after the barrier above)
  for (int idx = tid; idx < Np * C; idx += kWbThreads) dxa[idx] = 0.f;
  for (int j0 = 0; j0 < C3; j0 += kWbChunk) {
    const int jw = min(kWbChunk, C3 - j0);
    __syncthreads();  // dxa zeroed / the previous slice's tiles done with dqs
    for (int idx = tid; idx < Np * kWbChunk; idx += kWbThreads) {
      const int i = idx / kWbChunk, jj = idx % kWbChunk;
      dqs[idx] = (i < N && jj < jw) ? dqkv_ws[(size_t)i * C3 + j0 + jj] : zero;
    }
    __syncthreads();
    for (int t = warp; t < mt_n * (C / 16); t += kWbWarps) {
      const int mt = t / (C / 16), nt = t % (C / 16);
      float* dst = dxa + (size_t)mt * 16 * C + nt * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, dst, C, wmma::mem_row_major);
      for (int k0 = 0; k0 < jw; k0 += 16) {
        FragA fa;
        FragBt fb;  // B[j][c] = qkv_w[nt*16 + c][j0 + k0 + j]
        wmma::load_matrix_sync(fa, dqs + (size_t)mt * 16 * kWbChunk + k0, kWbChunk);
        wmma::load_matrix_sync(fb, wqkv + (size_t)nt * 16 * C3 + j0 + k0, C3);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(dst, acc, C, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * C; idx += kWbThreads) dx[idx] = __float2bfloat16(dxa[idx]);
}

struct WinBwdWsLayout {
  size_t o, dqkv, dqkvb, dbias, atb, bytes;
};

inline WinBwdWsLayout win_bwd_ws_layout(int Bn, int N, int C, int nh, int is_bf16) {
  const size_t T = (size_t)Bn * N, es = is_bf16 ? 2 : 4;
  WinBwdWsLayout l;
  size_t o = 0;
  l.o = o;     o = align256(o + T * C * es);
  l.dqkv = o;  o = align256(o + T * 3 * C * es);
  l.dqkvb = o; o = align256(o + sizeof(float) * (size_t)Bn * 3 * C);
  l.dbias = o; o = align256(o + sizeof(float) * (size_t)Bn * nh * N * N);
  l.atb = o;   o = align256(o + sizeof(float) * atb_partial_floats((int)T, C, 3 * C));
  l.bytes = o;
  return l;
}

}  // namespace vadcl

extern "C" {

// The tensor-core body's layout in bf16 at the widths it takes, the CUDA-core
// body's fp32 tiles otherwise.
long long vadcl_window_attn_bwd_smem_bytes(int n, int c, int nh, int is_bf16) {
  return (long long)(is_bf16 && vadcl::win_bwd_tc_eligible(c, nh)
                         ? vadcl::win_bwd_tc_layout(n, c, nh).bytes
                         : vadcl::win_bwd_smem_bytes(n, c, nh));
}

long long vadcl_window_attn_bwd_workspace_bytes(int Bn, int N, int C, int nh, int is_bf16) {
  return (long long)vadcl::win_bwd_ws_layout(Bn, N, C, nh, is_bf16).bytes;
}

// Kernel 8.
int vadcl_window_attn_bwd(const void* x, const void* dout, const void* qkv_w,
                          const float* qkv_b, const void* proj_w, const float* bias,
                          const float* mask, void* dx, float* dqkv_w, float* dqkv_b,
                          float* dproj_w, float* dproj_b, float* dbias, void* workspace,
                          int Bn, int N, int C, int nh, int nW, float scale, int is_bf16,
                          void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bn <= 0 || N <= 0 || C % nh != 0 || nW <= 0) return cudaErrorInvalidValue;
  const bool tc = is_bf16 && win_bwd_tc_eligible(C, nh);
  const size_t smem = tc ? win_bwd_tc_layout(N, C, nh).bytes : win_bwd_smem_bytes(N, C, nh);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const WinBwdWsLayout l = win_bwd_ws_layout(Bn, N, C, nh, is_bf16);
  char* ws = static_cast<char*>(workspace);
  WinBwdArgs a{x, dout, qkv_w, qkv_b, proj_w, bias, mask, dx, ws + l.o, ws + l.dqkv,
               reinterpret_cast<float*>(ws + l.dqkvb), reinterpret_cast<float*>(ws + l.dbias),
               Bn, N, C, nh, nW, scale};
  cudaError_t err;
  if (tc) {
    if ((err = allow_smem(window_attn_bwd_tc_kernel, smem)) != cudaSuccess) return err;
    window_attn_bwd_tc_kernel<<<Bn, kWbThreads, smem, s>>>(a);
  } else if (is_bf16) {
    if ((err = allow_smem(window_attn_bwd_kernel<__nv_bfloat16>, smem)) != cudaSuccess) return err;
    window_attn_bwd_kernel<__nv_bfloat16><<<Bn, kWbThreads, smem, s>>>(a);
  } else {
    if ((err = allow_smem(window_attn_bwd_kernel<float>, smem)) != cudaSuccess) return err;
    window_attn_bwd_kernel<float><<<Bn, kWbThreads, smem, s>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int T = Bn * N;
  float* part = reinterpret_cast<float*>(ws + l.atb);
  if ((err = launch_atb(x, is_bf16, a.dqkv_ws, is_bf16, T, C, 3 * C, part, dqkv_w, s))) return err;
  if ((err = launch_atb(a.o_ws, is_bf16, dout, is_bf16, T, C, C, part, dproj_w, s))) return err;
  if ((err = launch_atb(nullptr, 0, dout, is_bf16, T, 1, C, part, dproj_b, s))) return err;
  if ((err = launch_sum_rows(a.dqkvb_part, dqkv_b, Bn, 3 * C, 3 * C, s))) return err;
  return launch_sum_rows(a.dbias_part, dbias, Bn, (long long)nh * N * N,
                         (long long)nh * N * N, s);
}

}  // extern "C"
