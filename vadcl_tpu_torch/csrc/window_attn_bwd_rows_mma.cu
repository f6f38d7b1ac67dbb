// The bf16 attention core of the row-tiled window attention backward: kernel
// 8 (vadcl_tpu/ops/pallas_attn_bwd.py:_bwd_kernel) for windows the whole-tile
// body (window_attn_bwd.cu) cannot hold, e.g. N = 196 and N = 392 (windows
// (4, 7, 7) and (8, 7, 7) of 8-frame reconstruction clips).
// window_attn_bwd_rows.cu runs the qkv and dout . W_proj^T products before it
// and the weight sums and dx after it; this launch reads q, k, v and do from
// the workspace and writes o = round(p . v), dqkv = round(dq | dk | dv), the
// per-window column sums of the unrounded dqkv and the d(bias) partials:
//   v' = s * (scale * log2 e) + (bias[h] + mask[w]) * log2 e, s = q . k^T;
//   P = 2^(v' - m) / l (2^ flushed to zero below the smallest normal, the
//   division fa_div), p = round(P), o = round(p . v);
//   dp = do . v^T;  r = rowsum(dp * P);  ds = P * (dp - r);
//   d(bias)[h] += ds over the windows;  dss = round(ds * scale);
//   dq = dss . k;  dk = dss^T . q;  dv = p^T . do.
// The softmax in base 2 on scores pre-multiplied by log2 e is the natural
// one's to fp32 rounding, and bias and mask are summed before the score is
// added, as in the forward core (window_attn_rows_mma.cu).  r is taken in the
// first walk, online: rowsum(dp * 2^(v' - m)) rescaled with the running sum
// l, then divided by l; ds keeps the form P * (dp - r).  Both orders are held
// by tests/test_torch_port_rows_bwd_mma.py against the plain version and the
// Pallas kernel.
//
// What bounded the body it replaces (one block per chunk of consecutive
// windows and head, a warp a strip): every score read its bias and mask from
// device memory in each of four walks (three over the keys, one over the
// queries), and every window read and rewrote its chunk's d(bias) partial,
// nH x N x N floats; its weight sums ran on CUDA cores.  Here:
//   * a block takes a head h and walks groups of G windows that share one
//     mask index (w, w + nW, ...; without a mask any G windows), in a fixed
//     order: the groups of a head are spread evenly over at most
//     rows_bwd_chunks blocks (a persistent grid), so the d(bias) partials
//     are no more than before;
//   * phase A walks the 16-row query strips in order.  A strip's bias and
//     mask rows are copied once by cp.async during the strip before, summed
//     and scaled into one fp32 tile and read by every window of the group.
//     K and V of the group's windows sit in shared memory as swizzled
//     16-byte chunks.  A first walk gives the running (m, l, rowsum) of
//     every window of the group at once, 8 / G warps a window splitting its
//     key blocks, merged in warp order; then for each window in turn the
//     block's 8 warps split the strip's key blocks (every 8th) in a second
//     walk that forms P, ds, dq and o.
//     A warp keeps the ds of its key blocks in registers across the group's
//     windows, summed in window order, and adds the sum into the block's
//     d(bias) partial once per strip and group (nothing atomic: every element
//     has one owner, so two calls give the same bits).  The warps' partial dq
//     and o strips are summed in warp order through shared memory;
//   * phase B walks the 16-row key strips with q and do of the group in
//     shared memory and the strip's (bias + mask) for its keys staged as a
//     tile: P and ds from phase A's row statistics, dk and dv.  No d(bias)
//     ties a warp to a block here, so the group's windows walk together,
//     8 / G warps a window splitting its query blocks, one block barrier a
//     strip, the partial strips merged per window in warp order;
//   * at N above 512 (or where not one window fits) the direct layout
//     (rows_bwd_direct_kernel) takes the footprint of the body before it: a block
//     per (chunk of consecutive windows, head), q, K, V, do of one window in
//     padded rows, a warp a strip, bias and mask from device memory, the
//     same walks; it holds every window the body before it held (N up to
//     1072, 640, 464, 352 at head widths 16, 32, 48, 64).
// Products are mma.sync.m16n8k16 with scores, probabilities and output strips
// in registers.  What bounds it now is neither bytes nor the tensor-core rate
// (at (256, 392, 96) / 6 heads both allow well under a tenth of its time):
// one 8-warp block an SM (255 registers a thread at head width 16), and
// walk 2's window-at-a-time split, where warp 0 takes 4 of 25 key blocks and
// two block barriers follow each (strip, window).
#include "window_attn_bwd_rows_mma.cuh"

namespace vadcl {

namespace {

using bf16 = __nv_bfloat16;

struct RowsBwdMmaArgs {
  const bf16* qkv;    // (Bn * N, 3C)
  const bf16* doa;    // (Bn * N, C) round(dout . W_proj^T)
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  bf16* o;            // (Bn * N, C)
  bf16* dqkv;         // (Bn * N, 3C)
  float* dqkvb_part;  // (Bn, 3C)
  float* dbias_part;  // (partials, nH, N, N)
  int N, C, nh, nW;   // nW: mask indices (1 without a mask)
  int per_class;      // windows a mask index has: Bn / nW
  int group, gpc;     // windows a group, groups a mask index
  int slots;          // blocks a head (staged); windows a chunk (direct: `group` 0)
  int vec;            // bias and mask rows copied 16 bytes at a time
  float smul, scale;  // scale * log2 e; scale
};

// (bias[i][j] + mask[i][j]) * log2 e for phase B from device memory (the
// direct layout): key rows j0, j1 (the strip's rows g and g + 8) and query
// columns i; -inf past the window either way.
struct RbGlobalBMT {
  const float *bias, *mask;
  int j0, j1, N;
  __device__ __forceinline__ float at(int i, int j) const {
    if (i >= N || j >= N) return -INFINITY;
    float v = __ldg(bias + (size_t)i * N + j);
    if (mask != nullptr) v += __ldg(mask + (size_t)i * N + j);
    return v * kLog2e;
  }
  // query columns col, col + 1 of key rows g (a) and g + 8 (b)
  __device__ __forceinline__ void operator()(int col, float2& a, float2& b) const {
    a = make_float2(at(col, j0), at(col + 1, j0));
    b = make_float2(at(col, j1), at(col + 1, j1));
  }
};

// ... or from phase B's tile in shared memory: the strip's 16 keys as rows,
// every query a column (t0, t1: its rows g and g + 8).
struct RbTileBMT {
  const float *t0, *t1;
  __device__ __forceinline__ void operator()(int col, float2& a, float2& b) const {
    a = *reinterpret_cast<const float2*>(t0 + col);
    b = *reinterpret_cast<const float2*>(t1 + col);
  }
};

// Walk 1, one key block: the strip's v' and dp = do . v^T, and the online
// (m, l, rowsum(dp * 2^(v' - m))) of rows g, g + 8, l and the rowsum this
// lane's share (summed over the quad at the end of the walk).
template <int kHd, bool kPad, class BM>
__device__ __forceinline__ void rb_block1(const uint32_t (&qf)[kHd / 16][4],
                                          const uint32_t (&df)[kHd / 16][4], const bf16* ks,
                                          const bf16* vs, const BM& bm, int kb, float smul,
                                          int lane, float (&m)[2], float (&l)[2],
                                          float (&rs)[2]) {
  float v[2][4], d[2][4];
  rm_scores<kHd, kPad>(qf, ks, bm, kb, smul, lane, v);
  rm_dot<kHd, kPad>(df, vs, kb, lane, d);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float b = fmaxf(fmaxf(v[0][2 * r], v[0][2 * r + 1]), fmaxf(v[1][2 * r], v[1][2 * r + 1]));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 1));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 2));
    const float n = fmaxf(m[r], b), f = ex2_ftz(m[r] - n);
    float al = 0.f, ar = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = ex2_ftz(v[nt][2 * r + c] - n);
        al += e;
        ar = fmaf(d[nt][2 * r + c], e, ar);
      }
    l[r] = fmaf(l[r], f, al);
    rs[r] = fmaf(rs[r], f, ar);
    m[r] = n;
  }
}

__device__ __forceinline__ void rb_quad_sum(float (&x)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x[r] += __shfl_xor_sync(0xffffffffu, x[r], 1);
    x[r] += __shfl_xor_sync(0xffffffffu, x[r], 2);
  }
}

// Walk 2, one key block: P, ds = P * (dp - r) (returned), dq += round(ds *
// scale) . k and o += round(P) . v.  m, l, r, rinv per row (rinv = 1 / l).
template <int kHd, bool kPad, class BM>
__device__ __forceinline__ void rb_block2(const uint32_t (&qf)[kHd / 16][4],
                                          const uint32_t (&df)[kHd / 16][4], const bf16* ks,
                                          const bf16* vs, const BM& bm, int kb, float smul,
                                          float scale, int lane, const float (&m)[2],
                                          const float (&l)[2], const float (&r)[2],
                                          const float (&rinv)[2], float (&dq)[kHd / 8][4],
                                          float (&oa)[kHd / 8][4], float (&ds)[2][4]) {
  float v[2][4], d[2][4], p[2][4];
  rm_scores<kHd, kPad>(qf, ks, bm, kb, smul, lane, v);
  rm_dot<kHd, kPad>(df, vs, kb, lane, d);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float pv = fa_div(ex2_ftz(v[nt][e] - m[h]), l[h], rinv[h]);
      p[nt][e] = pv;
      ds[nt][e] = pv * (d[nt][e] - r[h]);
      d[nt][e] = ds[nt][e] * scale;
    }
  uint32_t pf[4], sf[4];
  rows_a_frag(p, pf);
  rows_a_frag(d, sf);
  rm_acc<kHd, kPad>(sf, ks, kb, lane, dq);
  rm_acc<kHd, kPad>(pf, vs, kb, lane, oa);
}

// Phase B, one query block qb of key strip's rows g, g + 8 (kf, vf: their k
// and v fragments): P^T from the row statistics (m, l, r of each query row),
// ds^T, dk += round(ds^T * scale) . q and dv += round(P^T) . do.
template <int kHd, bool kPad, class BMT>
__device__ __forceinline__ void rb_blockB(const uint32_t (&kf)[kHd / 16][4],
                                          const uint32_t (&vf)[kHd / 16][4], const bf16* qs,
                                          const bf16* dos, const BMT& bm, const float* sm,
                                          const float* sl, const float* sr, int qb, float smul,
                                          float scale, int lane, float (&dk)[kHd / 8][4],
                                          float (&dv)[kHd / 8][4]) {
  float st[2][4], dt[2][4];
  rm_dot<kHd, kPad>(kf, qs, qb, lane, st);
  rm_dot<kHd, kPad>(vf, dos, qb, lane, dt);
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int i = qb * 16 + nt * 8 + 2 * t;  // query columns i, i + 1
    float2 a, b;
    bm(i, a, b);
    const float tv[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = i + (e & 1);
      const float lq = sl[q];
      const float pv = fa_div(ex2_ftz(fmaf(st[nt][e], smul, tv[e]) - sm[q]), lq, 1.f / lq);
      st[nt][e] = pv;
      dt[nt][e] = pv * (dt[nt][e] - sr[q]) * scale;
    }
  }
  uint32_t pf[4], sf[4];
  rows_a_frag(st, pf);
  rows_a_frag(dt, sf);
  rm_acc<kHd, kPad>(sf, qs, qb, lane, dk);
  rm_acc<kHd, kPad>(pf, dos, qb, lane, dv);
}

// Column sums of a 16 x kHd fp32 strip (rows past the window left out) into
// out[0 .. kHd) (kAdd: added to it): lanes 0-3 write, in the C fragment's
// column order.
template <int kHt, bool kAdd = false>
__device__ __forceinline__ void strip_colsum(const float (&acc)[kHt][4], bool r0, bool r1,
                                             float* out, int lane) {
#pragma unroll
  for (int i = 0; i < kHt; ++i) {
    float c0 = (r0 ? acc[i][0] : 0.f) + (r1 ? acc[i][2] : 0.f);
    float c1 = (r0 ? acc[i][1] : 0.f) + (r1 ? acc[i][3] : 0.f);
#pragma unroll
    for (int o = 4; o < kWarp; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (lane < 4) {
      if (kAdd) c0 += out[i * 8 + 2 * lane], c1 += out[i * 8 + 2 * lane + 1];
      out[i * 8 + 2 * lane] = c0, out[i * 8 + 2 * lane + 1] = c1;
    }
  }
}

template <int kHd>
__device__ __forceinline__ void zero_acc(float (&a)[kHd / 8][4]) {
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// A warp's two partial 16 x kHd strips into its slot of op (rows of 2 kHd + 8).
template <int kHd>
__device__ __forceinline__ void rb_put(float* slot, const float (&a)[kHd / 8][4],
                                       const float (&b)[kHd / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int ld = 2 * kHd + 8;
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) {
    const int col = i * 8 + 2 * t;
    *reinterpret_cast<float2*>(slot + g * ld + col) = make_float2(a[i][0], a[i][1]);
    *reinterpret_cast<float2*>(slot + (g + 8) * ld + col) = make_float2(a[i][2], a[i][3]);
    *reinterpret_cast<float2*>(slot + g * ld + kHd + col) = make_float2(b[i][0], b[i][1]);
    *reinterpret_cast<float2*>(slot + (g + 8) * ld + kHd + col) = make_float2(b[i][2], b[i][3]);
  }
}

// The `slots` partial strips from op on (consecutive warps' slots) summed in
// warp order; row r of the strip (rows past the window skipped) goes rounded
// to dst0 (the first kHd columns; rows ld0 elements apart) and dst1 (the
// second; ld1).  All threads.
template <int kHd>
__device__ __forceinline__ void rb_merge(const float* op, int slots, int rows, bf16* dst0,
                                         size_t ld0, bf16* dst1, size_t ld1) {
  constexpr int kLd = 2 * kHd + 8;
  for (int e = threadIdx.x; e < 16 * kHd; e += kRbWarps * kWarp) {
    const int r = e / kHd, col = 2 * (e % kHd);  // col < 2 kHd
    if (r >= rows) continue;
    float2 acc = *reinterpret_cast<const float2*>(op + r * kLd + col);
    for (int w = 1; w < slots; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(op + (w * 16 + r) * kLd + col);
      acc.x += v.x;
      acc.y += v.y;
    }
    bf16* dst = col < kHd ? dst0 + r * ld0 + col : dst1 + r * ld1 + (col - kHd);
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc.x, acc.y);
  }
}

template <int kHd>
__global__ void __launch_bounds__(kRbWarps * kWarp, 1) rows_bwd_mma_kernel(RowsBwdMmaArgs a) {
  constexpr int kKs = kHd / 16, kHt = kHd / 8, kCh = kHd / 8, kThreads = kRbWarps * kWarp;
  constexpr int kOld = 2 * kHd + 8;  // floats a row of a warp's partial strips
  extern __shared__ __align__(16) unsigned char sm[];
  const int N = a.N, C = a.C, C3 = 3 * C, Np = rows_padded(N), nblk = Np / 16, tld = Np + 8;
  const int G = a.group;
  const RowsBwdLayout lay = rows_bwd_layout(N, kHd, G);
  bf16* kv = reinterpret_cast<bf16*>(sm + lay.kv);
  float* tile = reinterpret_cast<float*>(sm + lay.t);
  float* rawb = reinterpret_cast<float*>(sm + lay.raw);
  float* rawm = rawb + 16 * Np;
  float* stats = reinterpret_cast<float*>(sm + lay.st);  // [G][m, l, r][Np]
  float4* ml = reinterpret_cast<float4*>(sm + lay.ml);
  float* op = reinterpret_cast<float*>(sm + lay.op);
  float* cs = reinterpret_cast<float*>(sm + lay.cs);  // [G][warp][dq, dk, dv column sums]

  const int h = blockIdx.x % a.nh, slot = blockIdx.x / a.nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2;
  const float* bias = a.bias + (size_t)h * N * N;
  const long long ng = (long long)a.nW * a.gpc;  // the head's groups
  const int g_begin = (int)(ng * slot / a.slots), g_end = (int)(ng * (slot + 1) / a.slots);
  float* dbias = a.dbias_part + ((size_t)slot * a.nh + h) * N * N;
  float* mine = op + (size_t)warp * 16 * kOld;  // this warp's partial strips

  for (int gg = g_begin; gg < g_end; ++gg) {
    const int w = gg / a.gpc, gi = gg % a.gpc;
    const int gv = min(G, a.per_class - gi * G);  // windows of this group
    const float* mask = a.mask != nullptr ? a.mask + (size_t)w * N * N : nullptr;
    auto win = [&](int u) { return (size_t)w + (size_t)a.nW * (gi * G + u); };
    const bool first = gg == g_begin;

    // two [Np][kHd] tiles a window: the head's slice of the columns at col0
    // of base0 (rows ld0 elements apart) and at col1 of base1 (ld1); rows past
    // the window zeros
    auto stage_kv = [&](const bf16* base0, int ld0, int col0, const bf16* base1, int ld1,
                        int col1) {
      for (int tl = 0; tl < 2 * gv; ++tl) {
        const int ld = tl & 1 ? ld1 : ld0;
        const bf16* src = (tl & 1 ? base1 : base0) + win(tl >> 1) * N * ld +
                          (tl & 1 ? col1 : col0) + h * kHd;
        bf16* dst = kv + (size_t)tl * Np * kHd;
        for (int e = tid; e < Np * kCh; e += kThreads) {
          const int r = e / kCh, c = e % kCh;
          cp_async16(dst + r * kHd + rm_swz<kHd>(r, c) * 8, src + (size_t)min(r, N - 1) * ld + c * 8,
                     r < N);
        }
      }
    };
    // phase A: query strip s's bias and mask rows into raw ([16][Np] each), a
    // warp a row
    auto stage_rows = [&](int s) {
      const int rows = min(16, N - s * 16);
      for (int r = warp; r < rows; r += kRbWarps) {
        const size_t at = (size_t)(s * 16 + r) * N;
        for (int mm = 0; mm < (mask != nullptr ? 2 : 1); ++mm) {
          const float* src = (mm ? mask : bias) + at;
          float* dst = (mm ? rawm : rawb) + r * Np;
          if (a.vec) {
            for (int v = 4 * lane; v < N; v += 4 * kWarp) cp_async16(dst + v, src + v, true);
          } else {
            for (int c = lane; c < N; c += kWarp) cp_async4(dst + c, src + c, true);
          }
        }
      }
    };
    // raw -> tile ([16][Np + 8]): (bias + mask) * log2 e; keys past the
    // window -inf, rows past it 0 over the real keys
    auto combine_rows = [&](int s) {
      for (int r = warp; r < 16; r += kRbWarps) {
        const bool real = s * 16 + r < N;
        for (int c = 4 * lane; c < Np; c += 4 * kWarp) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (real) {
            v = *reinterpret_cast<const float4*>(rawb + r * Np + c);
            if (mask != nullptr) {
              const float4 u = *reinterpret_cast<const float4*>(rawm + r * Np + c);
              v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
            }
            v.x *= kLog2e, v.y *= kLog2e, v.z *= kLog2e, v.w *= kLog2e;
          }
          if (c + 0 >= N) v.x = -INFINITY;
          if (c + 1 >= N) v.y = -INFINITY;
          if (c + 2 >= N) v.z = -INFINITY;
          if (c + 3 >= N) v.w = -INFINITY;
          *reinterpret_cast<float4*>(tile + r * tld + c) = v;
        }
      }
    };
    // phase B: key strip js's bias and mask columns of every query row into
    // raw ([Np][16] each)
    auto stage_cols = [&](int js) {
      const int j0 = js * 16;
      for (int mm = 0; mm < (mask != nullptr ? 2 : 1); ++mm) {
        const float* src = mm ? mask : bias;
        float* dst = mm ? rawm : rawb;
        if (a.vec) {
          for (int e = tid; e < N * 4; e += kThreads) {
            const int i = e >> 2, c = 4 * (e & 3);
            cp_async16(dst + i * 16 + c, src + (size_t)i * N + min(j0 + c, N - 4), j0 + c < N);
          }
        } else {
          for (int e = tid; e < N * 16; e += kThreads) {
            const int i = e >> 4, c = e & 15;
            cp_async4(dst + i * 16 + c, src + (size_t)i * N + min(j0 + c, N - 1), j0 + c < N);
          }
        }
      }
    };
    // raw -> tile ([16][Np + 8], the strip's keys as rows): -inf past the
    // window either way
    auto combine_cols = [&](int js) {
      for (int e = tid; e < Np * 16; e += kThreads) {
        const int i = e >> 4, c = e & 15;
        float v = -INFINITY;
        if (i < N && js * 16 + c < N) {
          v = rawb[i * 16 + c];
          if (mask != nullptr) v += rawm[i * 16 + c];
          v *= kLog2e;
        }
        tile[c * tld + i] = v;
      }
    };

    // ---- phase A: query strips ----
    // Walk 1 has no d(bias) either: the group's windows take it together, 8 / G
    // warps a window each taking every (8 / G)-th key block; walk 2 then takes
    // the windows in turn, all warps on one, every 8th key block a warp.
    const int wu = kRbWarps / G, ub = warp / wu, part = warp % wu;
    const bool active = ub < gv;
    stage_kv(a.qkv, C3, C, a.qkv, C3, 2 * C);  // K and V
    stage_rows(0);
    cp_async_commit();
    for (int e = tid; e < gv * kRbWarps * 3 * kHd; e += kThreads) cs[e] = 0.f;
    // q and do of a (strip, window): in flight during the walk before
    uint32_t qf[kKs][4], df[kKs][4], qn[kKs][4], dn[kKs][4];
    auto load_qd = [&](int s, int u, uint32_t (&qx)[kKs][4], uint32_t (&dx)[kKs][4]) {
      rm_load_q<kKs>(a.qkv + win(u) * N * C3 + h * kHd, C3, s, N, lane, qx);
      rm_load_q<kKs>(a.doa + win(u) * N * C + h * kHd, C, s, N, lane, dx);
    };
    cp_async_wait<0>();
    __syncthreads();
    combine_rows(0);
    __syncthreads();
    const RmTileBM bm{tile + g * tld, tile + (g + 8) * tld};
    for (int s = 0; s < nblk; ++s) {
      if (s + 1 < nblk) stage_rows(s + 1);
      cp_async_commit();
      const int rows = min(16, N - s * 16);
      load_qd(s, 0, qn, dn);  // walk 2's first window, in flight during walk 1
      if (active) {
        uint32_t q1[kKs][4], d1[kKs][4];
        load_qd(s, ub, q1, d1);
        const bf16* ks = kv + (size_t)2 * ub * Np * kHd;
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
        for (int kb = part; kb < nblk; kb += wu)
          rb_block1<kHd, false>(q1, d1, ks, ks + (size_t)Np * kHd, bm, kb, a.smul, lane, m, l,
                                rs);
        rb_quad_sum(l);
        rb_quad_sum(rs);
        if ((lane & 3) == 0) {
          ml[warp * 16 + g] = make_float4(m[0], l[0], rs[0], 0.f);
          ml[warp * 16 + g + 8] = make_float4(m[1], l[1], rs[1], 0.f);
        }
      }
      __syncthreads();
      float dbr[kRbKeyMax][2][4];
      for (int u = 0; u < gv; ++u) {
        const size_t wn = win(u);
        const bf16* ks = kv + (size_t)2 * u * Np * kHd;
        const bf16* vs = ks + (size_t)Np * kHd;
#pragma unroll
        for (int k = 0; k < kKs; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[k][e] = qn[k][e], df[k][e] = dn[k][e];
        if (u + 1 < gv) load_qd(s, u + 1, qn, dn);
        // the window's wu partial (m, l, rowsum), merged in warp order
        float m[2], l[2], r[2], rinv[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float4* pm = ml + u * wu * 16 + g + 8 * hh;
          float mx = pm[0].x;
          for (int q = 1; q < wu; ++q) mx = fmaxf(mx, pm[q * 16].x);
          float lsum = 0.f, rsum = 0.f;
          for (int q = 0; q < wu; ++q) {
            const float f = ex2_ftz(pm[q * 16].x - mx);
            lsum = fmaf(pm[q * 16].y, f, lsum);
            rsum = fmaf(pm[q * 16].z, f, rsum);
          }
          m[hh] = mx;
          l[hh] = lsum;
          r[hh] = rsum / lsum;
          rinv[hh] = 1.f / lsum;
        }
        if (warp == 0 && (lane & 3) == 0) {
          float* su = stats + (size_t)u * 3 * Np;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = s * 16 + g + 8 * hh;
            su[i] = m[hh], su[Np + i] = l[hh], su[2 * Np + i] = r[hh];
          }
        }
        float dq[kHt][4], oa[kHt][4];
        zero_acc<kHd>(dq);
        zero_acc<kHd>(oa);
#pragma unroll
        for (int i = 0; i < kRbKeyMax; ++i) {
          const int kb = warp + i * kRbWarps;
          if (kb < nblk) {
            float ds[2][4];
            rb_block2<kHd, false>(qf, df, ks, vs, bm, kb, a.smul, a.scale, lane, m, l, r, rinv,
                                  dq, oa, ds);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                dbr[i][nt][e] = u == 0 ? ds[nt][e] : dbr[i][nt][e] + ds[nt][e];
          }
        }
        // this warp's share of the window's dq column sums, strips in order
        strip_colsum<kHt, true>(dq, s * 16 + g < N, s * 16 + g + 8 < N,
                                cs + ((size_t)u * kRbWarps + warp) * 3 * kHd, lane);
        rb_put<kHd>(mine, dq, oa, lane);
        __syncthreads();
        rb_merge<kHd>(op, kRbWarps, rows, a.dqkv + (wn * N + s * 16) * C3 + h * kHd, C3,
                      a.o + (wn * N + s * 16) * C + h * kHd, C);
        if (u + 1 < gv) __syncthreads();  // op is rewritten by the next window's walk
      }
      // the group's d(bias) of this strip into the block's partial, once: the
      // partial's old values all read first (one round trip, in flight across
      // the barrier and the next strip's combine), then the sums stored;
      // pairs of columns as one 8-byte access where N is even
      float old[kRbKeyMax][2][4];
#pragma unroll
      for (int i = 0; i < kRbKeyMax; ++i)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int kb = warp + i * kRbWarps;
            const int row = s * 16 + g + 8 * hh, col = kb * 16 + nt * 8 + 2 * (lane & 3);
            const float* db = dbias + (size_t)row * N + col;
            float2 o2 = make_float2(0.f, 0.f);
            if (!first && kb < nblk && row < N) {
              if ((N & 1) == 0 && col < N) {
                o2 = *reinterpret_cast<const float2*>(db);
              } else {
                if (col < N) o2.x = db[0];
                if (col + 1 < N) o2.y = db[1];
              }
            }
            old[i][nt][2 * hh] = o2.x, old[i][nt][2 * hh + 1] = o2.y;
          }
      cp_async_wait<0>();
      __syncthreads();
      if (s + 1 < nblk) combine_rows(s + 1);
#pragma unroll
      for (int i = 0; i < kRbKeyMax; ++i) {
        const int kb = warp + i * kRbWarps;
        if (kb < nblk) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = s * 16 + g + 8 * hh, col = kb * 16 + nt * 8 + 2 * (lane & 3);
              float* db = dbias + (size_t)row * N + col;
              const float v0 = first ? dbr[i][nt][2 * hh] : dbr[i][nt][2 * hh] + old[i][nt][2 * hh];
              const float v1 =
                  first ? dbr[i][nt][2 * hh + 1] : dbr[i][nt][2 * hh + 1] + old[i][nt][2 * hh + 1];
              if (row < N && (N & 1) == 0 && col < N) {
                *reinterpret_cast<float2*>(db) = make_float2(v0, v1);
              } else if (row < N) {
                if (col < N) db[0] = v0;
                if (col + 1 < N) db[1] = v1;
              }
            }
        }
      }
      if (s + 1 < nblk) __syncthreads();  // the combined tile, before the next strip
    }

    // ---- phase B: key strips ----
    // The windows of the group walk together, as in walk 1: wu warps a window
    // (no d(bias) here ties a warp to a key block across windows), each taking
    // every wu-th query block, merged per window in warp order.
    stage_kv(a.qkv, C3, 0, a.doa, C, 0);  // q and do
    stage_cols(0);
    cp_async_commit();
    // k and v of this warp's window's key strip: in flight during the strip
    // before
    uint32_t kf[kKs][4], vf[kKs][4], kn[kKs][4], vn[kKs][4];
    auto load_kv = [&](int js, uint32_t (&kx)[kKs][4], uint32_t (&vx)[kKs][4]) {
      rm_load_q<kKs>(a.qkv + win(ub) * N * C3 + C + h * kHd, C3, js, N, lane, kx);
      rm_load_q<kKs>(a.qkv + win(ub) * N * C3 + 2 * C + h * kHd, C3, js, N, lane, vx);
    };
    if (active) load_kv(0, kf, vf);
    cp_async_wait<0>();
    __syncthreads();
    combine_cols(0);
    __syncthreads();
    const RbTileBMT bmt{tile + g * tld, tile + (g + 8) * tld};
    const bf16* qs = kv + (size_t)2 * ub * Np * kHd;
    const bf16* dos = qs + (size_t)Np * kHd;
    const float* su = stats + (size_t)ub * 3 * Np;
    float* cw = cs + ((size_t)ub * kRbWarps + warp) * 3 * kHd;
    for (int js = 0; js < nblk; ++js) {
      if (js + 1 < nblk) stage_cols(js + 1);
      cp_async_commit();
      const int rows = min(16, N - js * 16);
      if (active) {
        if (js + 1 < nblk) load_kv(js + 1, kn, vn);
        float dk[kHt][4], dv[kHt][4];
        zero_acc<kHd>(dk);
        zero_acc<kHd>(dv);
        for (int qb = part; qb < nblk; qb += wu)
          rb_blockB<kHd, false>(kf, vf, qs, dos, bmt, su, su + Np, su + 2 * Np, qb, a.smul,
                                a.scale, lane, dk, dv);
        strip_colsum<kHt, true>(dk, js * 16 + g < N, js * 16 + g + 8 < N, cw + kHd, lane);
        strip_colsum<kHt, true>(dv, js * 16 + g < N, js * 16 + g + 8 < N, cw + 2 * kHd, lane);
        rb_put<kHd>(mine, dk, dv, lane);
#pragma unroll
        for (int k = 0; k < kKs; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) kf[k][e] = kn[k][e], vf[k][e] = vn[k][e];
      }
      __syncthreads();
      for (int u = 0; u < gv; ++u) {
        bf16* d0 = a.dqkv + (win(u) * N + js * 16) * C3 + h * kHd;
        rb_merge<kHd>(op + (size_t)u * wu * 16 * kOld, wu, rows, d0 + C, C3, d0 + 2 * C, C3);
      }
      cp_async_wait<0>();
      __syncthreads();  // (also: op is rewritten by the next strip's walk)
      if (js + 1 < nblk) {
        combine_cols(js + 1);
        __syncthreads();
      }
    }
    // the windows' dqkv column sums: the warps' shares in warp order
    for (int e = tid; e < gv * 3 * kHd; e += kThreads) {
      const int u = e / (3 * kHd), j = e % (3 * kHd);
      const float* cw = cs + (size_t)u * kRbWarps * 3 * kHd + j;
      float sum = cw[0];
      for (int q = 1; q < kRbWarps; ++q) sum += cw[q * 3 * kHd];
      a.dqkvb_part[win(u) * C3 + (j / kHd) * C + h * kHd + j % kHd] = sum;
    }
    __syncthreads();  // the next group restages every tile
  }
}

// The direct layout, for windows no group fits (rows_bwd_group 0): one block
// per (chunk of a.slots consecutive windows, head), q, K, V and do of one
// window's head in padded rows, each of the kRbWarps warps a whole strip
// (every kRbWarps-th) over every key (phase A) or query (phase B) block,
// bias and mask read from device memory per score, ds added into the chunk's
// d(bias) partial per window.  The same arithmetic as the staged kernel at
// one warp a strip.
template <int kHd>
__global__ void __launch_bounds__(kRbWarps * kWarp) rows_bwd_direct_kernel(RowsBwdMmaArgs a) {
  constexpr int kKs = kHd / 16, kHt = kHd / 8, kCh = kHd / 8, kLd = kHd + 8;
  constexpr int kThreads = kRbWarps * kWarp;
  extern __shared__ __align__(16) unsigned char sm[];
  const int N = a.N, C = a.C, C3 = 3 * C, nh = a.nh, Np = rows_padded(N), nblk = Np / 16;
  const int chunk = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* ks = qs + (size_t)Np * kLd;
  bf16* vs = ks + (size_t)Np * kLd;
  bf16* dos = vs + (size_t)Np * kLd;
  float* mrow = reinterpret_cast<float*>(dos + (size_t)Np * kLd);
  float* lrow = mrow + Np;
  float* rrow = lrow + Np;
  float* csum = rrow + Np;  // [strip][3 kHd]
  const float* bias = a.bias + (size_t)h * N * N;
  float* dbias = a.dbias_part + ((size_t)chunk * nh + h) * N * N;
  const int Bn = a.nW * a.per_class;
  const int w_begin = chunk * a.slots, w_end = min(Bn, w_begin + a.slots);

  for (int w = w_begin; w < w_end; ++w) {
    const bf16* qkv = a.qkv + (size_t)w * N * C3;
    const bf16* doa = a.doa + (size_t)w * N * C;
    const float* mask = a.mask != nullptr ? a.mask + (size_t)(w % a.nW) * N * N : nullptr;
    const bool first = w == w_begin;
    for (int e = tid; e < 4 * Np * kCh; e += kThreads) {
      const int part = e / (Np * kCh), r = (e / kCh) % Np, c = e % kCh;
      const bf16* src = part < 3 ? qkv + (size_t)min(r, N - 1) * C3 + part * C
                                 : doa + (size_t)min(r, N - 1) * C;
      cp_async16(qs + ((size_t)part * Np + r) * kLd + c * 8, src + h * kHd + c * 8, r < N);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // phase A: a warp per query strip
    for (int s = warp; s < nblk; s += kRbWarps) {
      const int i0 = s * 16 + g, i1 = i0 + 8;
      const RmGlobalBM bm{bias, mask, i0, i1, N};
      uint32_t qf[kKs][4], df[kKs][4];
      rm_load_q<kKs>(qkv + h * kHd, C3, s, N, lane, qf);
      rm_load_q<kKs>(doa + h * kHd, C, s, N, lane, df);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
      for (int kb = 0; kb < nblk; ++kb)
        rb_block1<kHd, true>(qf, df, ks, vs, bm, kb, a.smul, lane, m, l, rs);
      rb_quad_sum(l);
      rb_quad_sum(rs);
      const float r[2] = {rs[0] / l[0], rs[1] / l[1]}, rinv[2] = {1.f / l[0], 1.f / l[1]};
      float dq[kHt][4], oa[kHt][4];
      zero_acc<kHd>(dq);
      zero_acc<kHd>(oa);
      for (int kb = 0; kb < nblk; ++kb) {
        float ds[2][4];
        rb_block2<kHd, true>(qf, df, ks, vs, bm, kb, a.smul, a.scale, lane, m, l, r, rinv, dq,
                             oa, ds);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1, j = kb * 16 + nt * 8 + 2 * t + (e & 1);
            if (i < N && j < N) {
              float* db = dbias + (size_t)i * N + j;
              *db = first ? ds[nt][e] : *db + ds[nt][e];
            }
          }
      }
      if (t == 0) {
        mrow[i0] = m[0], lrow[i0] = l[0], rrow[i0] = r[0];
        mrow[i1] = m[1], lrow[i1] = l[1], rrow[i1] = r[1];
      }
      strip_store<kHt>(oa, a.o + (size_t)w * N * C, C, i0, i1, N, h * kHd, t);
      strip_store<kHt>(dq, a.dqkv + (size_t)w * N * C3, C3, i0, i1, N, h * kHd, t);
      strip_colsum<kHt>(dq, i0 < N, i1 < N, csum + s * 3 * kHd, lane);
    }
    __syncthreads();

    // phase B: a warp per key strip
    for (int js = warp; js < nblk; js += kRbWarps) {
      const int j0 = js * 16 + g, j1 = j0 + 8;
      const RbGlobalBMT bmt{bias, mask, j0, j1, N};
      uint32_t kf[kKs][4], vf[kKs][4];
      rm_load_q<kKs>(qkv + C + h * kHd, C3, js, N, lane, kf);
      rm_load_q<kKs>(qkv + 2 * C + h * kHd, C3, js, N, lane, vf);
      float dk[kHt][4], dv[kHt][4];
      zero_acc<kHd>(dk);
      zero_acc<kHd>(dv);
      for (int qb = 0; qb < nblk; ++qb)
        rb_blockB<kHd, true>(kf, vf, qs, dos, bmt, mrow, lrow, rrow, qb, a.smul, a.scale, lane,
                             dk, dv);
      bf16* d0 = a.dqkv + (size_t)w * N * C3;
      strip_store<kHt>(dk, d0, C3, j0, j1, N, C + h * kHd, t);
      strip_store<kHt>(dv, d0, C3, j0, j1, N, 2 * C + h * kHd, t);
      strip_colsum<kHt>(dk, j0 < N, j1 < N, csum + js * 3 * kHd + kHd, lane);
      strip_colsum<kHt>(dv, j0 < N, j1 < N, csum + js * 3 * kHd + 2 * kHd, lane);
    }
    __syncthreads();

    for (int j = tid; j < 3 * kHd; j += kThreads) {
      float sum = 0.f;
      for (int st = 0; st < nblk; ++st) sum += csum[st * 3 * kHd + j];
      a.dqkvb_part[(size_t)w * C3 + (j / kHd) * C + h * kHd + j % kHd] = sum;
    }
    __syncthreads();  // the next window reuses the shared tiles
  }
}

template <int kHd>
cudaError_t launch_core(const RowsBwdMmaArgs& a, size_t smem, unsigned blocks, cudaStream_t s) {
  if (a.group == 0) {
    const cudaError_t err = allow_smem(rows_bwd_direct_kernel<kHd>, smem);
    if (err != cudaSuccess) return err;
    rows_bwd_direct_kernel<kHd><<<blocks, kRbWarps * kWarp, smem, s>>>(a);
    return cudaGetLastError();
  }
  const cudaError_t err = allow_smem(rows_bwd_mma_kernel<kHd>, smem);
  if (err != cudaSuccess) return err;
  rows_bwd_mma_kernel<kHd><<<blocks, kRbWarps * kWarp, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_rows_bwd_mma_core(const void* qkv, const void* doa, const float* bias,
                                     const float* mask, void* o, void* dqkv, float* dqkvb_part,
                                     float* dbias_part, int* partials, int Bn, int N, int C,
                                     int nh, int nW, float scale, cudaStream_t stream) {
  if (Bn <= 0 || N <= 0 || nh <= 0 || nW <= 0 || C % nh) return cudaErrorInvalidValue;
  const int hd = C / nh, classes = mask != nullptr ? nW : 1;
  if (Bn % classes) return cudaErrorInvalidValue;
  const int per = Bn / classes, G = rows_bwd_group(N, hd, per);
  const size_t smem = rows_bwd_layout(N, hd, G).bytes;
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const auto aligned16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  RowsBwdMmaArgs a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.doa = static_cast<const bf16*>(doa);
  a.bias = bias;
  a.mask = mask;
  a.o = static_cast<bf16*>(o);
  a.dqkv = static_cast<bf16*>(dqkv);
  a.dqkvb_part = dqkvb_part;
  a.dbias_part = dbias_part;
  a.N = N, a.C = C, a.nh = nh, a.nW = classes;
  a.per_class = per;
  a.group = G;
  a.gpc = G ? (per + G - 1) / G : 0;
  const int chunks = rows_bwd_chunks(Bn, nh);
  if (G) {
    const long long ng = (long long)classes * a.gpc;
    a.slots = (int)(ng < chunks ? ng : chunks);
    *partials = a.slots;
  } else {
    a.slots = rows_bwd_chunk(Bn, nh);  // windows a chunk
    *partials = chunks;
  }
  a.vec = N % 4 == 0 && aligned16(bias) && (mask == nullptr || aligned16(mask));
  a.smul = scale * kLog2e;
  a.scale = scale;
  const unsigned blocks = (unsigned)((size_t)*partials * nh);
  switch (hd) {
    case 16: return launch_core<16>(a, smem, blocks, stream);
    case 32: return launch_core<32>(a, smem, blocks, stream);
    case 48: return launch_core<48>(a, smem, blocks, stream);
    case 64: return launch_core<64>(a, smem, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vadcl

extern "C" {

// Windows one block of the bf16 backward core takes, given the windows that
// share a mask; 0: the direct layout.
int vadcl_window_attn_bwd_rows_group(int n, int c, int nh, int per_class) {
  if (nh <= 0 || c % nh) return 0;
  return vadcl::rows_bwd_group(n, c / nh, per_class);
}

// Shared memory of one block of the bf16 backward core at `group` windows a
// block (0: the direct layout).
long long vadcl_window_attn_bwd_rows_group_smem_bytes(int n, int c, int nh, int group) {
  if (nh <= 0 || c % nh) return 0;
  return (long long)vadcl::rows_bwd_layout(n, c / nh, group).bytes;
}

}  // extern "C"
