// The bf16 attention core of the row-tiled window attention forward: kernels 7
// and 9 (vadcl_tpu/ops/pallas_attn.py:_attn_kernel and _attn_kernel_packed)
// for windows the whole-tile body (window_attn.cu) cannot hold, e.g. N = 196
// and N = 392 (windows (4, 7, 7) and (8, 7, 7) of 8-frame reconstruction
// clips).  window_attn_rows.cu runs the qkv product before it and the
// projection after it; this launch reads q, k, v from the qkv workspace and
// writes o = round(p . v) per head:
//   v' = s * (scale * log2 e) + (bias[h] + mask[w]) * log2 e   (kernel 9: s
//        of the pre-scaled q, times log2 e), fp32, s = q . k^T;
//   m = max v' over the keys, l = sum 2^(v' - m) (2^ flushed to zero below
//   the smallest normal), p = round(e / l) by fa_div (kernel 9: e * (1 / l)).
// The softmax in base 2 on scores pre-multiplied by log2 e is the natural
// one's to fp32 rounding; bias and mask are summed before the score is added
// (JAX adds the score to the bias first): one fp32 rounding apart, held by
// tests/test_torch_port_rows_mma.py against the plain version and the Pallas
// kernel.
//
// What bounded the body it replaces (rows_attn_bf16_kernel, one block per
// window and head): every score read its bias and mask from device memory in
// both of its walks over the keys, 8 bytes a score twice, 15 GB a call at
// (1024, 392, 96) / 6 heads, half of each sector unused.  Here:
//   * one block takes a head h, a mask index w and a group of G windows that
//     share w (w, w + nW, ...; without a mask any G windows): K and V of the
//     head of all G windows sit in shared memory (16-byte chunks swizzled
//     against bank conflicts instead of padded rows, so four windows fit at
//     N = 392, head width 16);
//   * the block walks the 16-row query strips in order.  A strip's bias and
//     mask rows are copied once by cp.async (16-byte copies where N % 4 == 0),
//     during the strip before, summed and scaled into one fp32 tile, and read
//     by every window of the group in both walks: device-memory traffic for
//     them falls by G, and no score reads device memory;
//   * the block's W warps (16 at head widths 16 and 32, 8 at 48 and 64)
//     split the strip's work: W / G warps a window, each taking every
//     (W / G)-th key block; the partial running maxima and sums are merged in
//     warp order through shared memory, then the partial p . v strips, summed
//     in the same fixed order, so two calls give the same bits;
//   * walk 1 takes its key blocks two at a time, one rescale of the running
//     sum per 32 keys.  Two walks remain (2^ twice a score): a strip's raw
//     scores (16 x 400 fp32 at N = 392: 25.6 KB a warp) do not fit shared
//     memory beside K and V, and a variant holding them in registers (one 2^
//     a score, 8 warps) was no faster at N = 392 on an H100.
// G is the largest of 8, 4, 2, 1 that fits 227 KB (rows_mma_layout): 8 at
// N = 196 and 4 at N = 392 at head width 16; 1 at N = 392, head width 64.
// Windows that not even one fits with its strip's tile (N above 800, 576,
// 512, 432 at head widths 16, 32, 48, 64) take the direct layout
// (rows_attn_direct_kernel): K and V of one head in padded rows, a warp a
// strip, bias and mask read from device memory per score, the same walks.  It
// holds every window the body before it held (N up to 2416, 1440, 1024, 800).
// Products are mma.sync.m16n8k16 with scores, probabilities and the output
// strip in registers.  What bounds it now is not one unit: at (1024, 392, 96)
// / 6 heads, builds without the 2^, without the tile's reads, without
// q . k^T or without p . v each ran barely faster: the warps' dependent
// chains (mma, max, shuffles, 2^, sums) with one block of 16 warps an SM.
#include "window_attn_rows_mma.cuh"

namespace vadcl {

namespace {

using bf16 = __nv_bfloat16;

struct RowsMmaArgs {
  const bf16* qkv;    // (Bn * N, 3C)
  bf16* o;            // (Bn * N, C)
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  int N, C, nh, nW;   // nW: mask indices (1 without a mask)
  int per_class;      // windows a mask index has: Bn / nW
  int group, groups;  // windows a block, blocks a (mask index, head)
  int vec;            // bias and mask rows copied 16 bytes at a time
  float smul;         // scale * log2 e (kernel 9: log2 e)
};

// Walk 1 over key blocks kb0, kb0 + step, ... two at a time (one rescale of
// the running sum per pair): the running max m and sum l of rows g, g + 8,
// l summed over the quad that shares a row.
template <int kHd, bool kPad, class BM>
__device__ __forceinline__ void rm_walk1(const uint32_t (&qf)[kHd / 16][4], const bf16* ks,
                                         const BM& bm, int nblk, int kb0, int step, float smul,
                                         int lane, float (&m)[2], float (&l)[2]) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll 2
  for (int kb = kb0; kb < nblk; kb += 2 * step) {
    float va[2][4], vb[2][4];
    rm_scores<kHd, kPad>(qf, ks, bm, kb, smul, lane, va);
    if (kb + step < nblk) {
      rm_scores<kHd, kPad>(qf, ks, bm, kb + step, smul, lane, vb);
    } else {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) vb[nt][0] = vb[nt][1] = vb[nt][2] = vb[nt][3] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float b = fmaxf(fmaxf(fmaxf(va[0][2 * r], va[0][2 * r + 1]),
                            fmaxf(va[1][2 * r], va[1][2 * r + 1])),
                      fmaxf(fmaxf(vb[0][2 * r], vb[0][2 * r + 1]),
                            fmaxf(vb[1][2 * r], vb[1][2 * r + 1])));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 1));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 2));
      const float n = fmaxf(m[r], b);
      float add = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        add += ex2_ftz(va[nt][2 * r] - n) + ex2_ftz(va[nt][2 * r + 1] - n);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        add += ex2_ftz(vb[nt][2 * r] - n) + ex2_ftz(vb[nt][2 * r + 1] - n);
      l[r] = l[r] * ex2_ftz(m[r] - n) + add;
      m[r] = n;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// Walk 2 over the same key blocks: p = round(e / l) (kernel 9: e * (1 / l)),
// oacc = p . V over them.
template <int kHd, bool kPad, bool PACKED, class BM>
__device__ __forceinline__ void rm_walk2(const uint32_t (&qf)[kHd / 16][4], const bf16* ks,
                                         const bf16* vs, const BM& bm, int nblk, int kb0,
                                         int step, float smul, int lane, const float (&m)[2],
                                         const float (&l)[2], float (&oacc)[kHd / 8][4]) {
  const float rinv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc = lane >> 4;
#pragma unroll 2
  for (int kb = kb0; kb < nblk; kb += step) {
    float v[2][4], p[2][4];
    rm_scores<kHd, kPad>(qf, ks, bm, kb, smul, lane, v);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float ex = ex2_ftz(v[nt][e] - m[r]);
        p[nt][e] = PACKED ? ex * rinv[r] : fa_div(ex, l[r], rinv[r]);
      }
    uint32_t pf[4];
    rows_a_frag(p, pf);
#pragma unroll
    for (int nq = 0; nq < kHd / 16; ++nq) {
      uint32_t vf[4];
      ldsm_x4_t(vf, rm_at<kHd, kPad>(vs, kb * 16 + vr, 2 * nq + vc));
      mma_bf16(oacc[2 * nq], pf, vf[0], vf[1]);
      mma_bf16(oacc[2 * nq + 1], pf, vf[2], vf[3]);
    }
  }
}

template <int kHd, bool PACKED>
__global__ void __launch_bounds__(rows_mma_warps(kHd) * kWarp, 1)
    rows_attn_mma_kernel(RowsMmaArgs a) {
  constexpr int kKs = kHd / 16, kHt = kHd / 8, kCh = kHd / 8, kOld = kHd + 8;
  constexpr int kWarps = rows_mma_warps(kHd), kThreads = kWarps * kWarp;
  extern __shared__ __align__(16) unsigned char sm[];
  const int N = a.N, C = a.C, C3 = 3 * C, Np = rows_padded(N), nblk = Np / 16, tld = Np + 8;
  const int G = a.group, Wu = kWarps / G;
  const RowsMmaLayout lay = rows_mma_layout(N, kHd, G);
  bf16* kv = reinterpret_cast<bf16*>(sm + lay.kv);
  float* tile = reinterpret_cast<float*>(sm + lay.t);
  float* rawb = reinterpret_cast<float*>(sm + lay.raw);
  float* rawm = rawb + 16 * Np;
  float2* ml = reinterpret_cast<float2*>(sm + lay.ml);
  float* op = reinterpret_cast<float*>(sm + lay.op);

  const int gi = blockIdx.x % a.groups, hw = blockIdx.x / a.groups;
  const int h = hw % a.nh, w = hw / a.nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int unit = warp / Wu, part = warp % Wu;  // window of the group, key phase
  const bool valid = gi * G + unit < a.per_class;
  const size_t win = (size_t)w + (size_t)a.nW * (gi * G + unit);
  const float* bias = a.bias + (size_t)h * N * N;
  const float* mask = a.mask != nullptr ? a.mask + (size_t)w * N * N : nullptr;

  // K and V of the group's windows: tile 2u + p (p = 0: K, 1: V); rows past
  // the window are zeros
  for (int tl = 0; tl < 2 * G; ++tl) {
    const int jj = gi * G + (tl >> 1);
    if (jj >= a.per_class) break;
    const bf16* src = a.qkv + ((size_t)w + (size_t)a.nW * jj) * N * C3 + (1 + (tl & 1)) * C +
                      h * kHd;
    bf16* dst = kv + (size_t)tl * Np * kHd;
    for (int e = tid; e < Np * kCh; e += kThreads) {
      const int r = e / kCh, c = e % kCh;
      cp_async16(dst + r * kHd + rm_swz<kHd>(r, c) * 8, src + (size_t)min(r, N - 1) * C3 + c * 8,
                 r < N);
    }
  }
  // strip s's bias and mask rows, as they are, into raw: a warp a row
  auto stage = [&](int s) {
    const int rows = min(16, N - s * 16);
    for (int r = warp; r < rows; r += kWarps) {
      const size_t at = (size_t)(s * 16 + r) * N;
      for (int m = 0; m < (mask != nullptr ? 2 : 1); ++m) {
        const float* src = (m ? mask : bias) + at;
        float* dst = (m ? rawm : rawb) + r * Np;
        if (a.vec) {
          for (int v = 4 * lane; v < N; v += 4 * kWarp) cp_async16(dst + v, src + v, true);
        } else {
          for (int c = lane; c < N; c += kWarp) cp_async4(dst + c, src + c, true);
        }
      }
    }
  };
  // raw -> tile: (bias + mask) * log2 e; keys past the window -inf, rows past
  // it 0 over the real keys
  auto combine = [&](int s) {
    for (int r = warp; r < 16; r += kWarps) {
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
  stage(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  combine(0);
  __syncthreads();

  const bf16* ks = kv + (size_t)2 * unit * Np * kHd;
  const bf16* vs = ks + (size_t)Np * kHd;
  const RmTileBM bm{tile + g * tld, tile + (g + 8) * tld};
  bf16* o = a.o + win * N * C;
  const bf16* q0 = a.qkv + win * N * C3 + h * kHd;
  uint32_t qf[kKs][4], qn[kKs][4];
  if (valid) rm_load_q<kKs>(q0, C3, 0, N, lane, qf);
  for (int s = 0; s < nblk; ++s) {
    if (s + 1 < nblk) stage(s + 1);
    cp_async_commit();
    const int i0 = s * 16 + g, i1 = i0 + 8;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float oacc[kHt][4];
    if (valid) {
      if (s + 1 < nblk) rm_load_q<kKs>(q0, C3, s + 1, N, lane, qn);  // in flight during the walks
      rm_walk1<kHd, false>(qf, ks, bm, nblk, part, Wu, a.smul, lane, m, l);
    }
    if (Wu > 1) {  // the window's Wu partial (m, l), merged in warp order
      if (valid && t == 0) {
        ml[warp * 16 + g] = make_float2(m[0], l[0]);
        ml[warp * 16 + g + 8] = make_float2(m[1], l[1]);
      }
      __syncthreads();
      if (valid) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2* pm = ml + unit * Wu * 16 + g + 8 * r;
          float mx = pm[0].x;
          for (int q = 1; q < Wu; ++q) mx = fmaxf(mx, pm[q * 16].x);
          float sum = 0.f;
          for (int q = 0; q < Wu; ++q) sum += pm[q * 16].y * ex2_ftz(pm[q * 16].x - mx);
          m[r] = mx;
          l[r] = sum;
        }
      }
    }
    if (valid) rm_walk2<kHd, false, PACKED>(qf, ks, vs, bm, nblk, part, Wu, a.smul, lane, m, l, oacc);
    if (Wu > 1) {  // the window's Wu partial strips, summed in warp order
      if (valid) {
        float* mine = op + (size_t)warp * 16 * kOld;
#pragma unroll
        for (int i = 0; i < kHt; ++i) {
          const int col = i * 8 + 2 * t;
          *reinterpret_cast<float2*>(mine + g * kOld + col) = make_float2(oacc[i][0], oacc[i][1]);
          *reinterpret_cast<float2*>(mine + (g + 8) * kOld + col) =
              make_float2(oacc[i][2], oacc[i][3]);
        }
      }
      __syncthreads();
      if (valid) {
        const float* first = op + (size_t)unit * Wu * 16 * kOld;
        for (int e = part * kWarp + lane; e < 16 * kHd / 2; e += Wu * kWarp) {
          const int r = e / (kHd / 2), col = 2 * (e % (kHd / 2));
          if (s * 16 + r >= N) continue;
          float2 acc = *reinterpret_cast<const float2*>(first + r * kOld + col);
          for (int q = 1; q < Wu; ++q) {
            const float2 v = *reinterpret_cast<const float2*>(first + (q * 16 + r) * kOld + col);
            acc.x += v.x;
            acc.y += v.y;
          }
          *reinterpret_cast<uint32_t*>(o + (size_t)(s * 16 + r) * C + h * kHd + col) =
              pack_bf16(acc.x, acc.y);
        }
      }
    } else if (valid) {
      strip_store<kHt>(oacc, o, C, i0, i1, N, h * kHd, t);
    }
#pragma unroll
    for (int k = 0; k < kKs; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[k][e] = qn[k][e];
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < nblk) {
      combine(s + 1);
      __syncthreads();
    }
  }
}

// The direct layout, for windows whose K and V beside one strip's tile fit no
// block (rows_mma_group 0: N above 800, 576, 512, 432 at head widths 16, 32,
// 48, 64): one block per (window, head), K and V in padded rows, each of the
// kRowsWarps warps a whole strip (every kRowsWarps-th), both walks over every
// key block, bias and mask read from device memory per score.  The same
// arithmetic as the staged kernel at one warp a window.
template <int kHd, bool PACKED>
__global__ void __launch_bounds__(kRowsThreads) rows_attn_direct_kernel(RowsMmaArgs a) {
  constexpr int kKs = kHd / 16, kHt = kHd / 8, kCh = kHd / 8, kLd = kHd + 8;
  extern __shared__ __align__(16) unsigned char sm[];
  const int N = a.N, C = a.C, C3 = 3 * C, Np = rows_padded(N), nblk = Np / 16;
  const int win = blockIdx.x / a.nh, h = blockIdx.x % a.nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  bf16* ks = reinterpret_cast<bf16*>(sm);
  bf16* vs = ks + (size_t)Np * kLd;
  const bf16* q0 = a.qkv + (size_t)win * N * C3 + h * kHd;
  for (int e = tid; e < 2 * Np * kCh; e += kRowsThreads) {
    const int p = e / (Np * kCh), r = (e / kCh) % Np, c = e % kCh;
    cp_async16((p ? vs : ks) + r * kLd + c * 8, q0 + (size_t)min(r, N - 1) * C3 + (1 + p) * C + c * 8,
               r < N);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float* bias = a.bias + (size_t)h * N * N;
  const float* mask = a.mask != nullptr ? a.mask + (size_t)(win % a.nW) * N * N : nullptr;
  bf16* o = a.o + (size_t)win * N * C;
  for (int s = warp; s < nblk; s += kRowsWarps) {
    const int i0 = s * 16 + (lane >> 2), i1 = i0 + 8;
    const RmGlobalBM bm{bias, mask, i0, i1, N};
    uint32_t qf[kKs][4];
    rm_load_q<kKs>(q0, C3, s, N, lane, qf);
    float m[2], l[2], oacc[kHt][4];
    rm_walk1<kHd, true>(qf, ks, bm, nblk, 0, 1, a.smul, lane, m, l);
    rm_walk2<kHd, true, PACKED>(qf, ks, vs, bm, nblk, 0, 1, a.smul, lane, m, l, oacc);
    strip_store<kHt>(oacc, o, C, i0, i1, N, h * kHd, lane & 3);
  }
}

template <int kHd, bool PACKED>
cudaError_t launch_core(const RowsMmaArgs& a, size_t smem, unsigned blocks, cudaStream_t s) {
  if (a.group == 0) {
    const cudaError_t err = allow_smem(rows_attn_direct_kernel<kHd, PACKED>, smem);
    if (err != cudaSuccess) return err;
    rows_attn_direct_kernel<kHd, PACKED><<<blocks, kRowsThreads, smem, s>>>(a);
    return cudaGetLastError();
  }
  const cudaError_t err = allow_smem(rows_attn_mma_kernel<kHd, PACKED>, smem);
  if (err != cudaSuccess) return err;
  rows_attn_mma_kernel<kHd, PACKED><<<blocks, rows_mma_warps(kHd) * kWarp, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_core_hd(const RowsMmaArgs& a, int hd, size_t smem, unsigned blocks,
                           cudaStream_t s) {
  switch (hd) {
    case 16: return launch_core<16, PACKED>(a, smem, blocks, s);
    case 32: return launch_core<32, PACKED>(a, smem, blocks, s);
    case 48: return launch_core<48, PACKED>(a, smem, blocks, s);
    case 64: return launch_core<64, PACKED>(a, smem, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// --- the forward's token-wise products --------------------------------------
//   out[T, Nc] = round((A[T, K] . B[K, Nc] (+ bias[Nc])) * (scale on the first
//   scale_cols columns)), bf16 A, B, out, fp32 sum: the qkv product and the
//   projection, and (through window_rows.cuh:launch_rows_gemm) the backward's
//   qkv, dout . W_proj^T and dx products.  Bound by bytes (x 77 MB in, qkv 231 MB out at
//   (1024, 392, 96)); that kernel read A once per 64-column tile and stored
//   4 bytes a lane.  Here a block of four warps owns 64 rows and every column:
//   its A rows are copied once (cp.async), B walks past in 64-column chunks
//   through a two-stage cp.async ring, and each chunk's output goes through
//   shared memory to 16-byte stores, whole rows of 128 bytes.  Where K is
//   above kFgMaxK, A's rows are held in panels of kFgMaxK columns, each
//   chunk walks every panel in turn (A then is read once per chunk, as in the
//   old kernel), the sum taken in the same order of k.
constexpr int kFgRows = 64, kFgCols = 64, kFgThreads = 128, kFgLdb = kFgCols + 8;
constexpr int kFgMaxK = 512;

inline size_t fwd_gemm_smem(int K) {
  const size_t kp = K < kFgMaxK ? K : kFgMaxK;
  return (size_t)kFgRows * (kp + 8) * 2 + 2 * kp * kFgLdb * 2 + (size_t)kFgRows * kFgLdb * 2;
}

template <bool kPanels>  // K above kFgMaxK; false: one panel
__global__ void __launch_bounds__(kFgThreads)
    rows_fwd_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                         const float* __restrict__ bias, bf16* __restrict__ out, int T, int K,
                         int Nc, int scale_cols, float scale) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int KP = kPanels ? kFgMaxK : K, lda = KP + 8, panels = kPanels ? (K + KP - 1) / KP : 1;
  bf16* as = reinterpret_cast<bf16*>(sm);           // kFgRows x KP: A's panel
  bf16* bs = as + (size_t)kFgRows * lda;           // two stages of KP x kFgLdb
  bf16* os = bs + 2 * (size_t)KP * kFgLdb;         // kFgRows x kFgLdb
  const int r0 = blockIdx.x * kFgRows, tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int chunks = (Nc + kFgCols - 1) / kFgCols, steps = chunks * panels;
  auto load_a = [&](int p) {
    const int k0 = p * KP, kv = min(KP, K - k0) / 8;
    for (int e = tid; e < kFgRows * kv; e += kFgThreads) {
      const int r = e / kv, v = e % kv;
      cp_async16(as + r * lda + v * 8, A + (size_t)min(r0 + r, T - 1) * K + k0 + v * 8,
                 r0 + r < T);
    }
  };
  // step st's B (stage st & 1): rows k0 .. of the panel at chunk c0's columns
  auto load_b = [&](int st, int c0, int k0) {
    bf16* dst = bs + (size_t)(st & 1) * KP * kFgLdb;
    const int kp = min(KP, K - k0);
    for (int e = tid; e < kp * (kFgCols / 8); e += kFgThreads) {
      const int k = e / (kFgCols / 8), v = e % (kFgCols / 8);
      const bool ok = c0 + v * 8 < Nc;
      cp_async16(dst + k * kFgLdb + v * 8, B + (size_t)(k0 + k) * Nc + (ok ? c0 + v * 8 : 0), ok);
    }
  };
  load_a(0);
  load_b(0, 0, 0);
  cp_async_commit();
  const int g = lane >> 2, t = lane & 3;
  for (int j = 0, st = 0; j < chunks; ++j) {
    const int c0 = j * kFgCols;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int p = 0; p < panels; ++p, ++st) {
      const bool more = p + 1 < panels;  // step st + 1 is this chunk's next panel
      if (st + 1 < steps) load_b(st + 1, more ? c0 : c0 + kFgCols, more ? (p + 1) * KP : 0);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // A's panel p and step st's B landed; os free
      warp_gemm_16xn<8>(as + warp * 16 * lda, lda, bs + (size_t)(st & 1) * KP * kFgLdb, kFgLdb,
                        min(KP, K - p * KP), lane, acc);
      if (kPanels && st + 1 < steps) {
        __syncthreads();  // A's panel and B's stage st free
        load_a(more ? p + 1 : 0);  // waited for with step st + 1's B
        cp_async_commit();
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c0 + i * 8 + 2 * t;
      float bx = 0.f, by = 0.f;
      if (bias != nullptr && col < Nc) bx = bias[col], by = bias[col + 1];
      const float mx = col < scale_cols ? scale : 1.f, my = col + 1 < scale_cols ? scale : 1.f;
      const int r = warp * 16 + g;
      *reinterpret_cast<uint32_t*>(os + r * kFgLdb + i * 8 + 2 * t) =
          pack_bf16((acc[i][0] + bx) * mx, (acc[i][1] + by) * my);
      *reinterpret_cast<uint32_t*>(os + (r + 8) * kFgLdb + i * 8 + 2 * t) =
          pack_bf16((acc[i][2] + bx) * mx, (acc[i][3] + by) * my);
    }
    __syncthreads();  // os complete; (one panel) B's stage st free for step st + 2
    const int cv = min(kFgCols, Nc - c0) / 8;
    for (int e = tid; e < kFgRows * cv; e += kFgThreads) {
      const int r = e / cv, v = e % cv;
      if (r0 + r < T)
        *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * Nc + c0 + v * 8) =
            *reinterpret_cast<const uint4*>(os + r * kFgLdb + v * 8);
    }
  }
}

}  // namespace

cudaError_t launch_rows_fwd_gemm(const void* A, const void* B, const float* bias, void* out,
                                 int T, int K, int Nc, int scale_cols, float scale,
                                 cudaStream_t stream) {
  if (T <= 0 || K <= 0 || Nc <= 0 || K % 16 || Nc % 16) return cudaErrorInvalidValue;
  const size_t smem = fwd_gemm_smem(K);
  const auto kernel = K > kFgMaxK ? rows_fwd_gemm_kernel<true> : rows_fwd_gemm_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((T + kFgRows - 1) / kFgRows), kFgThreads, smem, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(B), bias, static_cast<bf16*>(out), T,
      K, Nc, scale_cols, scale);
  return cudaGetLastError();
}

cudaError_t launch_rows_mma_core(const void* qkv, void* o, const float* bias, const float* mask,
                                 int Bn, int N, int C, int nh, int nW, float scale, bool packed,
                                 cudaStream_t stream) {
  if (Bn <= 0 || N <= 0 || nh <= 0 || nW <= 0 || C % nh) return cudaErrorInvalidValue;
  const int hd = C / nh, classes = mask != nullptr ? nW : 1;
  if (Bn % classes) return cudaErrorInvalidValue;
  const int per = Bn / classes, G = rows_mma_group(N, hd, per);
  const size_t smem = rows_mma_layout(N, hd, G).bytes;
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const auto aligned16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  RowsMmaArgs a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.o = static_cast<bf16*>(o);
  a.bias = bias;
  a.mask = mask;
  a.N = N, a.C = C, a.nh = nh, a.nW = classes;
  a.per_class = per;
  a.group = G;
  a.groups = G ? (per + G - 1) / G : per;
  a.vec = N % 4 == 0 && aligned16(bias) && (mask == nullptr || aligned16(mask));
  a.smul = (packed ? 1.f : scale) * kLog2e;
  const unsigned blocks = (unsigned)((size_t)classes * nh * a.groups);
  return packed ? launch_core_hd<true>(a, hd, smem, blocks, stream)
                : launch_core_hd<false>(a, hd, smem, blocks, stream);
}

}  // namespace vadcl

extern "C" {

// Windows one block of the bf16 core takes, given the windows that share a
// mask; 0: the direct layout.
int vadcl_window_attn_rows_group(int n, int c, int nh, int per_class) {
  if (nh <= 0 || c % nh) return 0;
  return vadcl::rows_mma_group(n, c / nh, per_class);
}

// Shared memory of one block of the bf16 core at `group` windows a block (0:
// the direct layout).
long long vadcl_window_attn_rows_group_smem_bytes(int n, int c, int nh, int group) {
  if (nh <= 0 || c % nh) return 0;
  return (long long)vadcl::rows_mma_layout(n, c / nh, group).bytes;
}

}  // extern "C"
