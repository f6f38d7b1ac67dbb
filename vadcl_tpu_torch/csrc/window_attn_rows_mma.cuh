// The bf16 row-tiled window attention forward (kernels 7 and 9,
// window_attn_rows_mma.cu): the attention core's shared-memory layout, the
// group of windows one block takes and the launch of the core, for
// window_attn_rows.cu; and the device code of a 16-row strip against a
// head's tile that the row-tiled backward (window_attn_bwd_rows_mma.cu)
// shares.
#pragma once

#include "window_rows.cuh"

namespace vadcl {

// Warps of one block: 16 at head widths 16 and 32 (117-128 registers a
// thread), 8 at 48 and 64 (139-157).
__host__ __device__ constexpr int rows_mma_warps(int hd) { return hd <= 32 ? 16 : 8; }

// Byte offsets of one block's shared memory for windows of n tokens, head
// width hd and `group` windows a block:
//   kv   K and V of the head of each window of the group, [Np][hd] bf16 each,
//        16-byte chunks swizzled (rm_swz), no padding;
//   t    the strip's 16 rows of (bias + mask) * log2(e), fp32, rows of Np + 8;
//   raw  the next strip's bias rows and mask rows as copied, [16][Np] fp32 each;
//   ml   each warp's running max and sum of its two rows, 16 float2 a warp;
//   op   each warp's partial output strip, [16][hd + 8] fp32 a warp.
// `group` 0 is the direct layout, for windows no group fits: K and V of one
// window's head in rows padded to hd + 8 and nothing else (the scores read
// bias and mask from device memory); every offset is its size.
struct RowsMmaLayout {
  size_t kv, t, raw, ml, op, bytes;
};

__host__ __device__ inline RowsMmaLayout rows_mma_layout(int n, int hd, int group) {
  const size_t np = rows_padded(n);
  RowsMmaLayout l;
  l.kv = 0;
  if (group == 0) {
    l.t = l.raw = l.ml = l.op = l.bytes = 2 * np * (hd + 8) * 2;
    return l;
  }
  l.t = (size_t)group * 2 * np * hd * 2;
  l.raw = l.t + 16 * (np + 8) * 4;
  l.ml = l.raw + 2 * 16 * np * 4;
  l.op = l.ml + (size_t)rows_mma_warps(hd) * 16 * 8;
  l.bytes = l.op + (size_t)rows_mma_warps(hd) * 16 * (hd + 8) * 4;
  return l;
}

// Windows a block takes: the largest of 8, 4, 2, 1 that is at most
// `per_class` (the windows that share one mask) and whose layout fits 227 KB;
// 0 (the direct layout, one window a block) where not even one window fits.
inline int rows_mma_group(int n, int hd, int per_class) {
  for (int g = 8; g >= 1; g /= 2)
    if (g <= per_class && rows_mma_layout(n, hd, g).bytes <= (size_t)kMaxSmemBytes) return g;
  return 0;
}

// --- a 16-row strip against a head's tile of a window (forward and backward) ---
// The strip's fragments are mma.sync's A layout (lane = 4 g + t holds rows g,
// g + 8); a tile is [Np][kHd] bf16 in shared memory, 16-byte chunks swizzled
// (rm_swz) or, with kPad, rows padded to kHd + 8.

// Physical 16-byte chunk of logical chunk c of row r in a [Np][kHd] bf16 tile:
// the 8 rows an ldmatrix reads at one logical chunk land on 8 different bank
// groups.  kPad: the direct layout's rows padded to kHd + 8 instead.
template <int kHd>
__device__ __forceinline__ int rm_swz(int r, int c) {
  if constexpr (kHd == 32) return c ^ ((r >> 1) & 3);
  else if constexpr (kHd == 64) return c ^ (r & 7);
  else return c ^ ((r >> 2) & 1);  // 16, 48
}

template <int kHd, bool kPad>
__device__ __forceinline__ const __nv_bfloat16* rm_at(const __nv_bfloat16* tile, int r, int c) {
  if constexpr (kPad) return tile + r * (kHd + 8) + c * 8;
  else return tile + r * kHd + rm_swz<kHd>(r, c) * 8;
}

// (bias + mask) * log2 e at keys col, col + 1 of the strip's rows g (a) and
// g + 8 (b); keys past the window -inf, rows past it 0 over the real keys.
// From the strip's tile in shared memory (t0, t1: its rows g and g + 8) ...
struct RmTileBM {
  const float *t0, *t1;
  __device__ __forceinline__ void operator()(int col, float2& a, float2& b) const {
    a = *reinterpret_cast<const float2*>(t0 + col);
    b = *reinterpret_cast<const float2*>(t1 + col);
  }
};

// ... or from device memory (the direct layout), rows i0 and i1 of the
// head's bias and the window's mask, summed and scaled as the tile is.
struct RmGlobalBM {
  const float *bias, *mask;
  int i0, i1, N;
  __device__ __forceinline__ float at(int i, int j) const {
    if (j >= N) return -INFINITY;
    if (i >= N) return 0.f;
    float v = __ldg(bias + (size_t)i * N + j);
    if (mask != nullptr) v += __ldg(mask + (size_t)i * N + j);
    return v * kLog2e;
  }
  __device__ __forceinline__ void operator()(int col, float2& a, float2& b) const {
    a = make_float2(at(i0, col), at(i0, col + 1));
    b = make_float2(at(i1, col), at(i1, col + 1));
  }
};

// s (16 x 16 fp32, C layout) = the strip . rows kb * 16 .. + 15 of the tile,
// transposed (q . k^T, do . v^T; the backward's k . q^T, v . do^T).
template <int kHd, bool kPad>
__device__ __forceinline__ void rm_dot(const uint32_t (&af)[kHd / 16][4],
                                       const __nv_bfloat16* tile, int kb, int lane,
                                       float (&s)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const int r = kb * 16 + (lane & 7) + (lane >> 4) * 8, c = (lane >> 3) & 1;
#pragma unroll
  for (int k = 0; k < kHd / 16; ++k) {
    uint32_t kf[4];
    ldsm_x4(kf, rm_at<kHd, kPad>(tile, r, 2 * k + c));
    mma_bf16(s[0], af[k], kf[0], kf[1]);
    mma_bf16(s[1], af[k], kf[2], kf[3]);
  }
}

// acc (16 x kHd fp32) += a (a 16 x 16 block as the A fragment) . rows
// kb * 16 .. + 15 of the tile (p . v; the backward's dss . k, dss^T . q,
// p^T . do).
template <int kHd, bool kPad>
__device__ __forceinline__ void rm_acc(const uint32_t (&a)[4], const __nv_bfloat16* tile, int kb,
                                       int lane, float (&acc)[kHd / 8][4]) {
  const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc = lane >> 4;
#pragma unroll
  for (int nq = 0; nq < kHd / 16; ++nq) {
    uint32_t vf[4];
    ldsm_x4_t(vf, rm_at<kHd, kPad>(tile, kb * 16 + vr, 2 * nq + vc));
    mma_bf16(acc[2 * nq], a, vf[0], vf[1]);
    mma_bf16(acc[2 * nq + 1], a, vf[2], vf[3]);
  }
}

// v' of the strip's 16 x 16 block kb: q . k^T by mma, then
// fma(s, smul, (bias + mask) log2 e).
template <int kHd, bool kPad, class BM>
__device__ __forceinline__ void rm_scores(const uint32_t (&qf)[kHd / 16][4],
                                          const __nv_bfloat16* ks, const BM& bm, int kb,
                                          float smul, int lane, float (&v)[2][4]) {
  float s[2][4];
  rm_dot<kHd, kPad>(qf, ks, kb, lane, s);
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float2 a, b;
    bm(kb * 16 + nt * 8 + 2 * t, a, b);
    v[nt][0] = fmaf(s[nt][0], smul, a.x);
    v[nt][1] = fmaf(s[nt][1], smul, a.y);
    v[nt][2] = fmaf(s[nt][2], smul, b.x);
    v[nt][3] = fmaf(s[nt][3], smul, b.y);
  }
}

// The A fragments of strip s's rows g and g + 8 of a window's head slice in
// device memory (zeros past the window); q0 points at the window's first
// token's slice, rows ld elements apart.
template <int kKs>
__device__ __forceinline__ void rm_load_q(const __nv_bfloat16* q0, int ld, int s, int N, int lane,
                                          uint32_t (&qf)[kKs][4]) {
  const int i0 = s * 16 + (lane >> 2), i1 = i0 + 8;
  const __nv_bfloat16* p0 = q0 + (size_t)i0 * ld + 2 * (lane & 3);
  const __nv_bfloat16* p1 = q0 + (size_t)i1 * ld + 2 * (lane & 3);
#pragma unroll
  for (int k = 0; k < kKs; ++k) {
    qf[k][0] = i0 < N ? *reinterpret_cast<const uint32_t*>(p0 + k * 16) : 0u;
    qf[k][1] = i1 < N ? *reinterpret_cast<const uint32_t*>(p1 + k * 16) : 0u;
    qf[k][2] = i0 < N ? *reinterpret_cast<const uint32_t*>(p0 + k * 16 + 8) : 0u;
    qf[k][3] = i1 < N ? *reinterpret_cast<const uint32_t*>(p1 + k * 16 + 8) : 0u;
  }
}

// o = attention(qkv) per (window, head), bf16, on `stream`: kernel 7's
// arithmetic, or with `packed` kernel 9's (q already scaled, p = e * (1 / l)).
cudaError_t launch_rows_mma_core(const void* qkv, void* o, const float* bias, const float* mask,
                                 int Bn, int N, int C, int nh, int nW, float scale, bool packed,
                                 cudaStream_t stream);

}  // namespace vadcl
