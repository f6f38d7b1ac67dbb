// Device code shared by the row-tiled window attention kernels
// (window_attn_rows.cu, window_attn_bwd_rows.cu): the bf16 cores' strip of 16
// query rows (scores with bias and mask, the running softmax statistics, the
// probabilities) and the token-wise products of both.
#pragma once

#include "mma.cuh"

namespace vadcl {

constexpr int kRowsThreads = 256;  // the attention cores: eight warps
constexpr int kRowsWarps = kRowsThreads / kWarp;

// A window's rows padded to whole 16-row strips.
__host__ __device__ inline int rows_padded(int n) { return (n + 15) / 16 * 16; }

// Widths the bf16 cores take: head widths 16, 32, 48 and 64.
inline bool rows_bf16_eligible(int c, int nh) {
  if (nh <= 0 || c % nh || c % 16) return false;
  const int hd = c / nh;
  return hd % 16 == 0 && hd <= 64;
}

// --- the bf16 attention cores' strip of 16 query rows (lane = 4 g + t holds
// rows i0 = 16 strip + g and i1 = i0 + 8 in mma.sync's C layout) ----------------

// The 16 x 16 score block of keys 16 kb .. 16 kb + 15: s = (q . k^T) * smul +
// bias + mask in fp32 from the strip's q fragments and the head's K tile
// (Np rows of ld elements, [key][d]); keys past the window -inf, rows past it
// 0 over the real keys.
template <int kKs>
__device__ __forceinline__ void rows_scores(const uint32_t (&qf)[kKs][4],
                                            const __nv_bfloat16* ks, int ld, int kb, int i0,
                                            int i1, int N, float smul, const float* bias,
                                            const float* mask, int lane, float (&s)[2][4]) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int k = 0; k < kKs; ++k) {
    uint32_t kf[4];
    ldsm_x4(kf, b_frag_row_nk(ks + (size_t)kb * 16 * ld + k * 16, ld, lane));
    mma_bf16(s[0], qf[k], kf[0], kf[1]);
    mma_bf16(s[1], qf[k], kf[2], kf[3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? i0 : i1, j = kb * 16 + nt * 8 + 2 * t + (e & 1);
      float v = -INFINITY;
      if (j < N) {
        v = 0.f;
        if (i < N) {
          v = s[nt][e] * smul + bias[(size_t)i * N + j];
          if (mask != nullptr) v += mask[(size_t)i * N + j];
        }
      }
      s[nt][e] = v;
    }
}

// The first walk over the keys: the running max m and the sum l rescaled to
// it (the FlashAttention rescale) of the strip's two rows, reduced over the
// quad that shares a row.
template <int kKs>
__device__ __forceinline__ void rows_stats(const uint32_t (&qf)[kKs][4], const __nv_bfloat16* ks,
                                           int ld, int nblk, int i0, int i1, int N, float smul,
                                           const float* bias, const float* mask, int lane,
                                           float (&m)[2], float (&l)[2]) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int kb = 0; kb < nblk; ++kb) {
    float s[2][4];
    rows_scores<kKs>(qf, ks, ld, kb, i0, i1, N, smul, bias, mask, lane, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float b = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]), fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 1));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 2));
      const float n = fmaxf(m[r], b);
      l[r] = l[r] * ex2_ftz((m[r] - n) * kLog2e) + ex2_ftz((s[0][2 * r] - n) * kLog2e) +
             ex2_ftz((s[0][2 * r + 1] - n) * kLog2e) + ex2_ftz((s[1][2 * r] - n) * kLog2e) +
             ex2_ftz((s[1][2 * r + 1] - n) * kLog2e);
      m[r] = n;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// p = e / l (kPacked: e * (1 / l)) of a score block, e = 2^((s - m) log2 e)
// flushed to zero, the division fa_div; rinv = 1 / l.
template <bool kPacked>
__device__ __forceinline__ void rows_probs(const float (&s)[2][4], const float (&m)[2],
                                           const float (&l)[2], const float (&rinv)[2],
                                           float (&p)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float ex = ex2_ftz((s[nt][e] - m[r]) * kLog2e);
      p[nt][e] = kPacked ? ex * rinv[r] : fa_div(ex, l[r], rinv[r]);
    }
}

// The strip's rows g and g + 8 of a 16 x kHd fp32 accumulator, rounded, into
// columns col0 .. of rows i0, i1 (those inside the window) of dst (ld elements).
template <int kHt>
__device__ __forceinline__ void strip_store(const float (&acc)[kHt][4], __nv_bfloat16* dst,
                                            size_t ld, int i0, int i1, int N, int col0, int t) {
#pragma unroll
  for (int i = 0; i < kHt; ++i) {
    const int col = col0 + i * 8 + 2 * t;
    if (i0 < N)
      *reinterpret_cast<uint32_t*>(dst + (size_t)i0 * ld + col) = pack_bf16(acc[i][0], acc[i][1]);
    if (i1 < N)
      *reinterpret_cast<uint32_t*>(dst + (size_t)i1 * ld + col) = pack_bf16(acc[i][2], acc[i][3]);
  }
}

// A 16 x 16 fp32 block in C layout, rounded to bf16, as the A fragment of the
// next product's 16-deep step (mma.cuh's header).
__device__ __forceinline__ void rows_a_frag(const float (&v)[2][4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(v[0][0], v[0][1]);
  a[1] = pack_bf16(v[0][2], v[0][3]);
  a[2] = pack_bf16(v[1][0], v[1][1]);
  a[3] = pack_bf16(v[1][2], v[1][3]);
}

// --- the token-wise products --------------------------------------------------
//   out[T, Nc] = round(A[T, K] . B[K, Nc] (+ bias[Nc])),
// the first `scale_cols` columns multiplied by `scale` before the rounding
// (kernel 9's q).  A and B are row-major and contiguous, bias fp32 or null,
// the sum fp32; `round` is the cast to the compute dtype.
//
// bf16: a block of four warps owns a 64 x 64 output tile; 64-deep slices of
// A and B are staged in shared memory (rows padded by 8 elements, so ldmatrix
// reads no bank twice) and each warp runs mma.sync.m16n8k16 on its 16 rows
// (warp_gemm_16xn).  Needs K and Nc to be multiples of 16 and 16-byte aligned
// rows.  fp32: the classic 64 x 64 tile on CUDA cores, 16-deep slices, four
// by four outputs a thread, any width.  Both are simple: what bounds them is
// one barrier pair per slice and no overlap of loads with products.
constexpr int kRgTile = 64;            // output rows and columns of a block
constexpr int kRgDepth = 64;           // bf16: depth staged per step
constexpr int kRgLd = kRgDepth + 8;    // bf16: padded shared-memory row
constexpr int kRgBf16Threads = 128;
constexpr int kRgF32Depth = 16;
constexpr int kRgF32Threads = 256;

template <int kDummy = 0>
__global__ void __launch_bounds__(kRgBf16Threads)
    rows_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int T,
                          int K, int Nc, int scale_cols, float scale) {
  using bf16 = __nv_bfloat16;
  __shared__ __align__(16) bf16 as[kRgTile * kRgLd];
  __shared__ __align__(16) bf16 bs[kRgDepth * kRgLd];
  const int r0 = blockIdx.x * kRgTile, c0 = blockIdx.y * kRgTile;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  constexpr int kVec = kRgDepth / 8;  // 16-byte vectors per staged row
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += kRgDepth) {
    const int kc = min(kRgDepth, K - k0);  // a multiple of 16
    for (int e = tid; e < kRgTile * kVec; e += kRgBf16Threads) {
      const int r = e / kVec, v = e % kVec;
      uint4 val = zero;
      if (r0 + r < T && v * 8 < kc)
        val = *reinterpret_cast<const uint4*>(A + (size_t)(r0 + r) * K + k0 + v * 8);
      *reinterpret_cast<uint4*>(as + r * kRgLd + v * 8) = val;
    }
    for (int e = tid; e < kRgDepth * kVec; e += kRgBf16Threads) {
      const int k = e / kVec, v = e % kVec;
      uint4 val = zero;
      if (k < kc && c0 + v * 8 < Nc)
        val = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + k) * Nc + c0 + v * 8);
      *reinterpret_cast<uint4*>(bs + k * kRgLd + v * 8) = val;
    }
    __syncthreads();
    warp_gemm_16xn<8>(as + warp * 16 * kRgLd, kRgLd, bs, kRgLd, kc, lane, acc);
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
  const int i0 = r0 + warp * 16 + g, i1 = i0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    if (col >= Nc) continue;
    float bx = 0.f, by = 0.f;
    if (bias != nullptr) bx = bias[col], by = bias[col + 1];
    const float mx = col < scale_cols ? scale : 1.f, my = col + 1 < scale_cols ? scale : 1.f;
    if (i0 < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)i0 * Nc + col) =
          pack_bf16((acc[j][0] + bx) * mx, (acc[j][1] + by) * my);
    if (i1 < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)i1 * Nc + col) =
          pack_bf16((acc[j][2] + bx) * mx, (acc[j][3] + by) * my);
  }
}

template <int kDummy = 0>
__global__ void __launch_bounds__(kRgF32Threads)
    rows_gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                         const float* __restrict__ bias, float* __restrict__ out, int T, int K,
                         int Nc, int scale_cols, float scale) {
  __shared__ float as[kRgF32Depth][kRgTile + 1];  // [k][row]
  __shared__ float bs[kRgF32Depth][kRgTile];      // [k][col]
  const int r0 = blockIdx.x * kRgTile, c0 = blockIdx.y * kRgTile;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kRgF32Depth) {
    for (int e = tid; e < kRgTile * kRgF32Depth; e += kRgF32Threads) {
      const int r = e / kRgF32Depth, k = e % kRgF32Depth;
      as[k][r] = (r0 + r < T && k0 + k < K) ? A[(size_t)(r0 + r) * K + k0 + k] : 0.f;
      const int kb = e / kRgTile, c = e % kRgTile;
      bs[kb][c] = (k0 + kb < K && c0 + c < Nc) ? B[(size_t)(k0 + kb) * Nc + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRgF32Depth; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][tr + 16 * i], bv[i] = bs[k][tc + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr + 16 * i;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc + 16 * j;
      if (c >= Nc) continue;
      float v = acc[i][j] + (bias != nullptr ? bias[c] : 0.f);
      if (c < scale_cols) v *= scale;
      out[(size_t)r * Nc + c] = v;
    }
  }
}

// out = round(A . B (+ bias)) as above, on `stream`; is_bf16 picks the
// compute dtype of A, B and out.
inline cudaError_t launch_rows_gemm(const void* A, const void* B, const float* bias, void* out,
                                    int T, int K, int Nc, int scale_cols, float scale,
                                    int is_bf16, cudaStream_t stream) {
  if (T <= 0 || K <= 0 || Nc <= 0) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((T + kRgTile - 1) / kRgTile),
                  (unsigned)((Nc + kRgTile - 1) / kRgTile));
  if (is_bf16) {
    if (K % 16 || Nc % 16) return cudaErrorInvalidValue;
    rows_gemm_bf16_kernel<<<grid, kRgBf16Threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B), bias,
        static_cast<__nv_bfloat16*>(out), T, K, Nc, scale_cols, scale);
  } else {
    rows_gemm_f32_kernel<<<grid, kRgF32Threads, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), bias,
        static_cast<float*>(out), T, K, Nc, scale_cols, scale);
  }
  return cudaGetLastError();
}

}  // namespace vadcl
