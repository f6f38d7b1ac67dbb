// Device code shared by the row-tiled window attention kernels
// (window_attn_rows.cu, window_attn_bwd_rows.cu and their bf16 cores): the
// widths the bf16 cores take, the streamed CUDA-core cores' chunk, a strip's
// output stores and A fragments, and the token-wise products of both
// directions.
#pragma once

#include "mma.cuh"

namespace vadcl {

constexpr int kRowsThreads = 256;  // the attention cores: eight warps
constexpr int kRowsWarps = kRowsThreads / kWarp;
// Channels of a head a chunk of the streamed CUDA-core cores holds
// (rows_attn_stream_kernel, rows_bwd_stream_kernel): a lane's channel of the
// p . v and gradient sums.
constexpr int kRsDepth = 32;

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
// the sum fp32; `round` is the cast to the compute dtype.  bf16 at K and Nc
// multiples of 16: window_attn_rows_mma.cu's rows_fwd_gemm_kernel.  fp32,
// and bf16 at other widths (an embed_dim 24 model's C = 24):
// rows_gemm_f32_kernel<T>, the classic 64 x 64 tile on CUDA cores, 16-deep
// slices, four by four outputs a thread, any width, fp32 arithmetic on T
// loads; what bounds it is one barrier pair per slice and no overlap of loads
// with products.
constexpr int kRgTile = 64;  // output rows and columns of a block
constexpr int kRgF32Depth = 16;
constexpr int kRgF32Threads = 256;

cudaError_t launch_rows_fwd_gemm(const void* A, const void* B, const float* bias, void* out,
                                 int T, int K, int Nc, int scale_cols, float scale,
                                 cudaStream_t stream);

template <typename E>
__global__ void __launch_bounds__(kRgF32Threads)
    rows_gemm_f32_kernel(const E* __restrict__ A, const E* __restrict__ B,
                         const float* __restrict__ bias, E* __restrict__ out, int T, int K,
                         int Nc, int scale_cols, float scale) {
  __shared__ float as[kRgF32Depth][kRgTile + 1];  // [k][row]
  __shared__ float bs[kRgF32Depth][kRgTile];      // [k][col]
  const int r0 = blockIdx.x * kRgTile, c0 = blockIdx.y * kRgTile;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kRgF32Depth) {
    for (int e = tid; e < kRgTile * kRgF32Depth; e += kRgF32Threads) {
      const int r = e / kRgF32Depth, k = e % kRgF32Depth;
      as[k][r] = (r0 + r < T && k0 + k < K) ? to_f(A[(size_t)(r0 + r) * K + k0 + k]) : 0.f;
      const int kb = e / kRgTile, c = e % kRgTile;
      bs[kb][c] = (k0 + kb < K && c0 + c < Nc) ? to_f(B[(size_t)(k0 + kb) * Nc + c0 + c]) : 0.f;
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
      out[(size_t)r * Nc + c] = from_f<E>(v);
    }
  }
}

// out = round(A . B (+ bias)) as above, on `stream`; is_bf16 picks the
// compute dtype of A, B and out.
inline cudaError_t launch_rows_gemm(const void* A, const void* B, const float* bias, void* out,
                                    int T, int K, int Nc, int scale_cols, float scale,
                                    int is_bf16, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (T <= 0 || K <= 0 || Nc <= 0) return cudaErrorInvalidValue;
  if (is_bf16 && K % 16 == 0 && Nc % 16 == 0)
    return launch_rows_fwd_gemm(A, B, bias, out, T, K, Nc, scale_cols, scale, stream);
  const dim3 grid((unsigned)((T + kRgTile - 1) / kRgTile),
                  (unsigned)((Nc + kRgTile - 1) / kRgTile));
  if (is_bf16)
    rows_gemm_f32_kernel<bf16><<<grid, kRgF32Threads, 0, stream>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(B), bias, static_cast<bf16*>(out),
        T, K, Nc, scale_cols, scale);
  else
    rows_gemm_f32_kernel<float><<<grid, kRgF32Threads, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), bias,
        static_cast<float*>(out), T, K, Nc, scale_cols, scale);
  return cudaGetLastError();
}

}  // namespace vadcl
