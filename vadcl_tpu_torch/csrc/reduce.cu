// The deterministic second pass of the backward kernels (see reduce.cuh).
//
// atb_partial_kernel: one block per (32 x 32 output tile, chunk of
// kAtbChunk tokens); 32-token slices of A and B are staged in shared memory
// as fp32 and each thread accumulates four outputs.  sum_rows_kernel then
// adds the chunk partials in chunk order.  Both run on CUDA cores in fp32.
//
// What bounds it: the partial pass is fp32 FMA from shared memory (four
// outputs per thread, one staged slice per 32 tokens); the sum pass reads
// the partials once.  Left on the table: tensor cores for bf16 operands,
// larger register tiles, and fusing the sum into the last chunk's block.
#include "reduce.cuh"

namespace vadcl {

constexpr int kAtbTile = 32;
constexpr int kAtbThreads = 256;

template <typename TA, typename TB>
__global__ void __launch_bounds__(kAtbThreads)
    atb_partial_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                       float* __restrict__ partial, int T, int Ca, int Cb) {
  __shared__ float as[kAtbTile][kAtbTile + 1];
  __shared__ float bs[kAtbTile][kAtbTile + 1];
  const int b0 = blockIdx.x * kAtbTile, a0 = blockIdx.y * kAtbTile, chunk = blockIdx.z;
  const int t_begin = chunk * kAtbChunk, t_end = min(T, t_begin + kAtbChunk);
  const int tid = threadIdx.x, tb = tid % kAtbTile, ta = tid / kAtbTile;  // ta in 0..7
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = t_begin; t0 < t_end; t0 += kAtbTile) {
    for (int e = tid; e < kAtbTile * kAtbTile; e += kAtbThreads) {
      const int r = e / kAtbTile, c = e % kAtbTile, t = t0 + r;
      float av = 0.f, bv = 0.f;
      if (t < t_end) {
        if (a0 + c < Ca) av = A != nullptr ? to_f(A[(size_t)t * Ca + a0 + c]) : 1.f;
        if (b0 + c < Cb) bv = to_f(B[(size_t)t * Cb + b0 + c]);
      }
      as[r][c] = av;
      bs[r][c] = bv;
    }
    __syncthreads();
    for (int r = 0; r < kAtbTile; ++r) {
      const float bv = bs[r][tb];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += as[r][ta + 8 * i] * bv;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ta + 8 * i, b = b0 + tb;
    if (a < Ca && b < Cb) partial[((size_t)chunk * Ca + a) * Cb + b] = acc[i];
  }
}

__global__ void sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                                int R, long long n, long long ld) {
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += part[r * ld + j];
  out[j] = s;
}

cudaError_t launch_sum_rows(const float* part, float* out, int R, long long n,
                            long long ld, cudaStream_t stream) {
  if (n <= 0 || R <= 0) return cudaErrorInvalidValue;
  const int threads = 256;
  sum_rows_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      part, out, R, n, ld);
  return cudaGetLastError();
}

template <typename TA, typename TB>
static void atb_launch(const void* A, const void* B, float* partial, int T, int Ca,
                       int Cb, dim3 grid, cudaStream_t stream) {
  atb_partial_kernel<TA, TB><<<grid, kAtbThreads, 0, stream>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B), partial, T, Ca, Cb);
}

cudaError_t launch_atb(const void* A, int a_bf16, const void* B, int b_bf16, int T,
                       int Ca, int Cb, float* partial, float* out, cudaStream_t stream) {
  if (T <= 0 || Ca <= 0 || Cb <= 0 || (A == nullptr && Ca != 1))
    return cudaErrorInvalidValue;
  const dim3 grid((Cb + kAtbTile - 1) / kAtbTile, (Ca + kAtbTile - 1) / kAtbTile,
                  atb_chunks(T));
  using bf16 = __nv_bfloat16;
  if (a_bf16 && b_bf16)
    atb_launch<bf16, bf16>(A, B, partial, T, Ca, Cb, grid, stream);
  else if (a_bf16)
    atb_launch<bf16, float>(A, B, partial, T, Ca, Cb, grid, stream);
  else if (b_bf16)
    atb_launch<float, bf16>(A, B, partial, T, Ca, Cb, grid, stream);
  else
    atb_launch<float, float>(A, B, partial, T, Ca, Cb, grid, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)Ca * Cb;
  return launch_sum_rows(partial, out, atb_chunks(T), n, n, stream);
}

}  // namespace vadcl
