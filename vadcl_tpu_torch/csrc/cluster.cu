// The fixed-order sum that both cluster heads end with: kernel C
// (cluster_assign, cluster_mma.cu) and kernel D (space_cluster_loss,
// space_cluster_mma.cu) write one loss partial per block, and one more launch
// sums the partials in a fixed order (no float atomics: the same bits on
// every run).  Also the library's error strings.
#include "cluster.cuh"

namespace vadcl {

constexpr int kSumThreads = 256;

// Deterministic sum of per-block partials: one block, fixed order.
__global__ void sum_partials_kernel(const float* __restrict__ partials, int n,
                                    float* __restrict__ out) {
  __shared__ float buf[kSumThreads];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += partials[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
}

cudaError_t launch_sum_partials(const float* partials, int n, float* out,
                                cudaStream_t stream) {
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partials, n, out);
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

const char* vadcl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
