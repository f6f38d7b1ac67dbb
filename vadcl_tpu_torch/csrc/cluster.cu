// Kernel D, space_cluster_loss — replaces
// vadcl_tpu/ops/pallas_cluster.py:_space_kernel (entry
// fused_space_cluster_loss).  fp32 FMA only (no TF32, no tensor cores) in
// torch.cdist's expanded form  d = sqrt(max((|x|^2 + |c|^2) - 2 x.c, 0)).
// One block per (channel, tile of kSpRows rows) against that channel's K
// centers of HW values; loss only.  The loss reduces deterministically:
// every block writes one partial, and a second launch sums the partials in a
// fixed order (no float atomics).  Kernel C (cluster_assign) is in
// cluster_mma.cu and ends with the same second launch.
//
// What bounds it: fp32 FMA throughput on CUDA cores (K x HW per row) and
// shared-memory load throughput; the centers stream from L2 once per block.
// Left on the table: tensor-core products that keep fp32 accuracy (as
// kernel C's 3xTF32 split), an online soft-assign that needs no
// (rows x K) tile, register tiling.
#include <stdint.h>

#include "cluster.cuh"

namespace vadcl {

constexpr int kSpThreads = 256;
constexpr int kSpRows = 16;
constexpr int kSpChunk = 16;
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

// sum_k (d_k * a_k)^2 with a = softmax(-alpha (d - dmin)), by one warp.
__device__ __forceinline__ float warp_soft_assign(const float* row, int K, float dmin,
                                                  float alpha) {
  const int lane = threadIdx.x % kWarp;
  float s = 0.f;
  for (int k = lane; k < K; k += kWarp) s += expf(-alpha * (row[k] - dmin));
  s = warp_sum(s);
  float loss = 0.f;
  for (int k = lane; k < K; k += kWarp) {
    const float d = row[k];
    const float a = expf(-alpha * (d - dmin)) / s;
    const float da = d * a;
    loss += da * da;
  }
  return warp_sum(loss);
}

inline size_t space_smem_bytes(int HW, int K) {
  const int hp = HW + 1;
  return sizeof(float) * ((size_t)kSpRows * hp + (size_t)kSpChunk * hp +
                          (size_t)kSpRows * K + 2 * kSpRows + kSpChunk);
}

__global__ void __launch_bounds__(kSpThreads)
    space_cluster_kernel(const float* __restrict__ maps,
                         const float* __restrict__ centers,
                         float* __restrict__ partials, int BD, int HW, int K,
                         float alpha) {
  extern __shared__ __align__(16) float smem[];
  const int hp = HW + 1;
  float* xs = smem;                    // kSpRows*hp
  float* cs = xs + kSpRows * hp;       // kSpChunk*hp
  float* dist = cs + kSpChunk * hp;    // kSpRows*K
  float* xsq = dist + kSpRows * K;     // kSpRows
  float* rloss = xsq + kSpRows;        // kSpRows
  float* csq = rloss + kSpRows;        // kSpChunk

  const int ntiles = (BD + kSpRows - 1) / kSpRows;
  const int ch = blockIdx.x / ntiles;
  const int r0 = (blockIdx.x % ntiles) * kSpRows;
  const int nr = min(kSpRows, BD - r0);
  const float* xin = maps + ((size_t)ch * BD + r0) * HW;
  const float* cen = centers + (size_t)ch * K * HW;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp, nwarps = nthr / kWarp;

  for (int idx = tid; idx < nr * HW; idx += nthr) {
    const int r = idx / HW, p = idx % HW;
    xs[r * hp + p] = xin[idx];
  }
  __syncthreads();
  for (int r = warp; r < nr; r += nwarps) {
    float s = 0.f;
    for (int p = lane; p < HW; p += kWarp) {
      const float v = xs[r * hp + p];
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) xsq[r] = s;
  }

  for (int k0 = 0; k0 < K; k0 += kSpChunk) {
    const int kc = min(kSpChunk, K - k0);
    __syncthreads();
    for (int idx = tid; idx < kc * HW; idx += nthr) {
      const int kk = idx / HW, p = idx % HW;
      cs[kk * hp + p] = cen[(size_t)k0 * HW + idx];
    }
    __syncthreads();
    for (int kk = warp; kk < kc; kk += nwarps) {
      float s = 0.f;
      for (int p = lane; p < HW; p += kWarp) {
        const float v = cs[kk * hp + p];
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) csq[kk] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < nr * kc; idx += nthr) {
      const int r = idx / kc, kk = idx % kc;
      const float* xr = xs + r * hp;
      const float* cr = cs + kk * hp;
      float cross = 0.f;
      for (int p = 0; p < HW; ++p) cross += xr[p] * cr[p];
      const float d2 = (xsq[r] + csq[kk]) - 2.f * cross;
      dist[r * K + k0 + kk] = sqrtf(fmaxf(d2, 0.f));
    }
  }
  __syncthreads();

  for (int r = warp; r < nr; r += nwarps) {
    float* row = dist + r * K;
    float dmin = INFINITY;
    for (int k = lane; k < K; k += kWarp) dmin = fminf(dmin, row[k]);
    for (int o = kWarp / 2; o > 0; o >>= 1)
      dmin = fminf(dmin, __shfl_xor_sync(0xffffffffu, dmin, o));
    const float l = warp_soft_assign(row, K, dmin, alpha);
    if (lane == 0) rloss[r] = l;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += rloss[r];
    partials[blockIdx.x] = s;
  }
}

cudaError_t launch_sum_partials(const float* partials, int n, float* out,
                                cudaStream_t stream) {
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partials, n, out);
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

// Scratch floats kernel D's wrapper allocates: one partial per (channel, row
// tile).
long long vadcl_space_cluster_scratch(int Cc, int BD) {
  return (long long)Cc * ((BD + vadcl::kSpRows - 1) / vadcl::kSpRows);
}

int vadcl_space_cluster_loss(const float* maps, const float* centers,
                             float* scratch, float* loss, int Cc, int BD, int HW,
                             int K, float alpha, void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = space_smem_bytes(HW, K);
  if (smem > (size_t)kMaxSmemBytes || BD <= 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(space_cluster_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = Cc * ((BD + kSpRows - 1) / kSpRows);
  space_cluster_kernel<<<blocks, kSpThreads, smem, s>>>(maps, centers, scratch, BD,
                                                        HW, K, alpha);
  return launch_sum_partials(scratch, blocks, loss, s);
}

const char* vadcl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
