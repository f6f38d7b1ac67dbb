// The two cluster-head kernels, all fp32 FMA (no TF32, no tensor cores) in
// torch.cdist's expanded form  d = sqrt(max((|x|^2 + |c|^2) - 2 x.c, 0)),
// so that hard labels match the plain version.
//
// C. cluster_assign — replaces vadcl_tpu/ops/pallas_cluster.py:_cluster_kernel
//    (entry fused_cluster_assign).  One block per tile of kClTokens tokens,
//    walking the K centers in chunks of kClChunk staged in shared memory:
//    distances -> first-occurrence argmin labels -> softmax(-alpha (d - dmin))
//    -> recon = assign @ centers, plus the block's partial of
//    sum((d * assign)^2).  The (tokens x K) distance/assignment tile lives in
//    shared memory only.  Both products are register-tiled: each thread
//    holds a 2 x 4 (distances) or 2 x 12 (recon) block of outputs and reads
//    its operands as float4.
// D. space_cluster_loss — replaces pallas_cluster.py:_space_kernel (entry
//    fused_space_cluster_loss).  One block per (channel, tile of kSpRows
//    rows) against that channel's K centers of HW values; loss only.
//
// Both losses reduce deterministically: every block writes one partial, and
// a second launch sums the partials in a fixed order (no float atomics).
//
// What bounds them: fp32 FMA throughput on CUDA cores (K x C, resp. K x HW,
// per row) and shared-memory load throughput; the centers stream from L2 once per
// block (kernel C reads them twice: distances, recon), and kernel C's
// 208 KB tile allows one block per SM.  Left on the table: 3xTF32 /
// split-bf16 tensor-core products that keep fp32 accuracy, an online
// (flash-style) soft-assign that needs no (tokens x K) tile, register tiling
// in kernel D.
#include <stdint.h>

#include "common.cuh"

namespace vadcl {

constexpr int kClThreads = 256;  // a 16 x 16 thread grid
constexpr int kClTokens = 32;
constexpr int kClChunk = 64;
constexpr int kClMaxCj = 12;  // channels per thread in the recon: C <= 192
constexpr int kSpThreads = 256;
constexpr int kSpRows = 16;
constexpr int kSpChunk = 16;
constexpr int kSumThreads = 256;

// |c_k|^2 for every center, one warp per center.
__global__ void center_sq_kernel(const float* __restrict__ centers, int K, int C,
                                 float* __restrict__ csq) {
  const int warps = blockDim.x / kWarp;
  const int k = blockIdx.x * warps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (k >= K) return;
  float s = 0.f;
  for (int c = lane; c < C; c += kWarp) {
    const float v = centers[(size_t)k * C + c];
    s += v * v;
  }
  s = warp_sum(s);
  if (lane == 0) csq[k] = s;
}

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

// First-occurrence argmin of row[0..K) and its minimum, by one warp.
__device__ __forceinline__ void warp_argmin(const float* row, int K, float* vmin,
                                            int* imin) {
  const int lane = threadIdx.x % kWarp;
  float best = INFINITY;
  int bi = K;
  for (int k = lane; k < K; k += kWarp) {
    const float v = row[k];
    if (v < best) {  // strict: the first (smallest) k wins within the lane
      best = v;
      bi = k;
    }
  }
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov < best || (ov == best && oi < bi)) {
      best = ov;
      bi = oi;
    }
  }
  *vmin = best;
  *imin = bi;
}

// sum_k (d_k * a_k)^2 with a = softmax(-alpha (d - dmin)); a is written
// back over d when `keep_assign` (kernel C needs it for the recon).
__device__ __forceinline__ float warp_soft_assign(float* row, int K, float dmin,
                                                  float alpha, bool keep_assign) {
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
    if (keep_assign) row[k] = a;
  }
  return warp_sum(loss);
}

// Kernel C's shared-memory layout.  Rows are padded so that float4 reads
// of neighbouring rows fall in different banks.
struct ClLayout {
  int cp4, xs_stride, cs_stride, ct_stride, kp, d_stride;
  size_t xs, chunk, dist, xsq, tloss, bytes;
};

__host__ __device__ inline ClLayout cl_layout(int C, int K) {
  ClLayout l;
  l.cp4 = (C + 3) / 4 * 4;
  l.xs_stride = l.cp4 + 4;
  l.cs_stride = l.cp4 + 4;
  l.ct_stride = kClChunk + 4;
  l.kp = (K + kClChunk - 1) / kClChunk * kClChunk;
  l.d_stride = l.kp + 4;
  const size_t chunk_a = (size_t)kClChunk * l.cs_stride, chunk_b = (size_t)C * l.ct_stride;
  l.xs = 0;
  l.chunk = l.xs + (size_t)kClTokens * l.xs_stride;
  l.dist = l.chunk + (chunk_a > chunk_b ? chunk_a : chunk_b);
  l.xsq = l.dist + (size_t)kClTokens * l.d_stride;
  l.tloss = l.xsq + kClTokens;
  l.bytes = sizeof(float) * (l.tloss + kClTokens);
  return l;
}

// Thread (ty, tx) of the 16 x 16 grid owns tokens 2ty, 2ty+1 and, in the
// distance pass, centers tx + 16j (j < 4) of a chunk; in the recon pass,
// channels tx + 16j (j < kClMaxCj).  Products are fp32 FMA over float4
// operands read from shared memory.
__global__ void __launch_bounds__(kClThreads)
    cluster_assign_kernel(const float* __restrict__ x,
                          const float* __restrict__ centers,
                          const float* __restrict__ csq, float* __restrict__ recon,
                          int32_t* __restrict__ labels,
                          float* __restrict__ partials, int N, int C, int K,
                          float alpha) {
  extern __shared__ __align__(16) float smem[];
  const ClLayout L = cl_layout(C, K);
  float* xs = smem + L.xs;        // kClTokens x xs_stride
  float* cs = smem + L.chunk;     // kClChunk x cs_stride (distance pass)
  float* ct = smem + L.chunk;     // C x ct_stride        (recon pass)
  float* dist = smem + L.dist;    // kClTokens x d_stride (d, then assign)
  float* xsq = smem + L.xsq;
  float* tloss = smem + L.tloss;

  const int t0 = blockIdx.x * kClTokens;
  const int nt = min(kClTokens, N - t0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp, nwarps = nthr / kWarp;
  const int tx = tid % 16, ty = tid / 16;

  for (int idx = tid; idx < kClTokens * L.cp4; idx += nthr) {
    const int t = idx / L.cp4, c = idx % L.cp4;
    xs[t * L.xs_stride + c] = (t < nt && c < C) ? x[(size_t)(t0 + t) * C + c] : 0.f;
  }
  for (int idx = tid; idx < kClTokens * (L.kp - K); idx += nthr) {
    const int t = idx / (L.kp - K), k = K + idx % (L.kp - K);
    dist[t * L.d_stride + k] = 0.f;  // padded centers: assignment 0
  }
  __syncthreads();
  for (int t = warp; t < nt; t += nwarps) {
    float s = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float v = xs[t * L.xs_stride + c];
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) xsq[t] = s;
  }

  // distances to every center, chunk by chunk
  for (int k0 = 0; k0 < K; k0 += kClChunk) {
    const int kc = min(kClChunk, K - k0);
    __syncthreads();  // previous chunk fully consumed (and xsq written)
    for (int idx = tid; idx < kClChunk * L.cp4; idx += nthr) {
      const int kk = idx / L.cp4, c = idx % L.cp4;
      cs[kk * L.cs_stride + c] =
          (kk < kc && c < C) ? centers[(size_t)(k0 + kk) * C + c] : 0.f;
    }
    __syncthreads();
    float acc[2][4] = {};
    for (int k4 = 0; k4 < L.cp4; k4 += 4) {
      float4 xa[2], cb[4];
      for (int i = 0; i < 2; ++i)
        xa[i] = *reinterpret_cast<const float4*>(xs + (ty * 2 + i) * L.xs_stride + k4);
      for (int j = 0; j < 4; ++j)
        cb[j] = *reinterpret_cast<const float4*>(cs + (tx + 16 * j) * L.cs_stride + k4);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 4; ++j) {
          float a = acc[i][j];
          a += xa[i].x * cb[j].x;
          a += xa[i].y * cb[j].y;
          a += xa[i].z * cb[j].z;
          a += xa[i].w * cb[j].w;
          acc[i][j] = a;
        }
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j) {
        const int t = ty * 2 + i, kk = tx + 16 * j;
        if (t < nt && kk < kc) {
          const float d2 = (xsq[t] + csq[k0 + kk]) - 2.f * acc[i][j];
          dist[t * L.d_stride + k0 + kk] = sqrtf(fmaxf(d2, 0.f));
        }
      }
  }
  __syncthreads();

  // labels, soft assignment (written over the distances), loss partials
  for (int t = warp; t < nt; t += nwarps) {
    float* row = dist + t * L.d_stride;
    float dmin;
    int imin;
    warp_argmin(row, K, &dmin, &imin);
    const float l = warp_soft_assign(row, K, dmin, alpha, true);
    if (lane == 0) {
      labels[t0 + t] = imin;
      tloss[t] = l;
    }
  }

  // recon = assign @ centers, the chunk staged channel-major
  float r[2][kClMaxCj] = {};
  for (int k0 = 0; k0 < L.kp; k0 += kClChunk) {
    const int kc = min(kClChunk, K - k0);
    __syncthreads();
    for (int idx = tid; idx < kClChunk * C; idx += nthr) {
      const int kk = idx / C, c = idx % C;
      ct[c * L.ct_stride + kk] = kk < kc ? centers[(size_t)(k0 + kk) * C + c] : 0.f;
    }
    __syncthreads();
    for (int k4 = 0; k4 < kClChunk; k4 += 4) {
      float4 av[2];
      for (int i = 0; i < 2; ++i)
        av[i] = *reinterpret_cast<const float4*>(dist + (ty * 2 + i) * L.d_stride + k0 + k4);
      for (int j = 0; j < kClMaxCj; ++j) {
        const int c = tx + 16 * j;
        if (c < C) {
          const float4 cv = *reinterpret_cast<const float4*>(ct + c * L.ct_stride + k4);
          for (int i = 0; i < 2; ++i) {
            float a = r[i][j];
            a += av[i].x * cv.x;
            a += av[i].y * cv.y;
            a += av[i].z * cv.z;
            a += av[i].w * cv.w;
            r[i][j] = a;
          }
        }
      }
    }
  }
  for (int i = 0; i < 2; ++i) {
    const int t = ty * 2 + i;
    if (t >= nt) continue;
    for (int j = 0; j < kClMaxCj; ++j) {
      const int c = tx + 16 * j;
      if (c < C) recon[(size_t)(t0 + t) * C + c] = r[i][j];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int t = 0; t < nt; ++t) s += tloss[t];
    partials[blockIdx.x] = s;
  }
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
    const float l = warp_soft_assign(row, K, dmin, alpha, false);
    if (lane == 0) rloss[r] = l;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += rloss[r];
    partials[blockIdx.x] = s;
  }
}

}  // namespace vadcl

extern "C" {

// Scratch floats the wrappers allocate: kernel C needs K (|c|^2) plus one
// partial per token tile; kernel D one partial per (channel, row tile).
long long vadcl_cluster_assign_scratch(int N, int K) {
  return (long long)K + (N + vadcl::kClTokens - 1) / vadcl::kClTokens;
}

long long vadcl_space_cluster_scratch(int Cc, int BD) {
  return (long long)Cc * ((BD + vadcl::kSpRows - 1) / vadcl::kSpRows);
}

int vadcl_cluster_assign(const float* x, const float* centers, float* recon,
                         int32_t* labels, float* scratch, float* loss, int N,
                         int C, int K, float alpha, void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = cl_layout(C, K).bytes;
  if (smem > (size_t)kMaxSmemBytes || N <= 0 || C > 16 * kClMaxCj)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(cluster_assign_kernel, smem);
  if (err != cudaSuccess) return err;
  float* csq = scratch;
  float* partials = scratch + K;
  const int warps = 256 / kWarp;
  center_sq_kernel<<<(K + warps - 1) / warps, 256, 0, s>>>(centers, K, C, csq);
  const int blocks = (N + kClTokens - 1) / kClTokens;
  cluster_assign_kernel<<<blocks, kClThreads, smem, s>>>(x, centers, csq, recon,
                                                         labels, partials, N, C, K,
                                                         alpha);
  sum_partials_kernel<<<1, kSumThreads, 0, s>>>(partials, blocks, loss);
  return cudaGetLastError();
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
  sum_partials_kernel<<<1, kSumThreads, 0, s>>>(scratch, blocks, loss);
  return cudaGetLastError();
}

const char* vadcl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
