// The LN2 -> MLP tail's device code: fc1 -> GELU -> fc2 over tokens held in
// shared memory, the hidden width walked in chunks so the hidden activation
// never reaches device memory.  Shared by ln_mlp.cu (kernel B, a block per
// token tile) and fold_attn.cuh (the whole-Swin-block kernel, which runs the
// tail on a window's tokens right after their attention).
//
// Cast boundaries are those of pallas_mlp.py:_fwd_kernel (which
// pallas_attn_fold.py:_mlp_tail_rows repeats): z, h and g round to the
// compute dtype; the fc2 sum is fp32.  GELU uses CUDA's erff (exact to ~2
// ulp) where the Pallas kernels use the Abramowitz-Stegun 7.1.26 form.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vadcl {

constexpr int kMlpChunk = 128;  // hidden columns per chunk, fp32 path
constexpr int kTcChunk = 128;   // hidden columns per chunk, tensor-core path
constexpr int kTcAcc = 6;       // fc2 accumulator tiles one warp may own

__device__ __forceinline__ float gelu_erf(float h) {
  return h * 0.5f * (1.f + erff(h * 0.7071067811865476f));
}

// On CUDA cores in fp32, all threads of the block, weights of element type T
// (float, or __nv_bfloat16 for kernel B's CUDA-core bf16 body).  z: nt x C
// (LN output, already rounded to T), acc: nt x C (the fc2 sums, zeroed here),
// g: nt x kMlpChunk scratch, all fp32 in shared memory.  h = z . W1 + b1 and
// g = gelu(h) round to T (round_to<float> is the identity, so the fp32
// instance is the loop the whole-block kernel has always run).  The caller
// has written z (no barrier needed before the call); on return acc is
// complete and visible to every thread.
template <typename T>
__device__ __forceinline__ void mlp_chunks_f32(const float* z, float* acc, float* g,
                                               const T* w1, const float* b1,
                                               const T* w2, int nt, int C, int Ch) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int idx = tid; idx < nt * C; idx += nthr) acc[idx] = 0.f;
  __syncthreads();
  for (int j0 = 0; j0 < Ch; j0 += kMlpChunk) {
    const int hc = min(kMlpChunk, Ch - j0);
    for (int idx = tid; idx < nt * hc; idx += nthr) {
      const int t = idx / hc, j = idx % hc;
      const float* zt = z + t * C;
      float h = 0.f;
      for (int c = 0; c < C; ++c) h += zt[c] * to_f(w1[(size_t)c * Ch + j0 + j]);
      g[t * kMlpChunk + j] = round_to<T>(gelu_erf(round_to<T>(h + b1[j0 + j])));
    }
    __syncthreads();
    for (int idx = tid; idx < nt * C; idx += nthr) {
      const int t = idx / C, c = idx % C;
      const float* gt = g + t * kMlpChunk;
      float a = acc[idx];
      for (int j = 0; j < hc; ++j) a += gt[j] * to_f(w2[(size_t)(j0 + j) * C + c]);
      acc[idx] = a;
    }
    __syncthreads();
  }
}

typedef nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> MlpFragC;

// bf16 on the tensor cores (WMMA 16x16x16, fp32 accumulation), all kThreads
// threads of the block.  z: rows x C bf16 (rows a multiple of 16), g: rows x
// kTcChunk bf16 scratch, hstage: rows x kTcChunk fp32 scratch, all in shared
// memory; w1 (C x Ch) and w2 (Ch x C) bf16 in device memory.  Warp w owns the
// output tiles w, w + warps, ... (tile t covers rows 16*(t / (C/16)), columns
// 16*(t % (C/16))), at most kTcAcc of them, and returns their sums in acc.
// The caller has written z and passed a barrier.  On return every warp is
// past its reads of hstage, but other warps may still read g.
// Needs C % 16 == 0, Ch % kTcChunk == 0, (rows/16)*(C/16) <= kTcAcc * warps.
template <int kThreads>
__device__ __forceinline__ void mlp_chunks_tc(const __nv_bfloat16* z, __nv_bfloat16* g,
                                              float* hstage, const __nv_bfloat16* w1,
                                              const float* b1, const __nv_bfloat16* w2,
                                              int rows, int C, int Ch,
                                              MlpFragC (&acc)[kTcAcc]) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int kWarps = kThreads / kWarp;
  const int tid = threadIdx.x, warp = tid / kWarp;
  const int cn = C / 16, out_tiles = (rows / 16) * cn;
  for (int j = 0; j < kTcAcc; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int j0 = 0; j0 < Ch; j0 += kTcChunk) {
    // h = z . W1[:, chunk]  (rows x kTcChunk fp32, staged)
    for (int t = warp; t < (rows / 16) * (kTcChunk / 16); t += kWarps) {
      const int mt = t / (kTcChunk / 16), ntl = t % (kTcChunk / 16);
      MlpFragC h;
      wmma::fill_fragment(h, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, z + (size_t)mt * 16 * C + k0, C);
        wmma::load_matrix_sync(fb, w1 + (size_t)k0 * Ch + j0 + ntl * 16, Ch);
        wmma::mma_sync(h, fa, fb, h);
      }
      wmma::store_matrix_sync(hstage + (size_t)mt * 16 * kTcChunk + ntl * 16, h, kTcChunk,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // + b1 -> bf16 -> exact GELU -> bf16
    for (int e = tid; e < rows * kTcChunk; e += kThreads) {
      const float hb = round_to<bf16>(hstage[e] + b1[j0 + e % kTcChunk]);
      g[e] = __float2bfloat16(gelu_erf(hb));
    }
    __syncthreads();
    // o += g . W2[chunk, :]
    for (int j = 0; j < kTcAcc; ++j) {
      const int t = warp + j * kWarps;
      if (t >= out_tiles) break;
      const int mt = t / cn, ntl = t % cn;
      for (int k0 = 0; k0 < kTcChunk; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, g + (size_t)mt * 16 * kTcChunk + k0, kTcChunk);
        wmma::load_matrix_sync(fb, w2 + (size_t)(j0 + k0) * C + ntl * 16, C);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
}

// Stores the accumulator tiles of mlp_chunks_tc as a rows x C fp32 matrix.
template <int kThreads>
__device__ __forceinline__ void mlp_store_acc(float* dst, MlpFragC (&acc)[kTcAcc], int rows,
                                              int C) {
  constexpr int kWarps = kThreads / kWarp;
  const int warp = threadIdx.x / kWarp, cn = C / 16, out_tiles = (rows / 16) * cn;
  for (int j = 0; j < kTcAcc; ++j) {
    const int t = warp + j * kWarps;
    if (t >= out_tiles) break;
    nvcuda::wmma::store_matrix_sync(dst + (size_t)(t / cn) * 16 * C + (t % cn) * 16, acc[j], C,
                                    nvcuda::wmma::mem_row_major);
  }
}

}  // namespace vadcl
