// The deterministic second pass of kernels 5 and 6 and of kernel 8's bf16
// row-tiled body on the tensor cores (reduce_mma.cu).  Kernel 8's whole-tile
// body, the fp32 bodies and the whole-block backward keep reduce.cu's fp32
// pass.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace vadcl {

// Tokens summed by one partial of the tensor-core A^T.B pass.
constexpr int kAtbMmaChunk = 1024;

inline int atb_mma_chunks(int t) { return (t + kAtbMmaChunk - 1) / kAtbMmaChunk; }

// Floats of partials launch_atb_mma needs for T tokens and a (Ca x Cb)
// output with its column sums of B.
inline size_t atb_mma_partial_floats(int t, int ca, int cb) {
  return (size_t)atb_mma_chunks(t) * ((size_t)ca * cb + cb);
}

// out[a, b] = sum_t A[t, a] * B[t, b] over T tokens, A (T x Ca) and B (T x Cb)
// row-major bf16, each given as a hi part and, for an operand whose values are
// fp32, its lo part (null: the operand is exactly bf16); see reduce_mma.cu for
// the products and their error.  colsum (optional) receives sum_t (B_hi +
// B_lo)[t, b].  Ca and Cb are multiples of 8, every pointer 16-byte aligned.
// Launches: fp32 partials over chunks of kAtbMmaChunk tokens into `partial`,
// then their sums in chunk order into `out` (and `colsum`).
cudaError_t launch_atb_mma(const __nv_bfloat16* a_hi, const __nv_bfloat16* a_lo,
                           const __nv_bfloat16* b_hi, const __nv_bfloat16* b_lo, int T, int Ca,
                           int Cb, float* partial, float* out, float* colsum,
                           cudaStream_t stream);

}  // namespace vadcl
