// Deterministic cross-block sums for the backward kernels (reduce.cu).
//
// On the TPU the backward kernels carry their weight-gradient sums across
// the sequential grid in VMEM.  Hopper blocks run in any order, so the
// per-tile kernels write per-token operands or per-block partials to a
// workspace, and these launches reduce them in a fixed order with fp32
// accumulation: no float atomics, the same bits on every run.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace vadcl {

// Tokens summed by one partial of the A^T.B reduction.
constexpr int kAtbChunk = 256;

inline int atb_chunks(int t) { return (t + kAtbChunk - 1) / kAtbChunk; }

// Floats of partials launch_atb needs for T tokens and a (Ca x Cb) output.
inline size_t atb_partial_floats(int t, int ca, int cb) {
  return (size_t)atb_chunks(t) * ca * cb;
}

inline size_t align256(size_t v) { return (v + 255) / 256 * 256; }

// out[a, b] = sum_t A[t, a] * B[t, b] over T tokens, both row-major and
// contiguous; A == nullptr stands for a column of ones (Ca must be 1), which
// makes out the column sums of B.  *_bf16 selects __nv_bfloat16 over float.
// Two launches: fp32 partials over chunks of kAtbChunk tokens into
// `partial`, then their sum in chunk order into `out`.
cudaError_t launch_atb(const void* A, int a_bf16, const void* B, int b_bf16, int T,
                       int Ca, int Cb, float* partial, float* out, cudaStream_t stream);

// out[j] = sum_{r < R} part[r * ld + j] for j < n, summed in row order.
cudaError_t launch_sum_rows(const float* part, float* out, int R, long long n,
                            long long ld, cudaStream_t stream);

}  // namespace vadcl
