// The fixed-order sum of per-block loss partials that both cluster heads
// end with (cluster.cu); kernel C (cluster_mma.cu) and kernel D
// (space_cluster_mma.cu) launch it.
#pragma once

#include "common.cuh"

namespace vadcl {

// out[0] = sum of partials[0..n), one block, in a fixed order (no float
// atomics: the same bits on every run).
cudaError_t launch_sum_partials(const float* partials, int n, float* out,
                                cudaStream_t stream);

}  // namespace vadcl
