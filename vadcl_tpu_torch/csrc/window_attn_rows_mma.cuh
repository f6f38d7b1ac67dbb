// The bf16 row-tiled window attention forward (kernels 7 and 9,
// window_attn_rows_mma.cu): the attention core's shared-memory layout, the
// group of windows one block takes, and the launches of the core and of the
// token-wise products, for window_attn_rows.cu.
#pragma once

#include "window_rows.cuh"

namespace vadcl {

// Warps of one block: 16 at head widths 16 and 32 (117-128 registers a
// thread), 8 at 48 and 64 (139-157).
__host__ __device__ constexpr int rows_mma_warps(int hd) { return hd <= 32 ? 16 : 8; }

// Byte offsets of one block's shared memory for windows of n tokens, head
// width hd and `group` windows a block:
//   kv   K and V of the head of each window of the group, [Np][hd] bf16 each,
//        16-byte chunks swizzled (rm_swz), no padding;
//   t    the strip's 16 rows of (bias + mask) * log2(e), fp32, rows of Np + 8;
//   raw  the next strip's bias rows and mask rows as copied, [16][Np] fp32 each;
//   ml   each warp's running max and sum of its two rows, 16 float2 a warp;
//   op   each warp's partial output strip, [16][hd + 8] fp32 a warp.
// `group` 0 is the direct layout, for windows no group fits: K and V of one
// window's head in rows padded to hd + 8 and nothing else (the scores read
// bias and mask from device memory); every offset is its size.
struct RowsMmaLayout {
  size_t kv, t, raw, ml, op, bytes;
};

__host__ __device__ inline RowsMmaLayout rows_mma_layout(int n, int hd, int group) {
  const size_t np = rows_padded(n);
  RowsMmaLayout l;
  l.kv = 0;
  if (group == 0) {
    l.t = l.raw = l.ml = l.op = l.bytes = 2 * np * (hd + 8) * 2;
    return l;
  }
  l.t = (size_t)group * 2 * np * hd * 2;
  l.raw = l.t + 16 * (np + 8) * 4;
  l.ml = l.raw + 2 * 16 * np * 4;
  l.op = l.ml + (size_t)rows_mma_warps(hd) * 16 * 8;
  l.bytes = l.op + (size_t)rows_mma_warps(hd) * 16 * (hd + 8) * 4;
  return l;
}

// Windows a block takes: the largest of 8, 4, 2, 1 that is at most
// `per_class` (the windows that share one mask) and whose layout fits 227 KB;
// 0 (the direct layout, one window a block) where not even one window fits.
inline int rows_mma_group(int n, int hd, int per_class) {
  for (int g = 8; g >= 1; g /= 2)
    if (g <= per_class && rows_mma_layout(n, hd, g).bytes <= (size_t)kMaxSmemBytes) return g;
  return 0;
}

// out = round((A . B + bias) * scale on the first scale_cols columns), bf16
// A (T x K), B (K x Nc), out (T x Nc), fp32 bias or null: the forward's qkv
// product and projection; K and Nc multiples of 16.
cudaError_t launch_rows_fwd_gemm(const void* A, const void* B, const float* bias, void* out,
                                 int T, int K, int Nc, int scale_cols, float scale,
                                 cudaStream_t stream);

// o = attention(qkv) per (window, head), bf16, on `stream`: kernel 7's
// arithmetic, or with `packed` kernel 9's (q already scaled, p = e * (1 / l)).
cudaError_t launch_rows_mma_core(const void* qkv, void* o, const float* bias, const float* mask,
                                 int Bn, int N, int C, int nh, int nW, float scale, bool packed,
                                 cudaStream_t stream);

}  // namespace vadcl
