// The bf16 row-tiled window attention backward (kernel 8,
// window_attn_bwd_rows_mma.cu): the core's shared-memory layout, the group of
// windows one block takes, the blocks a head's groups are spread over, and the
// launch of the core, for window_attn_bwd_rows.cu.
#pragma once

#include "window_attn_rows_mma.cuh"

namespace vadcl {

constexpr int kRbWarps = 8;   // warps of a block of the core (both layouts)
constexpr int kRbKeyMax = 4;  // key blocks a warp holds a strip's d(bias) of

// Byte offsets of one block's shared memory for windows of n tokens, head
// width hd and `group` G windows a block:
//   kv   two [Np][hd] bf16 tiles for each window of the group, 16-byte chunks
//        swizzled (rm_swz): K and V in phase A (query strips), q and dout's
//        head slice in phase B (key strips);
//   t    the strip's (bias + mask) * log2 e, fp32, 16 rows of Np + 8: phase A
//        the strip's query rows, phase B its keys (every query a column);
//   raw  the next strip's bias and mask as copied, fp32, 16 x Np each;
//   st   the row statistics (m, l, rowsum(dp * P)) of every query row of each
//        window of the group, fp32, [G][3][Np];
//   ml   each warp's partial (m, l, rowsum) of its strip's 16 rows, float4;
//   op   each warp's two partial 16 x hd output strips (dq and o; dk and dv),
//        fp32, rows of 2 hd + 8;
//   cs   each warp's share of each window's column sums of dq, dk, dv, fp32,
//        [G][kRbWarps][3 hd].
// `group` 0 is the direct layout, for windows no group fits: q, K, V and
// dout's slice of one window's head in rows padded to hd + 8, its row
// statistics and the strips' column sums, the footprint of the body before
// it (bias and mask are read from device memory); every offset is its size.
struct RowsBwdLayout {
  size_t kv, t, raw, st, ml, op, cs, bytes;
};

__host__ __device__ inline RowsBwdLayout rows_bwd_layout(int n, int hd, int group) {
  const size_t np = rows_padded(n);
  RowsBwdLayout l;
  l.kv = 0;
  if (group == 0) {
    l.t = l.raw = l.st = l.ml = l.op = l.cs = l.bytes =
        2 * 4 * np * (hd + 8) + 4 * (3 * np + np / 16 * 3 * hd);
    return l;
  }
  l.t = (size_t)group * 2 * np * hd * 2;
  l.raw = l.t + 16 * (np + 8) * 4;
  l.st = l.raw + 2 * 16 * np * 4;
  l.ml = l.st + (size_t)group * 3 * np * 4;
  l.op = l.ml + (size_t)kRbWarps * 16 * 16;
  l.cs = l.op + (size_t)kRbWarps * 16 * (2 * hd + 8) * 4;
  l.bytes = l.cs + (size_t)group * kRbWarps * 3 * hd * 4;
  return l;
}

// Windows a block takes: the largest of 8, 4, 2, 1 that is at most
// `per_class` (the windows that share one mask) and whose layout fits 227 KB,
// where a warp's key blocks of a strip (every kRbWarps-th) number at most
// kRbKeyMax (N <= 512); 0 (the direct layout) elsewhere.
inline int rows_bwd_group(int n, int hd, int per_class) {
  if (rows_padded(n) / 16 > kRbWarps * kRbKeyMax) return 0;
  for (int g = 8; g >= 1; g /= 2)
    if (g <= per_class && rows_bwd_layout(n, hd, g).bytes <= (size_t)kMaxSmemBytes) return g;
  return 0;
}

// Windows per chunk of the direct layout's grid (a block per chunk of
// consecutive windows and head), and the chunks that makes: about 264 blocks.
// The staged layout spreads a head's groups over at most as many blocks, so
// its d(bias) partials are no more than the direct layout's.
constexpr int kRowsBwdBlocks = 264;
inline int rows_bwd_chunk(int Bn, int nh) {
  const int want = min(Bn, (kRowsBwdBlocks + nh - 1) / nh);
  return (Bn + want - 1) / want;
}
inline int rows_bwd_chunks(int Bn, int nh) {
  const int chunk = rows_bwd_chunk(Bn, nh);
  return (Bn + chunk - 1) / chunk;
}

// The bf16 core of the row-tiled backward on `stream`: from qkv (T x 3C) and
// do = round(dout . W_proj^T) (T x C), o = round(p . v) (T x C), dqkv =
// round(dq | dk | dv) (T x 3C), the per-window column sums of the unrounded
// dqkv (Bn x 3C) and the d(bias) partials (at most rows_bwd_chunks of
// nH x N x N, summed in order by the caller); *partials receives their count.
cudaError_t launch_rows_bwd_mma_core(const void* qkv, const void* doa, const float* bias,
                                     const float* mask, void* o, void* dqkv, float* dqkvb_part,
                                     float* dbias_part, int* partials, int Bn, int N, int C,
                                     int nh, int nW, float scale, cudaStream_t stream);

}  // namespace vadcl
