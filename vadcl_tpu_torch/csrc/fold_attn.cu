// Folded Swin window attention, block front half:
//   out = x + proj(attention(LN1(x)))   per (batch, window), heads looped,
// its head-packed inference variant, and the whole Swin block in one kernel:
//   out = y1 + fc2(gelu(fc1(LN2(y1)))),  y1 = round(x + proj(attention(LN1(x)))).
//
// Replaces vadcl_tpu/ops/pallas_attn_fold.py:
//   vadcl_fold_attn        -> _fold_kernel (entry fused_window_attention_folded,
//                             through folded_block_attention_trainable with
//                             ln_scale, residual=True, or
//                             folded_window_attention_trainable with neither);
//   vadcl_fold_attn_packed -> _fold_packed_kernel (entry
//                             fused_window_attention_folded_packed; inference);
//   vadcl_fold_block       -> _fold_kernel with tail= (entry
//                             folded_full_block_trainable; _mlp_tail_rows)
//                             in fp32 and at the bf16 geometries
//                             fold_block_mma.cu's body does not take.
// The device code is in fold_attn_mma.cuh (kernels A and 10 in bf16) and
// fold_attn.cuh (fp32, and the whole-block body, which the whole-block backward
// reuses).
//
// "Fold": the block reads its window's tokens straight from the
// unpartitioned (B, D, H, W, C) tensor by strides and writes the result back
// in place of the same tokens, so window_partition / window_reverse never
// exist as tensors in device memory.  The shifted blocks' cyclic roll is
// folded into the same addressing (token_offset), so it costs no pass
// either.
//
// Cast boundaries of kernel A follow _fold_kernel: LN output, qkv, the
// softmax probabilities and the per-head output round to the compute dtype;
// scores are scaled after the q.k product; softmax, bias, mask and residual
// are fp32.  The packed variant (kernel 10) keeps _fold_packed_kernel's
// arithmetic and none of its layout (the TPU kernel packs all heads of a
// window into the lanes of one (N, nH*N) score tile with masked K/V row-tiles
// and indicator matmuls, which only add exact zeros and have no use on
// tensor-core tiles): the qkv row stays fp32 until q = round(q * scale) and
// k, v = round(.), the scores get no scale, the row max is per head, and
// p = round(e * (1 / sum e)).
//
// Kernels, by entry and compute dtype:
//   * vadcl_fold_attn_bf16 (kernels A and 10 in bf16, the model's compute
//     dtype on the card): fold_attn_mma.cuh.  One warp per strip of 16 query
//     rows, scores and probabilities in tensor-core registers
//     (mma.sync.m16n8k16 + ldmatrix), per-head weight slices staged by
//     cp.async.bulk through an mbarrier ring, bias and mask read once per
//     head in accumulator order, one named barrier per head.  89.7 KB of
//     shared memory per window at N = 98, C = 96 (two windows per SM), 154 KB
//     at C = 192, 207 KB at C = 256 with 8 heads (the weight slices in two
//     depth chunks); two N = 49 windows share a block.  head_dim must be 16
//     or 32 and N <= 112.
//     What bounds it: instruction throughput and latency, not bytes or
//     tensor-core time.  The softmax costs about ten fp32 instructions per score
//     against one mma per 128 scores; every bias and mask value is read from
//     L2 once per window and head (packed, coalesced); the big products (qkv,
//     proj) run as mma.sync with one ldmatrix.x4 per two mma; at C = 192 one
//     block of eight warps is all an SM holds.
//     Left on the table: wgmma for qkv and proj on a 64/128-row tile, the
//     window's mask resident in shared memory across heads, a persistent
//     grid that keeps bias slices resident across windows, 16-byte stores.
//   * vadcl_fold_attn / vadcl_fold_attn_packed (fp32, the path the model's
//     exact comparisons run): fold_attn_kernel, CUDA-core loops, one block of
//     512 threads per window; the LN'd window, the pre-projection output, one
//     head's q/k/v (N x hd, padded to hd+1 against bank conflicts) and its
//     N x N scores sit in fp32 shared memory.
//   * vadcl_fold_block (fp32, and the bf16 geometries fold_block_mma.cu does
//     not take; in bf16 fold_attn_tc_body<.., kTail=true>, which the old
//     whole-block backward's recompute shares): the four products
//     as WMMA 16x16x16 tiles with fp32 accumulation, score and probability
//     tiles in shared memory (189 KB at N = 98, C = 192), one block per window
//     and SM, four block-wide barriers per head.
//
// The whole-block kernel runs the tail per window, right after that window's
// projection: y1 rounds to the compute dtype into the LN tile (dead by then),
// LN2 (fast variance, fp32) rounds into the pre-projection tile, and the
// hidden width is walked in 128-column chunks streamed from L2, with kernel
// B's cast boundaries (z, h and g round; fc2 sums, b2 and the residual are
// fp32) and the WMMA tail of mlp_tail.cuh.  In bf16 the fc1 stage, the GELU
// chunk and the fp32 fc2 sums reuse the region of q, k, v, scores and
// probabilities, and the fc2 accumulator lives in the warps' fragments (at
// most 6 tiles a warp: ceil(N/16) * C/16 <= 96).  y1 never reaches device
// memory.  Its redesign for bf16 is fold_block_mma.cu.
#include "fold_attn.cuh"
#include "fold_attn_mma.cuh"

namespace vadcl {

template <bool kPacked, bool kTail>
__global__ void __launch_bounds__(kFoldThreads) fold_attn_kernel(FoldArgs a) {
  extern __shared__ __align__(128) unsigned char sm[];
  fold_attn_body<kPacked, kTail>(a, reinterpret_cast<float*>(sm));
}

template <bool kPacked, bool kTail>
__global__ void __launch_bounds__(kFoldThreads) fold_attn_tc_kernel(FoldArgs a) {
  extern __shared__ __align__(128) unsigned char sm[];
  fold_attn_tc_body<kPacked, kTail>(a, sm);
}

// Shared memory one block of the launch's kernel needs.
inline size_t fold_plan_smem(int n, int c, int nh, int is_bf16, bool tail = false) {
  return is_bf16 ? tc_layout(n, c, nh, tail).bytes : fold_smem_bytes(n, c, nh, tail);
}

template <bool kPacked, bool kTail>
cudaError_t launch_fold(const FoldArgs& a, int is_bf16, cudaStream_t stream) {
  const int n = a.wd * a.wh * a.ww;
  const size_t smem = fold_plan_smem(n, a.C, a.nh, is_bf16, kTail);
  if (smem > (size_t)kMaxSmemBytes || !fold_args_ok(a)) return cudaErrorInvalidValue;
  if (is_bf16 && !tc_eligible(a.C, a.nh)) return cudaErrorInvalidValue;
  if (kTail && is_bf16 && !tc_tail_eligible(n, a.C, a.Ch)) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)fold_blocks(a);
  cudaError_t err;
  if (is_bf16) {
    // without the tail, bf16 is fold_attn_mma.cuh's kernel (vadcl_fold_attn_bf16)
    if constexpr (kTail) {
      if ((err = allow_smem(fold_attn_tc_kernel<kPacked, kTail>, smem)) != cudaSuccess)
        return err;
      fold_attn_tc_kernel<kPacked, kTail><<<blocks, kFoldThreads, smem, stream>>>(a);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    if ((err = allow_smem(fold_attn_kernel<kPacked, kTail>, smem)) != cudaSuccess) return err;
    fold_attn_kernel<kPacked, kTail><<<blocks, kFoldThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

// Shared memory one block of the launch's kernel needs; the wrappers refuse
// geometries above the card's limit before launching.  Kernels A and 10 share
// one layout, and so this one entry.
long long vadcl_fold_attn_smem_bytes(int n, int c, int nh, int is_bf16) {
  if (is_bf16) return (long long)vadcl::fa_smem_bytes(n, c, nh > 0 ? c / nh : 0);
  return (long long)vadcl::fold_plan_smem(n, c, nh, 0);
}

// Kernels A (packed = 0) and 10 (packed = 1) in bf16: weights, rel-pos bias
// and mask in the packed layouts of ops/fold_attn.py.
int vadcl_fold_attn_bf16(const void* x, const float* ln_s, const float* ln_b, const void* wpack,
                         const float* qkv_b, const float* proj_b, const float* biasp,
                         const float* maskp, void* out, int B, int D, int H, int W, int C,
                         int nh, int wd, int wh, int ww, int sd, int sh, int sw, float scale,
                         int residual, int packed, void* stream) {
  using bf16 = __nv_bfloat16;
  vadcl::FoldMmaArgs a{static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(wpack),
                       qkv_b, proj_b, biasp, maskp, static_cast<bf16*>(out),
                       B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return packed ? vadcl::launch_fold_mma<true>(a, s) : vadcl::launch_fold_mma<false>(a, s);
}

// (the hidden width is walked in fixed chunks and does not enter)
long long vadcl_fold_block_smem_bytes(int n, int c, int nh, int is_bf16) {
  return (long long)vadcl::fold_plan_smem(n, c, nh, is_bf16, true);
}

// fp32 only (bf16: vadcl_fold_attn_bf16).
int vadcl_fold_attn(const void* x, const float* ln_s, const float* ln_b,
                    const void* qkv_w, const float* qkv_b, const void* proj_w,
                    const float* proj_b, const float* bias, const float* mask,
                    void* out, int B, int D, int H, int W, int C, int nh, int wd,
                    int wh, int ww, int sd, int sh, int sw, float scale,
                    int residual, int is_bf16, void* stream) {
  vadcl::FoldArgs a{x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, out,
                    B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, residual};
  return vadcl::launch_fold<false, false>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

int vadcl_fold_attn_packed(const void* x, const float* ln_s, const float* ln_b,
                           const void* qkv_w, const float* qkv_b, const void* proj_w,
                           const float* proj_b, const float* bias, const float* mask,
                           void* out, int B, int D, int H, int W, int C, int nh, int wd,
                           int wh, int ww, int sd, int sh, int sw, float scale,
                           int residual, int is_bf16, void* stream) {
  vadcl::FoldArgs a{x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, out,
                    B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, residual};
  return vadcl::launch_fold<true, false>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// The whole Swin block: LN1 and the residual are always on.
int vadcl_fold_block(const void* x, const float* ln_s, const float* ln_b,
                     const void* qkv_w, const float* qkv_b, const void* proj_w,
                     const float* proj_b, const float* bias, const float* mask,
                     const float* ln2_s, const float* ln2_b, const void* w1,
                     const float* b1, const void* w2, const float* b2, void* out, int B,
                     int D, int H, int W, int C, int nh, int Ch, int wd, int wh, int ww,
                     int sd, int sh, int sw, float scale, int is_bf16, void* stream) {
  if (ln_s == nullptr || ln_b == nullptr || Ch <= 0) return cudaErrorInvalidValue;
  vadcl::FoldArgs a{x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, bias, mask, out,
                    B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, 1,
                    ln2_s, ln2_b, w1, b1, w2, b2, Ch};
  return vadcl::launch_fold<false, true>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
