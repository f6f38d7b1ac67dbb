// Backward of the fused Swin block tail y = x + fc2(gelu(fc1(LN2(x)))) over
// (T, C) tokens (kernel 5): dx, dLN2, dw1, db1, dw2, db2.
//
// Replaces vadcl_tpu/ops/pallas_mlp.py:_bwd_kernel (entry _vjp_bwd, the
// custom VJP of fused_ln_mlp) in fp32, and in bf16 at the widths the
// tensor-core body of ln_mlp_bwd_mma.cu does not take (C not a multiple of 16
// or above 192, a hidden width not a multiple of 64).
//
// Pass 1, ln_mlp_bwd_kernel: one block per 16-token tile.  It recomputes
// LN2 in fp32 (flax fast variance) keeping xhat and rstd, then walks the 4C
// hidden width in 64-column chunks:
//   hb = round(round(z) . W1 + b1),  g = gelu(hb),
//   dh = (dy . W2^T) * gelu'(hb),    dz += dh . W1^T,
// and finishes with dx = dy + LN-vjp(dz) in the compute dtype.  As in the
// Pallas kernel, only the recompute rounds (z before fc1, h before GELU);
// the backward products run in fp32 on fp32 operands: the unrounded z and
// g, dy and the weights upcast from the compute dtype.  So every product is
// fp32 FMA on CUDA cores, for both compute dtypes (a bf16 tensor-core
// version would round z and g: another contract).  GELU and its derivative
// use CUDA's erff/expf where Pallas uses the A&S erf (1.5e-7 abs).
//
// The sums over tokens (the TPU grid carries them in VMEM) go through the
// deterministic second pass of reduce.cu: pass 1 writes z (T x C), g and dh
// (T x 4C) in fp32 and per-block column sums of dz*xhat and dz; pass 2 forms
// dw2 = g^T . dy, dw1 = z^T . dh, db1 = colsum(dh), db2 = colsum(dy) and sums
// the partials, in a fixed order with fp32 accumulation.
//
// What bounds it: fp32 FMA on CUDA cores (five T x C x 4C products, three
// in pass 1 and two in pass 2).  Pass 1 gives each thread a 2-token x
// 4-column register tile fed by vector loads, the weights read through L1
// from L2 by every block; the fp32 g and dh workspace is 2 x T x 4C floats,
// written and read once.  It takes every width: vector loads of the weights
// where C and the hidden width are multiples of 4 and the matrices aligned,
// scalar loads elsewhere (a template flag), and tiles of 16 tokens, or of 8, 4
// or 2 where 16 tokens' fp32 rows outgrow 227 KB (C above 772: a narrower
// tile widens the hidden chunk, mlp_bwd_chunk).  The tile body is in mlp_bwd.cuh, which the whole-Swin-block backward
// (fold_attn_bwd.cu) shares.  Left on the table: TF32 or 3xTF32 tensor-core
// products within a stated tolerance, the weight chunks staged in shared
// memory, weight-gradient partials kept per block instead of the g/dh
// workspace, a persistent grid.
#include "mlp_bwd.cuh"
#include "reduce.cuh"

namespace vadcl {

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMbThreads)
    ln_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, T* __restrict__ dx, float* __restrict__ z_ws,
                      float* __restrict__ g_ws, float* __restrict__ dh_ws,
                      float* __restrict__ dln_part, int ntok, int C, int Ch, int mt) {
  extern __shared__ __align__(16) float smem[];
  const int t0 = blockIdx.x * mt;
  mlp_bwd_tile<T, BlockBarrier, kVec>(smem, x, dy, ln_s, ln_b, w1, b1, w2, dx, z_ws, g_ws,
                                      dh_ws, dln_part + (size_t)blockIdx.x * 2 * C, nullptr, t0,
                                      min(mt, ntok - t0), C, Ch, threadIdx.x, BlockBarrier(),
                                      mt);
}

template <typename T, bool kVec>
cudaError_t launch_mlp_bwd_tiles(const void* x, const void* dy, const float* ln_s,
                                 const float* ln_b, const void* w1, const float* b1,
                                 const void* w2, void* dx, float* z, float* g, float* dh,
                                 float* dln, int ntok, int C, int Ch, int mt, size_t smem,
                                 cudaStream_t s) {
  const auto kernel = ln_mlp_bwd_kernel<T, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(ntok + mt - 1) / mt, kMbThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ln_s, ln_b, static_cast<const T*>(w1),
      b1, static_cast<const T*>(w2), static_cast<T*>(dx), z, g, dh, dln, ntok, C, Ch, mt);
  return cudaGetLastError();
}

struct MlpBwdLayout {
  size_t z, g, dh, dln, atb, bytes;
};

inline MlpBwdLayout mlp_bwd_layout(int ntok, int C, int Ch) {
  const int mt = mlp_bwd_tokens(C) > 0 ? mlp_bwd_tokens(C) : kMbTok;
  const size_t T = ntok, blocks = (ntok + mt - 1) / mt;
  const size_t atb_c = atb_partial_floats(ntok, C, Ch);
  MlpBwdLayout l;
  size_t o = 0;
  l.z = o;   o = align256(o + sizeof(float) * T * C);
  l.g = o;   o = align256(o + sizeof(float) * T * Ch);
  l.dh = o;  o = align256(o + sizeof(float) * T * Ch);
  l.dln = o; o = align256(o + sizeof(float) * blocks * 2 * C);
  l.atb = o; o = align256(o + sizeof(float) * atb_c);
  l.bytes = o;
  return l;
}

}  // namespace vadcl

extern "C" {

// Tokens a tile of the CUDA-core body holds at width C (0: no tile fits).
int vadcl_ln_mlp_bwd_tokens(int C) { return C > 0 ? vadcl::mlp_bwd_tokens(C) : 0; }

long long vadcl_ln_mlp_bwd_workspace_bytes(int ntok, int C, int Ch) {
  return (long long)vadcl::mlp_bwd_layout(ntok, C, Ch).bytes;
}

int vadcl_ln_mlp_bwd(const void* x, const void* dy, const float* ln_s, const float* ln_b,
                     const void* w1, const float* b1, const void* w2, void* dx, float* dls,
                     float* dlb, float* dw1, float* db1, float* dw2, float* db2,
                     void* workspace, int ntok, int C, int Ch, int is_bf16, void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt = C > 0 ? mlp_bwd_tokens(C) : 0;
  if (ntok <= 0 || Ch <= 0 || mt == 0) return cudaErrorInvalidValue;
  const size_t smem = mlp_bwd_smem_bytes(C, mt);
  const MlpBwdLayout l = mlp_bwd_layout(ntok, C, Ch);
  char* ws = static_cast<char*>(workspace);
  float* z = reinterpret_cast<float*>(ws + l.z);
  float* g = reinterpret_cast<float*>(ws + l.g);
  float* dh = reinterpret_cast<float*>(ws + l.dh);
  float* dln = reinterpret_cast<float*>(ws + l.dln);
  float* part = reinterpret_cast<float*>(ws + l.atb);
  const int blocks = (ntok + mt - 1) / mt;
  using bf16 = __nv_bfloat16;
  const bool vec = mlp_bwd_vector_loads(C, Ch, w1, w2, is_bf16 ? sizeof(bf16) : sizeof(float));
  const auto launch = is_bf16 ? (vec ? launch_mlp_bwd_tiles<bf16, true>
                                     : launch_mlp_bwd_tiles<bf16, false>)
                              : (vec ? launch_mlp_bwd_tiles<float, true>
                                     : launch_mlp_bwd_tiles<float, false>);
  cudaError_t err = launch(x, dy, ln_s, ln_b, w1, b1, w2, dx, z, g, dh, dln, ntok, C, Ch, mt,
                           smem, s);
  if (err != cudaSuccess) return err;
  if ((err = launch_atb(g, 0, dy, is_bf16, ntok, Ch, C, part, dw2, s))) return err;
  if ((err = launch_atb(z, 0, dh, 0, ntok, C, Ch, part, dw1, s))) return err;
  if ((err = launch_atb(nullptr, 0, dh, 0, ntok, 1, Ch, part, db1, s))) return err;
  if ((err = launch_atb(nullptr, 0, dy, is_bf16, ntok, 1, C, part, db2, s))) return err;
  if ((err = launch_sum_rows(dln, dls, blocks, C, 2 * C, s))) return err;
  return launch_sum_rows(dln + C, dlb, blocks, C, 2 * C, s);
}

}  // extern "C"
