// Fused Swin block tail:  y = x + fc2(gelu(fc1(LN2(x))))  over (T, C) tokens.
//
// Replaces vadcl_tpu/ops/pallas_mlp.py:_fwd_kernel (entry fused_ln_mlp).
//
// One block per token tile.  LN2 runs in fp32 (flax fast variance); the
// block then walks the 4C hidden width in chunks of columns:
// h = z . W1[:, chunk] + b1 -> round to the compute dtype -> exact-erf GELU
// -> round -> accumulate g . W2[chunk, :] into an fp32 (tokens x C) tile.
// The hidden activation never reaches device memory.  Cast boundaries are
// those of _fwd_kernel: z, h and g round to the compute dtype; the fc2 sum,
// b2 and the residual add are fp32.  GELU uses CUDA's erff (exact to ~2 ulp)
// where the Pallas kernel uses the Abramowitz-Stegun 7.1.26 form (1.5e-7 abs
// error).
//
// Two kernels, one per compute dtype.  bf16 (the model's compute dtype on
// the card): ln_mlp_tc_kernel runs fc1 and fc2 on the tensor cores (WMMA
// bf16 tiles, fp32 accumulation, 64 tokens per block, the fc2 accumulator
// in registers); it needs C % 16 == 0, C <= 192 and the hidden width a
// multiple of 128, and refuses other widths.  fp32 (the path the model's
// exact comparisons run): ln_mlp_kernel, CUDA-core loops, 32 tokens per
// block.
//
// What bounds it: every block streams both weight matrices from L2
// (C x 4C x 2 values per 64 tokens) through WMMA fragment loads, and the
// GELU epilogue runs between the two products behind block barriers.  Left
// on the table: wgmma with the weights staged once per block by TMA, a
// persistent grid, overlapping the epilogue with the next chunk's fc1.
//
// The chunk loops themselves (fc1 -> GELU -> fc2) live in mlp_tail.cuh, which
// the whole-Swin-block kernel (fold_attn.cuh) shares.
#include "mlp_tail.cuh"

namespace vadcl {

constexpr int kMlpThreads = 256;
constexpr int kTokens = 32;

inline size_t mlp_smem_bytes(int c) {
  return sizeof(float) * (2 * (size_t)kTokens * c + (size_t)kTokens * kMlpChunk);
}

__global__ void __launch_bounds__(kMlpThreads)
    ln_mlp_kernel(const float* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ y, int ntok, int C,
                  int Ch) {
  extern __shared__ __align__(16) float smem[];
  float* z = smem;                  // kTokens*C   LN output
  float* acc = z + kTokens * C;     // kTokens*C   fc2 accumulator
  float* g = acc + kTokens * C;     // kTokens*kMlpChunk  GELU chunk

  const int t0 = blockIdx.x * kTokens;
  const int nt = min(kTokens, ntok - t0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp, nwarps = nthr / kWarp;

  for (int t = warp; t < nt; t += nwarps) {
    const float* xt = x + (size_t)(t0 + t) * C;
    float mu, rstd;
    warp_ln_stats(xt, C, &mu, &rstd);
    for (int c = lane; c < C; c += kWarp)
      z[t * C + c] = (xt[c] - mu) * rstd * ln_s[c] + ln_b[c];
  }
  mlp_chunks_f32(z, acc, g, w1, b1, w2, nt, C, Ch);

  for (int idx = tid; idx < nt * C; idx += nthr) {
    const int t = idx / C, c = idx % C;
    const size_t off = (size_t)(t0 + t) * C + c;
    y[off] = x[off] + (acc[idx] + b2[c]);
  }
}

cudaError_t launch_ln_mlp(const void* x, const float* ln_s, const float* ln_b,
                          const void* w1, const float* b1, const void* w2,
                          const float* b2, void* y, int ntok, int C, int Ch,
                          cudaStream_t stream) {
  const size_t smem = mlp_smem_bytes(C);
  if (smem > (size_t)kMaxSmemBytes || ntok <= 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ln_mlp_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (ntok + kTokens - 1) / kTokens;
  ln_mlp_kernel<<<blocks, kMlpThreads, smem, stream>>>(
      static_cast<const float*>(x), ln_s, ln_b, static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<float*>(y), ntok, C, Ch);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the math of ln_mlp_kernel with bf16 cast
// boundaries, fc1 and fc2 as WMMA 16x16x16 bf16 tiles with fp32
// accumulation.  A block takes kTcTokens tokens; each warp keeps its share
// of the (tokens x C) fc2 accumulator in registers across the hidden
// chunks.  Needs C % 16 == 0, C <= 192 and the hidden width a multiple of
// kTcChunk; other widths are refused.
// ---------------------------------------------------------------------------
constexpr int kTcMlpThreads = 256;
constexpr int kTcMlpWarps = kTcMlpThreads / kWarp;
constexpr int kTcTokens = 64;
constexpr int kTcMaxC = 192;
static_assert((kTcTokens / 16) * (kTcMaxC / 16) <= kTcAcc * kTcMlpWarps,
              "a warp owns at most kTcAcc output tiles");

inline bool mlp_tc_eligible(int c, int ch) {
  return c % 16 == 0 && c <= kTcMaxC && ch % kTcChunk == 0;
}

inline size_t mlp_tc_smem_bytes(int c) {
  const size_t z = 2 * (size_t)kTcTokens * c, g = 2 * (size_t)kTcTokens * kTcChunk;
  const size_t stage = 4 * (size_t)kTcTokens * (c > kTcChunk ? c : kTcChunk);
  return z + g + stage;
}

__global__ void __launch_bounds__(kTcMlpThreads)
    ln_mlp_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2, __nv_bfloat16* __restrict__ y,
                     int ntok, int C, int Ch) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* z = reinterpret_cast<bf16*>(sm);                          // kTcTokens x C
  bf16* g = z + (size_t)kTcTokens * C;                            // kTcTokens x kTcChunk
  float* stage = reinterpret_cast<float*>(g + (size_t)kTcTokens * kTcChunk);

  const int t0 = blockIdx.x * kTcTokens;
  const int nt = min(kTcTokens, ntok - t0);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;

  for (int t = warp; t < kTcTokens; t += kTcMlpWarps) {
    bf16* zt = z + (size_t)t * C;
    if (t >= nt) {
      for (int c = lane; c < C; c += kWarp) zt[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xt = x + (size_t)(t0 + t) * C;
    float mu, rstd;
    warp_ln_stats(xt, C, &mu, &rstd);
    for (int c = lane; c < C; c += kWarp)
      zt[c] = __float2bfloat16((to_f(xt[c]) - mu) * rstd * ln_s[c] + ln_b[c]);
  }
  __syncthreads();

  MlpFragC acc[kTcAcc];
  mlp_chunks_tc<kTcMlpThreads>(z, g, stage, w1, b1, w2, kTcTokens, C, Ch, acc);
  // every warp is past the last epilogue's reads of stage (see mlp_chunks_tc)
  mlp_store_acc<kTcMlpThreads>(stage, acc, kTcTokens, C);
  __syncthreads();
  for (int e = tid; e < nt * C; e += kTcMlpThreads) {
    const size_t off = (size_t)t0 * C + e;
    y[off] = __float2bfloat16(to_f(x[off]) + (stage[e] + b2[e % C]));
  }
}

cudaError_t launch_ln_mlp_tc(const void* x, const float* ln_s, const float* ln_b,
                             const void* w1, const float* b1, const void* w2,
                             const float* b2, void* y, int ntok, int C, int Ch,
                             cudaStream_t stream) {
  const size_t smem = mlp_tc_smem_bytes(C);
  if (!mlp_tc_eligible(C, Ch) || ntok <= 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ln_mlp_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (ntok + kTcTokens - 1) / kTcTokens;
  using bf16 = __nv_bfloat16;
  ln_mlp_tc_kernel<<<blocks, kTcMlpThreads, smem, stream>>>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<bf16*>(y), ntok, C, Ch);
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" int vadcl_ln_mlp(const void* x, const float* ln_s, const float* ln_b,
                            const void* w1, const float* b1, const void* w2,
                            const float* b2, void* y, int ntok, int C, int Ch,
                            int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vadcl::launch_ln_mlp_tc(x, ln_s, ln_b, w1, b1, w2, b2, y, ntok, C, Ch, s);
  return vadcl::launch_ln_mlp(x, ln_s, ln_b, w1, b1, w2, b2, y, ntok, C, Ch, s);
}
