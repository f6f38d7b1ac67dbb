// Backward of the fused Swin block tail y = x + fc2(gelu(fc1(LN2(x)))) over
// (T, C) tokens (kernel 5): dx, dLN2, dw1, db1, dw2, db2.
//
// Replaces vadcl_tpu/ops/pallas_mlp.py:_bwd_kernel (entry _vjp_bwd, the
// custom VJP of fused_ln_mlp).
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
// written and read once.  Needs C and the hidden width to be multiples of 4.
// Left on the table: TF32 or 3xTF32 tensor-core products within a stated
// tolerance, the weight chunks staged in shared memory, weight-gradient
// partials kept per block instead of the g/dh workspace, a persistent grid.
#include "reduce.cuh"

namespace vadcl {

constexpr int kMbThreads = 128;
constexpr int kMbWarps = kMbThreads / kWarp;
constexpr int kMbTok = 16;    // tokens per block
constexpr int kMbChunk = 64;  // hidden columns per chunk
constexpr int kMbPad = 4;     // row padding in floats: 16-byte aligned rows

inline size_t mlp_bwd_smem_bytes(int c) {
  const size_t cs = c + kMbPad, hs = kMbChunk + kMbPad;
  return sizeof(float) * (4 * kMbTok * cs + 2 * kMbTok * hs + kMbTok + (size_t)kMbWarps * 2 * c);
}

inline bool mlp_bwd_eligible(int c, int ch) { return c % 4 == 0 && ch % 4 == 0; }

__device__ __forceinline__ float gelu_f(float h) {
  return h * 0.5f * (1.f + erff(h * 0.7071067811865476f));
}

__device__ __forceinline__ float dgelu_f(float h) {
  const float cdf = 0.5f * (1.f + erff(h * 0.7071067811865476f));
  return cdf + h * expf(-0.5f * h * h) * 0.3989422804014327f;
}

// Four consecutive values as fp32 (one 16- or 8-byte load; p is aligned).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// Register tiles: every product thread owns 2 tokens x 4 columns and walks
// the summed axis 4 at a time (vector loads of the operands).
template <typename T>
__global__ void __launch_bounds__(kMbThreads)
    ln_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, T* __restrict__ dx, float* __restrict__ z_ws,
                      float* __restrict__ g_ws, float* __restrict__ dh_ws,
                      float* __restrict__ dln_part, int ntok, int C, int Ch) {
  extern __shared__ __align__(16) float smem[];
  const int Cs = C + kMbPad, Hs = kMbChunk + kMbPad;
  float* xh = smem;                    // kMbTok x Cs  xhat
  float* zr = xh + kMbTok * Cs;        // kMbTok x Cs  round(z), fc1's operand
  float* dys = zr + kMbTok * Cs;       // kMbTok x Cs  dy (fp32)
  float* dzs = dys + kMbTok * Cs;      // kMbTok x Cs  dz accumulator
  float* hs = dzs + kMbTok * Cs;       // kMbTok x Hs  hb of the chunk
  float* dhs = hs + kMbTok * Hs;       // kMbTok x Hs  dh of the chunk
  float* rstd = dhs + kMbTok * Hs;     // kMbTok
  float* wpart = rstd + kMbTok;        // kMbWarps x 2C per-warp dln partials

  const int t0 = blockIdx.x * kMbTok;
  const int nt = min(kMbTok, ntok - t0);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;

  // LN2 recompute: xhat, rstd, round(z); z (unrounded fp32) to the
  // workspace; dy fp32.  Padded tokens are zero rows with no gradient.
  for (int t = warp; t < kMbTok; t += kMbWarps) {
    float* xt = xh + t * Cs;
    float* zt = zr + t * Cs;
    float* dt = dys + t * Cs;
    if (t >= nt) {
      for (int c = lane; c < C; c += kWarp) xt[c] = zt[c] = dt[c] = 0.f;
      if (lane == 0) rstd[t] = 0.f;
      continue;
    }
    const T* xg = x + (size_t)(t0 + t) * C;
    float m, r;
    warp_ln_stats(xg, C, &m, &r);
    if (lane == 0) rstd[t] = r;
    for (int c = lane; c < C; c += kWarp) {
      const float v = (to_f(xg[c]) - m) * r;
      const float z = v * ln_s[c] + ln_b[c];
      xt[c] = v;
      zt[c] = round_to<T>(z);
      z_ws[(size_t)(t0 + t) * C + c] = z;
      dt[c] = to_f(dy[(size_t)(t0 + t) * C + c]);
    }
  }
  for (int idx = tid; idx < kMbTok * Cs; idx += kMbThreads) dzs[idx] = 0.f;
  for (int idx = tid; idx < kMbWarps * 2 * C; idx += kMbThreads) wpart[idx] = 0.f;
  __syncthreads();

  const int tp = tid / (kMbChunk / 4), jg = tid % (kMbChunk / 4);  // tokens 2tp, 2tp+1
  for (int j0 = 0; j0 < Ch; j0 += kMbChunk) {
    const int cw = min(kMbChunk, Ch - j0);
    // hb = round(round(z) . W1 + b1); dh = (dy . W2^T) * gelu'(hb)
    if (4 * jg < cw) {
      const int j = j0 + 4 * jg;
      float h[2][4] = {}, g[2][4] = {};
      const float* z0 = zr + (2 * tp) * Cs;
      const float* d0 = dys + (2 * tp) * Cs;
      for (int c = 0; c < C; c += 4) {
        float za[4], zb[4], da[4], db[4], w[4];
        load4(z0 + c, za);
        load4(z0 + Cs + c, zb);
        load4(d0 + c, da);
        load4(d0 + Cs + c, db);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          load4(w1 + (size_t)(c + q) * Ch + j, w);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            h[0][r] += za[q] * w[r];
            h[1][r] += zb[q] * w[r];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          load4(w2 + (size_t)(j + r) * C + c, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            g[0][r] += da[q] * w[q];
            g[1][r] += db[q] * w[q];
          }
        }
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int t = 2 * tp + tt;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hb = round_to<T>(h[tt][r] + b1[j + r]);
          hs[t * Hs + 4 * jg + r] = hb;
          dhs[t * Hs + 4 * jg + r] = t < nt ? g[tt][r] * dgelu_f(hb) : 0.f;
        }
      }
    }
    __syncthreads();
    // g and dh of the chunk to the workspace (coalesced along the hidden axis)
    for (int idx = tid; idx < nt * cw; idx += kMbThreads) {
      const int t = idx / cw, j = idx % cw;
      const size_t off = (size_t)(t0 + t) * Ch + j0 + j;
      g_ws[off] = gelu_f(hs[t * Hs + j]);
      dh_ws[off] = dhs[t * Hs + j];
    }
    // dz += dh . W1[:, chunk]^T; each (token pair, 4 columns) tile has one owner
    for (int tile = tid; tile < (kMbTok / 2) * (C / 4); tile += kMbThreads) {
      const int p = tile / (C / 4), cg = tile % (C / 4);
      const float* a0 = dhs + (2 * p) * Hs;
      float acc[2][4] = {};
      for (int jj = 0; jj < cw; jj += 4) {
        float ha[4], hb[4], w[4];
        load4(a0 + jj, ha);
        load4(a0 + Hs + jj, hb);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          load4(w1 + (size_t)(4 * cg + r) * Ch + j0 + jj, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[0][r] += ha[q] * w[q];
            acc[1][r] += hb[q] * w[q];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dzs[(2 * p) * Cs + 4 * cg + r] += acc[0][r];
        dzs[(2 * p + 1) * Cs + 4 * cg + r] += acc[1][r];
      }
    }
    __syncthreads();
  }

  // dx = dy + LN-vjp(dz), one warp per token; per-warp dln partials
  for (int t = warp; t < nt; t += kMbWarps) {
    const float* xt = xh + t * Cs;
    const float* dzt = dzs + t * Cs;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float dxhat = dzt[c] * ln_s[c];
      s1 += dxhat;
      s2 += dxhat * xt[c];
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    float* wp = wpart + warp * 2 * C;
    for (int c = lane; c < C; c += kWarp) {
      wp[c] += dzt[c] * xt[c];
      wp[C + c] += dzt[c];
      const float dxhat = dzt[c] * ln_s[c];
      const float v = dys[t * Cs + c] + rstd[t] * (dxhat - s1 - xt[c] * s2);
      dx[(size_t)(t0 + t) * C + c] = from_f<T>(v);
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * C; c += kMbThreads) {
    float s = 0.f;
    for (int w = 0; w < kMbWarps; ++w) s += wpart[w * 2 * C + c];
    dln_part[(size_t)blockIdx.x * 2 * C + c] = s;
  }
}

struct MlpBwdLayout {
  size_t z, g, dh, dln, atb, bytes;
};

inline MlpBwdLayout mlp_bwd_layout(int ntok, int C, int Ch) {
  const size_t T = ntok, blocks = (ntok + kMbTok - 1) / kMbTok;
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

long long vadcl_ln_mlp_bwd_workspace_bytes(int ntok, int C, int Ch) {
  return (long long)vadcl::mlp_bwd_layout(ntok, C, Ch).bytes;
}

int vadcl_ln_mlp_bwd(const void* x, const void* dy, const float* ln_s, const float* ln_b,
                     const void* w1, const float* b1, const void* w2, void* dx, float* dls,
                     float* dlb, float* dw1, float* db1, float* dw2, float* db2,
                     void* workspace, int ntok, int C, int Ch, int is_bf16, void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ntok <= 0 || C <= 0 || !mlp_bwd_eligible(C, Ch)) return cudaErrorInvalidValue;
  const size_t smem = mlp_bwd_smem_bytes(C);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const MlpBwdLayout l = mlp_bwd_layout(ntok, C, Ch);
  char* ws = static_cast<char*>(workspace);
  float* z = reinterpret_cast<float*>(ws + l.z);
  float* g = reinterpret_cast<float*>(ws + l.g);
  float* dh = reinterpret_cast<float*>(ws + l.dh);
  float* dln = reinterpret_cast<float*>(ws + l.dln);
  float* part = reinterpret_cast<float*>(ws + l.atb);
  const int blocks = (ntok + kMbTok - 1) / kMbTok;
  cudaError_t err;
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    err = allow_smem(ln_mlp_bwd_kernel<bf16>, smem);
    if (err != cudaSuccess) return err;
    ln_mlp_bwd_kernel<bf16><<<blocks, kMbThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), ln_s, ln_b,
        static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2),
        static_cast<bf16*>(dx), z, g, dh, dln, ntok, C, Ch);
  } else {
    err = allow_smem(ln_mlp_bwd_kernel<float>, smem);
    if (err != cudaSuccess) return err;
    ln_mlp_bwd_kernel<float><<<blocks, kMbThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), ln_s, ln_b,
        static_cast<const float*>(w1), b1, static_cast<const float*>(w2),
        static_cast<float*>(dx), z, g, dh, dln, ntok, C, Ch);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_atb(g, 0, dy, is_bf16, ntok, Ch, C, part, dw2, s))) return err;
  if ((err = launch_atb(z, 0, dh, 0, ntok, C, Ch, part, dw1, s))) return err;
  if ((err = launch_atb(nullptr, 0, dh, 0, ntok, 1, Ch, part, db1, s))) return err;
  if ((err = launch_atb(nullptr, 0, dy, is_bf16, ntok, 1, C, part, db2, s))) return err;
  if ((err = launch_sum_rows(dln, dls, blocks, C, 2 * C, s))) return err;
  return launch_sum_rows(dln + C, dlb, blocks, C, 2 * C, s);
}

}  // extern "C"
