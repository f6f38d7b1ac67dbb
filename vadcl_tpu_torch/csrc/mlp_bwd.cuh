// Device code of kernel 5's first pass (see ln_mlp_bwd.cu): the backward of
// y = x + fc2(gelu(fc1(LN2(x)))) over one tile of mt <= kMbTok tokens (16,
// or 8, 4, 2 where 16 tokens' rows outgrow 227 KB: mlp_bwd_tokens), run by a
// group of kMbThreads threads.  Shared by ln_mlp_bwd.cu (a block per tile)
// and fold_attn_bwd.cu (the whole-Swin-block backward, where groups of a
// window's block walk the window's tiles).
#pragma once

#include <cstdint>

#include "mlp_tail.cuh"

namespace vadcl {

constexpr int kMbThreads = 128;
constexpr int kMbWarps = kMbThreads / kWarp;
constexpr int kMbTok = 16;    // tokens per tile (the most)
constexpr int kMbChunk = 64;  // hidden columns per chunk at kMbTok tokens
constexpr int kMbPad = 4;     // row padding in floats: 16-byte aligned rows

// Row stride of the tile's C-wide rows: C rounded up to 4, then the padding.
__host__ __device__ inline int mlp_bwd_stride(int c) { return (c + 3) / 4 * 4 + kMbPad; }

// Hidden columns per chunk of an mt-token tile: the product threads are mt / 2
// token pairs x 4-column groups, so the chunk widens as the tile narrows.
__host__ __device__ inline int mlp_bwd_chunk(int mt) { return 4 * kMbThreads / (mt / 2); }

// Shared memory of one group with mt tokens a tile.
__host__ __device__ inline size_t mlp_bwd_smem_bytes(int c, int mt = kMbTok) {
  const size_t cs = mlp_bwd_stride(c), hs = mlp_bwd_chunk(mt) + kMbPad;
  return sizeof(float) * (4 * (size_t)mt * cs + 2 * (size_t)mt * hs + mt + (size_t)kMbWarps * 2 * c);
}

// Tokens a tile of ln_mlp_bwd.cu holds at width c: the most of 16, 8, 4, 2
// whose group fits 227 KB (0 above C = 3,500).
inline int mlp_bwd_tokens(int c) {
  for (int mt = kMbTok; mt >= 2; mt /= 2)
    if (mlp_bwd_smem_bytes(c, mt) <= (size_t)kMaxSmemBytes) return mt;
  return 0;
}

// The whole-block backward (fold_attn_bwd.cu) keeps its vector loads and
// 16-token tiles: it takes C and hidden widths that are multiples of 4.
inline bool mlp_bwd_eligible(int c, int ch) { return c % 4 == 0 && ch % 4 == 0; }

// Whether the tile may take its vector loads of the weights: C and the hidden
// width multiples of 4 and both matrices aligned to 4 elements.  Elsewhere it
// takes scalar loads (mlp_bwd_tile's kVec = false), so every width runs.
inline bool mlp_bwd_vector_loads(int c, int ch, const void* w1, const void* w2, size_t elem) {
  return c % 4 == 0 && ch % 4 == 0 && reinterpret_cast<uintptr_t>(w1) % (4 * elem) == 0 &&
         reinterpret_cast<uintptr_t>(w2) % (4 * elem) == 0;
}

__device__ __forceinline__ float dgelu_erf(float h) {
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

// The first n (<= 4) of four consecutive values as fp32, the rest 0 (scalar
// loads: any alignment, nothing read past n).
template <typename T>
__device__ __forceinline__ void load4n(const T* p, int n, float v[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = q < n ? to_f(p[q]) : 0.f;
}
__device__ __forceinline__ void load4s(const float* p, float v[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = p[q];
}

// The barrier of a group: the whole block, or kMbThreads threads of a larger
// block on a named barrier of their own.
struct BlockBarrier {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct GroupBarrier {
  int id;  // 1..15; 0 is __syncthreads's
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kMbThreads) : "memory");
  }
};

// One tile of mt tokens (even, <= kMbTok).  Row t of the tile is token
// rows[t] (rows == null: token row0 + t) of x, dy, dx, z_ws (C wide) and
// g_ws, dh_ws (Ch wide); nt <= mt rows are real.  tid is the thread's index
// in its group, smem the group's mlp_bwd_smem_bytes(C, mt) bytes; dln_part receives the tile's 2C
// column sums of dz*xhat and dz.  Register tiles: every product thread owns 2
// tokens x 4 columns and walks the summed axis 4 at a time: vector loads where
// kVec (C and the hidden width multiples of 4, aligned weights), else scalar
// loads that read nothing past C or the hidden width, the rows' padding to a
// multiple of 4 zero, so the same sums run in the same order at every width.
template <typename T, typename Barrier, bool kVec = true>
__device__ __forceinline__ void mlp_bwd_tile(
    float* smem, const T* x, const T* dy, const float* ln_s, const float* ln_b, const T* w1,
    const float* b1, const T* w2, T* dx, float* z_ws, float* g_ws, float* dh_ws,
    float* dln_part, const long long* rows, long long row0, int nt, int C, int Ch, int tid,
    Barrier barrier, int mt = kMbTok) {
  const int hc = mlp_bwd_chunk(mt);
  const int Cs = mlp_bwd_stride(C), Hs = hc + kMbPad;
  float* xh = smem;                // mt x Cs  xhat
  float* zr = xh + mt * Cs;        // mt x Cs  round(z), fc1's operand
  float* dys = zr + mt * Cs;       // mt x Cs  dy (fp32)
  float* dzs = dys + mt * Cs;      // mt x Cs  dz accumulator
  float* hs = dzs + mt * Cs;       // mt x Hs  hb of the chunk
  float* dhs = hs + mt * Hs;       // mt x Hs  dh of the chunk
  float* rstd = dhs + mt * Hs;     // mt
  float* wpart = rstd + mt;        // kMbWarps x 2C per-warp dln partials

  const int warp = tid / kWarp, lane = tid % kWarp;
  auto tokrow = [&](int t) -> size_t {
    return (size_t)(rows != nullptr ? rows[t] : row0 + t);
  };

  // LN2 recompute: xhat, rstd, round(z); z (unrounded fp32) to the
  // workspace; dy fp32.  Padded tokens are zero rows with no gradient.
  for (int t = warp; t < mt; t += kMbWarps) {
    float* xt = xh + t * Cs;
    float* zt = zr + t * Cs;
    float* dt = dys + t * Cs;
    for (int c = C + lane; c < Cs; c += kWarp) xt[c] = zt[c] = dt[c] = 0.f;  // the padding
    if (t >= nt) {
      for (int c = lane; c < C; c += kWarp) xt[c] = zt[c] = dt[c] = 0.f;
      if (lane == 0) rstd[t] = 0.f;
      continue;
    }
    const size_t tr = tokrow(t);
    const T* xg = x + tr * C;
    float m, r;
    warp_ln_stats(xg, C, &m, &r);
    if (lane == 0) rstd[t] = r;
    for (int c = lane; c < C; c += kWarp) {
      const float v = (to_f(xg[c]) - m) * r;
      const float z = v * ln_s[c] + ln_b[c];
      xt[c] = v;
      zt[c] = round_to<T>(z);
      z_ws[tr * C + c] = z;
      dt[c] = to_f(dy[tr * C + c]);
    }
  }
  for (int idx = tid; idx < mt * Cs; idx += kMbThreads) dzs[idx] = 0.f;
  for (int idx = tid; idx < kMbWarps * 2 * C; idx += kMbThreads) wpart[idx] = 0.f;
  barrier();

  const int tp = tid / (hc / 4), jg = tid % (hc / 4);  // tokens 2tp, 2tp+1
  for (int j0 = 0; j0 < Ch; j0 += hc) {
    const int cw = min(hc, Ch - j0);
    // hb = round(round(z) . W1 + b1); dh = (dy . W2^T) * gelu'(hb)
    if (4 * jg < cw) {
      const int j = j0 + 4 * jg;
      const int jn = min(4, cw - 4 * jg);  // this group's hidden columns (4 where kVec)
      float h[2][4] = {}, g[2][4] = {};
      const float* z0 = zr + (2 * tp) * Cs;
      const float* d0 = dys + (2 * tp) * Cs;
      for (int c = 0; c < C; c += 4) {
        float za[4], zb[4], da[4], db[4], w[4];
        if (kVec) {
          load4(z0 + c, za);
          load4(z0 + Cs + c, zb);
          load4(d0 + c, da);
          load4(d0 + Cs + c, db);
        } else {
          load4s(z0 + c, za);
          load4s(z0 + Cs + c, zb);
          load4s(d0 + c, da);
          load4s(d0 + Cs + c, db);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (kVec)
            load4(w1 + (size_t)(c + q) * Ch + j, w);
          else
            load4n(w1 + (size_t)(c + q) * Ch + j, c + q < C ? jn : 0, w);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            h[0][r] += za[q] * w[r];
            h[1][r] += zb[q] * w[r];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (kVec)
            load4(w2 + (size_t)(j + r) * C + c, w);
          else
            load4n(w2 + (size_t)(j + r) * C + c, r < jn ? min(4, C - c) : 0, w);
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
          // (columns past the hidden width: zeros, which the dz product reads)
          const float hb = r < jn ? round_to<T>(h[tt][r] + b1[j + r]) : 0.f;
          hs[t * Hs + 4 * jg + r] = hb;
          dhs[t * Hs + 4 * jg + r] = t < nt && r < jn ? g[tt][r] * dgelu_erf(hb) : 0.f;
        }
      }
    }
    barrier();
    // g and dh of the chunk to the workspace (coalesced along the hidden axis)
    for (int idx = tid; idx < nt * cw; idx += kMbThreads) {
      const int t = idx / cw, j = idx % cw;
      const size_t off = tokrow(t) * Ch + j0 + j;
      g_ws[off] = gelu_erf(hs[t * Hs + j]);
      dh_ws[off] = dhs[t * Hs + j];
    }
    // dz += dh . W1[:, chunk]^T; each (token pair, 4 columns) tile has one owner
    const int cg4 = (C + 3) / 4;  // column groups of 4 (C / 4 where kVec)
    for (int tile = tid; tile < (mt / 2) * cg4; tile += kMbThreads) {
      const int p = tile / cg4, cg = tile % cg4;
      const float* a0 = dhs + (2 * p) * Hs;
      float acc[2][4] = {};
      for (int jj = 0; jj < cw; jj += 4) {
        float ha[4], hb[4], w[4];
        load4(a0 + jj, ha);
        load4(a0 + Hs + jj, hb);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (kVec)
            load4(w1 + (size_t)(4 * cg + r) * Ch + j0 + jj, w);
          else
            load4n(w1 + (size_t)(4 * cg + r) * Ch + j0 + jj, 4 * cg + r < C ? min(4, cw - jj) : 0,
                   w);
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
    barrier();
  }

  // dx = dy + LN-vjp(dz), one warp per token; per-warp dln partials
  for (int t = warp; t < nt; t += kMbWarps) {
    const size_t tr = tokrow(t);
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
      dx[tr * C + c] = from_f<T>(v);
    }
  }
  barrier();
  for (int c = tid; c < 2 * C; c += kMbThreads) {
    float s = 0.f;
    for (int w = 0; w < kMbWarps; ++w) s += wpart[w * 2 * C + c];
    dln_part[c] = s;
  }
}

}  // namespace vadcl
