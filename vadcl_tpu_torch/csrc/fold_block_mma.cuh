// Device code the two whole-Swin-block kernels for Hopper share
// (fold_block_mma.cu, the forward; fold_block_bwd_mma.cu, the backward): the
// window's token addressing, kernel A's strip routines (q, k, v of a head;
// the scores softmax'd in registers) and step 1 of a window, which computes
//   y1 = round(x + proj(attention(LN1 x)))
// for one warp's 16-row strip on kernel A's strip body (fold_attn_mma.cuh).
#pragma once

#include "fold_attn_mma.cuh"

namespace vadcl {

constexpr int kBbMaxC = 192;
constexpr int kBbPiece = 32;      // hidden columns per ring stage of the MLP step
constexpr int kBbPackChunk = 64;  // hidden columns per chunk of kernel B's pack

__host__ __device__ inline int bb_proj_slices(int c, int hd) {
  return (c + fa_slice(hd) - 1) / fa_slice(hd);
}

// Token index of window token i (of the window at (b, wi_d, wi_h, wi_w)), the
// roll folded in; -1 for a padded row.  Args: the kernel's arguments (B, D, H,
// W, the window wd, wh, ww and the shift sd, sh, sw).
template <class Args>
__device__ __forceinline__ long long bb_tok(const Args& a, int b, int wi_d, int wi_h, int wi_w,
                                            int i, int N) {
  if (i >= N) return -1;
  const int d = wi_d * a.wd + i / (a.wh * a.ww), h = wi_h * a.wh + (i / a.ww) % a.wh,
            w = wi_w * a.ww + i % a.ww;
  const long long dd = (d + a.sd) % a.D, hh = (h + a.sh) % a.H, ww = (w + a.sw) % a.W;
  return ((b * (long long)a.D + dd) * a.H + hh) * a.W + ww;
}

// The strip's scores on top of (bias + mask) / scale, softmax'd in place to P
// (fp32, registers); kernel A's and kernel 6's row phase.
template <int kNt, int kHd, int kLdkv>
__device__ __forceinline__ void bb_softmax(float (&sacc)[kNt][4], const uint32_t (&qf)[kHd / 16][4],
                                           const __nv_bfloat16* Kb, const float4* bp,
                                           const float4* mp, float pre, float post, int lane) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    float4 v = __ldg(bp + nt * kWarp);
    if (mp != nullptr) {
      const float4 m = __ldg(mp + nt * kWarp);
      v.x += m.x, v.y += m.y, v.z += m.z, v.w += m.w;
    }
    sacc[nt][0] = v.x * pre, sacc[nt][1] = v.y * pre;
    sacc[nt][2] = v.z * pre, sacc[nt][3] = v.w * pre;
  }
#pragma unroll
  for (int np = 0; np < kNt / 2; ++np)
#pragma unroll
    for (int ks = 0; ks < kHd / 16; ++ks) {
      uint32_t kf[4];
      ldsm_x4(kf, b_frag_row_nk(Kb + (size_t)np * 16 * kLdkv + ks * 16, kLdkv, lane));
      mma_bf16(sacc[2 * np], qf[ks], kf[0], kf[1]);
      mma_bf16(sacc[2 * np + 1], qf[ks], kf[2], kf[3]);
    }
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    sacc[nt][0] *= post, sacc[nt][1] *= post, sacc[nt][2] *= post, sacc[nt][3] *= post;
    m0 = fmaxf(m0, fmaxf(sacc[nt][0], sacc[nt][1]));
    m1 = fmaxf(m1, fmaxf(sacc[nt][2], sacc[nt][3]));
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    sacc[nt][0] = ex2_ftz(sacc[nt][0] - m0), sacc[nt][1] = ex2_ftz(sacc[nt][1] - m0);
    sacc[nt][2] = ex2_ftz(sacc[nt][2] - m1), sacc[nt][3] = ex2_ftz(sacc[nt][3] - m1);
    l0 += sacc[nt][0] + sacc[nt][1];
    l1 += sacc[nt][2] + sacc[nt][3];
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    sacc[nt][0] = fa_div(sacc[nt][0], l0, r0), sacc[nt][1] = fa_div(sacc[nt][1], l0, r0);
    sacc[nt][2] = fa_div(sacc[nt][2], l1, r1), sacc[nt][3] = fa_div(sacc[nt][3], l1, r1);
  }
}

// q, k, v of head h for the warp's strip from the LN1 rows and the head's
// slice: adds the qkv bias, returns q as A fragments, writes k and v (and, with
// Qb, q) rows into the tiles.
template <int kHd, int kLdw, int kLdkv>
__device__ __forceinline__ void bb_qkv(uint32_t (&qf)[kHd / 16][4], const __nv_bfloat16* rows,
                                       int ldr, const __nv_bfloat16* slice, const float* qkv_b,
                                       int C, int h, __nv_bfloat16* Qb, __nv_bfloat16* Kb,
                                       __nv_bfloat16* Vb, int strip, int lane) {
  constexpr int kHt = kHd / 8, kQt = 3 * kHt;
  const int g = lane >> 2, t = lane & 3;
  float qa[kQt][4];
#pragma unroll
  for (int i = 0; i < kQt; ++i) qa[i][0] = qa[i][1] = qa[i][2] = qa[i][3] = 0.f;
  warp_gemm_16xn<kQt>(rows, ldr, slice, kLdw, C, lane, qa);
#pragma unroll
  for (int i = 0; i < kQt; ++i) {
    const float2 bb =
        *reinterpret_cast<const float2*>(qkv_b + (i / kHt) * C + h * kHd + (i % kHt) * 8 + 2 * t);
    qa[i][0] += bb.x, qa[i][1] += bb.y, qa[i][2] += bb.x, qa[i][3] += bb.y;
  }
#pragma unroll
  for (int ks = 0; ks < kHd / 16; ++ks) acc_to_a(qf[ks], qa[2 * ks], qa[2 * ks + 1]);
#pragma unroll
  for (int i = 0; i < kQt; ++i) {
    __nv_bfloat16* base = i < kHt ? Qb : (i < 2 * kHt ? Kb : Vb);
    if (base == nullptr) continue;
    __nv_bfloat16* dst = base + (size_t)strip * 16 * kLdkv + (i % kHt) * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + g * kLdkv) = pack_bf16(qa[i][0], qa[i][1]);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdkv) = pack_bf16(qa[i][2], qa[i][3]);
  }
}

// Step 1 of a window for the warp's strip (kNt = Np / 8 n-tiles, kHd the head
// width): with LN1 of its 16 rows in `rows`, per head q, k, v (k and v into
// the window's K and V tiles at `kv`, double-buffered: head h takes buffer
// (h + kv0) & 1), the scores in registers on top of the packed bias and mask,
// P = e / l, o = round(P).V into the warp's rows of the o tile `ot` (and, with
// o_ws, to the workspace at the rows' tokens e0, e1, in elements); then the
// projection, y1 = round(x + o.W_proj + proj_b), into `rows`.  The weights
// come through the two-stage ring: nH slices of kernel A's pack, then its
// ceil(C / 3hd) projection slices; `seq` counts the ring's items.  One named
// barrier of the window's strips a head.
template <int kNt, int kHd, class Args>
__device__ __forceinline__ void bb_attn_strip(const Args& a, const unsigned char* ring,
                                              size_t stage, uint64_t* full, uint64_t* empty,
                                              int& seq, int kv0, __nv_bfloat16* kv,
                                              __nv_bfloat16* ot, __nv_bfloat16* rows, int ldr,
                                              const float4* bfrag, const float4* mfrag, float pre,
                                              float post, long long e0, long long e1,
                                              __nv_bfloat16* o_ws, int strip, int lane) {
  using bf16 = __nv_bfloat16;
  constexpr int kStrips = kNt / 2, Np = kNt * 8, kHt = kHd / 8, kQt = 3 * kHt;
  constexpr int kLdw = fa_ldw(kHd), kLdkv = fa_ldkv(kHd), kConsumers = kStrips * kWarp;
  const int C = a.C, nh = a.nh, npc = bb_proj_slices(C, kHd);
  const int g = lane >> 2, t = lane & 3;
  for (int h = 0; h < nh; ++h, ++seq) {
    const int s = seq & 1;
    bf16* Kb = kv + (size_t)(((h + kv0) & 1) * 2) * Np * kLdkv;
    bf16* Vb = Kb + (size_t)Np * kLdkv;
    mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
    uint32_t qf[kHd / 16][4];
    bb_qkv<kHd, kLdw, kLdkv>(qf, rows, ldr, reinterpret_cast<const bf16*>(ring + (size_t)s * stage),
                             a.qkv_b, C, h, nullptr, Kb, Vb, strip, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    named_barrier(1, kConsumers);  // every strip's k and v of head h are in
    float sacc[kNt][4];
    bb_softmax<kNt, kHd, kLdkv>(sacc, qf, Kb, bfrag + (size_t)h * kStrips * kNt * kWarp, mfrag,
                                pre, post, lane);
    float oacc[kHt][4];
#pragma unroll
    for (int i = 0; i < kHt; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < kNt / 2; ++k2) {
      uint32_t pf[4];
      acc_to_a(pf, sacc[2 * k2], sacc[2 * k2 + 1]);
#pragma unroll
      for (int nq = 0; nq < kHd / 16; ++nq) {
        uint32_t vf[4];
        ldsm_x4_t(vf, b_frag_row_kn(Vb + (size_t)k2 * 16 * kLdkv + nq * 16, kLdkv, lane));
        mma_bf16(oacc[2 * nq], pf, vf[0], vf[1]);
        mma_bf16(oacc[2 * nq + 1], pf, vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kHt; ++i) {
      const int col = h * kHd + i * 8 + 2 * t;
      const uint32_t lo = pack_bf16(oacc[i][0], oacc[i][1]);
      const uint32_t hi = pack_bf16(oacc[i][2], oacc[i][3]);
      *reinterpret_cast<uint32_t*>(ot + g * ldr + col) = lo;
      *reinterpret_cast<uint32_t*>(ot + (g + 8) * ldr + col) = hi;
      if (o_ws != nullptr && e0 >= 0) *reinterpret_cast<uint32_t*>(o_ws + e0 + col) = lo;
      if (o_ws != nullptr && e1 >= 0) *reinterpret_cast<uint32_t*>(o_ws + e1 + col) = hi;
    }
  }
  __syncwarp();  // the warp's o rows are complete
  // the projection, 3hd output columns per slice, into the warp's y1 rows
  for (int j = 0; j < npc; ++j, ++seq) {
    const int s = seq & 1;
    float pa[kQt][4];
#pragma unroll
    for (int i = 0; i < kQt; ++i) pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0.f;
    mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
    warp_gemm_16xn<kQt>(ot, ldr, reinterpret_cast<const bf16*>(ring + (size_t)s * stage), kLdw, C,
                        lane, pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
    for (int i = 0; i < kQt; ++i) {
      const int col = j * fa_slice(kHd) + i * 8 + 2 * t;
      if (col >= C) continue;
      const float2 bb = *reinterpret_cast<const float2*>(a.proj_b + col);
      uint32_t lo = 0u, hi = 0u;
      if (e0 >= 0) {
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(a.x + e0 + col));
        lo = pack_bf16(pa[i][0] + bb.x + xv.x, pa[i][1] + bb.y + xv.y);
      }
      if (e1 >= 0) {
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(a.x + e1 + col));
        hi = pack_bf16(pa[i][2] + bb.x + xv.x, pa[i][3] + bb.y + xv.y);
      }
      *reinterpret_cast<uint32_t*>(rows + g * ldr + col) = lo;
      *reinterpret_cast<uint32_t*>(rows + (g + 8) * ldr + col) = hi;
    }
  }
}

}  // namespace vadcl
