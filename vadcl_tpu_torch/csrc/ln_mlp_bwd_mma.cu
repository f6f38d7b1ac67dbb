// Kernel 5's bf16 body for Hopper: the backward of y = x + fc2(gelu(fc1(LN2
// x))) over (T, C) tokens on the tensor cores (dx, dLN2, dW1, db1, dW2, db2).
//
// Replaces vadcl_tpu/ops/pallas_mlp.py:_bwd_kernel (entry _vjp_bwd) for bf16
// tokens at C % 16 == 0, C <= 192 and a hidden width divisible by 64 (the
// model's widths); the CUDA-core body of ln_mlp_bwd.cu keeps fp32 and every
// other width (ops/ln_mlp.py:mlp_bwd_body picks).
//
// Numerical contract: ln_mlp_bwd_plain's.  The recompute rounds z = LN2(x)
// before fc1 and h before GELU; every backward product is the fp32 product of
// fp32 operands (the unrounded z and dh, the GELU output g of the rounded h,
// dy and the weights, which are exactly bf16).  On the tensor cores:
//   * round(z) . W1 and dy . W2^T have exact bf16 operands: one bf16 mma.sync
//     pass with fp32 accumulation (exact products, another summation order);
//   * dz = dh . W1^T has one fp32 operand: dh is split in registers into
//     hi = round(dh) and lo = round(dh - hi), and hi . W1^T + lo . W1^T are
//     summed in the fp32 accumulator.  dh = hi + lo + r with |r| <= 2^-18 |dh|,
//     so each product is the fp32 product to a relative 2^-18;
//   * dW2 = g^T . dy and dW1 = z^T . dh run in the second pass
//     (reduce_mma.cu) on g, z and dh split the same way by this kernel: two
//     passes for g^T . dy, three (hi.hi + hi.lo + lo.hi, the lo.lo term below
//     2^-16 dropped) for z^T . dh: each product to about 1.1e-5 relative.
// No fp32 operand is rounded once to bf16 or TF32 (that would be another
// contract: a 2^-9 relative error per operand).  GELU and its derivative use
// CUDA's erff/expf where Pallas uses the A&S erf (1.5e-7 abs).
//
// Pass 1, ln_mlp_bwd_mma_kernel: a block of 8 warps owns 128 tokens, a warp
// 16 of them (one m16n8k16 row strip).  It recomputes LN2 in fp32 into its
// rows of a round(z) tile, copies dy into a dy tile (both bf16 in shared
// memory, rows padded by 8 elements: conflict-free ldmatrix) and writes z as
// its hi/lo pair to the workspace.  The weights arrive as B's own pack
// (ops/ln_mlp.py:pack_mlp_weights: chunk j is W1[:, 64j:64j+64] then
// W2[64j:64j+64, :] in wgmma's N-major core-matrix layout), so the pack the
// forward made in the same step serves here with no second pack: one
// cp.async.bulk copy per 64-column chunk into a two-stage ring, the next chunk
// in flight while this one is multiplied.  The core-matrix layout is also a
// ldmatrix layout (8 rows of 16 contiguous bytes per core matrix), read
// transposed for W1 as fc1's B operand and plainly for W2^T and W1^T.  Per 16
// hidden columns a warp forms h and dy . W2^T (16 x 16 each) in registers,
// then hb = round(h + b1), g = gelu(hb), dh = (dy . W2^T) * gelu'(hb), writes
// g and dh as hi/lo pairs, and adds dh . W1^T into its 16 x C dz accumulator,
// which stays in registers across all chunks (C a template parameter).  The
// epilogue forms dx = dy + LN-vjp(dz) in registers (row sums by quad
// shuffles) and the block's dLN2 partials (column sums in a fixed warp
// order).  Rows past the token count are zero rows and are never stored.
//
// Weight sums.  Taken: the second pass stays, on tensor cores
// (reduce_mma.cu), reading z, g and dh as split bf16.  A block owning weight
// tiles and folding the token sum into pass 1 would need the whole 2 x C x 4C
// fp32 weight-gradient pair per block (295 KB at C = 96) or a block per hidden
// chunk, and then dz (summed over chunks) would need a T x C partial per
// chunk.  Workspace at T = 25088, C = 96, hidden 384 (chip_smoke.py prints
// it): before, z, g, dh in fp32 (86.7 MB) + per-16-token dLN partials (1.2
// MB) + per-256-token A^T.B partials (14.5 MB): 102.4 MB; now the same
// operands as hi/lo bf16 pairs (86.7 MB) + per-block dLN partials (0.15 MB) +
// per-1024-token partials (3.7 MB): 90.6 MB.  Every sum is fixed-order: no
// float atomics, the same bits on every run.
//
// What bounds it: at the flagship shape the five products are 9.25 GFLOP as
// fp32 (0.138 ms at 67 TFLOP/s) and 16.6 GFLOP as the split bf16 passes above
// (0.017 ms at 989 TFLOP/s); the workspace is written once and read once
// (about 0.05 ms at 3.35 TB/s), the erff GELU and its derivative cost issue
// slots per hidden value.  Left on the table: wgmma with the ring feeding a
// warpgroup, a persistent grid, the second pass fused into the first.
#include "mlp_bwd.cuh"
#include "mma.cuh"
#include "reduce.cuh"
#include "reduce_mma.cuh"

namespace vadcl {

constexpr int kM5Chunk = 64;  // hidden columns per packed chunk (pack_mlp_weights)
constexpr int kM5Warps = 8;
constexpr int kM5Threads = kM5Warps * kWarp;
constexpr int kM5Rows = 16 * kM5Warps;  // tokens per block
constexpr int kM5Pad = 8;               // elements of padding per tile row
constexpr int kM5MaxC = 192;

inline bool m5_eligible(int c, int ch) {
  return c >= 16 && c % 16 == 0 && c <= kM5MaxC && ch > 0 && ch % kM5Chunk == 0;
}

__host__ __device__ inline size_t m5_chunk_bytes(int c) {
  return sizeof(__nv_bfloat16) * 2 * (size_t)c * kM5Chunk;
}

struct M5Smem {
  size_t stage, z, dy, stats, wsum, bytes;
};

// Shared memory of one block: two mbarriers, two ring stages, the round(z)
// and dy tiles, the rows' LN statistics and the per-warp dLN column sums.
__host__ __device__ inline M5Smem m5_smem(int c) {
  M5Smem l;
  size_t o = 128;
  l.stage = o; o += 2 * m5_chunk_bytes(c);
  l.z = o;     o += sizeof(__nv_bfloat16) * kM5Rows * (size_t)(c + kM5Pad);
  l.dy = o;    o += sizeof(__nv_bfloat16) * kM5Rows * (size_t)(c + kM5Pad);
  l.stats = o; o += sizeof(float) * 2 * kM5Rows;
  l.wsum = o;  o += sizeof(float) * kM5Warps * 2 * (size_t)c;
  l.bytes = o;
  return l;
}

struct M5Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dy;
  const float* ln_s;
  const float* ln_b;
  const __nv_bfloat16* wpack;
  const float* b1;
  __nv_bfloat16* dx;
  __nv_bfloat16 *z_hi, *z_lo, *g_hi, *g_lo, *dh_hi, *dh_lo;  // (T, C), (T, Ch) x 2
  float* dln_part;  // (blocks, 2C): sum dz*xhat, then sum dz
  int ntok, Ch;
};

template <int C>
__global__ void __launch_bounds__(kM5Threads, C <= 96 ? 2 : 1)
    ln_mlp_bwd_mma_kernel(M5Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int ld = C + kM5Pad;
  extern __shared__ __align__(128) unsigned char sm[];
  const M5Smem L = m5_smem(C);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  const uint32_t chunk_bytes = (uint32_t)m5_chunk_bytes(C);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kM5Rows + warp * 16;  // this warp's first token
  const int nchunks = a.Ch / kM5Chunk;
  bf16* zw = reinterpret_cast<bf16*>(sm + L.z) + warp * 16 * ld;
  bf16* dyw = reinterpret_cast<bf16*>(sm + L.dy) + warp * 16 * ld;
  float* mu = reinterpret_cast<float*>(sm + L.stats) + warp * 16;
  float* rs = mu + kM5Rows;
  float* wsum = reinterpret_cast<float*>(sm + L.wsum);

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(full, chunk_bytes);
    bulk_copy_g2s(sm + L.stage, a.wpack, chunk_bytes, full);
  }

  // LN2 recompute of the warp's 16 rows (the first chunk's copy in flight)
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    bf16* zr = zw + r * ld;
    bf16* dr = dyw + r * ld;
    if (row >= a.ntok) {
      for (int c = 2 * lane; c < C; c += 2 * kWarp) {
        *reinterpret_cast<uint32_t*>(zr + c) = 0u;
        *reinterpret_cast<uint32_t*>(dr + c) = 0u;
      }
      if (lane == 0) mu[r] = rs[r] = 0.f;
      continue;
    }
    const bf16* xr = a.x + (size_t)row * C;
    float m, rstd;
    warp_ln_stats(xr, C, &m, &rstd);
    if (lane == 0) mu[r] = m, rs[r] = rstd;
    for (int c = 2 * lane; c < C; c += 2 * kWarp) {
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(xr + c));
      const float z0 = (xv.x - m) * rstd * a.ln_s[c] + a.ln_b[c];
      const float z1 = (xv.y - m) * rstd * a.ln_s[c + 1] + a.ln_b[c + 1];
      *reinterpret_cast<uint32_t*>(zr + c) = pack_bf16(z0, z1);
      store_split2(a.z_hi, a.z_lo, (size_t)row * C + c, z0, z1);
      *reinterpret_cast<uint32_t*>(dr + c) =
          *reinterpret_cast<const uint32_t*>(a.dy + (size_t)row * C + c);
    }
  }
  __syncwarp();  // (the tiles' rows and statistics are the warp's own)

  float dz[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i) dz[i][0] = dz[i][1] = dz[i][2] = dz[i][3] = 0.f;
  const bool row_ok[2] = {row0 + g < a.ntok, row0 + g + 8 < a.ntok};

  for (int j = 0; j < nchunks; ++j) {
    const int s = j & 1;
    if (tid == 0 && j + 1 < nchunks) {  // (stage s ^ 1 was last read before the barrier below)
      mbar_expect_tx(full + (s ^ 1), chunk_bytes);
      bulk_copy_g2s(sm + L.stage + (size_t)(s ^ 1) * chunk_bytes,
                    reinterpret_cast<const unsigned char*>(a.wpack) + (size_t)(j + 1) * chunk_bytes,
                    chunk_bytes, full + (s ^ 1));
    }
    mbar_wait(full + s, (uint32_t)((j >> 1) & 1));
    // W1[:, chunk] at element (c, n): ((n / 8) * C + c) * 8 + n % 8;
    // W2[chunk, :] at element (n, c): ((c / 8) * 64 + n) * 8 + c % 8
    const bf16* w1s = reinterpret_cast<const bf16*>(sm + L.stage + (size_t)s * chunk_bytes);
    const bf16* w2s = w1s + (size_t)C * kM5Chunk;
#pragma unroll 1
    for (int p = 0; p < kM5Chunk / 16; ++p) {  // 16 hidden columns at a time
      float h[2][4], dg[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[i][e] = dg[i][e] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t az[4], ad[4], bw[4], bv[4];
        ldsm_x4(az, a_frag_row(zw + k0, ld, lane));
        // fc1's B (k = c, n = hidden) stored [k][n] within core matrices: transposed
        ldsm_x4_t(bw, w1s + ((size_t)(2 * p + (lane >> 4)) * C + k0 + (lane & 7) +
                             ((lane >> 3) & 1) * 8) * 8);
        mma_bf16(h[0], az, bw[0], bw[1]);
        mma_bf16(h[1], az, bw[2], bw[3]);
        ldsm_x4(ad, a_frag_row(dyw + k0, ld, lane));
        // W2^T's B (k = c, n = hidden) stored [n][k]: plain
        ldsm_x4(bv, w2s + ((size_t)((k0 >> 3) + ((lane >> 3) & 1)) * kM5Chunk + 16 * p +
                           (lane & 7) + (lane >> 4) * 8) * 8);
        mma_bf16(dg[0], ad, bv[0], bv[1]);
        mma_bf16(dg[1], ad, bv[2], bv[3]);
      }
      // hb = round(h + b1), g = gelu(hb), dh = (dy . W2^T) * gelu'(hb)
      float dh[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = j * kM5Chunk + 16 * p + nt * 8 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(a.b1 + col);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float hb0 = round_to<bf16>(h[nt][2 * hr] + bb.x);
          const float hb1 = round_to<bf16>(h[nt][2 * hr + 1] + bb.y);
          dh[nt][2 * hr] = dg[nt][2 * hr] * dgelu_erf(hb0);
          dh[nt][2 * hr + 1] = dg[nt][2 * hr + 1] * dgelu_erf(hb1);
          if (row_ok[hr]) {
            const size_t off = (size_t)(row0 + g + 8 * hr) * a.Ch + col;
            store_split2(a.g_hi, a.g_lo, off, gelu_erf(hb0), gelu_erf(hb1));
            store_split2(a.dh_hi, a.dh_lo, off, dh[nt][2 * hr], dh[nt][2 * hr + 1]);
          }
        }
      }
      // dz += dh . W1[:, cols]^T as hi and lo passes (B: k = hidden, n = c, stored [n][k])
      uint32_t ahi[4], alo[4];
      acc_to_a_split(ahi, alo, dh[0], dh[1]);
#pragma unroll
      for (int nc = 0; nc < C / 16; ++nc) {
        uint32_t bw[4];
        ldsm_x4(bw, w1s + ((size_t)(2 * p + ((lane >> 3) & 1)) * C + nc * 16 + (lane & 7) +
                           (lane >> 4) * 8) * 8);
        mma_bf16(dz[2 * nc], ahi, bw[0], bw[1]);
        mma_bf16(dz[2 * nc + 1], ahi, bw[2], bw[3]);
        mma_bf16(dz[2 * nc], alo, bw[0], bw[1]);
        mma_bf16(dz[2 * nc + 1], alo, bw[2], bw[3]);
      }
    }
    __syncthreads();  // every warp is done with stage s before chunk j + 2 is copied into it
  }

  // dx = dy + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), dxhat = dz * s
  float m[2], r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) m[hr] = mu[g + 8 * hr], r[hr] = rs[g + 8 * hr];
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(a.ln_s + col);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (!row_ok[hr]) continue;
      const float2 xv = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(a.x + (size_t)(row0 + g + 8 * hr) * C + col));
      const float d0 = dz[nt][2 * hr] * sc.x, d1 = dz[nt][2 * hr + 1] * sc.y;
      s1[hr] += d0 + d1;
      s2[hr] += d0 * ((xv.x - m[hr]) * r[hr]) + d1 * ((xv.y - m[hr]) * r[hr]);
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    s1[hr] += __shfl_xor_sync(0xffffffffu, s1[hr], 1);
    s1[hr] += __shfl_xor_sync(0xffffffffu, s1[hr], 2);
    s2[hr] += __shfl_xor_sync(0xffffffffu, s2[hr], 1);
    s2[hr] += __shfl_xor_sync(0xffffffffu, s2[hr], 2);
    s1[hr] /= C;
    s2[hr] /= C;
  }
  float* wp = wsum + warp * 2 * C;
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(a.ln_s + col);
    float cx0 = 0.f, cx1 = 0.f, cz0 = 0.f, cz1 = 0.f;  // this column pair's dLN sums
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (!row_ok[hr]) continue;
      const size_t off = (size_t)(row0 + g + 8 * hr) * C + col;
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(a.x + off));
      const float xh0 = (xv.x - m[hr]) * r[hr], xh1 = (xv.y - m[hr]) * r[hr];
      const float z0 = dz[nt][2 * hr], z1 = dz[nt][2 * hr + 1];
      const float2 dyv =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(dyw + (g + 8 * hr) * ld + col));
      const float v0 = dyv.x + r[hr] * (z0 * sc.x - s1[hr] - xh0 * s2[hr]);
      const float v1 = dyv.y + r[hr] * (z1 * sc.y - s1[hr] - xh1 * s2[hr]);
      *reinterpret_cast<uint32_t*>(a.dx + off) = pack_bf16(v0, v1);
      cx0 += z0 * xh0, cx1 += z1 * xh1, cz0 += z0, cz1 += z1;
    }
#pragma unroll
    for (int o = 4; o < kWarp; o <<= 1) {
      cx0 += __shfl_xor_sync(0xffffffffu, cx0, o);
      cx1 += __shfl_xor_sync(0xffffffffu, cx1, o);
      cz0 += __shfl_xor_sync(0xffffffffu, cz0, o);
      cz1 += __shfl_xor_sync(0xffffffffu, cz1, o);
    }
    if (g == 0) {
      wp[col] = cx0, wp[col + 1] = cx1;
      wp[C + col] = cz0, wp[C + col + 1] = cz1;
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * C; c += kM5Threads) {
    float s = 0.f;
    for (int w = 0; w < kM5Warps; ++w) s += wsum[w * 2 * C + c];
    a.dln_part[(size_t)blockIdx.x * 2 * C + c] = s;
  }
}

struct M5Workspace {
  size_t zh, zl, gh, gl, dhh, dhl, dln, atb, bytes;
};

inline M5Workspace m5_workspace(int ntok, int C, int Ch) {
  const size_t T = ntok, blocks = (ntok + kM5Rows - 1) / kM5Rows, bf = 2;
  const size_t atb_c = atb_mma_partial_floats(ntok, Ch, C) > atb_mma_partial_floats(ntok, C, Ch)
                           ? atb_mma_partial_floats(ntok, Ch, C)
                           : atb_mma_partial_floats(ntok, C, Ch);
  M5Workspace l;
  size_t o = 0;
  l.zh = o;  o = align256(o + bf * T * C);
  l.zl = o;  o = align256(o + bf * T * C);
  l.gh = o;  o = align256(o + bf * T * Ch);
  l.gl = o;  o = align256(o + bf * T * Ch);
  l.dhh = o; o = align256(o + bf * T * Ch);
  l.dhl = o; o = align256(o + bf * T * Ch);
  l.dln = o; o = align256(o + sizeof(float) * blocks * 2 * C);
  l.atb = o; o = align256(o + sizeof(float) * atb_c);
  l.bytes = o;
  return l;
}

}  // namespace vadcl

extern "C" {

long long vadcl_ln_mlp_bwd_bf16_workspace_bytes(int ntok, int C, int Ch) {
  return (long long)vadcl::m5_workspace(ntok, C, Ch).bytes;
}

long long vadcl_ln_mlp_bwd_bf16_smem_bytes(int C) {
  return (long long)vadcl::m5_smem(C).bytes;
}

// x, dy (T, C) bf16; wpack: ops/ln_mlp.py:pack_mlp_weights of (w1, w2); the
// gradients fp32 except dx (bf16).
int vadcl_ln_mlp_bwd_bf16(const void* x, const void* dy, const float* ln_s, const float* ln_b,
                          const void* wpack, const float* b1, void* dx, float* dls, float* dlb,
                          float* dw1, float* db1, float* dw2, float* db2, void* workspace,
                          int ntok, int C, int Ch, void* stream) {
  using namespace vadcl;
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ntok <= 0 || !m5_eligible(C, Ch)) return cudaErrorInvalidValue;
  const size_t smem = m5_smem(C).bytes;
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const M5Workspace l = m5_workspace(ntok, C, Ch);
  char* ws = static_cast<char*>(workspace);
  auto at = [&](size_t off) { return reinterpret_cast<bf16*>(ws + off); };
  float* dln = reinterpret_cast<float*>(ws + l.dln);
  float* part = reinterpret_cast<float*>(ws + l.atb);
  M5Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(dy), ln_s, ln_b,
           static_cast<const bf16*>(wpack), b1, static_cast<bf16*>(dx),
           at(l.zh), at(l.zl), at(l.gh), at(l.gl), at(l.dhh), at(l.dhl), dln, ntok, Ch};
  using Kernel = void (*)(M5Args);
  static const Kernel kernels[kM5MaxC / 16] = {
      ln_mlp_bwd_mma_kernel<16>,  ln_mlp_bwd_mma_kernel<32>,  ln_mlp_bwd_mma_kernel<48>,
      ln_mlp_bwd_mma_kernel<64>,  ln_mlp_bwd_mma_kernel<80>,  ln_mlp_bwd_mma_kernel<96>,
      ln_mlp_bwd_mma_kernel<112>, ln_mlp_bwd_mma_kernel<128>, ln_mlp_bwd_mma_kernel<144>,
      ln_mlp_bwd_mma_kernel<160>, ln_mlp_bwd_mma_kernel<176>, ln_mlp_bwd_mma_kernel<192>};
  const Kernel kernel = kernels[C / 16 - 1];
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (ntok + kM5Rows - 1) / kM5Rows;
  kernel<<<blocks, kM5Threads, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the second pass: dW2 = g^T . dy (+ db2 = colsum dy), dW1 = z^T . dh (+ db1 = colsum dh)
  if ((err = launch_atb_mma(a.g_hi, a.g_lo, a.dy, nullptr, ntok, Ch, C, part, dw2, db2, s)))
    return err;
  if ((err = launch_atb_mma(a.z_hi, a.z_lo, a.dh_hi, a.dh_lo, ntok, C, Ch, part, dw1, db1, s)))
    return err;
  if ((err = launch_sum_rows(dln, dls, blocks, C, 2 * C, s))) return err;
  return launch_sum_rows(dln + C, dlb, blocks, C, 2 * C, s);
}

}  // extern "C"
