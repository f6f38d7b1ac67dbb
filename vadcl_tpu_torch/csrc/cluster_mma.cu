// C. cluster_assign — replaces vadcl_tpu/ops/pallas_cluster.py:_cluster_kernel
//    (entry fused_cluster_assign).  Tokens x (N, C) and centers (K, C), fp32:
//      d      = sqrt(max((|x|^2 + |c|^2) - 2 x.c, 0))   (torch.cdist's form)
//      labels = first-occurrence argmin_k d
//      recon  = softmax(-alpha (d - d_min)) @ centers
//      loss   = sum((d * softmax)^2), one partial per block, then a fixed-order
//               sum (launch_sum_partials, cluster.cu): no float atomics.
//
// What bounds it on an H100: the two products, 4 N K C flops.  In fp32 on
// CUDA cores (67 TFLOP/s) that is 0.29 ms at the flagship (25088 x 1024 x
// 192); the tensor cores run TF32 at 495 TFLOP/s.  One TF32 rounding of each
// operand (2^-11) is not the contract: it moves the recon by about 1e-3 and
// flips argmin labels.  So every product here is 3xTF32: each operand splits
// into hi = tf32(v) and lo = tf32(v - hi), and hi.hi + hi.lo + lo.hi are summed
// in fp32, which lands within about 2^-21 of the fp32 product.  The kernel's
// accuracy therefore does not follow torch.backends.cuda.matmul.allow_tf32:
// the split holds fp32-level results whatever that flag says.  Three passes of
// both products over the TF32 peak: 0.12 ms at the flagship; the bytes (tokens
// in, recon out, centers once) 0.012 ms.
//
// Design:
//  - A pre-pass (cluster_assign_prep_kernel) writes |c|^2 and the centers'
//    hi and lo parts, zero-padded to Kp rows (a multiple of the chunk) of
//    Cp + 4 words (Cp a multiple of 8: the shared-memory rows below) into the
//    wrapper's scratch: the centers are read from device memory once per call
//    and split once; the 1.6 MB at the flagship stay in L2, and a chunk is one
//    contiguous block.
//  - A block of 8 warps owns 64 tokens: four 16-token row tiles (one m16
//    tile each), two warps per tile.  K is walked in chunks of 32 centers
//    through a two-stage ring: one thread refills a stage with three bulk
//    copies (cp.async.bulk, hi, lo, |c|^2) once all eight warps have released
//    it on an mbarrier, so no block-wide barrier paces the chunks and the 256
//    threads issue no copies.  Of each chunk the first warp of a tile
//    takes centers 0-15, the second 16-31, and each chunk feeds both products:
//    cross = x . chunk^T (m16n8k8, k = channels) and recon += e . chunk
//    (k = the chunk's centers).  No (tokens x K) tile exists.  Two warps per
//    tile put two warps on each scheduler (about 235 registers a thread at C = 192
//    allow no more), which hides the latency of the shared-memory loads and of
//    the mma chains that one warp alone leaves exposed.
//  - Online soft-assign, per row and warp (a row lives in a quad of lanes): the
//    running minimum m and its index, s = sum e, Q = sum (d e)^2 and the
//    16 x Cp recon accumulator in registers.  When m falls to m', s and the
//    recon scale by f = exp(-alpha (m - m')) and Q by f^2.  Within a chunk ties
//    go to the lower index; across chunks only a strictly smaller value
//    replaces m.  At the end the second warp of a tile hands its state to the
//    first through shared memory, which rescales both to the smaller minimum
//    (a tie to the lower index: first occurrence overall), divides the recon
//    by s, and takes Q / s^2 as the row's loss.
//  - The product-1 accumulator holds (row g, centers 2t, 2t+1) of each 8-center
//    tile; the A fragment of product 2 wants (row g, k t) and (row g, k t+4).
//    No shuffle: product 2 reads its k columns permuted, A column t <-> center
//    2t and t + 4 <-> 2t + 1, and loads its B rows in the same order.
//  - Shared memory rows are Cp + 4 words: with a stride of 4 mod 8 the B loads
//    of both products ((center g, channel t) and (center 2t, channel g)) and
//    the A loads hit 32 distinct banks.
//  - Padded centers (k >= K) get e = 0 and never win the argmin; padded tokens
//    write nothing and add nothing to the partial.
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "mma.cuh"

namespace vadcl {

constexpr int kCaTiles = 4;                       // 16-token row tiles per block
constexpr int kCaThreads = 2 * kCaTiles * kWarp;  // two warps per tile
constexpr int kCaTokens = 16 * kCaTiles;          // tokens per block
constexpr int kCaChunk = 32;                      // centers per ring stage
constexpr int kCaPrepThreads = 256;               // pre-pass: one warp per center

// Channel tiles of 8 a width is padded to: the smallest instantiated count
// that holds C (C <= 192), else 0.
inline int ca_tiles(int C) {
  const int tiles[] = {2, 4, 8, 12, 16, 24};
  for (int nt : tiles)
    if (C <= 8 * nt) return nt;
  return 0;
}

__host__ __device__ inline int ca_kp(int K) {
  return (K + kCaChunk - 1) / kCaChunk * kCaChunk;
}
inline int ca_blocks(int N) { return (N + kCaTokens - 1) / kCaTokens; }

// Shared memory of the main kernel: the split token tile, then two ring
// stages of (hi chunk, lo chunk, |c|^2), in 32-bit words.
__host__ __device__ constexpr int ca_stride(int nt) { return 8 * nt + 4; }
__host__ __device__ constexpr int ca_stage_words(int nt) {
  return 2 * kCaChunk * ca_stride(nt) + kCaChunk;
}
constexpr size_t ca_smem_bytes(int nt) {
  return sizeof(uint32_t) * (2 * kCaTokens * ca_stride(nt) + 2 * ca_stage_words(nt));
}

// |c|^2 and the tf32 split of every center, zero-padded to Kp rows of
// `stride` words (the main kernel's shared-memory rows).
__global__ void __launch_bounds__(kCaPrepThreads)
    cluster_assign_prep_kernel(const float* __restrict__ centers, int K, int C, int Kp,
                               int stride, float* __restrict__ csq, uint32_t* __restrict__ hi,
                               uint32_t* __restrict__ lo) {
  const int warps = blockDim.x / kWarp;
  const int k = blockIdx.x * warps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (k >= Kp) return;
  float s = 0.f;
  for (int c = lane; c < stride; c += kWarp) {
    const float v = (k < K && c < C) ? centers[(size_t)k * C + c] : 0.f;
    s += v * v;
    uint32_t h, l;
    split_tf32(v, h, l);
    hi[(size_t)k * stride + c] = h;
    lo[(size_t)k * stride + c] = l;
  }
  s = warp_sum(s);
  if (lane == 0) csq[k] = s;
}

// NT = Cp / 8 channel tiles (a compile-time count: the recon accumulator,
// 4 NT floats a lane, lives in registers).
template <int NT>
__global__ void __launch_bounds__(kCaThreads, 1)
    cluster_assign_mma_kernel(const float* __restrict__ x, const float* __restrict__ csq_g,
                              const uint32_t* __restrict__ hi_g,
                              const uint32_t* __restrict__ lo_g, float* __restrict__ recon,
                              int32_t* __restrict__ labels, float* __restrict__ partials,
                              int N, int C, int K, float alpha) {
  constexpr int Cp = 8 * NT, S = ca_stride(NT), kStage = ca_stage_words(NT);
  constexpr uint32_t kPartBytes = 4 * kCaChunk * S;  // a chunk's hi (or lo) rows
  constexpr int kHalf = kCaChunk / 2;  // the centers of a chunk one warp takes
  constexpr int kXch = 4 * NT + 8;     // floats a lane hands over at the end
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float xsq_s[kCaTokens];
  __shared__ float tile_loss[kCaTiles];
  uint32_t* xh = smem;                  // kCaTokens x S, tf32 hi of the tokens
  uint32_t* xl = xh + kCaTokens * S;    // and their lo
  uint32_t* ring = xl + kCaTokens * S;  // 2 x kStage

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp % kCaTiles, half = warp / kCaTiles;
  const int row0 = blockIdx.x * kCaTokens + tile * 16;  // this warp's first token
  const int nchunks = ca_kp(K) / kCaChunk;

  // The ring: stage s is full when its copies have landed (full[s], one
  // arrival plus the bytes) and empty when all warps have read it (empty[s]).
  // Thread 0 refills a stage once it is empty: three bulk copies, since the
  // pre-pass laid the centers out in the ring's own rows.
  __shared__ uint64_t full[2], empty[2];
  if (tid == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kCaThreads / kWarp);
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int chunk) {
    const int st = chunk & 1, use = chunk >> 1;
    if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
    uint32_t* dst = ring + st * kStage;
    const size_t k0 = (size_t)chunk * kCaChunk;
    mbar_expect_tx(full + st, 2 * kPartBytes + 4 * kCaChunk);
    bulk_copy_g2s(dst, hi_g + k0 * S, kPartBytes, full + st);
    bulk_copy_g2s(dst + kCaChunk * S, lo_g + k0 * S, kPartBytes, full + st);
    bulk_copy_g2s(dst + 2 * kCaChunk * S, csq_g + k0, 4 * kCaChunk, full + st);
  };
  if (tid == 0) issue(0);

  // The block's tokens go raw into xh (every thread, many loads in flight);
  // then the first warp of each tile splits its rows, each quad rows g and
  // g + 8 (channels t mod 4), and sums their squares; a barrier publishes the
  // split tile and |x|^2 to both warps of the tile.
  const int t0 = blockIdx.x * kCaTokens;
#pragma unroll 8
  for (int i = tid; i < kCaTokens * Cp; i += kCaThreads) {
    const int r = i / Cp, c = i % Cp;
    const float v = (t0 + r < N && c < C) ? x[(size_t)(t0 + r) * C + c] : 0.f;
    xh[r * S + c] = __float_as_uint(v);
  }
  __syncthreads();
  if (half == 0) {
    uint32_t* wxh = xh + tile * 16 * S;
    uint32_t* wxl = xl + tile * 16 * S;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sq = 0.f;
      for (int c = t; c < Cp; c += 4) {
        const float v = __uint_as_float(wxh[(g + 8 * h) * S + c]);
        sq += v * v;
        uint32_t vh, vl;
        split_tf32(v, vh, vl);
        wxh[(g + 8 * h) * S + c] = vh;
        wxl[(g + 8 * h) * S + c] = vl;
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      if (t == 0) xsq_s[tile * 16 + g + 8 * h] = sq;
    }
  }
  __syncthreads();
  const uint32_t* ah_row = xh + (tile * 16 + g) * S + t;
  const uint32_t* al_row = xl + (tile * 16 + g) * S + t;

  // Running state of rows g (index 0) and g + 8 (index 1) over this warp's
  // centers (half `half` of every chunk); s and Q are this lane's share (its
  // centers 2t, 2t + 1 of each 8), summed over the quad at the end.
  float m[2] = {INFINITY, INFINITY}, s_part[2] = {0.f, 0.f}, q_part[2] = {0.f, 0.f};
  int arg[2] = {0, 0};
  const float xsq[2] = {xsq_s[tile * 16 + g], xsq_s[tile * 16 + g + 8]};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int ci = 0; ci < nchunks; ++ci) {
    if (tid == 0 && ci + 1 < nchunks) issue(ci + 1);
    mbar_wait(full + (ci & 1), (ci >> 1) & 1);
    const uint32_t* stage = ring + (ci & 1) * kStage;
    const uint32_t* ch = stage + half * kHalf * S;  // this warp's 16 center rows
    const uint32_t* cl = ch + kCaChunk * S;
    const float* cs = reinterpret_cast<const float*>(stage + 2 * kCaChunk * S) + half * kHalf;
    const int k0 = ci * kCaChunk + half * kHalf;

    // product 1: cross (16 x 16) over the channels; four accumulator sets by
    // k step keep eight independent chains in flight
    float cr[4][2][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 2; ++j) cr[p][j][0] = cr[p][j][1] = cr[p][j][2] = cr[p][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const uint32_t ah[4] = {ah_row[8 * kk], ah_row[8 * S + 8 * kk], ah_row[8 * kk + 4],
                              ah_row[8 * S + 8 * kk + 4]};
      const uint32_t al[4] = {al_row[8 * kk], al_row[8 * S + 8 * kk], al_row[8 * kk + 4],
                              al_row[8 * S + 8 * kk + 4]};
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = (8 * j + g) * S + 8 * kk + t;
        bh[j][0] = ch[off], bh[j][1] = ch[off + 4];
        bl[j][0] = cl[off], bl[j][1] = cl[off + 4];
      }
      // pass by pass, so that neighbouring mma do not depend on each other
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_tf32(cr[kk & 3][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_tf32(cr[kk & 3][j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_tf32(cr[kk & 3][j], ah, bh[j][0], bh[j][1]);
    }

    // distances; this chunk's first-occurrence minimum of each row
    float d[2][4], cmin[2] = {INFINITY, INFINITY};
    int cidx[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const float cross = (cr[0][j][e] + cr[1][j][e]) + (cr[2][j][e] + cr[3][j][e]);
        const float d2 = (xsq[h] + cs[kc]) - 2.f * cross;
        const float dv = k0 + kc < K ? sqrtf(fmaxf(d2, 0.f)) : INFINITY;
        d[j][e] = dv;
        if (dv < cmin[h]) cmin[h] = dv, cidx[h] = k0 + kc;  // ascending k: first wins
      }
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, cmin[h], o);
        const int oi = __shfl_xor_sync(0xffffffffu, cidx[h], o);
        if (ov < cmin[h] || (ov == cmin[h] && oi < cidx[h])) cmin[h] = ov, cidx[h] = oi;
      }
      f[h] = 1.f;
      if (cmin[h] < m[h]) {  // strictly smaller: an earlier chunk keeps a tie
        f[h] = m[h] == INFINITY ? 0.f : expf(-alpha * (m[h] - cmin[h]));
        m[h] = cmin[h];
        arg[h] = cidx[h];
      }
      s_part[h] *= f[h];
      q_part[h] *= f[h] * f[h];
    }
    if (__any_sync(0xffffffffu, f[0] != 1.f || f[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= f[0], acc[n][1] *= f[0];
        acc[n][2] *= f[1], acc[n][3] *= f[1];
      }
    }
    float ev[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float v = 0.f;
        if (k0 + 8 * j + 2 * t + (e & 1) < K) {
          v = expf(-alpha * (d[j][e] - m[h]));
          const float de = d[j][e] * v;
          s_part[h] += v;
          q_part[h] += de * de;
        }
        ev[j][e] = v;
      }

    // product 2: recon += e . chunk, one 8-center k step per tile of product 1,
    // A column t <-> center 2t, column t + 4 <-> center 2t + 1
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(ev[kk][0], ah[0], al[0]);  // row g,     center 2t
      split_tf32(ev[kk][2], ah[1], al[1]);  // row g + 8, center 2t
      split_tf32(ev[kk][1], ah[2], al[2]);  // row g,     center 2t + 1
      split_tf32(ev[kk][3], ah[3], al[3]);  // row g + 8, center 2t + 1
      const uint32_t* bh = ch + (8 * kk + 2 * t) * S + g;
      const uint32_t* bl = cl + (8 * kk + 2 * t) * S + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t h0 = bh[8 * n], h1 = bh[S + 8 * n];
        const uint32_t l0 = bl[8 * n], l1 = bl[S + 8 * n];
        mma_tf32(acc[n], ah, l0, l1);
        mma_tf32(acc[n], al, h0, h1);
        mma_tf32(acc[n], ah, h0, h1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + (ci & 1));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s_part[h] += __shfl_xor_sync(0xffffffffu, s_part[h], 1);
    s_part[h] += __shfl_xor_sync(0xffffffffu, s_part[h], 2);
    q_part[h] += __shfl_xor_sync(0xffffffffu, q_part[h], 1);
    q_part[h] += __shfl_xor_sync(0xffffffffu, q_part[h], 2);
  }
  __syncthreads();  // every chunk read: the ring is free
  // The second warp of each tile hands its state to the first through the
  // ring, lane to lane; the first merges the two (a split-K
  // softmax: both rescale to the smaller minimum, a tie to the lower index).
  float* xch = reinterpret_cast<float*>(ring) + tile * kXch * kWarp + lane;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 * n + e) * kWarp] = acc[n][e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xch[(4 * NT + h) * kWarp] = m[h];
      xch[(4 * NT + 2 + h) * kWarp] = __int_as_float(arg[h]);
      xch[(4 * NT + 4 + h) * kWarp] = s_part[h];
      xch[(4 * NT + 6 + h) * kWarp] = q_part[h];
    }
  }
  __syncthreads();
  if (half == 0) {
    float row_loss = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = xch[(4 * NT + h) * kWarp];
      const int a1 = __float_as_int(xch[(4 * NT + 2 + h) * kWarp]);
      if (m1 < m[h] || (m1 == m[h] && a1 < arg[h])) arg[h] = a1;
      const float mm = fminf(m[h], m1);
      const float f0 = m[h] == INFINITY ? 0.f : expf(-alpha * (m[h] - mm));
      const float f1 = m1 == INFINITY ? 0.f : expf(-alpha * (m1 - mm));
      const float s = s_part[h] * f0 + xch[(4 * NT + 4 + h) * kWarp] * f1;
      const float q = q_part[h] * (f0 * f0) + xch[(4 * NT + 6 + h) * kWarp] * (f1 * f1);
      const int tok = row0 + g + 8 * h;
      if (tok < N) {
        float* out = recon + (size_t)tok * C;
        const float inv = 1.f / s;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = 8 * n + 2 * t;
          const float r0 = acc[n][2 * h] * f0 + xch[(4 * n + 2 * h) * kWarp] * f1;
          const float r1 = acc[n][2 * h + 1] * f0 + xch[(4 * n + 2 * h + 1) * kWarp] * f1;
          if (c < C) out[c] = r0 * inv;
          if (c + 1 < C) out[c + 1] = r1 * inv;
        }
        if (t == 0) {
          labels[tok] = arg[h];
          row_loss += q / (s * s);
        }
      }
    }
    row_loss = warp_sum(row_loss);
    if (lane == 0) tile_loss[tile] = row_loss;
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < kCaTiles; ++w) sum += tile_loss[w];
    partials[blockIdx.x] = sum;
  }
}

template <int NT>
cudaError_t launch_cluster_assign(const float* x, const float* csq, const uint32_t* hi,
                                  const uint32_t* lo, float* recon, int32_t* labels,
                                  float* partials, int N, int C, int K, float alpha,
                                  cudaStream_t s) {
  const size_t smem = ca_smem_bytes(NT);
  cudaError_t err = allow_smem(cluster_assign_mma_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  cluster_assign_mma_kernel<NT><<<ca_blocks(N), kCaThreads, smem, s>>>(
      x, csq, hi, lo, recon, labels, partials, N, C, K, alpha);
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

// Scratch floats the wrapper allocates: |c|^2 (Kp), the centers' hi and lo
// parts (Kp x Cp each) and one loss partial per block; -1 if C is too wide.
long long vadcl_cluster_assign_scratch(int N, int C, int K) {
  using namespace vadcl;
  const int nt = ca_tiles(C);
  if (nt == 0 || N <= 0 || K <= 0 || C <= 0) return -1;
  const long long kp = ca_kp(K);
  return kp + 2 * kp * ca_stride(nt) + ca_blocks(N);
}

int vadcl_cluster_assign(const float* x, const float* centers, float* recon,
                         int32_t* labels, float* scratch, float* loss, int N,
                         int C, int K, float alpha, void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = ca_tiles(C);
  if (nt == 0 || N <= 0 || K <= 0 || C <= 0) return cudaErrorInvalidValue;
  const int kp = ca_kp(K), stride = ca_stride(nt);
  float* csq = scratch;
  uint32_t* hi = reinterpret_cast<uint32_t*>(scratch + kp);
  uint32_t* lo = hi + (size_t)kp * stride;
  float* partials = reinterpret_cast<float*>(lo + (size_t)kp * stride);
  const int warps = kCaPrepThreads / kWarp;
  cluster_assign_prep_kernel<<<(kp + warps - 1) / warps, kCaPrepThreads, 0, s>>>(
      centers, K, C, kp, stride, csq, hi, lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto launch = [&](auto tiles) {
    return launch_cluster_assign<decltype(tiles)::value>(x, csq, hi, lo, recon, labels,
                                                         partials, N, C, K, alpha, s);
  };
  switch (nt) {
    case 2: err = launch(std::integral_constant<int, 2>()); break;
    case 4: err = launch(std::integral_constant<int, 4>()); break;
    case 8: err = launch(std::integral_constant<int, 8>()); break;
    case 12: err = launch(std::integral_constant<int, 12>()); break;
    case 16: err = launch(std::integral_constant<int, 16>()); break;
    default: err = launch(std::integral_constant<int, 24>()); break;
  }
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partials, ca_blocks(N), loss, s);
}

}  // extern "C"
