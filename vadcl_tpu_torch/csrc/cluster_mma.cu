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
//  - Widths above 192 (kCaShapes): the recon accumulator (4 NT floats a lane)
//    and the ring (two stages of 2 x 32 rows of Cp + 4 words) outgrow the
//    registers and the 227 KB.  So an instance may split the recon's channel
//    tiles over P warps of a row tile (each of the P runs the same product 1
//    and softmax state, bit for bit, and product 2 for NT / P channel tiles;
//    the block then holds 4 / P row tiles), take 16-center chunks (each warp
//    8 of them), and run its ring with one stage.  Every instance keeps the
//    first-occurrence argmin, the 3xTF32 products and the loss partials'
//    fixed order; the instances of C <= 192 are the ones before (P = 1,
//    32-center chunks, two stages), so their bits are unchanged.
//  - Widths above 768 (768 < C <= 6144): the token tile (hi and lo) and a
//    chunk of centers no longer fit one block.  A thread-block cluster of 2,
//    4 or 8 blocks (the fewest whose slabs of ceil(C / blocks) channels fit
//    768) shares each row tile: block r holds channel slab r of the tokens and,
//    through the ring, of every chunk of centers (the pre-pass lays the
//    centers out slab by slab), and runs the widest instances (NT = 64 or 96,
//    P = 4) on it.  Per chunk every warp writes its partial cross products
//    (over its slab) to shared memory, the cluster synchronises, and every
//    block reads the partials of blocks 0, 1, ... in that order from
//    distributed shared memory and sums them, as it sums |x|^2's partials once
//    per call: every block holds the same cross products bit for bit, so all
//    run the same online soft-assign (minimum, first-occurrence index, s, Q)
//    and each accumulates the recon of its own slab only.  Block 0 writes the
//    labels and the loss partial.  Two exchange buffers alternate by chunk, so
//    one cluster barrier a chunk orders a block's next write after every
//    block's read; a last barrier keeps each block's shared memory alive until
//    the others have read it.  Chosen over two passes (minimum and sum, then
//    the recon per channel slab), which would run product 1 twice and write
//    per-row state to device memory; the clustered body keeps one pass and the
//    instances up to 768 unchanged (a template flag).
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "mma.cuh"

namespace vadcl {

constexpr int kCaThreads = 256;      // eight warps: row tiles x channel parts x two halves
constexpr int kCaMaxTokens = 64;     // tokens of a block with four row tiles
constexpr int kCaKpAlign = 32;       // centers are padded to a multiple of this
constexpr int kCaPrepThreads = 256;  // pre-pass: one warp per center

// One instance of the main kernel: NT channel tiles of 8 (C <= 8 NT), P
// channel parts (warps of a row tile splitting product 2's output channels;
// 4 / P row tiles a block), CH centers per ring stage (each of the two warps
// of a (row tile, part) takes CH / 2) and the ring's stages.
struct CaShape {
  int nt, parts, chunk, stages;
};
constexpr CaShape kCaShapes[] = {{2, 1, 32, 2},  {4, 1, 32, 2},  {8, 1, 32, 2},
                                 {12, 1, 32, 2}, {16, 1, 32, 2}, {24, 1, 32, 2},
                                 {32, 2, 32, 2}, {48, 2, 16, 2}, {64, 4, 16, 2},
                                 {96, 4, 16, 1}};
constexpr int kCaShapeCount = sizeof(kCaShapes) / sizeof(kCaShapes[0]);

constexpr int kCaMaxBlocks = 8;  // the largest portable cluster

// Blocks splitting a row tile's channels: 1 up to 768, else the fewest of 2,
// 4, 8 whose slabs fit the widest instance (0 above 6144).
inline int ca_blocks(int C) {
  const int widest = 8 * kCaShapes[kCaShapeCount - 1].nt;
  for (int b = 1; b <= kCaMaxBlocks; b *= 2)
    if (C <= b * widest) return b;
  return 0;
}
// Channels of one block's slab.
inline int ca_slab(int C) { return (C + ca_blocks(C) - 1) / ca_blocks(C); }

// The instance a block runs: the first whose channel tiles hold its slab,
// else -1 (C above 6144).
inline int ca_shape(int C) {
  if (C <= 0 || ca_blocks(C) == 0) return -1;
  for (int i = 0; i < kCaShapeCount; ++i)
    if (ca_slab(C) <= 8 * kCaShapes[i].nt) return i;
  return -1;
}

__host__ __device__ constexpr int ca_tokens(int parts) { return 16 * (4 / parts); }
__host__ __device__ inline int ca_kp(int K) {
  return (K + kCaKpAlign - 1) / kCaKpAlign * kCaKpAlign;
}
inline int ca_row_blocks(int N, int parts) {
  return (N + ca_tokens(parts) - 1) / ca_tokens(parts);
}

// Shared memory of the main kernel: the split token tile, then the ring's
// stages of (hi chunk, lo chunk, |c|^2), in 32-bit words.
__host__ __device__ constexpr int ca_stride(int nt) { return 8 * nt + 4; }
__host__ __device__ constexpr int ca_stage_words(int nt, int chunk) {
  return 2 * chunk * ca_stride(nt) + chunk;
}
// The split instances' exchange of partial cross products: two buffers of
// one (16 x chunk / 2) tile per warp.
__host__ __device__ constexpr int ca_xbuf_words(int chunk) {
  return 2 * (kCaThreads / kWarp) * (chunk / 2) * 16;
}
constexpr size_t ca_smem_bytes(int nt, int parts, int chunk, int stages, bool split = false) {
  return sizeof(uint32_t) * (2 * ca_tokens(parts) * ca_stride(nt) +
                             stages * ca_stage_words(nt, chunk) + (split ? ca_xbuf_words(chunk) : 0));
}

// |c|^2 and the tf32 split of every center, zero-padded to Kp rows of
// `stride` words (the main kernel's shared-memory rows), one (Kp x stride)
// array per channel slab of `slab` channels (one slab, slab = C, up to 768).
__global__ void __launch_bounds__(kCaPrepThreads)
    cluster_assign_prep_kernel(const float* __restrict__ centers, int K, int C, int Kp,
                               int stride, int slab, int slabs, float* __restrict__ csq,
                               uint32_t* __restrict__ hi, uint32_t* __restrict__ lo) {
  const int warps = blockDim.x / kWarp;
  const int k = blockIdx.x * warps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (k >= Kp) return;
  float s = 0.f;
  for (int r = 0; r < slabs; ++r) {
    const int c0 = r * slab, cl = min(slab, C - c0);
    const size_t row = ((size_t)r * Kp + k) * stride;
    for (int c = lane; c < stride; c += kWarp) {
      const float v = (k < K && c < cl) ? centers[(size_t)k * C + c0 + c] : 0.f;
      s += v * v;
      uint32_t h, l;
      split_tf32(v, h, l);
      hi[row + c] = h;
      lo[row + c] = l;
    }
  }
  s = warp_sum(s);
  if (lane == 0) csq[k] = s;
}

// NT = Cp / 8 channel tiles (a compile-time count: the recon accumulator,
// 4 NT / P floats a lane, lives in registers); the other parameters as
// CaShape's.  SPLIT: a block of a cluster holding channel slab
// %cluster_ctarank of `slab` channels (see the header); else slab = C.
template <int NT, int P, int CH, int STAGES, bool SPLIT>
__global__ void __launch_bounds__(kCaThreads, 1)
    cluster_assign_mma_kernel(const float* __restrict__ x, const float* __restrict__ csq_g,
                              const uint32_t* __restrict__ hi_g,
                              const uint32_t* __restrict__ lo_g, float* __restrict__ recon,
                              int32_t* __restrict__ labels, float* __restrict__ partials,
                              int N, int C, int K, float alpha, int slab) {
  constexpr int Cp = 8 * NT, S = ca_stride(NT), kStage = ca_stage_words(NT, CH);
  constexpr int kTiles = 4 / P, kTokens = ca_tokens(P);
  constexpr int NTL = NT / P;           // the recon channel tiles of one warp
  constexpr uint32_t kPartBytes = 4 * CH * S;  // a chunk's hi (or lo) rows
  constexpr int kHalf = CH / 2;         // the centers of a chunk one warp takes
  constexpr int kJ = kHalf / 8;         // their 8-center tiles
  constexpr int kXch = 4 * NTL + 8;     // floats a lane hands over at the end
  static_assert(NT % P == 0 && kHalf % 8 == 0 && (STAGES == 1 || STAGES == 2), "shape");
  static_assert(kTiles * P * kXch * kWarp <= STAGES * kStage, "the hand-over fits the ring");
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float xsq_s[kCaMaxTokens];
  __shared__ float tile_loss[4];
  uint32_t* xh = smem;                 // kTokens x S, tf32 hi of the tokens
  uint32_t* xl = xh + kTokens * S;     // and their lo
  uint32_t* ring = xl + kTokens * S;   // STAGES x kStage

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp % kTiles, part = (warp / kTiles) % P, half = warp / (kTiles * P);
  const int n0 = part * NTL;  // this warp's first recon channel tile
  const int rank = SPLIT ? (int)cluster_ctarank() : 0;     // this block's channel slab
  const int nranks = SPLIT ? (int)cluster_nctarank() : 1;
  const int rb = blockIdx.x / nranks;                      // the row tile's block index
  const int cbase = rank * slab, clen = SPLIT ? min(slab, C - cbase) : C;  // the slab
  const int row0 = rb * kTokens + tile * 16;  // this warp's first token
  const int nchunks = ca_kp(K) / CH;
  if (SPLIT) {  // this slab's split centers
    hi_g += (size_t)rank * ca_kp(K) * S;
    lo_g += (size_t)rank * ca_kp(K) * S;
  }

  // The ring: stage s is full when its copies have landed (full[s], one
  // arrival plus the bytes) and empty when all warps have read it (empty[s]).
  // Thread 0 refills a stage once it is empty: three bulk copies, since the
  // pre-pass laid the centers out in the ring's own rows.  With one stage the
  // next chunk is issued once every warp has released this one.
  __shared__ uint64_t full[STAGES], empty[STAGES];
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kCaThreads / kWarp);
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int chunk) {
    const int st = chunk % STAGES, use = chunk / STAGES;
    if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
    uint32_t* dst = ring + st * kStage;
    const size_t k0 = (size_t)chunk * CH;
    mbar_expect_tx(full + st, 2 * kPartBytes + 4 * CH);
    bulk_copy_g2s(dst, hi_g + k0 * S, kPartBytes, full + st);
    bulk_copy_g2s(dst + CH * S, lo_g + k0 * S, kPartBytes, full + st);
    bulk_copy_g2s(dst + 2 * CH * S, csq_g + k0, 4 * CH, full + st);
  };
  if (tid == 0 && STAGES == 2) issue(0);

// The block's tokens go raw into xh (every thread, many loads in flight);
  // then the first warp of each tile splits its rows, each quad rows g and
  // g + 8 (channels t mod 4), and sums their squares; a barrier publishes the
  // split tile and |x|^2 to both warps of the tile.
  const int t0 = rb * kTokens;
#pragma unroll 8
  for (int i = tid; i < kTokens * Cp; i += kCaThreads) {
    const int r = i / Cp, c = i % Cp;
    const float v = (t0 + r < N && c < clen) ? x[(size_t)(t0 + r) * C + cbase + c] : 0.f;
    xh[r * S + c] = __float_as_uint(v);
  }
  __syncthreads();
  if (warp < kTiles) {  // (half 0, part 0)
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
  if (SPLIT) cluster_sync();  // every block's |x|^2 partials written
  const uint32_t* ah_row = xh + (tile * 16 + g) * S + t;
  const uint32_t* al_row = xl + (tile * 16 + g) * S + t;
  // |x|^2 of rows g and g + 8: the slabs' partials summed in block order
  auto row_sq = [&](int r) {
    if (!SPLIT) return xsq_s[r];
    float v = 0.f;
    for (int b = 0; b < nranks; ++b) v += ld_cluster_f32(cluster_map(xsq_s + r, b));
    return v;
  };
  float* xbuf = reinterpret_cast<float*>(smem + 2 * kTokens * S + STAGES * kStage);

  // Running state of rows g (index 0) and g + 8 (index 1) over this warp's
  // centers (half `half` of every chunk); s and Q are this lane's share (its
  // centers 2t, 2t + 1 of each 8), summed over the quad at the end.
  float m[2] = {INFINITY, INFINITY}, s_part[2] = {0.f, 0.f}, q_part[2] = {0.f, 0.f};
  int arg[2] = {0, 0};
  const float xsq[2] = {row_sq(tile * 16 + g), row_sq(tile * 16 + g + 8)};
  float acc[NTL][4];
#pragma unroll
  for (int n = 0; n < NTL; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int ci = 0; ci < nchunks; ++ci) {
    if (tid == 0 && ci + STAGES - 1 < nchunks) issue(ci + STAGES - 1);
    mbar_wait(full + ci % STAGES, (ci / STAGES) & 1);
    const uint32_t* stage = ring + (ci % STAGES) * kStage;
    const uint32_t* ch = stage + half * kHalf * S;  // this warp's kHalf center rows
    const uint32_t* cl = ch + CH * S;
    const float* cs = reinterpret_cast<const float*>(stage + 2 * CH * S) + half * kHalf;
    const int k0 = ci * CH + half * kHalf;

    // product 1: cross (16 x kHalf) over the channels; four accumulator sets
    // by k step keep independent chains in flight
    float cr[4][kJ][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < kJ; ++j) cr[p][j][0] = cr[p][j][1] = cr[p][j][2] = cr[p][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const uint32_t ah[4] = {ah_row[8 * kk], ah_row[8 * S + 8 * kk], ah_row[8 * kk + 4],
                              ah_row[8 * S + 8 * kk + 4]};
      const uint32_t al[4] = {al_row[8 * kk], al_row[8 * S + 8 * kk], al_row[8 * kk + 4],
                              al_row[8 * S + 8 * kk + 4]};
      uint32_t bh[kJ][2], bl[kJ][2];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int off = (8 * j + g) * S + 8 * kk + t;
        bh[j][0] = ch[off], bh[j][1] = ch[off + 4];
        bl[j][0] = cl[off], bl[j][1] = cl[off + 4];
      }
      // pass by pass, so that neighbouring mma do not depend on each other
#pragma unroll
      for (int j = 0; j < kJ; ++j) mma_tf32(cr[kk & 3][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) mma_tf32(cr[kk & 3][j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) mma_tf32(cr[kk & 3][j], ah, bh[j][0], bh[j][1]);
    }

    float cross[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cross[j][e] = (cr[0][j][e] + cr[1][j][e]) + (cr[2][j][e] + cr[3][j][e]);
    if (SPLIT) {
      // the slabs' partials, summed in block order from every block's buffer
      float* mine = xbuf + (((ci & 1) * (kCaThreads / kWarp) + warp) * kJ * 4) * kWarp + lane;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * kWarp] = cross[j][e];
      cluster_sync();
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = 0.f;
          for (int b = 0; b < nranks; ++b)
            v += ld_cluster_f32(cluster_map(mine + (4 * j + e) * kWarp, b));
          cross[j][e] = v;
        }
    }

    // distances; this chunk's first-occurrence minimum of each row
    float d[kJ][4], cmin[2] = {INFINITY, INFINITY};
    int cidx[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const float d2 = (xsq[h] + cs[kc]) - 2.f * cross[j][e];
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
      for (int n = 0; n < NTL; ++n) {
        acc[n][0] *= f[0], acc[n][1] *= f[0];
        acc[n][2] *= f[1], acc[n][3] *= f[1];
      }
    }
    float ev[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
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

    // product 2: recon += e . chunk over this warp's channel tiles, one
    // 8-center k step per tile of product 1, A column t <-> center 2t,
    // column t + 4 <-> center 2t + 1
#pragma unroll
    for (int kk = 0; kk < kJ; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(ev[kk][0], ah[0], al[0]);  // row g,     center 2t
      split_tf32(ev[kk][2], ah[1], al[1]);  // row g + 8, center 2t
      split_tf32(ev[kk][1], ah[2], al[2]);  // row g,     center 2t + 1
      split_tf32(ev[kk][3], ah[3], al[3]);  // row g + 8, center 2t + 1
      const uint32_t* bh = ch + (8 * kk + 2 * t) * S + 8 * n0 + g;
      const uint32_t* bl = cl + (8 * kk + 2 * t) * S + 8 * n0 + g;
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        const uint32_t h0 = bh[8 * n], h1 = bh[S + 8 * n];
        const uint32_t l0 = bl[8 * n], l1 = bl[S + 8 * n];
        mma_tf32(acc[n], ah, l0, l1);
        mma_tf32(acc[n], al, h0, h1);
        mma_tf32(acc[n], ah, h0, h1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + ci % STAGES);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s_part[h] += __shfl_xor_sync(0xffffffffu, s_part[h], 1);
    s_part[h] += __shfl_xor_sync(0xffffffffu, s_part[h], 2);
    q_part[h] += __shfl_xor_sync(0xffffffffu, q_part[h], 1);
    q_part[h] += __shfl_xor_sync(0xffffffffu, q_part[h], 2);
  }
  __syncthreads();  // every chunk read: the ring is free
  // The second warp of each (tile, part) hands its state to the first through
  // the ring, lane to lane; the first merges the two (a split-K softmax: both
  // rescale to the smaller minimum, a tie to the lower index).  The P parts
  // of a tile hold the same state; part 0 writes the labels and the loss.
  float* xch = reinterpret_cast<float*>(ring) + (tile * P + part) * kXch * kWarp + lane;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 * n + e) * kWarp] = acc[n][e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xch[(4 * NTL + h) * kWarp] = m[h];
      xch[(4 * NTL + 2 + h) * kWarp] = __int_as_float(arg[h]);
      xch[(4 * NTL + 4 + h) * kWarp] = s_part[h];
      xch[(4 * NTL + 6 + h) * kWarp] = q_part[h];
    }
  }
  __syncthreads();
  if (half == 0) {
    float row_loss = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = xch[(4 * NTL + h) * kWarp];
      const int a1 = __float_as_int(xch[(4 * NTL + 2 + h) * kWarp]);
      if (m1 < m[h] || (m1 == m[h] && a1 < arg[h])) arg[h] = a1;
      const float mm = fminf(m[h], m1);
      const float f0 = m[h] == INFINITY ? 0.f : expf(-alpha * (m[h] - mm));
      const float f1 = m1 == INFINITY ? 0.f : expf(-alpha * (m1 - mm));
      const float s = s_part[h] * f0 + xch[(4 * NTL + 4 + h) * kWarp] * f1;
      const float q = q_part[h] * (f0 * f0) + xch[(4 * NTL + 6 + h) * kWarp] * (f1 * f1);
      const int tok = row0 + g + 8 * h;
      if (tok < N) {
        float* out = recon + (size_t)tok * C + cbase;
        const float inv = 1.f / s;
#pragma unroll
        for (int n = 0; n < NTL; ++n) {
          const int c = 8 * (n0 + n) + 2 * t;
          const float r0 = acc[n][2 * h] * f0 + xch[(4 * n + 2 * h) * kWarp] * f1;
          const float r1 = acc[n][2 * h + 1] * f0 + xch[(4 * n + 2 * h + 1) * kWarp] * f1;
          if (c < clen) out[c] = r0 * inv;
          if (c + 1 < clen) out[c + 1] = r1 * inv;
        }
        if (t == 0 && part == 0 && rank == 0) {
          labels[tok] = arg[h];
          row_loss += q / (s * s);
        }
      }
    }
    row_loss = warp_sum(row_loss);
    if (lane == 0 && part == 0) tile_loss[tile] = row_loss;
  }
  __syncthreads();
  if (tid == 0 && rank == 0) {
    float sum = 0.f;
    for (int w = 0; w < kTiles; ++w) sum += tile_loss[w];
    partials[rb] = sum;
  }
  if (SPLIT) cluster_sync();  // no block leaves while another may read its buffers
}

// Instance I on one block per row tile, or (SPLIT) on clusters of `blocks`
// blocks per row tile, each on a slab of `slab` channels.
template <int I, bool SPLIT>
cudaError_t launch_cluster_assign(const float* x, const float* csq, const uint32_t* hi,
                                  const uint32_t* lo, float* recon, int32_t* labels,
                                  float* partials, int N, int C, int K, float alpha, int blocks,
                                  int slab, cudaStream_t s) {
  constexpr CaShape sh = kCaShapes[I];
  constexpr size_t smem = ca_smem_bytes(sh.nt, sh.parts, sh.chunk, sh.stages, SPLIT);
  static_assert(smem + 4 * (kCaMaxTokens + 4) + 2 * 8 * sh.stages <= (size_t)kMaxSmemBytes,
                "the block fits 227 KB");
  const auto kernel = cluster_assign_mma_kernel<sh.nt, sh.parts, sh.chunk, sh.stages, SPLIT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = ca_row_blocks(N, sh.parts);
  if (!SPLIT) {
    kernel<<<rows, kCaThreads, smem, s>>>(x, csq, hi, lo, recon, labels, partials, N, C, K,
                                          alpha, C);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * blocks));
  cfg.blockDim = dim3(kCaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, csq, hi, lo, recon, labels, partials, N, C, K,
                           alpha, slab);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

// Scratch floats the wrapper allocates: |c|^2 (Kp), the centers' hi and lo
// parts (Kp x Cp each, per channel slab) and one loss partial per row tile;
// -1 if C is too wide (above 6144).
long long vadcl_cluster_assign_scratch(int N, int C, int K) {
  using namespace vadcl;
  const int i = ca_shape(C);
  if (i < 0 || N <= 0 || K <= 0 || C <= 0) return -1;
  const long long kp = ca_kp(K);
  return kp + 2 * ca_blocks(C) * kp * ca_stride(kCaShapes[i].nt) +
         ca_row_blocks(N, kCaShapes[i].parts);
}

// The instance a width takes, as nt | parts << 8 | chunk << 12 | stages << 20
// | blocks << 24 (blocks splitting the channels; 0 above 6144): what
// ops/cluster_kernels.py:cluster_assign_shape and cluster_assign_blocks
// mirror.
int vadcl_cluster_assign_shape(int C) {
  using namespace vadcl;
  const int i = C > 0 ? ca_shape(C) : -1;
  if (i < 0) return 0;
  const CaShape& sh = kCaShapes[i];
  return sh.nt | sh.parts << 8 | sh.chunk << 12 | sh.stages << 20 | ca_blocks(C) << 24;
}

int vadcl_cluster_assign(const float* x, const float* centers, float* recon,
                         int32_t* labels, float* scratch, float* loss, int N,
                         int C, int K, float alpha, void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int i = ca_shape(C);
  if (i < 0 || N <= 0 || K <= 0 || C <= 0) return cudaErrorInvalidValue;
  const int kp = ca_kp(K), stride = ca_stride(kCaShapes[i].nt);
  const int blocks = ca_blocks(C), slab = ca_slab(C);
  float* csq = scratch;
  uint32_t* hi = reinterpret_cast<uint32_t*>(scratch + kp);
  uint32_t* lo = hi + (size_t)blocks * kp * stride;
  float* partials = reinterpret_cast<float*>(lo + (size_t)blocks * kp * stride);
  const int warps = kCaPrepThreads / kWarp;
  cluster_assign_prep_kernel<<<(kp + warps - 1) / warps, kCaPrepThreads, 0, s>>>(
      centers, K, C, kp, stride, slab, blocks, csq, hi, lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto launch = [&](auto inst) {
    return launch_cluster_assign<decltype(inst)::value, false>(
        x, csq, hi, lo, recon, labels, partials, N, C, K, alpha, 1, C, s);
  };
  const auto launch_split = [&](auto inst) {
    return launch_cluster_assign<decltype(inst)::value, true>(
        x, csq, hi, lo, recon, labels, partials, N, C, K, alpha, blocks, slab, s);
  };
  if (blocks > 1) {  // the widest two instances, on a slab of the channels each
    err = i == 8 ? launch_split(std::integral_constant<int, 8>())
                 : launch_split(std::integral_constant<int, 9>());
  } else {
    switch (i) {
      case 0: err = launch(std::integral_constant<int, 0>()); break;
      case 1: err = launch(std::integral_constant<int, 1>()); break;
      case 2: err = launch(std::integral_constant<int, 2>()); break;
      case 3: err = launch(std::integral_constant<int, 3>()); break;
      case 4: err = launch(std::integral_constant<int, 4>()); break;
      case 5: err = launch(std::integral_constant<int, 5>()); break;
      case 6: err = launch(std::integral_constant<int, 6>()); break;
      case 7: err = launch(std::integral_constant<int, 7>()); break;
      case 8: err = launch(std::integral_constant<int, 8>()); break;
      default: err = launch(std::integral_constant<int, 9>()); break;
    }
  }
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partials, ca_row_blocks(N, kCaShapes[i].parts), loss, s);
}

}  // extern "C"
