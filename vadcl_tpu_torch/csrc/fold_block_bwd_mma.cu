// The whole-Swin-block backward for Hopper (bf16): the 14 gradients of
//   y = y1 + fc2(gelu(fc1(LN2 y1))),   y1 = x + proj(attention(LN1 x))
// per (8,7,7)-shrunk window of the unpartitioned (B, D, H, W, C) tensor, the
// shift roll folded into the addressing: dx, dLN1, dqkv_w, dqkv_b, dproj_w,
// dproj_b, d(bias), dLN2, dw1, db1, dw2, db2.
//
// Replaces vadcl_tpu/ops/pallas_attn_fold.py:_fold_bwd_kernel in its tail_refs
// mode (entry _fold_bwd_call through _full_bwd, the custom VJP of
// folded_full_block_trainable) for bf16 windows of at most 112 tokens at head
// width 16 or 32, C % 16 == 0, C <= 192, a hidden width divisible by 64 and a
// block within 227 KB (ops/fold_attn.py:fold_block_bwd_body picks);
// fold_attn_bwd.cu's whole-block body keeps fp32 and every other geometry.
//
// Numerical contract: fold_block_bwd_plain's, the cast boundaries of the
// reference: y1 rounds to bf16; LN2 is fp32, z rounds before fc1 and h before
// GELU; dw1 = z^T.dh, dw2 = g^T.dY and dz = dh.W1^T are products of fp32
// operands; dy1 = dY + LN2-vjp(dz) rounds to bf16 and is the attention
// backward's upstream gradient and the residual branch's.  Products whose
// operands the contract rounds to bf16 run as one bf16 mma.sync.m16n8k16 pass
// with fp32 accumulation; an fp32 operand (dh in dz; z, g, dh in the weight
// sums) is split into hi = round(x) and lo = round(x - hi) and both passes are
// summed in fp32 (about 1e-5 relative, ln_mlp_bwd_mma.cu's scheme).  No fp32
// operand is rounded once to bf16.
//
// Design: the strip bodies of kernels A (fold_attn_mma.cuh), 5
// (ln_mlp_bwd_mma.cu) and 6 (fold_attn_bwd_mma.cu) in one launch; step 1
// (kernel A's) is fold_block_mma.cuh:bb_attn_strip, which the whole-block
// forward (fold_block_mma.cu) runs too.  A window is
// padded to Np = 64 or 112 rows and cut into strips of 16; warp w owns strip w
// in every step, so a step hands its rows to the next through the warp's own
// registers and shared-memory rows.  A block walks a chunk of consecutive
// windows (kBbBlocks blocks in all); one producer warp streams every weight
// through one two-stage cp.async.bulk / mbarrier ring, per window in the order
// the steps use them: kernel A's pack (ops/fold_attn.py:pack_fold_weights)
// for step 1, kernel B's pack (ops/ln_mlp.py:pack_mlp_weights) in pieces of
// 32 hidden columns for step 2, kernel A's pack again for step 3 and dxa.
// Per window:
//   1. y1 on kernel A's strip body: LN1 of the strip, per head q, k, v, the
//      scores in registers on top of the packed bias and mask, P = e / l
//      (ex2.approx.ftz, fa_div), o = round(P).V into the o tile and to the
//      workspace (dproj_w's operand, never recomputed), then y1 = round(x +
//      o.W_proj + proj_b) into the strip's rows of the LN1 tile;
//   2. kernel 5's strip body on those rows: LN2 in fp32, round(z).W1 and
//      dY.W2^T one bf16 pass each, a ring stage's 32 hidden columns at a time
//      (two independent chains a warp), hb, g, dh (z, g, dh to the workspace
//      as hi/lo pairs for the second pass), dz += dh_hi.W1^T + dh_lo.W1^T in
//      registers over the hidden width, then dy1 = round(dY + LN2-vjp(dz)) to
//      the workspace and the strip's dLN2 column sums;
//   3. kernel 6's strip body with dy1 as upstream: LN1 again, per head q, k,
//      v and doa = round(dy1.W_proj^T), the row phase in registers (d(bias)
//      summed over the block's chunk by its one owner), the column phase from
//      the round(P) and round(ds * scale) tiles, round(dqkv) to the
//      workspace; dxa = round(dqkv).W_qkv^T, dx = LN1-vjp(dxa) + dy1 two rows
//      at a time (a half-warp a row).
// Three named barriers of the window's warps separate the steps (each step's
// tiles overlay the last one's), besides kernels A's and 6's own per head.
// Shared memory: the ring, the LN1 / y1 tile, and the largest step's region
// (step 3's, as kernel 6's body): 199 KB at N = 98, C = 192.  LN1's rows,
// q, k and v do not stay resident from step 1 to step 3: at C = 192 the y1
// rows, the z and dY tiles and kernel 6's region would need 236 KB.  Windows
// of at most 64 tokens at head width 16 and C <= 96 (85 KB) run two blocks an
// SM (168 registers, a few spilled); every other instance one (237-255).
//
// Deterministic sums: every partial has one owner (d(bias) per (block, head,
// i, j); dqkv_b, dLN1 and dLN2 per (block, strip, column)), written by the
// chunk's first window and added to by the others in window order, each
// owner reading all its old values before it writes any (a read-modify-write
// a value cost one trip to L2 each: most of the first build's time where a
// chunk held two windows); at the block's end its strips' partials are summed
// in strip order.  The second pass sums the blocks' partials in a fixed order
// (bb_sum_rows: eight groups of rows, then the groups) and forms dqkv_w,
// dproj_w (with dproj_b), dw1 (with db1) and dw2 (with db2) on the tensor
// cores (reduce_mma.cu).  No float atomics: two calls give the same bits.
//
// What bounds it: at enc stage 0, batch 4 (25,088 tokens, C = 96, hidden
// 384) the products are 25 GFLOP as the bf16 passes run them (0.025 ms at
// 989 TFLOP/s) and the fp32 contract's MLP products 9.25 GFLOP (0.138 ms at
// 67 TFLOP/s FMA).  On an H100 80GB HBM3 at 700 W the launch reads 0.49 ms
// and the second pass 0.18 (0.15 of it the four weight products); per window
// a warp spends about 40% of its clocks in step 2 (issue-bound on the erff
// GELU and its derivative with two warps a scheduler), 35% in step 3's heads,
// 11% in step 1.  What the design does not do: more than one 8-warp block an
// SM at N = 98 (255 registers, up to 199 KB), and anything about enc stage 1
// (64 windows at batch 4, so 64 blocks for 132 SMs): the chain of a window's
// steps runs in one block, and splitting its heads across blocks would split
// step 2, which needs every head's y1.
#include "fold_block_mma.cuh"
#include "mlp_bwd.cuh"
#include "reduce.cuh"
#include "reduce_mma.cuh"

namespace vadcl {

constexpr int kBbBlocks = 132;  // target blocks an SM a block: windows are chunked to this
constexpr int kBbDxaPad = 4;    // floats of padding per dxa row

struct BbLayout {
  size_t stage, ring, row, kv, o, z, dy, stats, tiles, ptile, dtile, dxa, bytes;
};

// Shared memory of one block for a window of n tokens, width c, head width hd:
// the ring, the LN1 tile (the y1 rows in steps 1 and 2), then one region that
// each step lays out anew.
__host__ __device__ inline BbLayout bb_layout(int n, int c, int hd) {
  const size_t np = fa_padded_rows(n), ldw = fa_ldw(hd), ldkv = fa_ldkv(hd), bf = 2;
  const size_t a_stage = bf * ((size_t)c * ldw + (size_t)bb_proj_slices(c, hd) * hd * ldw);
  const size_t b_stage = bf * 2 * (size_t)c * kBbPiece;
  const size_t tile = bf * np * (c + kFaPad);
  BbLayout l;
  l.stage = a_stage > b_stage ? a_stage : b_stage;
  size_t o = kFaBarrierBytes;
  l.ring = o;  o += 2 * l.stage;
  l.row = o;   o += tile;
  // step 1: K and V of two heads, the o tile
  l.kv = o;
  l.o = o + bf * 2 * 2 * np * ldkv;
  size_t end = l.o + tile;
  // step 2: the round(z) and dY tiles, the rows' LN2 statistics
  l.z = o;
  l.dy = o + tile;
  l.stats = o + 2 * tile;
  const size_t s2 = l.stats + sizeof(float) * 2 * np;
  // step 3: kernel 6's tiles, then the dxa rows over them
  l.tiles = o;
  l.ptile = o + bf * 2 * 4 * np * ldkv;
  l.dtile = l.ptile + bf * np * (np + 8);
  const size_t s3 = l.dtile + bf * np * (np + 8);
  l.dxa = o;
  const size_t s3x = o + sizeof(float) * np * (c + kBbDxaPad);
  if (s2 > end) end = s2;
  if (s3 > end) end = s3;
  if (s3x > end) end = s3x;
  l.bytes = end;
  return l;
}

inline bool bb_eligible(int n, int c, int nh, int ch) {
  if (nh <= 0 || c % nh || c % 16 || c > kBbMaxC || n <= 0 || n > kFaMaxTokens || ch <= 0 ||
      ch % kBbPackChunk)
    return false;
  const int hd = c / nh;
  return (hd == 16 || hd == 32) && bb_layout(n, c, hd).bytes <= (size_t)kMaxSmemBytes;
}

struct BbArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dout;  // dY, the block's upstream gradient
  const float* ln_s;
  const float* ln_b;
  const __nv_bfloat16* wpack;  // kernel A's pack
  const float* qkv_b;          // (3C,)
  const float* proj_b;         // (C,)
  const float* biasp;          // kernel A's packed bias
  const float* maskp;          // kernel A's packed mask, or null
  const float* ln2_s;
  const float* ln2_b;
  const __nv_bfloat16* mpack;  // kernel B's pack
  const float* b1;             // (Ch,)
  __nv_bfloat16* dx;
  __nv_bfloat16 *row_ws, *o_ws, *dy1_ws;  // (T, C)
  __nv_bfloat16* dqkv_ws;                 // (T, 3C)
  __nv_bfloat16 *z_hi, *z_lo;             // (T, C)
  __nv_bfloat16 *g_hi, *g_lo, *dh_hi, *dh_lo;  // (T, Ch)
  float* dqkvb_part;  // (blocks, strips, 3C)
  float* dln_part;    // (blocks, strips, 2C): sum dxa*xhat, sum dxa
  float* dln2_part;   // (blocks, strips, 2C): sum dz*xhat2, sum dz
  float* dbias_part;  // (blocks, nH, N, N)
  int B, D, H, W, C, nh, Ch, wd, wh, ww;
  int sd, sh, sw;
  float scale;
  int chunk;  // windows per block
};

__device__ __forceinline__ uint32_t bb_pair(const __nv_bfloat16* base, long long off) {
  return off < 0 ? 0u : *reinterpret_cast<const uint32_t*>(base + off);
}

// A row of n partial sums owned by one warp: the chunk's first window writes
// `v`, the others add it, every old value read before any is written (one
// latency, not one a value).
__device__ __forceinline__ void bb_add_row(float* p, const float* v, int n, int lane,
                                           bool first) {
  constexpr int kMax = 2 * kBbMaxC / kWarp;
  float old[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    const int c = lane + k * kWarp;
    old[k] = (!first && c < n) ? p[c] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    const int c = lane + k * kWarp;
    if (c < n) p[c] = old[k] + v[c];
  }
}

// hi = round(x), lo = round(x - hi) of two neighbouring values into two arrays.
__device__ __forceinline__ void bb_store_split(__nv_bfloat16* hi, __nv_bfloat16* lo, size_t off,
                                               float a, float b) {
  float ha, la, hb, lb;
  split_bf16(a, ha, la);
  split_bf16(b, hb, lb);
  *reinterpret_cast<uint32_t*>(hi + off) = pack_bf16(ha, hb);
  *reinterpret_cast<uint32_t*>(lo + off) = pack_bf16(la, lb);
}

// One of dq, dk, dv (16 rows x kHt 8-column tiles) of the warp's tokens:
// rounded into dqkv at columns col0 .., its unrounded column sums into the
// strip's dqkv_b partial (``old``: the partial's values there, read before).
template <int kHt>
__device__ __forceinline__ void bb_emit_dqkv(const float (&v)[kHt][4], __nv_bfloat16* dqkv,
                                             float* part, const float2 (&old)[kHt], int col0,
                                             long long tok0, long long tok1, int C3, int t,
                                             int g, bool first) {
#pragma unroll
  for (int i = 0; i < kHt; ++i) {
    const int col = col0 + i * 8 + 2 * t;
    float c0 = 0.f, c1 = 0.f;
    if (tok0 >= 0) {
      *reinterpret_cast<uint32_t*>(dqkv + tok0 * C3 + col) = pack_bf16(v[i][0], v[i][1]);
      c0 += v[i][0], c1 += v[i][1];
    }
    if (tok1 >= 0) {
      *reinterpret_cast<uint32_t*>(dqkv + tok1 * C3 + col) = pack_bf16(v[i][2], v[i][3]);
      c0 += v[i][2], c1 += v[i][3];
    }
#pragma unroll
    for (int o = 4; o < kWarp; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (g == 0)
      *reinterpret_cast<float2*>(part + col) =
          first ? make_float2(c0, c1) : make_float2(old[i].x + c0, old[i].y + c1);
  }
}

// The strip's dqkv_b partial at head h's columns of q, k and v (lanes of
// g == 0), read in one go before the column phase adds to them.
template <int kHt, int kHd>
__device__ __forceinline__ void bb_load_dqkvb(float2 (&old)[3][kHt], const float* part, int C,
                                              int h, int t, int g, bool first) {
#pragma unroll
  for (int w = 0; w < 3; ++w)
#pragma unroll
    for (int i = 0; i < kHt; ++i)
      old[w][i] = (g == 0 && !first)
                      ? *reinterpret_cast<const float2*>(part + w * C + h * kHd + i * 8 + 2 * t)
                      : make_float2(0.f, 0.f);
}

// Blocks an SM of an instance: two for windows of at most 64 tokens at head
// width 16 and C <= 96 (the decoder's last stage), else one.
__host__ __device__ constexpr int bb_blocks_per_sm(int nt, int hd, int ct) {
  return nt == 8 && hd == 16 && ct == 6 ? 2 : 1;
}

// kNt = Np / 8 (8 or 14), kHd the head width (16 or 32), kCt the 16-column
// tiles of dz a warp holds (6: C <= 96, 12: C <= 192).
template <int kNt, int kHd, int kCt>
__global__ void __launch_bounds__((kNt / 2 + 1) * kWarp, bb_blocks_per_sm(kNt, kHd, kCt))
    fold_block_bwd_mma_kernel(BbArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kStrips = kNt / 2, Np = kNt * 8, kHt = kHd / 8, kQt = 3 * kHt;
  constexpr int kLdw = fa_ldw(kHd), kLdkv = fa_ldkv(kHd), kLdp = Np + 8;
  constexpr int kConsumers = kStrips * kWarp;
  extern __shared__ __align__(128) unsigned char sm[];

  const int C = a.C, nh = a.nh, C3 = 3 * C, ldr = C + kFaPad, ldx = C + kBbDxaPad;
  const int N = a.wd * a.wh * a.ww;
  const BbLayout L = bb_layout(N, C, kHd);
  const int npc = bb_proj_slices(C, kHd);
  const int npieces = a.Ch / kBbPiece;
  const uint32_t slice_bytes = (uint32_t)(sizeof(bf16) * C * kLdw);
  const uint32_t part_bytes = (uint32_t)(sizeof(bf16) * kHd * kLdw);
  const uint32_t half_bytes = (uint32_t)(sizeof(bf16) * C * kBbPiece);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + 2;
  unsigned char* ring = sm + L.ring;

  const int nwh = a.H / a.wh, nww = a.W / a.ww;
  const int nw = (a.D / a.wd) * nwh * nww;
  const long long total = (long long)a.B * nw;
  const long long wbeg = (long long)blockIdx.x * a.chunk;
  const long long wend = wbeg + a.chunk < total ? wbeg + a.chunk : total;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kStrips);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier

  if (warp == kStrips) {
    // producer: per window the items of steps 1, 2 and 3 in the order they are used
    if (lane == 0) {
      const int items = 3 * nh + npc + npieces;
      int seq = 0;
      for (long long widx = wbeg; widx < wend; ++widx)
        for (int item = 0; item < items; ++item, ++seq) {
          const int s = seq & 1, use = seq >> 1;
          if (use > 0) mbar_wait(empty + s, (uint32_t)((use - 1) & 1));
          unsigned char* dst = ring + (size_t)s * L.stage;
          if (item < nh + npc) {  // step 1: slice `item` of kernel A's pack
            mbar_expect_tx(full + s, slice_bytes);
            bulk_copy_g2s(dst, a.wpack + (size_t)item * C * kLdw, slice_bytes, full + s);
          } else if (item < nh + npc + npieces) {
            // step 2: hidden columns 32q .. 32q + 31 of kernel B's pack: W1's as
            // [4][C][8], then W2's as [C / 8][32][8]
            const int q = item - nh - npc, half = q & 1;
            const bf16* chunk = a.mpack + (size_t)(q >> 1) * 2 * C * kBbPackChunk;
            mbar_expect_tx(full + s, 2 * half_bytes);
            bulk_copy_g2s(dst, chunk + (size_t)half * 4 * C * 8, half_bytes, full + s);
            const bf16* w2 = chunk + (size_t)C * kBbPackChunk + (size_t)half * kBbPiece * 8;
            for (int cg = 0; cg < C / 8; ++cg)
              bulk_copy_g2s(dst + half_bytes + (size_t)cg * kBbPiece * 8 * sizeof(bf16),
                            w2 + (size_t)cg * kBbPackChunk * 8, kBbPiece * 8 * sizeof(bf16),
                            full + s);
          } else {  // step 3: nH stages of (slice h, head h's W_proj rows), then nH slices
            const int k = item - nh - npc - npieces, h = k % nh;
            const bool proj = k < nh;
            mbar_expect_tx(full + s, slice_bytes + (proj ? npc * part_bytes : 0u));
            bulk_copy_g2s(dst, a.wpack + (size_t)h * C * kLdw, slice_bytes, full + s);
            if (proj)
              for (int j = 0; j < npc; ++j)
                bulk_copy_g2s(dst + slice_bytes + (size_t)j * part_bytes,
                              a.wpack + ((size_t)(nh + j) * C + (size_t)h * kHd) * kLdw,
                              part_bytes, full + s);
          }
        }
    }
    return;
  }

  const int strip = warp, g = lane >> 2, t = lane & 3;
  bf16* rowt = reinterpret_cast<bf16*>(sm + L.row);
  bf16* rows = rowt + (size_t)strip * 16 * ldr;  // the warp's LN1 (then y1) rows
  const bool has_mask = a.maskp != nullptr;
  const float pre = 1.f / a.scale, post = a.scale * kLog2e;
  const size_t nn = (size_t)N * N;
  const size_t prow = (size_t)blockIdx.x * kStrips + strip;
  float* dbias_blk = a.dbias_part + (size_t)blockIdx.x * nh * nn;
  float* dqkvb = a.dqkvb_part + prow * C3;
  float* dln = a.dln_part + prow * 2 * C;
  float* dln2 = a.dln2_part + prow * 2 * C;
  int seq = 0;

  for (long long widx = wbeg; widx < wend; ++widx) {
    const bool first = widx == wbeg;
    const int win = (int)(widx % nw), b = (int)(widx / nw);
    const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;
    const int i0 = strip * 16 + g, i1 = i0 + 8;  // the fragment rows of this lane
    const long long tok0 = bb_tok(a, b, wi_d, wi_h, wi_w, i0, N);
    const long long tok1 = bb_tok(a, b, wi_d, wi_h, wi_w, i1, N);
    const long long e0 = tok0 < 0 ? -1 : tok0 * C, e1 = tok1 < 0 ? -1 : tok1 * C;
    const float4* bfrag =
        reinterpret_cast<const float4*>(a.biasp) + (size_t)strip * kNt * kWarp + lane;
    const float4* mfrag =
        has_mask ? reinterpret_cast<const float4*>(a.maskp) +
                       ((size_t)win * kStrips + strip) * kNt * kWarp + lane
                 : nullptr;
    auto ln1_rows = [&]() {  // LN1 of the warp's 16 rows into its rows of the tile
      const int r = lane >> 1;
      const long long tr = bb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + r, N);
      warp_ln_16rows(tr < 0 ? nullptr : a.x + tr * C, C, a.ln_s, a.ln_b,
                     reinterpret_cast<uint4*>(rows + (size_t)r * ldr), 1, nullptr, lane);
      __syncwarp();
    };

    // ---- step 1: y1 = round(x + o . W_proj + proj_b), kernel A's strip body ----
    ln1_rows();
    bb_attn_strip<kNt, kHd>(a, ring, L.stage, full, empty, seq, 0,
                            reinterpret_cast<bf16*>(sm + L.kv),
                            reinterpret_cast<bf16*>(sm + L.o) + (size_t)strip * 16 * ldr, rows, ldr,
                            bfrag, mfrag, pre, post, e0, e1, a.o_ws, strip, lane);
    named_barrier(1, kConsumers);  // the K, V and o tiles are free: step 2 overlays them

    // ---- step 2: kernel 5's strip body on the warp's y1 rows ----
    {
      bf16* zt = reinterpret_cast<bf16*>(sm + L.z) + (size_t)strip * 16 * ldr;
      bf16* dyt = reinterpret_cast<bf16*>(sm + L.dy) + (size_t)strip * 16 * ldr;
      float* mu = reinterpret_cast<float*>(sm + L.stats) + strip * 16;
      float* rs = mu + Np;
      for (int r = 0; r < 16; ++r) {
        const long long tr = bb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + r, N);
        bf16* zr = zt + (size_t)r * ldr;
        bf16* dr = dyt + (size_t)r * ldr;
        if (tr < 0) {
          for (int c = 2 * lane; c < C; c += 2 * kWarp) {
            *reinterpret_cast<uint32_t*>(zr + c) = 0u;
            *reinterpret_cast<uint32_t*>(dr + c) = 0u;
          }
          if (lane == 0) mu[r] = rs[r] = 0.f;
          continue;
        }
        const bf16* yr = rows + (size_t)r * ldr;
        float m, rstd;
        warp_ln_stats(yr, C, &m, &rstd);
        if (lane == 0) mu[r] = m, rs[r] = rstd;
        for (int c = 2 * lane; c < C; c += 2 * kWarp) {
          const float2 yv = unpack_bf16(*reinterpret_cast<const uint32_t*>(yr + c));
          const float z0 = (yv.x - m) * rstd * a.ln2_s[c] + a.ln2_b[c];
          const float z1 = (yv.y - m) * rstd * a.ln2_s[c + 1] + a.ln2_b[c + 1];
          *reinterpret_cast<uint32_t*>(zr + c) = pack_bf16(z0, z1);
          bb_store_split(a.z_hi, a.z_lo, (size_t)tr * C + c, z0, z1);
          *reinterpret_cast<uint32_t*>(dr + c) =
              *reinterpret_cast<const uint32_t*>(a.dout + (size_t)tr * C + c);
        }
      }
      __syncwarp();  // (the tiles' rows and statistics are the warp's own)

      float dz[2 * kCt][4];
#pragma unroll
      for (int i = 0; i < 2 * kCt; ++i) dz[i][0] = dz[i][1] = dz[i][2] = dz[i][3] = 0.f;
      const int nct = C / 16;
      for (int q = 0; q < npieces; ++q, ++seq) {
        const int s = seq & 1;
        mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
        // W1's columns at element (c, n): ((n / 8) * C + c) * 8 + n % 8;
        // W2's rows at element (n, c): ((c / 8) * 32 + n) * 8 + c % 8
        const bf16* w1s = reinterpret_cast<const bf16*>(ring + (size_t)s * L.stage);
        const bf16* w2s = w1s + (size_t)C * kBbPiece;
        // the piece's 32 hidden columns together: two independent chains a warp,
        // the round(z) and dY fragments loaded once for both
        constexpr int kP = kBbPiece / 16;
        float hacc[2 * kP][4], dg[2 * kP][4];
#pragma unroll
        for (int i = 0; i < 2 * kP; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[i][e] = dg[i][e] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < C; k0 += 16) {
          uint32_t az[4], ad[4];
          ldsm_x4(az, a_frag_row(zt + k0, ldr, lane));
          ldsm_x4(ad, a_frag_row(dyt + k0, ldr, lane));
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            uint32_t bw[4], bv[4];
            ldsm_x4_t(bw, w1s + ((size_t)(2 * p + (lane >> 4)) * C + k0 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * 8);
            mma_bf16(hacc[2 * p], az, bw[0], bw[1]);
            mma_bf16(hacc[2 * p + 1], az, bw[2], bw[3]);
            ldsm_x4(bv, w2s + ((size_t)((k0 >> 3) + ((lane >> 3) & 1)) * kBbPiece + 16 * p +
                               (lane & 7) + (lane >> 4) * 8) * 8);
            mma_bf16(dg[2 * p], ad, bv[0], bv[1]);
            mma_bf16(dg[2 * p + 1], ad, bv[2], bv[3]);
          }
        }
        // hb = round(h + b1), g = gelu(hb), dh = (dY . W2^T) * gelu'(hb)
        float dh[2 * kP][4];
#pragma unroll
        for (int nt = 0; nt < 2 * kP; ++nt) {
          const int col = q * kBbPiece + nt * 8 + 2 * t;
          const float2 bb = *reinterpret_cast<const float2*>(a.b1 + col);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float hb0 = round_to<bf16>(hacc[nt][2 * hr] + bb.x);
            const float hb1 = round_to<bf16>(hacc[nt][2 * hr + 1] + bb.y);
            dh[nt][2 * hr] = dg[nt][2 * hr] * dgelu_erf(hb0);
            dh[nt][2 * hr + 1] = dg[nt][2 * hr + 1] * dgelu_erf(hb1);
            const long long tk = hr ? tok1 : tok0;
            if (tk >= 0) {
              const size_t off = (size_t)tk * a.Ch + col;
              bb_store_split(a.g_hi, a.g_lo, off, gelu_erf(hb0), gelu_erf(hb1));
              bb_store_split(a.dh_hi, a.dh_lo, off, dh[nt][2 * hr], dh[nt][2 * hr + 1]);
            }
          }
        }
        // dz += dh . W1[:, cols]^T as hi and lo passes (B: k = hidden, n = c, stored
        // [n][k]), each accumulator taking the columns' blocks in order
        uint32_t ahi[kP][4], alo[kP][4];
#pragma unroll
        for (int p = 0; p < kP; ++p) acc_to_a_split(ahi[p], alo[p], dh[2 * p], dh[2 * p + 1]);
#pragma unroll
        for (int nc = 0; nc < kCt; ++nc) {
          if (nc >= nct) break;
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            uint32_t bw[4];
            ldsm_x4(bw, w1s + ((size_t)(2 * p + ((lane >> 3) & 1)) * C + nc * 16 + (lane & 7) +
                               (lane >> 4) * 8) * 8);
            mma_bf16(dz[2 * nc], ahi[p], bw[0], bw[1]);
            mma_bf16(dz[2 * nc + 1], ahi[p], bw[2], bw[3]);
            mma_bf16(dz[2 * nc], alo[p], bw[0], bw[1]);
            mma_bf16(dz[2 * nc + 1], alo[p], bw[2], bw[3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }

      // dy1 = dY + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), dxhat = dz * s2
      float m[2], r[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) m[hr] = mu[g + 8 * hr], r[hr] = rs[g + 8 * hr];
      const bool row_ok[2] = {tok0 >= 0, tok1 >= 0};
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2 * kCt; ++nt) {
        if (nt >= 2 * nct) break;
        const int col = nt * 8 + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(a.ln2_s + col);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 yv =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(rows + (g + 8 * hr) * ldr + col));
          const float d0 = dz[nt][2 * hr] * sc.x, d1 = dz[nt][2 * hr + 1] * sc.y;
          s1[hr] += d0 + d1;
          s2[hr] += d0 * ((yv.x - m[hr]) * r[hr]) + d1 * ((yv.y - m[hr]) * r[hr]);
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
#pragma unroll
      for (int nt = 0; nt < 2 * kCt; ++nt) {
        if (nt >= 2 * nct) break;
        const int col = nt * 8 + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(a.ln2_s + col);
        float cx0 = 0.f, cx1 = 0.f, cz0 = 0.f, cz1 = 0.f;  // this column pair's dLN2 sums
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (!row_ok[hr]) continue;
          const float2 yv =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(rows + (g + 8 * hr) * ldr + col));
          const float xh0 = (yv.x - m[hr]) * r[hr], xh1 = (yv.y - m[hr]) * r[hr];
          const float z0 = dz[nt][2 * hr], z1 = dz[nt][2 * hr + 1];
          const float2 dyv =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(dyt + (g + 8 * hr) * ldr + col));
          const float v0 = dyv.x + r[hr] * (z0 * sc.x - s1[hr] - xh0 * s2[hr]);
          const float v1 = dyv.y + r[hr] * (z1 * sc.y - s1[hr] - xh1 * s2[hr]);
          *reinterpret_cast<uint32_t*>(a.dy1_ws + (hr ? e1 : e0) + col) = pack_bf16(v0, v1);
          cx0 += z0 * xh0, cx1 += z1 * xh1, cz0 += z0, cz1 += z1;
        }
#pragma unroll
        for (int o = 4; o < kWarp; o <<= 1) {
          cx0 += __shfl_xor_sync(0xffffffffu, cx0, o);
          cx1 += __shfl_xor_sync(0xffffffffu, cx1, o);
          cz0 += __shfl_xor_sync(0xffffffffu, cz0, o);
          cz1 += __shfl_xor_sync(0xffffffffu, cz1, o);
        }
        if (g == 0) {  // (the z tile's rows are free: the strip's sums go there)
          float* sums = reinterpret_cast<float*>(zt);
          sums[col] = cx0, sums[col + 1] = cx1, sums[C + col] = cz0, sums[C + col + 1] = cz1;
        }
      }
      __syncwarp();
      bb_add_row(dln2, reinterpret_cast<const float*>(zt), 2 * C, lane, first);
    }
    named_barrier(1, kConsumers);  // step 3's tiles overlay the other warps' z and dY tiles

    // ---- step 3: kernel 6's strip body with dy1 as upstream ----
    ln1_rows();
    for (int e = lane; e < 16 * (C / 8); e += kWarp) {
      const int r = e / (C / 8), v = e % (C / 8);
      const long long tr = bb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + r, N);
      if (tr >= 0)
        *reinterpret_cast<uint4*>(a.row_ws + tr * C + 8 * v) =
            *reinterpret_cast<const uint4*>(rows + (size_t)r * ldr + 8 * v);
    }
    {
      bf16* tiles = reinterpret_cast<bf16*>(sm + L.tiles);
      bf16* Pt = reinterpret_cast<bf16*>(sm + L.ptile);
      bf16* Dt = reinterpret_cast<bf16*>(sm + L.dtile);
      for (int h = 0; h < nh; ++h, ++seq) {
        const int s = seq & 1;
        bf16* Qb = tiles + (size_t)((h & 1) * 4) * Np * kLdkv;
        bf16* Kb = Qb + (size_t)Np * kLdkv;
        bf16* Vb = Kb + (size_t)Np * kLdkv;
        bf16* Db = Vb + (size_t)Np * kLdkv;
        mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
        const bf16* slice = reinterpret_cast<const bf16*>(ring + (size_t)s * L.stage);
        const bf16* projp = slice + (size_t)C * kLdw;
        uint32_t qf[kHd / 16][4];
        bb_qkv<kHd, kLdw, kLdkv>(qf, rows, ldr, slice, a.qkv_b, C, h, Qb, Kb, Vb, strip, lane);
        // doa = round(dy1 . W_proj[h hd .. h hd + hd - 1, :]^T); B (k = c, n = d) is
        // stored [n][k] in the stage's W_proj rows, one block of 3hd columns per slice
        float da[kHt][4];
#pragma unroll
        for (int i = 0; i < kHt; ++i) da[i][0] = da[i][1] = da[i][2] = da[i][3] = 0.f;
        for (int c0 = 0; c0 < C; c0 += 16) {
          uint32_t af[4];
          af[0] = bb_pair(a.dy1_ws, e0 < 0 ? -1 : e0 + c0 + 2 * t);
          af[1] = bb_pair(a.dy1_ws, e1 < 0 ? -1 : e1 + c0 + 2 * t);
          af[2] = bb_pair(a.dy1_ws, e0 < 0 ? -1 : e0 + c0 + 8 + 2 * t);
          af[3] = bb_pair(a.dy1_ws, e1 < 0 ? -1 : e1 + c0 + 8 + 2 * t);
          const bf16* pj =
              projp + (size_t)(c0 / fa_slice(kHd)) * kHd * kLdw + c0 % fa_slice(kHd);
#pragma unroll
          for (int np = 0; np < kHd / 16; ++np) {
            uint32_t bf[4];
            ldsm_x4(bf, b_frag_row_nk(pj + (size_t)np * 16 * kLdw, kLdw, lane));
            mma_bf16(da[2 * np], af, bf[0], bf[1]);
            mma_bf16(da[2 * np + 1], af, bf[2], bf[3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);  // the stage comes back for dxa later
        uint32_t df[kHd / 16][4];  // round(doa) as the A fragments of dp = doa . v^T
#pragma unroll
        for (int ks = 0; ks < kHd / 16; ++ks) acc_to_a(df[ks], da[2 * ks], da[2 * ks + 1]);
#pragma unroll
        for (int i = 0; i < kHt; ++i) {
          bf16* dst = Db + (size_t)strip * 16 * kLdkv + i * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(dst + g * kLdkv) = pack_bf16(da[i][0], da[i][1]);
          *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdkv) = pack_bf16(da[i][2], da[i][3]);
        }
        named_barrier(1, kConsumers);  // every strip's q, k, v, doa of head h are in

        // row phase: P, round(P) into the P tile, rowsum(dp * P), ds, d(bias), dq
        float sacc[kNt][4];
        bb_softmax<kNt, kHd, kLdkv>(sacc, qf, Kb, bfrag + (size_t)h * kStrips * kNt * kWarp,
                                    mfrag, pre, post, lane);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          bf16* dst = Pt + (size_t)(strip * 16) * kLdp + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(dst + g * kLdp) = pack_bf16(sacc[nt][0], sacc[nt][1]);
          *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdp) = pack_bf16(sacc[nt][2], sacc[nt][3]);
        }
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
          float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < kHd / 16; ++ks) {
            uint32_t vf[4];
            ldsm_x4(vf, b_frag_row_nk(Vb + (size_t)np * 16 * kLdkv + ks * 16, kLdkv, lane));
            mma_bf16(dp[0], df[ks], vf[0], vf[1]);
            mma_bf16(dp[1], df[ks], vf[2], vf[3]);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            rs0 += dp[q][0] * sacc[2 * np + q][0] + dp[q][1] * sacc[2 * np + q][1];
            rs1 += dp[q][2] * sacc[2 * np + q][2] + dp[q][3] * sacc[2 * np + q][3];
          }
        }
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
        float dq[kHt][4];
#pragma unroll
        for (int i = 0; i < kHt; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
        float* dbh = dbias_blk + (size_t)h * nn;
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
          // the partial's old values of these 16 keys, in flight during the products
          float old[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? i0 : i1, j = (2 * np + q) * 8 + 2 * t + (e & 1);
              old[q][e] = (!first && i < N && j < N) ? dbh[(size_t)i * N + j] : 0.f;
            }
          float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < kHd / 16; ++ks) {
            uint32_t vf[4];
            ldsm_x4(vf, b_frag_row_nk(Vb + (size_t)np * 16 * kLdkv + ks * 16, kLdkv, lane));
            mma_bf16(dp[0], df[ks], vf[0], vf[1]);
            mma_bf16(dp[1], df[ks], vf[2], vf[3]);
          }
          float ss[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int nt = 2 * np + q;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ds = sacc[nt][e] * (dp[q][e] - (e < 2 ? rs0 : rs1));
              ss[q][e] = ds * a.scale;
              const int i = e < 2 ? i0 : i1, j = nt * 8 + 2 * t + (e & 1);
              if (i < N && j < N) dbh[(size_t)i * N + j] = old[q][e] + ds;
            }
            bf16* dst = Dt + (size_t)(strip * 16) * kLdp + nt * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(dst + g * kLdp) = pack_bf16(ss[q][0], ss[q][1]);
            *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdp) = pack_bf16(ss[q][2], ss[q][3]);
          }
          uint32_t sf[4];
          acc_to_a(sf, ss[0], ss[1]);
#pragma unroll
          for (int nq = 0; nq < kHd / 16; ++nq) {
            uint32_t kf[4];
            ldsm_x4_t(kf, b_frag_row_kn(Kb + (size_t)np * 16 * kLdkv + nq * 16, kLdkv, lane));
            mma_bf16(dq[2 * nq], sf, kf[0], kf[1]);
            mma_bf16(dq[2 * nq + 1], sf, kf[2], kf[3]);
          }
        }
        named_barrier(1, kConsumers);  // the P and ds tiles are complete

        // column phase: dv = round(P)^T . doa, dk = dss^T . q for key strip `strip`
        float2 oldb[3][kHt];  // (in flight during the products)
        bb_load_dqkvb<kHt, kHd>(oldb, dqkvb, C, h, t, g, first);
        float dv[kHt][4], dk[kHt][4];
#pragma unroll
        for (int i = 0; i < kHt; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[i][e] = dk[i][e] = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < kNt / 2; ++k2) {
          uint32_t ap[4], as[4];
          ldsm_x4_t(ap, a_frag_row_km(Pt + (size_t)k2 * 16 * kLdp + strip * 16, kLdp, lane));
          ldsm_x4_t(as, a_frag_row_km(Dt + (size_t)k2 * 16 * kLdp + strip * 16, kLdp, lane));
#pragma unroll
          for (int nq = 0; nq < kHd / 16; ++nq) {
            uint32_t bd[4], bq[4];
            ldsm_x4_t(bd, b_frag_row_kn(Db + (size_t)k2 * 16 * kLdkv + nq * 16, kLdkv, lane));
            ldsm_x4_t(bq, b_frag_row_kn(Qb + (size_t)k2 * 16 * kLdkv + nq * 16, kLdkv, lane));
            mma_bf16(dv[2 * nq], ap, bd[0], bd[1]);
            mma_bf16(dv[2 * nq + 1], ap, bd[2], bd[3]);
            mma_bf16(dk[2 * nq], as, bq[0], bq[1]);
            mma_bf16(dk[2 * nq + 1], as, bq[2], bq[3]);
          }
        }
        bb_emit_dqkv<kHt>(dq, a.dqkv_ws, dqkvb, oldb[0], 0 * C + h * kHd, tok0, tok1, C3, t, g,
                          first);
        bb_emit_dqkv<kHt>(dk, a.dqkv_ws, dqkvb, oldb[1], 1 * C + h * kHd, tok0, tok1, C3, t, g,
                          first);
        bb_emit_dqkv<kHt>(dv, a.dqkv_ws, dqkvb, oldb[2], 2 * C + h * kHd, tok0, tok1, C3, t, g,
                          first);
      }
    }

    // dxa = round(dqkv) . W_qkv^T: fp32 rows that overlay the per-head tiles
    named_barrier(1, kConsumers);
    float* dxa = reinterpret_cast<float*>(sm + L.dxa) + (size_t)strip * 16 * ldx;
    for (int e = lane; e < 16 * C; e += kWarp) dxa[(e / C) * ldx + e % C] = 0.f;
    __syncwarp();  // (also makes the warp's dqkv rows visible to all its lanes)
    const long long q0 = tok0 < 0 ? -1 : tok0 * C3, q1 = tok1 < 0 ? -1 : tok1 * C3;
    for (int h = 0; h < nh; ++h, ++seq) {
      const int s = seq & 1;
      uint32_t af[3 * kHd / 16][4];  // the warp's round(dqkv) rows of head h (q | k | v)
#pragma unroll
      for (int ks = 0; ks < 3 * kHd / 16; ++ks) {
        const int col = (16 * ks / kHd) * C + h * kHd + (16 * ks) % kHd;
        af[ks][0] = bb_pair(a.dqkv_ws, q0 < 0 ? -1 : q0 + col + 2 * t);
        af[ks][1] = bb_pair(a.dqkv_ws, q1 < 0 ? -1 : q1 + col + 2 * t);
        af[ks][2] = bb_pair(a.dqkv_ws, q0 < 0 ? -1 : q0 + col + 8 + 2 * t);
        af[ks][3] = bb_pair(a.dqkv_ws, q1 < 0 ? -1 : q1 + col + 8 + 2 * t);
      }
      mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
      const bf16* slice = reinterpret_cast<const bf16*>(ring + (size_t)s * L.stage);
      for (int nc = 0; nc < C / 16; ++nc) {
        float acc[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = nc * 16 + q * 8 + 2 * t;
          const float2 u = *reinterpret_cast<const float2*>(dxa + g * ldx + col);
          const float2 v = *reinterpret_cast<const float2*>(dxa + (g + 8) * ldx + col);
          acc[q][0] = u.x, acc[q][1] = u.y, acc[q][2] = v.x, acc[q][3] = v.y;
        }
#pragma unroll
        for (int ks = 0; ks < 3 * kHd / 16; ++ks) {
          uint32_t bf[4];  // B (k = the slice's columns, n = c) stored [n][k]
          ldsm_x4(bf, b_frag_row_nk(slice + (size_t)nc * 16 * kLdw + ks * 16, kLdw, lane));
          mma_bf16(acc[0], af[ks], bf[0], bf[1]);
          mma_bf16(acc[1], af[ks], bf[2], bf[3]);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = nc * 16 + q * 8 + 2 * t;
          *reinterpret_cast<float2*>(dxa + g * ldx + col) = make_float2(acc[q][0], acc[q][1]);
          *reinterpret_cast<float2*>(dxa + (g + 8) * ldx + col) =
              make_float2(acc[q][2], acc[q][3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    // dx = LN1-vjp(dxa) + dy1, two rows at a time (a half-warp a row, a lane a
    // column pair every 32 columns, loads of a row in flight together); the
    // dLN1 column sums per lane
    constexpr int kPairs = kBbMaxC / kWarp;
    const int half = lane >> 4, l16 = lane & 15;
    float2 cx[kPairs], cz[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) cx[k] = cz[k] = make_float2(0.f, 0.f);
    for (int r0 = 0; r0 < 16; r0 += 2) {
      if (i0 - g + r0 >= N) break;  // (padded rows are the last of a window)
      const int r = r0 + half;
      const long long tr = bb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + r, N);
      float2 xv[kPairs], dv[kPairs], sv[kPairs];
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int c = 2 * l16 + k * kWarp;
        const bool ok = tr >= 0 && c < C;
        xv[k] = ok ? unpack_bf16(*reinterpret_cast<const uint32_t*>(a.x + tr * C + c))
                   : make_float2(0.f, 0.f);
        dv[k] = ok ? *reinterpret_cast<const float2*>(dxa + r * ldx + c) : make_float2(0.f, 0.f);
        sv[k] = ok ? *reinterpret_cast<const float2*>(a.ln_s + c) : make_float2(0.f, 0.f);
        sum += xv[k].x + xv[k].y;
        sq += xv[k].x * xv[k].x + xv[k].y * xv[k].y;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      const float m = sum / C;
      const float rstd = 1.f / sqrtf(fmaxf(sq / C - m * m, 0.f) + 1e-5f);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const float d0 = dv[k].x * sv[k].x, d1 = dv[k].y * sv[k].y;
        s1 += d0 + d1;
        s2 += d0 * ((xv[k].x - m) * rstd) + d1 * ((xv[k].y - m) * rstd);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      s1 /= C;
      s2 /= C;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int c = 2 * l16 + k * kWarp;
        if (tr < 0 || c >= C) continue;
        const float xh0 = (xv[k].x - m) * rstd, xh1 = (xv[k].y - m) * rstd;
        const float2 dy =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(a.dy1_ws + tr * C + c));
        *reinterpret_cast<uint32_t*>(a.dx + tr * C + c) =
            pack_bf16(rstd * (dv[k].x * sv[k].x - s1 - xh0 * s2) + dy.x,
                      rstd * (dv[k].y * sv[k].y - s1 - xh1 * s2) + dy.y);
        cx[k].x += dv[k].x * xh0, cx[k].y += dv[k].y * xh1;
        cz[k].x += dv[k].x, cz[k].y += dv[k].y;
      }
    }
    // the two halves hold the same columns: lanes 0-15 add the strip's sums to
    // its dLN1 partial, every old value read first
    float2 ox[kPairs], oz[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      cx[k].x += __shfl_xor_sync(0xffffffffu, cx[k].x, 16);
      cx[k].y += __shfl_xor_sync(0xffffffffu, cx[k].y, 16);
      cz[k].x += __shfl_xor_sync(0xffffffffu, cz[k].x, 16);
      cz[k].y += __shfl_xor_sync(0xffffffffu, cz[k].y, 16);
      const int c = 2 * l16 + k * kWarp;
      const bool own = half == 0 && c < C && !first;
      ox[k] = own ? *reinterpret_cast<const float2*>(dln + c) : make_float2(0.f, 0.f);
      oz[k] = own ? *reinterpret_cast<const float2*>(dln + C + c) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int c = 2 * l16 + k * kWarp;
      if (half != 0 || c >= C) continue;
      *reinterpret_cast<float2*>(dln + c) = make_float2(ox[k].x + cx[k].x, ox[k].y + cx[k].y);
      *reinterpret_cast<float2*>(dln + C + c) =
          make_float2(oz[k].x + cz[k].x, oz[k].y + cz[k].y);
    }
    named_barrier(1, kConsumers);  // the next window's tiles overlay other warps' dxa rows
  }
  // the block's strips' partials summed in strip order into strip 0's rows
  // (past the barrier above every strip's writes are visible)
  const int tid = threadIdx.x;
  float* parts[3] = {a.dqkvb_part, a.dln_part, a.dln2_part};
  const int widths[3] = {C3, 2 * C, 2 * C};
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    float* base = parts[v] + (size_t)blockIdx.x * kStrips * widths[v];
    for (int c = tid; c < widths[v]; c += kConsumers) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kStrips; ++w) sum += base[(size_t)w * widths[v] + c];
      base[c] = sum;
    }
  }
}

// out[j] = sum over r < R of part[r * ld + j], in a fixed order: eight groups
// of rows (r = g, g + 8, ...) summed by their own threads, then the groups in
// order.  (Many rows and few columns would leave reduce.cu's thread a column
// with a long chain of dependent loads.)
constexpr int kSrCols = 32, kSrGroups = 8;

__global__ void __launch_bounds__(kSrCols * kSrGroups)
    bb_sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int R,
                       long long n, long long ld) {
  __shared__ float acc[kSrGroups][kSrCols];
  const int tc = threadIdx.x % kSrCols, tg = threadIdx.x / kSrCols;
  const long long j = blockIdx.x * (long long)kSrCols + tc;
  float s = 0.f;
  if (j < n)
    for (int r = tg; r < R; r += kSrGroups) s += part[r * ld + j];
  acc[tg][tc] = s;
  __syncthreads();
  if (tg == 0 && j < n) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kSrGroups; ++q) t += acc[q][tc];
    out[j] = t;
  }
}

inline cudaError_t launch_bb_sum_rows(const float* part, float* out, int R, long long n,
                                      long long ld, cudaStream_t stream) {
  bb_sum_rows_kernel<<<(unsigned)((n + kSrCols - 1) / kSrCols), kSrCols * kSrGroups, 0,
                       stream>>>(part, out, R, n, ld);
  return cudaGetLastError();
}

template <int kNt, int kHd, int kCt>
cudaError_t launch_bb_as(const BbArgs& a, unsigned blocks, size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(fold_block_bwd_mma_kernel<kNt, kHd, kCt>, smem);
  if (err != cudaSuccess) return err;
  fold_block_bwd_mma_kernel<kNt, kHd, kCt><<<blocks, (kNt / 2 + 1) * kWarp, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kNt, int kHd>
cudaError_t launch_bb_nt(const BbArgs& a, unsigned blocks, size_t smem, cudaStream_t stream) {
  return a.C <= 96 ? launch_bb_as<kNt, kHd, 6>(a, blocks, smem, stream)
                   : launch_bb_as<kNt, kHd, 12>(a, blocks, smem, stream);
}

struct BbWorkspace {
  size_t row, o, dy1, dqkv, zh, zl, gh, gl, dhh, dhl, dqkvb, dln, dln2, dbias, atb, bytes;
  int blocks, chunk, strips;
};

inline BbWorkspace bb_workspace(int B, int D, int H, int W, int C, int nh, int Ch, int wd,
                                int wh, int ww) {
  const int n = wd * wh * ww;
  const size_t T = (size_t)B * D * H * W, bf = 2;
  const long long windows = (long long)B * (D / wd) * (H / wh) * (W / ww);
  const int target = kBbBlocks * bb_blocks_per_sm(fa_padded_rows(n) / 8, C / nh,
                                                  C <= 96 ? 6 : 12);
  BbWorkspace l;
  l.chunk = (int)((windows + target - 1) / target);
  l.blocks = (int)((windows + l.chunk - 1) / l.chunk);
  l.strips = fa_padded_rows(n) / 16;
  const size_t rows = (size_t)l.blocks * l.strips;
  size_t atb = atb_mma_partial_floats((int)T, C, 3 * C);
  const size_t others[3] = {atb_mma_partial_floats((int)T, C, C),
                            atb_mma_partial_floats((int)T, Ch, C),
                            atb_mma_partial_floats((int)T, C, Ch)};
  for (size_t v : others) atb = v > atb ? v : atb;
  size_t o = 0;
  l.row = o;   o = align256(o + bf * T * C);
  l.o = o;     o = align256(o + bf * T * C);
  l.dy1 = o;   o = align256(o + bf * T * C);
  l.dqkv = o;  o = align256(o + bf * T * 3 * C);
  l.zh = o;    o = align256(o + bf * T * C);
  l.zl = o;    o = align256(o + bf * T * C);
  l.gh = o;    o = align256(o + bf * T * Ch);
  l.gl = o;    o = align256(o + bf * T * Ch);
  l.dhh = o;   o = align256(o + bf * T * Ch);
  l.dhl = o;   o = align256(o + bf * T * Ch);
  l.dqkvb = o; o = align256(o + sizeof(float) * rows * 3 * C);
  l.dln = o;   o = align256(o + sizeof(float) * rows * 2 * C);
  l.dln2 = o;  o = align256(o + sizeof(float) * rows * 2 * C);
  l.dbias = o; o = align256(o + sizeof(float) * l.blocks * nh * (size_t)n * n);
  l.atb = o;   o = align256(o + sizeof(float) * atb);
  l.bytes = o;
  return l;
}

}  // namespace vadcl

extern "C" {

long long vadcl_fold_block_bwd_bf16_smem_bytes(int n, int c, int nh) {
  return (long long)vadcl::bb_layout(n, c, c / nh).bytes;
}

long long vadcl_fold_block_bwd_bf16_workspace_bytes(int B, int D, int H, int W, int C, int nh,
                                                    int Ch, int wd, int wh, int ww) {
  return (long long)vadcl::bb_workspace(B, D, H, W, C, nh, Ch, wd, wh, ww).bytes;
}

// x, dout (B, D, H, W, C) bf16; wpack, biasp, maskp: kernel A's packs; mpack:
// kernel B's pack of (w1, w2); qkv_b (3C,) fp32 (zeros without a bias); the
// gradients fp32 except dx (bf16); dln and dln2 (2C,): the LayerNorm's scale
// gradient, then its bias gradient.
int vadcl_fold_block_bwd_bf16(const void* x, const void* dout, const float* ln_s,
                              const float* ln_b, const void* wpack, const float* qkv_b,
                              const float* proj_b, const float* biasp, const float* maskp,
                              const float* ln2_s, const float* ln2_b, const void* mpack,
                              const float* b1, void* dx, float* dln, float* dqkv_w,
                              float* dqkv_b, float* dproj_w, float* dproj_b, float* dbias,
                              float* dln2, float* dw1, float* db1, float* dw2, float* db2,
                              void* workspace, int B, int D, int H, int W, int C, int nh, int Ch,
                              int wd, int wh, int ww, int sd, int sh, int sw, float scale,
                              void* stream) {
  using namespace vadcl;
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = wd * wh * ww;
  if (B <= 0 || D % wd || H % wh || W % ww || !bb_eligible(n, C, nh, Ch))
    return cudaErrorInvalidValue;
  const int hd = C / nh;
  const size_t smem = bb_layout(n, C, hd).bytes;
  const BbWorkspace l = bb_workspace(B, D, H, W, C, nh, Ch, wd, wh, ww);
  char* ws = static_cast<char*>(workspace);
  auto at = [&](size_t off) { return reinterpret_cast<bf16*>(ws + off); };
  auto fl = [&](size_t off) { return reinterpret_cast<float*>(ws + off); };
  BbArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(dout), ln_s, ln_b,
           static_cast<const bf16*>(wpack), qkv_b, proj_b, biasp, maskp, ln2_s, ln2_b,
           static_cast<const bf16*>(mpack), b1, static_cast<bf16*>(dx),
           at(l.row), at(l.o), at(l.dy1), at(l.dqkv), at(l.zh), at(l.zl),
           at(l.gh), at(l.gl), at(l.dhh), at(l.dhl),
           fl(l.dqkvb), fl(l.dln), fl(l.dln2), fl(l.dbias),
           B, D, H, W, C, nh, Ch, wd, wh, ww, sd, sh, sw, scale, l.chunk};
  cudaError_t err;
  const bool wide = fa_padded_rows(n) == kFaMaxTokens;
  if (hd == 16)
    err = wide ? launch_bb_nt<14, 16>(a, l.blocks, smem, s) : launch_bb_nt<8, 16>(a, l.blocks, smem, s);
  else
    err = wide ? launch_bb_nt<14, 32>(a, l.blocks, smem, s) : launch_bb_nt<8, 32>(a, l.blocks, smem, s);
  if (err != cudaSuccess) return err;
  // the second pass: the weight sums on the tensor cores, the partials in order
  const int T = B * D * H * W;
  float* part = fl(l.atb);
  if ((err = launch_atb_mma(a.row_ws, nullptr, a.dqkv_ws, nullptr, T, C, 3 * C, part, dqkv_w,
                            nullptr, s)))
    return err;
  if ((err = launch_atb_mma(a.o_ws, nullptr, a.dy1_ws, nullptr, T, C, C, part, dproj_w, dproj_b,
                            s)))
    return err;
  if ((err = launch_atb_mma(a.g_hi, a.g_lo, a.dout, nullptr, T, Ch, C, part, dw2, db2, s)))
    return err;
  if ((err = launch_atb_mma(a.z_hi, a.z_lo, a.dh_hi, a.dh_lo, T, C, Ch, part, dw1, db1, s)))
    return err;
  // (each block left its strips' sums in its first strip's row)
  const long long st = l.strips;
  if ((err = launch_bb_sum_rows(a.dqkvb_part, dqkv_b, l.blocks, 3 * C, st * 3 * C, s)))
    return err;
  if ((err = launch_bb_sum_rows(a.dln_part, dln, l.blocks, 2 * C, st * 2 * C, s))) return err;
  if ((err = launch_bb_sum_rows(a.dln2_part, dln2, l.blocks, 2 * C, st * 2 * C, s))) return err;
  return launch_bb_sum_rows(a.dbias_part, dbias, l.blocks, (long long)nh * n * n,
                            (long long)nh * n * n, s);
}

}  // extern "C"
