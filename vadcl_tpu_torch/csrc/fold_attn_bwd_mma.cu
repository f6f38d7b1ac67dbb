// Kernel 6's bf16 body for Hopper: the backward of the folded Swin attention
// front half,  out = x + proj(attention(LN1 x))  ->  dx, dLN1, dqkv_w, dqkv_b,
// dproj_w, dproj_b, d(bias),  per (8,7,7)-shrunk window of the unpartitioned
// (B, D, H, W, C) tensor with the shift roll folded into the addressing; also
// the no-LN/no-residual mode (ln_s == null, residual == 0).
//
// Replaces vadcl_tpu/ops/pallas_attn_fold.py:_fold_bwd_kernel (entry
// _fold_bwd_call) for bf16 windows of at most 112 tokens at head width 16 or
// 32 and C <= 256 (every such geometry's block fits 227 KB once the weight
// slices stream in depth chunks: the flagship's, and the Video Swin-B width's
// C = 128 with 4 heads and C = 256 with 8), and of 113-208 tokens at head
// width 16 where the long layout fits (below: the 196-token windows of
// 8-frame clips at C = 96 with 6 heads and C = 192 with 12); fold_attn_bwd.cu's bodies keep
// fp32 and every other bf16 geometry (ops/fold_attn.py: fold_bwd_body picks).  Numerical contract: fold_attention_bwd_plain's, the
// order and cast boundaries of fold_attn_bwd.cu.  Every product has operands
// the contract already rounds to bf16 (LN1 output, q, k, v, round(P), dout,
// round(dout . proj_w^T), round(ds * scale), round(dqkv), the weights), so
// each runs as one bf16 mma.sync.m16n8k16 pass with fp32 accumulation: exact
// products, another summation order.  The softmax, its backward and d(bias)
// are fp32.
//
// Design (kernel A's, fold_attn_mma.cuh, turned around).  A window is padded to
// Np = 64 or 112 rows (208 in the long layout, below) and cut into strips of
// 16; warp w owns query strip w and,
// in the column phase, key strip w: the same 16 tokens.  A block walks a
// chunk of consecutive windows; one producer warp streams weights through a
// two-stage cp.async.bulk / mbarrier ring from kernel A's own pack
// (ops/fold_attn.py:pack_fold_weights: slice h holds head h's C x 3hd columns
// of W_qkv, slice nH + j columns 3hd j .. of W_proj), so the pack the forward
// made in the same step is a cache hit.  Per window:
//   * LN1 of the warp's rows into a row tile (bf16, also written out for
//     dqkv_w's sum);
//   * per head, slice h and the rows h hd .. h hd + hd - 1 of every W_proj
//     slice (each contiguous in the pack): one ring stage holding both where
//     that block fits, else (depth chunks, below) the slice's chunks and then
//     the W_proj rows, a stage each:
//     (a) q, k, v = round(row . W + b) of the strip (q also kept as register
//         fragments) and doa = round(dout . W_proj[head rows]^T) (dout read
//         as A fragments straight from device memory) into double-buffered
//         Q, K, V, DOA tiles; one named barrier;
//     (b) row phase, registers only: S = q.k^T on top of the packed bias and
//         mask (kernel A's pack_fold_scores), P = e / l (ex2.approx.ftz, the
//         division fa_div: e flushed to zero never takes IEEE division's slow
//         path), round(P) into the P tile, o = round(P).V to the workspace,
//         rowsum(dp * P) with dp = doa.v^T, then dp again, ds = P * (dp - r),
//         d(bias) added into the chunk's partial, round(ds * scale) into the
//         ds tile and dq = dss.k; one named barrier;
//     (c) column phase: dv = round(P)^T . doa and dk = dss^T . q from the P
//         and ds tiles (transposed ldmatrix), then round(dqkv) of the warp's
//         tokens to the workspace and its unrounded column sums.
//   * dxa = round(dqkv) . W_qkv^T over the heads (the slices streamed a second
//     time, chunk k giving dxa's columns k C / chunks .., the warp's own dqkv
//     rows as A fragments) into fp32 rows that overlay the per-head tiles,
//     then the LN vjp and the residual per row.
// Only round(P) and round(ds * scale) ever reach shared memory as score-sized
// tiles (bf16); the fp32 softmax, dp and ds stay in mma.sync registers.
//
// Depth chunks (fb_depth_chunks: 1 wherever the whole-slice stages fit, where
// the kChunked = false instances run as before, bit for bit and instruction
// for instruction; else the fewest of 2, 3, 4 that fit, the kChunked
// instances).  At (98, 256, 8) everything but the ring takes 184,704 B (LN1
// rows 59,136; the double-buffered Q, K, V, DOA tiles 71,680; the round(P)
// and round(ds * scale) tiles 53,760; the barriers), which leaves 47,744 B
// for two stages where two whole ones take 146,432.  Of the two ways to make
// room, depth chunks were taken over single-buffered per-head tiles: those
// would free 35,840 B but cost a second named barrier a head (the next head's
// q, k, v and doa could not be written while a warp still reads this head's
// in its column phase), and still need chunks at C = 256.  With 4 chunks of
// 64 rows a stage holds one chunk (13,312 B) or head h's W_proj rows (19,968
// B), so the block is 224,640 B; (49, 256, 8) and (98, 128, 4) take 2 chunks
// (153,728 and 182,656 B), as does (98, 192, 6) (210,304 B).  A chunk changes
// no summation order: the qkv accumulator persists across a slice's chunks
// and each dxa column is still summed over the heads in order.  The cost is
// more ring items, 9 nH a window at 4 chunks against 2 nH, each handed over
// by every consumer warp.
//
// Long windows (fold_attn_bwd_long_kernel: Np = 208, 13 strips, head width
// 16).  The one-strip layout would hold round(P) and round(ds * scale) of a
// head whole (2 x 2 x 208 x 216 = 179,712 B) beside the rest: 331,648 B at
// (196, 96, 6).  And thirteen strip warps with the producer (448 threads)
// leave 144 registers a thread, less than a 16 x 208 fp32 score row (104)
// and what goes with it.  So seven consumer warps own two strips each (256
// threads, up to 255 registers; warp w owns query and key strips w and w +
// 7), and the P and ds tiles hold G query strips (every key column): a head
// runs its row phase and its column phase once per phase of G query strips,
// each warp's dv and dk staying in registers across the phases and summed
// over the query strips in order.  Every score row is computed once, whole,
// in registers, with the one-strip body's operations, so each value is the
// one that body would give at 208 rows.  A design over key blocks (P and ds
// of every query row and 64 keys a tile) was measured first: it needs each
// row's statistics before any block, so it computed every score twice, and
// took 13 named barriers a head; it ran 1.26 and 1.48 times the row-tiled
// body's time at (256, 196, 96) and (64, 196, 192) on an H100 at 700 W.  The
// Q, K, V, DOA tiles are single-buffered.
// fb_long_layout: the barriers, the ring, the LN1 rows (208 x (C + 8) bf16),
// the Q, K, V, DOA tiles (4 x 208 x 24 bf16, 39,936 B) and the P and ds tiles
// (2 x 16 G x 216 bf16, 13,824 G B); the fp32 dxa rows (208 x (C + 4))
// overlay everything from the LN1 rows on (those are in row_ws by then).
// fb_long_chunks takes the largest G (7 at most: two phases), then the fewest
// depth chunks.  (196, 96, 6): G = 7, one chunk: 128 + 28,672 + 43,264 +
// 39,936 + 96,768 = 208,768 B.  (196, 192, 12): G = 7 at 4 chunks, head h's
// W_proj rows in two ring items (fb_long_proj_items: in one they would size
// the stage, 234,368 B): 128 + 10,752 + 83,200 + 39,936 + 96,768 = 230,784 B
// (dxa's overlay ends at 173,952 B); G = 6 at 2 chunks would fit too
// (227,712 B) but in three phases, and read 0.986 ms at (64, 196, 192)
// where G = 7 reads 0.875 (H100, 700 W, one call each).  Named barriers:
// 1 + 2 x phases a head (5) where the one-strip body takes 2.
//
// Head groups (the kGrouped instances of both bodies; ops/fold_attn.py:
// fold_bwd_head_groups picks `groups`, 1 keeping the other instances).  Where
// windows are fewer than SMs (64 windows at batch 4 on the 8-frame encoder's
// stage 1 and the Video Swin-B width's stage 1 and decoder stage 0: one block
// a window left 68 of 132 SMs idle), a window's heads split over the
// `groups` blocks of a thread-block cluster: rank g takes heads g nH /
// groups .. (g + 1) nH / groups - 1.  Each rank has its own LN1 row tile (rank
// 0 alone writes row_ws), streams only its heads' slices and W_proj rows
// through its ring, and writes its heads' columns of o, dqkv and the dqkv_b
// partials and its heads' d(bias) planes: disjoint from the other ranks', so
// those need no more summing.  Its dxa rows hold its heads' sum (in head
// order).  After a cluster barrier each rank sums the ranks' rows r = g, g +
// groups, .. of every strip over distributed shared memory in rank order
// (fb_sum_ranks), into its own rows, which no other rank reads, and runs the
// LN vjp and the residual on them, leaving its dLN1 column sums in two of
// those rows; after a second cluster barrier rank 0 adds the ranks' sums in
// rank order into the (chunk, strip or warp) partial (fb_sum_dln: per block
// partials would double the rows the second pass sums one after another,
// about 15 us a launch at 448 more rows on an H100), and a third keeps the
// window's shared memory until every rank has read it.  The producer warp
// takes part in the three barriers, so a window's items are in flight only
// within the window.  The stamps of
// tools/fold_bwd_clocks_torch.py at batch 4 (H100, 700 W) put the per-head
// steps at 60-70% of a block's clocks at the 64-window shapes, the LN vjp at
// 21-26% and LN1 at 4-8%; two groups halve all but LN1, which every rank
// computes for its own tile.

// Deterministic sums.  d(bias) is summed over the block's chunk of windows by
// the one thread that holds each (h, i, j) in its accumulator: written by the
// chunk's first window, added to by the others in window order; the partials
// are nH x N x N per chunk (at most kFbBlocks chunks), not per window (enc
// stage 0, batch 4: 128 x 6 x 98 x 98 floats, 29.5 MB, where the per-window
// partials of fold_attn_bwd.cu are 59 MB).  dqkv_b and dLN1 go the same way
// per (chunk, strip), in the long layout per (chunk, warp).  The second pass
// sums the partials in chunk order (sum_rows) and forms dqkv_w = row^T .
// round(dqkv) and dproj_w = o^T . dout
// (with dproj_b = colsum dout) on the tensor cores (reduce_mma.cu, one bf16
// pass each: both operands are exactly bf16).  No float atomics.
//
// What bounds it: 7 GFLOP of bf16 products at enc stage 0, batch 4 (0.008 ms
// at 989 TFLOP/s) against per-head named barriers, the ring's hand-overs
// (one per chunk), the d(bias) partial traffic (read and written once per
// window through L2), the LN vjp's dependent loads a row, and a grid of at
// most one 8-warp block per SM (head groups where windows are few).  Left on
// the table: wgmma, several heads or windows in flight per block, d(bias)
// held on chip across a chunk, head groups for the whole-slice instances
// (the flagship's: they keep one block a window).
#include "fold_attn_mma.cuh"
#include "reduce.cuh"
#include "reduce_mma.cuh"

namespace vadcl {

constexpr int kFbBlocks = 132;  // target blocks: windows are chunked to about this many
constexpr int kFbMaxC = 256;    // the LN vjp keeps C / 32 column sums a lane
constexpr int kFbDxaPad = 4;    // floats of padding per dxa row

__host__ __device__ inline int fb_proj_slices(int c, int hd) {
  return (c + fa_slice(hd) - 1) / fa_slice(hd);
}

struct FbLayout {
  size_t stage, ring, row, tiles, ptile, dtile, dxa, bytes;
};

// Shared memory of one block for a window of n tokens, width c, head width hd,
// kernel A's weight slices streamed in `chunks` depth chunks of c / chunks
// rows: with one chunk a stage holds head h's whole slice and its rows of
// every W_proj slice; with more, a stage holds one chunk or those rows.
__host__ __device__ inline FbLayout fb_layout(int n, int c, int hd, int chunks) {
  const size_t np = fa_padded_rows(n), ldw = fa_ldw(hd), ldkv = fa_ldkv(hd), bf = 2;
  const size_t rows = (size_t)(c / chunks) * ldw, proj = (size_t)fb_proj_slices(c, hd) * hd * ldw;
  FbLayout l;
  l.stage = bf * (chunks == 1 ? rows + proj : (rows > proj ? rows : proj));
  size_t o = kFaBarrierBytes;
  l.ring = o;  o += 2 * l.stage;
  l.row = o;   o += bf * np * (c + kFaPad);
  const size_t region = o;
  l.tiles = o; o += bf * 2 * 4 * np * ldkv;  // [head parity][Q, K, V, DOA][np][ldkv]
  l.ptile = o; o += bf * np * (np + 8);
  l.dtile = o; o += bf * np * (np + 8);
  l.dxa = region;
  const size_t dxa_end = region + sizeof(float) * np * (c + kFbDxaPad);
  l.bytes = o > dxa_end ? o : dxa_end;
  return l;
}

// The long layout (Np = 208, head width 16: the 196-token windows of 8-frame
// clips), fold_attn_bwd_long_kernel's: the ring and the LN1 row tile as
// above, single-buffered Q, K, V, DOA tiles, and round(P) and round(ds *
// scale) tiles of `group` query strips (every key column); the fp32 dxa rows
// overlay everything from the row tile on once the heads are done (the row
// tile is in row_ws by then).
constexpr int kFbLongWarps = 7;  // consumer warps of the long layout: warp w owns strips w, w + 7
constexpr int kFbLongStrips = kFaLongTokens / 16;  // 13

// Ring items head h's W_proj rows take in the long layout: with the slices
// in depth chunks, as many as keep an item within a chunk's rows (C = 192 at 4
// chunks: 2 items of 2 slices' rows), so that they do not size the stage.
__host__ __device__ inline int fb_long_proj_items(int c, int hd, int chunks) {
  const int npc = fb_proj_slices(c, hd);
  if (chunks == 1) return 1;
  int p = 1;
  while (p < npc && (npc + p - 1) / p * hd > c / chunks) ++p;
  return p;
}

__host__ __device__ inline FbLayout fb_long_layout(int n, int c, int hd, int chunks, int group) {
  const size_t np = fa_padded_rows(n), ldw = fa_ldw(hd), ldkv = fa_ldkv(hd), bf = 2;
  const int npc = fb_proj_slices(c, hd), pitems = fb_long_proj_items(c, hd, chunks);
  const size_t rows = (size_t)(c / chunks) * ldw;
  const size_t proj = (size_t)((npc + pitems - 1) / pitems) * hd * ldw;  // one item's rows
  FbLayout l;
  l.stage = bf * (chunks == 1 ? rows + proj : (rows > proj ? rows : proj));
  size_t o = kFaBarrierBytes;
  l.ring = o;  o += 2 * l.stage;
  l.row = o;   o += bf * np * (c + kFaPad);
  l.tiles = o; o += bf * 4 * np * ldkv;  // [Q, K, V, DOA][np][ldkv]
  l.ptile = o; o += bf * (size_t)group * 16 * (np + 8);
  l.dtile = o; o += bf * (size_t)group * 16 * (np + 8);
  l.dxa = l.row;
  const size_t dxa_end = l.row + sizeof(float) * np * (c + kFbDxaPad);
  l.bytes = o > dxa_end ? o : dxa_end;
  return l;
}

// Query strips a phase of the long layout holds at `chunks` depth chunks: the
// most, up to kFbLongWarps (two phases), whose block fits; 0 where none does.
__host__ __device__ inline int fb_long_group(int n, int c, int hd, int chunks) {
  for (int g = kFbLongWarps; g > 0; --g)
    if (fb_long_layout(n, c, hd, chunks, g).bytes <= (size_t)kMaxSmemBytes) return g;
  return 0;
}

// Depth chunks of the long layout: the fewest (1, else 2, 3, 4 cutting C into
// multiples of 16 rows, C <= kFaMaxChunkedC) that give the largest group, so
// that a head takes the fewest phases; 0 where no block fits.
__host__ __device__ inline int fb_long_chunks(int n, int c, int hd) {
  int best = 0, best_group = 0;
  for (int k = 1; k <= 4; ++k) {
    if (k > 1 && (c > kFaMaxChunkedC || c % (16 * k))) continue;
    const int g = fb_long_group(n, c, hd, k);
    if (g > best_group) best = k, best_group = g;
  }
  return best;
}

// The layout of the body a window of n tokens runs in (the long layout with
// its largest group at these chunks, one strip where none fits).
__host__ __device__ inline FbLayout fb_block_layout(int n, int c, int hd, int chunks) {
  if (fa_padded_rows(n) != kFaLongTokens) return fb_layout(n, c, hd, chunks);
  const int g = fb_long_group(n, c, hd, chunks);
  return fb_long_layout(n, c, hd, chunks, g > 0 ? g : 1);
}

// Depth chunks of a weight slice: 1 wherever that block fits (the layout
// before chunking), else (C <= kFaMaxChunkedC) the fewest of 2, 3, 4 that cut
// C into multiples of 16 rows and fit; 0 where none does.  Beyond 4 a stage
// would not shrink: head h's W_proj rows (C / 3 rows of a slice, rounded up)
// outweigh a chunk.
// (The long layout: fb_long_chunks.)
__host__ __device__ inline int fb_depth_chunks(int n, int c, int hd) {
  if (fa_padded_rows(n) == kFaLongTokens) return fb_long_chunks(n, c, hd);
  if (fb_layout(n, c, hd, 1).bytes <= (size_t)kMaxSmemBytes) return 1;
  if (c > kFaMaxChunkedC) return 0;
  for (int k = 2; k <= 4; ++k)
    if (c % (16 * k) == 0 && fb_layout(n, c, hd, k).bytes <= (size_t)kMaxSmemBytes) return k;
  return 0;
}

// Shared memory of the launch's block (with one chunk where none fits).
__host__ __device__ inline size_t fb_smem_bytes(int n, int c, int hd) {
  const int k = fb_depth_chunks(n, c, hd);
  return fb_block_layout(n, c, hd, k > 0 ? k : 1).bytes;
}

inline bool fb_eligible(int n, int c, int nh) {
  if (nh <= 0 || c % nh || c % 16 || c > kFbMaxC || n <= 0 || n > kFaLongTokens) return false;
  const int hd = c / nh;
  if (n > kFaMaxTokens && hd != 16) return false;  // the long layout is built for head width 16
  return (hd == 16 || hd == 32) && fb_depth_chunks(n, c, hd) > 0;
}

struct FoldBwdMmaArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dout;
  const float* ln_s;  // null: no LayerNorm (and no residual)
  const float* ln_b;
  const __nv_bfloat16* wpack;  // kernel A's pack
  const float* qkv_b;          // (3C,)
  const float* biasp;          // kernel A's packed bias
  const float* maskp;          // kernel A's packed mask, or null
  __nv_bfloat16* dx;
  __nv_bfloat16* row_ws;   // (T, C)
  __nv_bfloat16* o_ws;     // (T, C)
  __nv_bfloat16* dqkv_ws;  // (T, 3C)
  float* dqkvb_part;  // (chunks, strips, 3C)
  float* dln_part;    // (chunks, strips, 2C)
  float* dbias_part;  // (chunks, nH, N, N)
  int B, D, H, W, C, nh, wd, wh, ww;
  int sd, sh, sw;
  float scale;
  int residual;
  int chunk;         // windows per block (per cluster with head groups)
  int depth_chunks;  // chunks a weight slice streams in (fb_depth_chunks)
  int groups;        // head groups: blocks of a window's cluster (the kGrouped instances)
};

// Element offset of window token i (of the window at (b, wi_d, wi_h, wi_w)),
// the roll folded in; -1 for a padded row.
__device__ __forceinline__ long long fb_tok(const FoldBwdMmaArgs& a, int b, int wi_d, int wi_h,
                                            int wi_w, int i, int N) {
  if (i >= N) return -1;
  const int d = wi_d * a.wd + i / (a.wh * a.ww), h = wi_h * a.wh + (i / a.ww) % a.wh,
            w = wi_w * a.ww + i % a.ww;
  const long long dd = (d + a.sd) % a.D, hh = (h + a.sh) % a.H, ww = (w + a.sw) % a.W;
  return (((b * (long long)a.D + dd) * a.H + hh) * a.W + ww) * a.C;
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* base, long long off) {
  return off < 0 ? 0u : *reinterpret_cast<const uint32_t*>(base + off);
}

// A partial owned by one thread: the chunk's first window writes, the others add.
__device__ __forceinline__ void own_add(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// One of dq, dk, dv (16 rows x kHt 8-column tiles, accumulator layout) of the
// warp's tokens: rounded into dqkv at columns col0 .., and its unrounded column
// sums (reduced over the warp's rows) into the warp's dqkv_b partial.
template <int kHt>
__device__ __forceinline__ void fb_emit_dqkv(const float (&v)[kHt][4], __nv_bfloat16* dqkv,
                                             float* part, int col0, long long tok0,
                                             long long tok1, int t, int g, bool first) {
#pragma unroll
  for (int i = 0; i < kHt; ++i) {
    const int col = col0 + i * 8 + 2 * t;
    float c0 = 0.f, c1 = 0.f;
    if (tok0 >= 0) {
      *reinterpret_cast<uint32_t*>(dqkv + 3 * tok0 + col) = pack_bf16(v[i][0], v[i][1]);
      c0 += v[i][0], c1 += v[i][1];
    }
    if (tok1 >= 0) {
      *reinterpret_cast<uint32_t*>(dqkv + 3 * tok1 + col) = pack_bf16(v[i][2], v[i][3]);
      c0 += v[i][2], c1 += v[i][3];
    }
#pragma unroll
    for (int o = 4; o < kWarp; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (g == 0) {
      own_add(part + col, c0, first);
      own_add(part + col + 1, c1, first);
    }
  }
}

// The producer warp's first lane: per window (wbeg .. wend - 1) and head (h0
// .. h1 - 1: the block's head group), the chunks of slice h and head h's
// W_proj rows (with one chunk, both in one stage; else in `pitems` items of
// consecutive slices' rows: 1 in the one-strip layout), then the slices'
// chunks again for dxa, each item into the next ring stage once its consumers
// have handed it back; `seq` counts the items across calls.
template <int kHd>
__device__ __forceinline__ void fb_produce(const FoldBwdMmaArgs& a, unsigned char* ring,
                                           size_t stage_size, uint64_t* full, uint64_t* empty,
                                           int chunks, int pitems, int h0, int h1,
                                           long long wbeg, long long wend, int& seq) {
  constexpr int kLdw = fa_ldw(kHd);
  const int C = a.C, nh = a.nh, kc = C / chunks, npc = fb_proj_slices(C, kHd);
  const uint32_t chunk_bytes = (uint32_t)(sizeof(__nv_bfloat16) * kc * kLdw);
  const uint32_t part_bytes = (uint32_t)(sizeof(__nv_bfloat16) * kHd * kLdw);
  auto stage = [&](uint32_t bytes) {  // the next item's stage, its bytes expected
    const int s = seq & 1, use = seq >> 1;
    if (use > 0) mbar_wait(empty + s, (uint32_t)((use - 1) & 1));
    mbar_expect_tx(full + s, bytes);
    ++seq;
    return s;
  };
  const int per = (npc + pitems - 1) / pitems;  // slices an item of W_proj rows holds
  auto proj_rows = [&](unsigned char* dst, int h, int s, int j0, int j1) {
    for (int j = j0; j < j1; ++j)
      bulk_copy_g2s(dst + (size_t)(j - j0) * part_bytes,
                    a.wpack + ((size_t)(nh + j) * C + (size_t)h * kHd) * kLdw, part_bytes,
                    full + s);
  };
  for (long long w = wbeg; w < wend; ++w)
    for (int pass = 0; pass < 2; ++pass)
      for (int h = h0; h < h1; ++h) {
        const bool with_proj = pass == 0 && chunks == 1;
        for (int k = 0; k < chunks; ++k) {
          const int s = stage(chunk_bytes + (with_proj ? npc * part_bytes : 0u));
          unsigned char* dst = ring + (size_t)s * stage_size;
          bulk_copy_g2s(dst, a.wpack + ((size_t)h * C + (size_t)k * kc) * kLdw, chunk_bytes,
                        full + s);
          if (with_proj) proj_rows(dst + chunk_bytes, h, s, 0, npc);
        }
        if (pass == 0 && chunks > 1)
          for (int j0 = 0; j0 < npc; j0 += per) {
            const int j1 = j0 + per < npc ? j0 + per : npc;
            const int s = stage((j1 - j0) * part_bytes);
            proj_rows(ring + (size_t)s * stage_size, h, s, j0, j1);
          }
      }
}

// dx = LN-vjp(dxa) + dout (or round(dxa) without LN) of strip `strip`'s rows
// r0, r0 + step, .. (every row: 0, 1; a head group's: its rank, groups), one
// row at a time (`dxa`: the strip's fp32 rows, ldx floats apart); the dLN1
// column sums per lane into `dln` (the scale's at dln[c], the bias's at
// dln[dln_ld + c]: a partial row, dln_ld = C, or a head group's exchange
// rows; written even where no row is).
__device__ __forceinline__ void fb_dx_strip(const FoldBwdMmaArgs& a, const float* dxa,
                                            float* dln, int dln_ld, int b, int wi_d, int wi_h,
                                            int wi_w, int strip, int N, int ldx, bool first,
                                            int lane, int r0, int step) {
  const int C = a.C;
  const bool has_ln = a.ln_s != nullptr;
  float cx[kFbMaxC / kWarp], cz[kFbMaxC / kWarp];
#pragma unroll
  for (int k = 0; k < kFbMaxC / kWarp; ++k) cx[k] = cz[k] = 0.f;
  for (int r = r0; r < 16; r += step) {
    const long long tr = fb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + r, N);
    if (tr < 0) break;
    const float* dr = dxa + r * ldx;
    if (!has_ln) {
      for (int c = lane; c < C; c += kWarp)
        a.dx[tr + c] = __float2bfloat16(
            dr[c] + (a.residual ? __bfloat162float(a.dout[tr + c]) : 0.f));
      continue;
    }
    float m, rstd;
    warp_ln_stats(a.x + tr, C, &m, &rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float dxh = dr[c] * a.ln_s[c];
      s1 += dxh;
      s2 += dxh * ((__bfloat162float(a.x[tr + c]) - m) * rstd);
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int k = 0; k < kFbMaxC / kWarp; ++k) {
      const int c = lane + k * kWarp;
      if (c >= C) break;
      const float xh = (__bfloat162float(a.x[tr + c]) - m) * rstd;
      const float v = rstd * (dr[c] * a.ln_s[c] - s1 - xh * s2) +
                      (a.residual ? __bfloat162float(a.dout[tr + c]) : 0.f);
      a.dx[tr + c] = __float2bfloat16(v);
      cx[k] += dr[c] * xh;
      cz[k] += dr[c];
    }
  }
  if (has_ln) {
#pragma unroll
    for (int k = 0; k < kFbMaxC / kWarp; ++k) {
      const int c = lane + k * kWarp;
      if (c >= C) break;
      own_add(dln + c, cx[k], first);
      own_add(dln + dln_ld + c, cz[k], first);
    }
  }
}

// A head group's dLN1 column sums, into the partial `dln` (rank 0): each
// rank's fb_dx_strip left its sums in its exchange rows, rows q and q +
// groups of `strip_rows` (a strip's fp32 rows, ldx floats apart) in rank q's
// shared memory, which no other rank touches; they are added in rank order.
__device__ __forceinline__ void fb_sum_dln(float* dln, const float* strip_rows, int ldx, int C,
                                           int groups, bool first, int lane) {
  for (int c = lane; c < C; c += kWarp) {
    float x = 0.f, z = 0.f;
    for (int q = 0; q < groups; ++q) {
      const float* p = strip_rows + (size_t)q * ldx + c;
      const float u = ld_cluster_f32(cluster_map(p, (uint32_t)q));
      const float w = ld_cluster_f32(cluster_map(p + (size_t)groups * ldx, (uint32_t)q));
      x = q == 0 ? u : x + u;
      z = q == 0 ? w : z + w;
    }
    own_add(dln + c, x, first);
    own_add(dln + C + c, z, first);
  }
}

// A head group's share of a strip's dxa rows: rows r = rank, rank + groups, ..
// (those of real tokens, strip row strip0 + r < N) of the strip's fp32 rows
// `rows` (ldx floats apart, C a multiple of 4) summed over the cluster's
// `groups` blocks in rank order, into this block's rows.  Runs after the
// cluster barrier that follows every rank's dxa; no other rank reads the rows
// this rank owns, so they are written in place.
__device__ __forceinline__ void fb_sum_ranks(float* rows, int ldx, int C, int strip0, int N,
                                             int rank, int groups, int lane) {
  for (int r = rank; r < 16 && strip0 + r < N; r += groups)
    for (int c = 4 * lane; c < C; c += 4 * kWarp) {
      float* p = rows + (size_t)r * ldx + c;
      float4 v = ld_cluster_f32x4(cluster_map(p, 0));
      for (int q = 1; q < groups; ++q) {
        const float4 u = ld_cluster_f32x4(cluster_map(p, (uint32_t)q));
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      *reinterpret_cast<float4*>(p) = v;
    }
}

// kNt = Np / 8 (8 or 14), kHd the head width (16 or 32); kChunked: the slices
// stream in a.depth_chunks depth chunks (else whole, the instructions of the
// layout before chunking); kGrouped: a window's heads split over the a.groups
// blocks of a cluster (else one block a window).
template <int kNt, int kHd, bool kChunked, bool kGrouped>
__global__ void __launch_bounds__((kNt / 2 + 1) * kWarp, 1)
    fold_attn_bwd_mma_kernel(FoldBwdMmaArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kStrips = kNt / 2, Np = kNt * 8, kHt = kHd / 8, kQt = 3 * kHt;
  constexpr int kLdw = fa_ldw(kHd), kLdkv = fa_ldkv(kHd), kLdp = Np + 8;
  constexpr int kConsumers = kStrips * kWarp;
  extern __shared__ __align__(128) unsigned char sm[];

  const int C = a.C, nh = a.nh, C3 = 3 * C, ldr = C + kFaPad, ldx = C + kFbDxaPad;
  const int N = a.wd * a.wh * a.ww;
  const int chunks = kChunked ? a.depth_chunks : 1, kc = C / chunks;  // depth chunks, rows
  const FbLayout L = fb_layout(N, C, kHd, chunks);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + 2;
  unsigned char* ring = sm + L.ring;

  const int nwh = a.H / a.wh, nww = a.W / a.ww;
  const int nw = (a.D / a.wd) * nwh * nww;
  const long long total = (long long)a.B * nw;
  const int groups = kGrouped ? a.groups : 1;
  const int rank = kGrouped ? (int)cluster_ctarank() : 0;
  const int cl = kGrouped ? (int)blockIdx.x / groups : (int)blockIdx.x;  // the window chunk
  const int h0 = rank * nh / groups, h1 = (rank + 1) * nh / groups;     // this block's heads
  const long long wbeg = (long long)cl * a.chunk;
  const long long wend = wbeg + a.chunk < total ? wbeg + a.chunk : total;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kStrips);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier

  if (warp == kStrips) {  // the producer (fb_produce)
    int pseq = 0;
    if constexpr (kGrouped) {
      for (long long w = wbeg; w < wend; ++w) {  // with the consumers' cluster barriers
        if (lane == 0)
          fb_produce<kHd>(a, ring, L.stage, full, empty, chunks, 1, h0, h1, w, w + 1, pseq);
        __syncwarp();
        cluster_sync();
        cluster_sync();
        cluster_sync();
      }
    } else if (lane == 0) {
      fb_produce<kHd>(a, ring, L.stage, full, empty, chunks, 1, 0, nh, wbeg, wend, pseq);
    }
    return;
  }

  const int strip = warp, g = lane >> 2, t = lane & 3;
  bf16* rowt = reinterpret_cast<bf16*>(sm + L.row);
  bf16* tiles = reinterpret_cast<bf16*>(sm + L.tiles);
  bf16* Pt = reinterpret_cast<bf16*>(sm + L.ptile);
  bf16* Dt = reinterpret_cast<bf16*>(sm + L.dtile);
  float* dxa = reinterpret_cast<float*>(sm + L.dxa) + (size_t)strip * 16 * ldx;
  const float pre = 1.f / a.scale, post = a.scale * kLog2e;
  const size_t nn = (size_t)N * N;
  float* dbias_blk = a.dbias_part + (size_t)cl * nh * nn;
  float* dqkvb = a.dqkvb_part + ((size_t)cl * kStrips + strip) * C3;
  float* dln = a.dln_part + ((size_t)cl * kStrips + strip) * 2 * C;
  int seq = 0;

  for (long long widx = wbeg; widx < wend; ++widx) {
    const bool first = widx == wbeg;
    const int win = (int)(widx % nw), b = (int)(widx / nw);
    const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;
    const int i0 = strip * 16 + g, i1 = i0 + 8;  // the fragment rows of this lane
    const long long tok0 = fb_tok(a, b, wi_d, wi_h, wi_w, i0, N);
    const long long tok1 = fb_tok(a, b, wi_d, wi_h, wi_w, i1, N);

    // LN1 (or a copy) of the warp's 16 rows into the row tile, then to row_ws
    // (by rank 0 of a head group)
    {
      const int r = lane >> 1;
      const long long tr = fb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + r, N);
      warp_ln_16rows(tr < 0 ? nullptr : a.x + tr, C, a.ln_s, a.ln_b,
                     reinterpret_cast<uint4*>(rowt + (size_t)(strip * 16 + r) * ldr), 1, nullptr,
                     lane);
    }
    __syncwarp();
    for (int e = lane; rank == 0 && e < 16 * (C / 8); e += kWarp) {
      const int r = e / (C / 8), v = e % (C / 8);
      const long long tr = fb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + r, N);
      if (tr >= 0)
        *reinterpret_cast<uint4*>(a.row_ws + tr + 8 * v) =
            *reinterpret_cast<const uint4*>(rowt + (size_t)(strip * 16 + r) * ldr + 8 * v);
    }

    const float4* bfrag =
        reinterpret_cast<const float4*>(a.biasp) + (size_t)strip * kNt * kWarp + lane;
    const float4* mfrag =
        a.maskp == nullptr ? nullptr
                           : reinterpret_cast<const float4*>(a.maskp) +
                                 ((size_t)win * kStrips + strip) * kNt * kWarp + lane;

    for (int h = h0; h < h1; ++h) {
      bf16* Qb = tiles + (size_t)((h & 1) * 4) * Np * kLdkv;
      bf16* Kb = Qb + (size_t)Np * kLdkv;
      bf16* Vb = Kb + (size_t)Np * kLdkv;
      bf16* Db = Vb + (size_t)Np * kLdkv;

      // (a) q, k, v of the strip, the slice's chunks in order
      float qa[kQt][4];
#pragma unroll
      for (int i = 0; i < kQt; ++i) qa[i][0] = qa[i][1] = qa[i][2] = qa[i][3] = 0.f;
      for (int k = 0; k < chunks; ++k) {
        const int s = seq & 1;
        mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
        warp_gemm_16xn<kQt>(rowt + (size_t)strip * 16 * ldr + k * kc, ldr,
                            reinterpret_cast<const bf16*>(ring + (size_t)s * L.stage), kLdw, kc,
                            lane, qa);
        if (chunks == 1) break;  // the stage holds the W_proj rows too: handed back after doa
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        ++seq;
      }
      // head h's W_proj rows: behind the slice in its stage, or the next item
      const int ps = seq & 1;
      if (chunks > 1) mbar_wait(full + ps, (uint32_t)((seq >> 1) & 1));
      const bf16* projp = reinterpret_cast<const bf16*>(ring + (size_t)ps * L.stage) +
                          (chunks == 1 ? (size_t)C * kLdw : 0);
#pragma unroll
      for (int i = 0; i < kQt; ++i) {
        const float2 bb = *reinterpret_cast<const float2*>(a.qkv_b + (i / kHt) * C + h * kHd +
                                                           (i % kHt) * 8 + 2 * t);
        qa[i][0] += bb.x, qa[i][1] += bb.y, qa[i][2] += bb.x, qa[i][3] += bb.y;
      }
      uint32_t qf[kHd / 16][4];
#pragma unroll
      for (int ks = 0; ks < kHd / 16; ++ks) acc_to_a(qf[ks], qa[2 * ks], qa[2 * ks + 1]);
#pragma unroll
      for (int i = 0; i < kQt; ++i) {
        bf16* dst = (i < kHt ? Qb : (i < 2 * kHt ? Kb : Vb)) + (size_t)strip * 16 * kLdkv +
                    (i % kHt) * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dst + g * kLdkv) = pack_bf16(qa[i][0], qa[i][1]);
        *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdkv) = pack_bf16(qa[i][2], qa[i][3]);
      }
      // doa = round(dout . W_proj[h hd .. h hd + hd - 1, :]^T); B (k = c, n = d) is
      // stored [n][k] in the stage's W_proj rows, one block of 3hd columns per slice
      float da[kHt][4];
#pragma unroll
      for (int i = 0; i < kHt; ++i) da[i][0] = da[i][1] = da[i][2] = da[i][3] = 0.f;
      for (int c0 = 0; c0 < C; c0 += 16) {
        uint32_t af[4];
        af[0] = ld_pair(a.dout, tok0 < 0 ? -1 : tok0 + c0 + 2 * t);
        af[1] = ld_pair(a.dout, tok1 < 0 ? -1 : tok1 + c0 + 2 * t);
        af[2] = ld_pair(a.dout, tok0 < 0 ? -1 : tok0 + c0 + 8 + 2 * t);
        af[3] = ld_pair(a.dout, tok1 < 0 ? -1 : tok1 + c0 + 8 + 2 * t);
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
      if (lane == 0) mbar_arrive(empty + ps);  // the stage comes back for dxa later
      ++seq;
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

      // (b) row phase: S on top of (bias + mask) / scale, then the softmax
      float sacc[kNt][4];
      {
        const float4* bp = bfrag + (size_t)h * kStrips * kNt * kWarp;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          float4 v = __ldg(bp + nt * kWarp);
          if (mfrag != nullptr) {
            const float4 m = __ldg(mfrag + nt * kWarp);
            v.x += m.x, v.y += m.y, v.z += m.z, v.w += m.w;
          }
          sacc[nt][0] = v.x * pre, sacc[nt][1] = v.y * pre;
          sacc[nt][2] = v.z * pre, sacc[nt][3] = v.w * pre;
        }
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
      // P (fp32, in place) and round(P) into the P tile
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        sacc[nt][0] = fa_div(sacc[nt][0], l0, r0), sacc[nt][1] = fa_div(sacc[nt][1], l0, r0);
        sacc[nt][2] = fa_div(sacc[nt][2], l1, r1), sacc[nt][3] = fa_div(sacc[nt][3], l1, r1);
        bf16* dst = Pt + (size_t)(strip * 16) * kLdp + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dst + g * kLdp) = pack_bf16(sacc[nt][0], sacc[nt][1]);
        *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdp) = pack_bf16(sacc[nt][2], sacc[nt][3]);
      }
      // o = round(P) . V to the workspace
      {
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
          if (tok0 >= 0)
            *reinterpret_cast<uint32_t*>(a.o_ws + tok0 + col) = pack_bf16(oacc[i][0], oacc[i][1]);
          if (tok1 >= 0)
            *reinterpret_cast<uint32_t*>(a.o_ws + tok1 + col) = pack_bf16(oacc[i][2], oacc[i][3]);
        }
      }
      // rowsum(dp * P), dp = doa . v^T a 16-key block at a time
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
      // dp again, ds = P (dp - r) into the chunk's d(bias), dss = round(ds * scale)
      // into the ds tile and dq = dss . k
      float dq[kHt][4];
#pragma unroll
      for (int i = 0; i < kHt; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
      float* dbh = dbias_blk + (size_t)h * nn;
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
        float ss[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int nt = 2 * np + q;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ds = sacc[nt][e] * (dp[q][e] - (e < 2 ? rs0 : rs1));
            ss[q][e] = ds * a.scale;
            const int i = e < 2 ? i0 : i1, j = nt * 8 + 2 * t + (e & 1);
            if (i < N && j < N) own_add(dbh + (size_t)i * N + j, ds, first);
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

      // (c) column phase: dv = round(P)^T . doa, dk = dss^T . q for key strip `strip`
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
      // round(dqkv) of the warp's tokens to the workspace; unrounded column sums
      fb_emit_dqkv<kHt>(dq, a.dqkv_ws, dqkvb, 0 * C + h * kHd, tok0, tok1, t, g, first);
      fb_emit_dqkv<kHt>(dk, a.dqkv_ws, dqkvb, 1 * C + h * kHd, tok0, tok1, t, g, first);
      fb_emit_dqkv<kHt>(dv, a.dqkv_ws, dqkvb, 2 * C + h * kHd, tok0, tok1, t, g, first);
    }

    // dxa = round(dqkv) . W_qkv^T: fp32 rows that overlay the per-head tiles,
    // once every warp is done with them
    named_barrier(1, kConsumers);
    for (int e = lane; e < 16 * C; e += kWarp) dxa[(e / C) * ldx + e % C] = 0.f;
    __syncwarp();  // (also makes the warp's dqkv rows visible to all its lanes)
    for (int h = h0; h < h1; ++h) {
      uint32_t af[3 * kHd / 16][4];  // the warp's round(dqkv) rows of head h (q | k | v)
#pragma unroll
      for (int ks = 0; ks < 3 * kHd / 16; ++ks) {
        const int col = (16 * ks / kHd) * C + h * kHd + (16 * ks) % kHd;
        af[ks][0] = ld_pair(a.dqkv_ws, tok0 < 0 ? -1 : 3 * tok0 + col + 2 * t);
        af[ks][1] = ld_pair(a.dqkv_ws, tok1 < 0 ? -1 : 3 * tok1 + col + 2 * t);
        af[ks][2] = ld_pair(a.dqkv_ws, tok0 < 0 ? -1 : 3 * tok0 + col + 8 + 2 * t);
        af[ks][3] = ld_pair(a.dqkv_ws, tok1 < 0 ? -1 : 3 * tok1 + col + 8 + 2 * t);
      }
      for (int k = 0; k < chunks; ++k, ++seq) {  // chunk k: dxa's columns k kc ..
        const int s = seq & 1;
        mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
        const bf16* slice = reinterpret_cast<const bf16*>(ring + (size_t)s * L.stage);
        for (int n16 = 0; n16 < kc / 16; ++n16) {
          const int c0 = k * kc + n16 * 16;
          float acc[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = c0 + q * 8 + 2 * t;
            const float2 u = *reinterpret_cast<const float2*>(dxa + g * ldx + col);
            const float2 v = *reinterpret_cast<const float2*>(dxa + (g + 8) * ldx + col);
            acc[q][0] = u.x, acc[q][1] = u.y, acc[q][2] = v.x, acc[q][3] = v.y;
          }
#pragma unroll
          for (int ks = 0; ks < 3 * kHd / 16; ++ks) {
            uint32_t bf[4];  // B (k = the slice's columns, n = c) stored [n][k]
            ldsm_x4(bf, b_frag_row_nk(slice + (size_t)n16 * 16 * kLdw + ks * 16, kLdw, lane));
            mma_bf16(acc[0], af[ks], bf[0], bf[1]);
            mma_bf16(acc[1], af[ks], bf[2], bf[3]);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = c0 + q * 8 + 2 * t;
            *reinterpret_cast<float2*>(dxa + g * ldx + col) = make_float2(acc[q][0], acc[q][1]);
            *reinterpret_cast<float2*>(dxa + (g + 8) * ldx + col) =
                make_float2(acc[q][2], acc[q][3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
    }

    if constexpr (kGrouped) {
      cluster_sync();  // every rank's dxa rows are in
      fb_sum_ranks(dxa, ldx, C, strip * 16, N, rank, groups, lane);
      __syncwarp();
    }
    // dx = LN-vjp(dxa) + dout (or round(dxa) without LN), one row at a time
    // (a head group's rows r = rank, rank + groups, ..); the dLN1 column sums
    // per lane (a head group's into its exchange rows: rows rank, rank + groups)
    fb_dx_strip(a, dxa, kGrouped ? dxa + (size_t)rank * ldx : dln, kGrouped ? groups * ldx : C,
                b, wi_d, wi_h, wi_w, strip, N, ldx, kGrouped || first, lane, rank, groups);
    if constexpr (kGrouped) {
      cluster_sync();  // every rank's dLN1 sums are in
      if (rank == 0 && a.ln_s != nullptr) fb_sum_dln(dln, dxa, ldx, C, groups, first, lane);
      cluster_sync();  // the other ranks are done with this block's dxa rows
    } else {
      named_barrier(1, kConsumers);  // the next window's tiles overlay other warps' dxa rows
    }
  }
}

// The d(bias) partials one thread owns in a 16-key step: columns j0, j0 + 1
// (n-tile 0) and j0 + 8, j0 + 9 (n-tile 1) of its rows g (`row0`) and g + 8
// (`row1`), ds[q] in accumulator order.  With an even N (every pair 8-byte
// aligned) the old values of all four pairs are read before any is written,
// so that a later window of the chunk waits for device memory once a step,
// not once a pair; an odd N takes the scalar own_add.
__device__ __forceinline__ void fb_dbias_16keys(float* row0, float* row1, const float (&ds)[2][4],
                                                int j0, bool ok0, bool ok1, int N, bool first,
                                                bool pairs) {
  if (!pairs) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * q + (e & 1);
        if (j < N && (e < 2 ? ok0 : ok1)) own_add((e < 2 ? row0 : row1) + j, ds[q][e], first);
      }
    return;
  }
  float2 v[2][2];  // [q][row]
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r) v[q][r] = make_float2(ds[q][2 * r], ds[q][2 * r + 1]);
  const bool in[2] = {j0 < N, j0 + 8 < N}, ok[2] = {ok0, ok1};
  float* rows[2] = {row0, row1};
  if (!first) {
    float2 old[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        old[q][r] = in[q] && ok[r] ? *reinterpret_cast<const float2*>(rows[r] + j0 + 8 * q)
                                   : make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) v[q][r].x += old[q][r].x, v[q][r].y += old[q][r].y;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (in[q] && ok[r]) *reinterpret_cast<float2*>(rows[r] + j0 + 8 * q) = v[q][r];
}

// The long layout's body (Np = 208, 13 strips, head width 16): seven consumer
// warps, warp w owning query strips w and w + 7 (warp 6 only strip 6), and
// the same key strips in the column phase.  Per window and head:
//   (a) as the one-strip body, for both of the warp's strips inside the same
//       ring stages; one named barrier;
//   then per phase, the query strips p G .. p G + G - 1 (G = fb_long_group:
//   7, two phases, where the block fits, else fewer, more phases):
//   (b) row phase: the warp with a strip in the phase (at most one: its two
//       strips lie 7 >= G apart) runs the one-strip body's row phase on it
//       (the whole 16 x 208 score row in registers), its round(P) and
//       round(ds * scale) rows into the phase's tiles and its dq straight to
//       the workspace; q and round(doa) come back as A fragments from the Q
//       and DOA tiles (the same bf16 values); one named barrier;
//   (c) column phase: every warp adds the phase's query strips to dv and dk
//       of its two key strips (registers across the phases, the query strips
//       in order); one named barrier (the tiles are free);
//   then dv and dk of the warp's key strips.  dxa streams the slices once a
// window for both strips; the fp32 dxa rows overlay the row tile
// (fb_long_layout).  Each value is the one the one-strip body would give at
// Np = 208, every sum in its order, but for the dqkv_b and dLN1 column sums:
// a warp adds its two strips' into one (block, warp) partial, so that the
// second pass sums 7 rows a block, not 13 (at 13 those sums took 0.055 ms
// each at (256, 196, 96) on an H100).  The row phase's code exists once, for
// a strip picked at run time: unrolled for each of two strips the kernel's
// instructions doubled, and with 8 warps an SM to hide nothing, instruction
// count and fetch showed in its time.  d(bias) goes out in 8-byte pairs, a
// 16-key step's old values read together (fb_dbias_16keys).  kGrouped: head
// groups, as in the one-strip body.
template <int kHd, bool kChunked, bool kGrouped>
__global__ void __launch_bounds__((kFbLongWarps + 1) * kWarp, 1)
    fold_attn_bwd_long_kernel(FoldBwdMmaArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int Np = kFaLongTokens, kNt = Np / 8, kStrips = kFbLongStrips;
  constexpr int kHt = kHd / 8, kQt = 3 * kHt, kSpw = 2;
  constexpr int kLdw = fa_ldw(kHd), kLdkv = fa_ldkv(kHd), kLdp = Np + 8;
  constexpr int kConsumers = kFbLongWarps * kWarp;
  extern __shared__ __align__(128) unsigned char sm[];

  const int C = a.C, nh = a.nh, C3 = 3 * C, ldr = C + kFaPad, ldx = C + kFbDxaPad;
  const int N = a.wd * a.wh * a.ww;
  const int chunks = kChunked ? a.depth_chunks : 1, kc = C / chunks;  // depth chunks, rows
  const int group = fb_long_group(N, C, kHd, chunks);  // query strips a phase
  const int pitems = fb_long_proj_items(C, kHd, chunks);  // ring items of head h's W_proj rows
  const int per = (fb_proj_slices(C, kHd) + pitems - 1) / pitems;  // slices an item holds
  const FbLayout L = fb_long_layout(N, C, kHd, chunks, group);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + 2;
  unsigned char* ring = sm + L.ring;

  const int nwh = a.H / a.wh, nww = a.W / a.ww;
  const int nw = (a.D / a.wd) * nwh * nww;
  const long long total = (long long)a.B * nw;
  const int groups = kGrouped ? a.groups : 1;
  const int rank = kGrouped ? (int)cluster_ctarank() : 0;
  const int cl = kGrouped ? (int)blockIdx.x / groups : (int)blockIdx.x;  // the window chunk
  const int h0 = rank * nh / groups, h1 = (rank + 1) * nh / groups;     // this block's heads
  const long long wbeg = (long long)cl * a.chunk;
  const long long wend = wbeg + a.chunk < total ? wbeg + a.chunk : total;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFbLongWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier

  if (warp == kFbLongWarps) {
    int pseq = 0;
    if constexpr (kGrouped) {
      for (long long w = wbeg; w < wend; ++w) {  // with the consumers' cluster barriers
        if (lane == 0)
          fb_produce<kHd>(a, ring, L.stage, full, empty, chunks, pitems, h0, h1, w, w + 1, pseq);
        __syncwarp();
        cluster_sync();
        cluster_sync();
        cluster_sync();
      }
    } else if (lane == 0) {
      fb_produce<kHd>(a, ring, L.stage, full, empty, chunks, pitems, 0, nh, wbeg, wend, pseq);
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int strip[kSpw] = {warp, warp + kFbLongWarps};
  const bool has[kSpw] = {true, warp + kFbLongWarps < kStrips};
  bf16* rowt = reinterpret_cast<bf16*>(sm + L.row);
  bf16* Qb = reinterpret_cast<bf16*>(sm + L.tiles);
  bf16* Kb = Qb + (size_t)Np * kLdkv;
  bf16* Vb = Kb + (size_t)Np * kLdkv;
  bf16* Db = Vb + (size_t)Np * kLdkv;
  bf16* Pt = reinterpret_cast<bf16*>(sm + L.ptile);  // [group * 16][kLdp]
  bf16* Dt = reinterpret_cast<bf16*>(sm + L.dtile);
  float* dxa = reinterpret_cast<float*>(sm + L.dxa);  // [Np][ldx], a strip's 16 rows each
  const float pre = 1.f / a.scale, post = a.scale * kLog2e;
  const size_t nn = (size_t)N * N;
  const bool pairs = (N & 1) == 0;  // d(bias) rows keep 8-byte pairs aligned
  float* dbias_blk = a.dbias_part + (size_t)cl * nh * nn;
  // this warp's (chunk, warp) partials of dqkv_b and dLN1: its two strips add
  // into one, the first strip's first window writing it
  float* dqkvb_w = a.dqkvb_part + ((size_t)cl * kFbLongWarps + warp) * C3;
  float* dln_w = a.dln_part + ((size_t)cl * kFbLongWarps + warp) * 2 * C;
  const int phases = (kStrips + group - 1) / group;
  constexpr size_t kHeadStep = (size_t)kStrips * kNt * kWarp;  // packed entries of a head
  int seq = 0;

  for (long long widx = wbeg; widx < wend; ++widx) {
    const bool first = widx == wbeg;
    const int win = (int)(widx % nw), b = (int)(widx / nw);
    const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;
    long long tok[kSpw][2];  // the fragment rows g and g + 8 of each strip
#pragma unroll
    for (int j = 0; j < kSpw; ++j) {
      tok[j][0] = fb_tok(a, b, wi_d, wi_h, wi_w, strip[j] * 16 + g, N);
      tok[j][1] = fb_tok(a, b, wi_d, wi_h, wi_w, strip[j] * 16 + g + 8, N);
    }

    // LN1 (or a copy) of the warp's rows into the row tile, then to row_ws (by
    // rank 0 of a head group; the strips in a run-time loop: one copy of the code)
#pragma unroll 1
    for (int st = warp; st < kStrips; st += kFbLongWarps) {
      const int r = lane >> 1;
      const long long tr = fb_tok(a, b, wi_d, wi_h, wi_w, st * 16 + r, N);
      warp_ln_16rows(tr < 0 ? nullptr : a.x + tr, C, a.ln_s, a.ln_b,
                     reinterpret_cast<uint4*>(rowt + (size_t)(st * 16 + r) * ldr), 1, nullptr,
                     lane);
      __syncwarp();
      for (int e = lane; rank == 0 && e < 16 * (C / 8); e += kWarp) {
        const int rr = e / (C / 8), v = e % (C / 8);
        const long long tt = fb_tok(a, b, wi_d, wi_h, wi_w, st * 16 + rr, N);
        if (tt >= 0)
          *reinterpret_cast<uint4*>(a.row_ws + tt + 8 * v) =
              *reinterpret_cast<const uint4*>(rowt + (size_t)(st * 16 + rr) * ldr + 8 * v);
      }
    }

    const float4* bias0 = reinterpret_cast<const float4*>(a.biasp) + lane;
    const float4* mask0 = a.maskp == nullptr ? nullptr
                                             : reinterpret_cast<const float4*>(a.maskp) +
                                                   (size_t)win * kHeadStep + lane;

    for (int h = h0; h < h1; ++h) {
      // (a) q, k, v of both strips, the slice's chunks in order
      float qa[kSpw][kQt][4];
#pragma unroll
      for (int j = 0; j < kSpw; ++j)
#pragma unroll
        for (int i = 0; i < kQt; ++i) qa[j][i][0] = qa[j][i][1] = qa[j][i][2] = qa[j][i][3] = 0.f;
      for (int k = 0; k < chunks; ++k) {
        const int s = seq & 1;
        mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
#pragma unroll
        for (int j = 0; j < kSpw; ++j)
          if (has[j])
            warp_gemm_16xn<kQt>(rowt + (size_t)strip[j] * 16 * ldr + k * kc, ldr,
                                reinterpret_cast<const bf16*>(ring + (size_t)s * L.stage), kLdw,
                                kc, lane, qa[j]);
        if (chunks == 1) break;  // the stage holds the W_proj rows too: handed back after doa
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        ++seq;
      }
#pragma unroll
      for (int j = 0; j < kSpw; ++j) {
        if (!has[j]) continue;
#pragma unroll
        for (int i = 0; i < kQt; ++i) {
          const float2 bb = *reinterpret_cast<const float2*>(a.qkv_b + (i / kHt) * C + h * kHd +
                                                             (i % kHt) * 8 + 2 * t);
          qa[j][i][0] += bb.x, qa[j][i][1] += bb.y, qa[j][i][2] += bb.x, qa[j][i][3] += bb.y;
        }
#pragma unroll
        for (int i = 0; i < kQt; ++i) {
          bf16* dst = (i < kHt ? Qb : (i < 2 * kHt ? Kb : Vb)) + (size_t)strip[j] * 16 * kLdkv +
                      (i % kHt) * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(dst + g * kLdkv) = pack_bf16(qa[j][i][0], qa[j][i][1]);
          *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdkv) = pack_bf16(qa[j][i][2], qa[j][i][3]);
        }
      }
      // doa = round(dout . W_proj[h hd .. h hd + hd - 1, :]^T) of both strips:
      // head h's W_proj rows behind the slice in its stage, or the next pitems
      // items, each a run of slices (c0 in order across them)
      float da[kSpw][kHt][4];
#pragma unroll
      for (int j = 0; j < kSpw; ++j)
#pragma unroll
        for (int i = 0; i < kHt; ++i) da[j][i][0] = da[j][i][1] = da[j][i][2] = da[j][i][3] = 0.f;
      for (int pi = 0; pi < pitems; ++pi) {
        const int ps = seq & 1;
        if (chunks > 1) mbar_wait(full + ps, (uint32_t)((seq >> 1) & 1));
        const bf16* projp = reinterpret_cast<const bf16*>(ring + (size_t)ps * L.stage) +
                            (chunks == 1 ? (size_t)C * kLdw : 0);
        const int c_beg = pi * per * fa_slice(kHd);
        const int c_end = c_beg + per * fa_slice(kHd) < C ? c_beg + per * fa_slice(kHd) : C;
#pragma unroll
        for (int j = 0; j < kSpw; ++j) {
          if (!has[j]) continue;
          for (int c0 = c_beg; c0 < c_end; c0 += 16) {
            uint32_t af[4];
            af[0] = ld_pair(a.dout, tok[j][0] < 0 ? -1 : tok[j][0] + c0 + 2 * t);
            af[1] = ld_pair(a.dout, tok[j][1] < 0 ? -1 : tok[j][1] + c0 + 2 * t);
            af[2] = ld_pair(a.dout, tok[j][0] < 0 ? -1 : tok[j][0] + c0 + 8 + 2 * t);
            af[3] = ld_pair(a.dout, tok[j][1] < 0 ? -1 : tok[j][1] + c0 + 8 + 2 * t);
            const bf16* pj = projp + (size_t)(c0 / fa_slice(kHd) - pi * per) * kHd * kLdw +
                             c0 % fa_slice(kHd);
#pragma unroll
            for (int np = 0; np < kHd / 16; ++np) {
              uint32_t bf[4];
              ldsm_x4(bf, b_frag_row_nk(pj + (size_t)np * 16 * kLdw, kLdw, lane));
              mma_bf16(da[j][2 * np], af, bf[0], bf[1]);
              mma_bf16(da[j][2 * np + 1], af, bf[2], bf[3]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + ps);  // (with one chunk: the slice's stage too)
        ++seq;
      }
#pragma unroll
      for (int j = 0; j < kSpw; ++j) {
        if (!has[j]) continue;
#pragma unroll
        for (int i = 0; i < kHt; ++i) {
          bf16* dst = Db + (size_t)strip[j] * 16 * kLdkv + i * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(dst + g * kLdkv) = pack_bf16(da[j][i][0], da[j][i][1]);
          *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdkv) =
              pack_bf16(da[j][i][2], da[j][i][3]);
        }
      }
      named_barrier(1, kConsumers);  // every strip's q, k, v, doa of head h are in

      // dv, dk of the warp's key strips, summed over the phases' query strips
      float dv[kSpw][kHt][4], dk[kSpw][kHt][4];
#pragma unroll
      for (int j = 0; j < kSpw; ++j)
#pragma unroll
        for (int i = 0; i < kHt; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[j][i][e] = dk[j][i][e] = 0.f;
      float* dbh = dbias_blk + (size_t)h * nn;
      for (int p = 0; p < phases; ++p) {
        const int q0 = p * group, q1 = q0 + group < kStrips ? q0 + group : kStrips;
        // (b) the row phase of the warp's strip in this phase
        const int sj = warp >= q0 && warp < q1 ? 0 : (has[1] && strip[1] >= q0 && strip[1] < q1 ? 1 : -1);
        if (sj >= 0) {
          const int st = strip[sj];
          const long long t0 = sj ? tok[1][0] : tok[0][0], t1 = sj ? tok[1][1] : tok[0][1];
          const int i0 = st * 16 + g, i1 = i0 + 8;
          bf16* prow = Pt + (size_t)((st - q0) * 16) * kLdp;
          bf16* drow = Dt + (size_t)((st - q0) * 16) * kLdp;
          float* brow0 = dbh + (size_t)i0 * N;  // the d(bias) rows of the lane's fragment rows
          float* brow1 = dbh + (size_t)i1 * N;
          // q and round(doa) of the strip as A fragments, from the tiles
          uint32_t qf[kHd / 16][4], df[kHd / 16][4];
#pragma unroll
          for (int ks = 0; ks < kHd / 16; ++ks) {
            ldsm_x4(qf[ks], a_frag_row(Qb + (size_t)st * 16 * kLdkv + ks * 16, kLdkv, lane));
            ldsm_x4(df[ks], a_frag_row(Db + (size_t)st * 16 * kLdkv + ks * 16, kLdkv, lane));
          }
          float sacc[kNt][4];
          {
            const float4* bp = bias0 + h * kHeadStep + (size_t)st * kNt * kWarp;
            const float4* mp = mask0 == nullptr ? nullptr : mask0 + (size_t)st * kNt * kWarp;
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
          // P (fp32, in place) and round(P) into the phase's P tile
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            sacc[nt][0] = fa_div(sacc[nt][0], l0, r0), sacc[nt][1] = fa_div(sacc[nt][1], l0, r0);
            sacc[nt][2] = fa_div(sacc[nt][2], l1, r1), sacc[nt][3] = fa_div(sacc[nt][3], l1, r1);
            bf16* dst = prow + nt * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(dst + g * kLdp) = pack_bf16(sacc[nt][0], sacc[nt][1]);
            *reinterpret_cast<uint32_t*>(dst + (g + 8) * kLdp) =
                pack_bf16(sacc[nt][2], sacc[nt][3]);
          }
          // o = round(P) . V to the workspace
          {
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
              if (t0 >= 0)
                *reinterpret_cast<uint32_t*>(a.o_ws + t0 + col) = pack_bf16(oacc[i][0], oacc[i][1]);
              if (t1 >= 0)
                *reinterpret_cast<uint32_t*>(a.o_ws + t1 + col) = pack_bf16(oacc[i][2], oacc[i][3]);
            }
          }
          // rowsum(dp * P), dp = doa . v^T a 16-key block at a time
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
          // dp again, ds = P (dp - r) into the chunk's d(bias), dss = round(ds *
          // scale) into the ds tile and dq = dss . k
          float dq[kHt][4];
#pragma unroll
          for (int i = 0; i < kHt; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
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
            float ss[2][4], ds[2][4];
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                ds[q][e] = sacc[2 * np + q][e] * (dp[q][e] - (e < 2 ? rs0 : rs1));
                ss[q][e] = ds[q][e] * a.scale;
              }
            fb_dbias_16keys(brow0, brow1, ds, 16 * np + 2 * t, i0 < N, i1 < N, N, first, pairs);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int nt = 2 * np + q;
              bf16* dst = drow + nt * 8 + 2 * t;
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
          fb_emit_dqkv<kHt>(dq, a.dqkv_ws, dqkvb_w, 0 * C + h * kHd, t0, t1, t, g,
                            first && sj == 0);
        }
        named_barrier(1, kConsumers);  // the phase's P and ds tiles are complete

        // (c) column phase: dv += round(P)^T . doa, dk += dss^T . q over the
        // phase's query strips, for each of the warp's key strips
#pragma unroll
        for (int j = 0; j < kSpw; ++j) {
          if (!has[j]) continue;
          for (int k2 = q0; k2 < q1; ++k2) {
            uint32_t ap[4], as[4];
            const size_t row = (size_t)(k2 - q0) * 16 * kLdp + strip[j] * 16;
            ldsm_x4_t(ap, a_frag_row_km(Pt + row, kLdp, lane));
            ldsm_x4_t(as, a_frag_row_km(Dt + row, kLdp, lane));
#pragma unroll
            for (int nq = 0; nq < kHd / 16; ++nq) {
              uint32_t bd[4], bq[4];
              ldsm_x4_t(bd, b_frag_row_kn(Db + (size_t)k2 * 16 * kLdkv + nq * 16, kLdkv, lane));
              ldsm_x4_t(bq, b_frag_row_kn(Qb + (size_t)k2 * 16 * kLdkv + nq * 16, kLdkv, lane));
              mma_bf16(dv[j][2 * nq], ap, bd[0], bd[1]);
              mma_bf16(dv[j][2 * nq + 1], ap, bd[2], bd[3]);
              mma_bf16(dk[j][2 * nq], as, bq[0], bq[1]);
              mma_bf16(dk[j][2 * nq + 1], as, bq[2], bq[3]);
            }
          }
        }
        named_barrier(1, kConsumers);  // every warp is done with the tiles
      }
      // round(dqkv) of the warp's key strips' tokens; unrounded column sums
#pragma unroll
      for (int j = 0; j < kSpw; ++j) {
        if (!has[j]) continue;
        fb_emit_dqkv<kHt>(dk[j], a.dqkv_ws, dqkvb_w, 1 * C + h * kHd, tok[j][0], tok[j][1], t, g,
                          first && j == 0);
        fb_emit_dqkv<kHt>(dv[j], a.dqkv_ws, dqkvb_w, 2 * C + h * kHd, tok[j][0], tok[j][1], t, g,
                          first && j == 0);
      }
    }

    // dxa = round(dqkv) . W_qkv^T: fp32 rows over the row tile and the per-head
    // tiles (every warp is past the last phase's barrier)
#pragma unroll
    for (int j = 0; j < kSpw; ++j) {
      if (!has[j]) continue;
      float* dr = dxa + (size_t)strip[j] * 16 * ldx;
      for (int e = lane; e < 16 * C; e += kWarp) dr[(e / C) * ldx + e % C] = 0.f;
    }
    __syncwarp();  // (also makes the warp's dqkv rows visible to all its lanes)
    for (int h = h0; h < h1; ++h) {
      uint32_t af[kSpw][3 * kHd / 16][4];  // the warp's round(dqkv) rows of head h (q | k | v)
#pragma unroll
      for (int j = 0; j < kSpw; ++j)
#pragma unroll
        for (int ks = 0; ks < 3 * kHd / 16; ++ks) {
          const int col = (16 * ks / kHd) * C + h * kHd + (16 * ks) % kHd;
          const long long t0 = has[j] ? tok[j][0] : -1, t1 = has[j] ? tok[j][1] : -1;
          af[j][ks][0] = ld_pair(a.dqkv_ws, t0 < 0 ? -1 : 3 * t0 + col + 2 * t);
          af[j][ks][1] = ld_pair(a.dqkv_ws, t1 < 0 ? -1 : 3 * t1 + col + 2 * t);
          af[j][ks][2] = ld_pair(a.dqkv_ws, t0 < 0 ? -1 : 3 * t0 + col + 8 + 2 * t);
          af[j][ks][3] = ld_pair(a.dqkv_ws, t1 < 0 ? -1 : 3 * t1 + col + 8 + 2 * t);
        }
      for (int k = 0; k < chunks; ++k, ++seq) {  // chunk k: dxa's columns k kc ..
        const int s = seq & 1;
        mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
        const bf16* slice = reinterpret_cast<const bf16*>(ring + (size_t)s * L.stage);
        for (int n16 = 0; n16 < kc / 16; ++n16) {
          const int c0 = k * kc + n16 * 16;
#pragma unroll
          for (int j = 0; j < kSpw; ++j) {
            if (!has[j]) continue;
            float* dr = dxa + (size_t)strip[j] * 16 * ldx;
            float acc[2][4];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int col = c0 + q * 8 + 2 * t;
              const float2 u = *reinterpret_cast<const float2*>(dr + g * ldx + col);
              const float2 v = *reinterpret_cast<const float2*>(dr + (g + 8) * ldx + col);
              acc[q][0] = u.x, acc[q][1] = u.y, acc[q][2] = v.x, acc[q][3] = v.y;
            }
#pragma unroll
            for (int ks = 0; ks < 3 * kHd / 16; ++ks) {
              uint32_t bf[4];  // B (k = the slice's columns, n = c) stored [n][k]
              ldsm_x4(bf, b_frag_row_nk(slice + (size_t)n16 * 16 * kLdw + ks * 16, kLdw, lane));
              mma_bf16(acc[0], af[j][ks], bf[0], bf[1]);
              mma_bf16(acc[1], af[j][ks], bf[2], bf[3]);
            }
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int col = c0 + q * 8 + 2 * t;
              *reinterpret_cast<float2*>(dr + g * ldx + col) = make_float2(acc[q][0], acc[q][1]);
              *reinterpret_cast<float2*>(dr + (g + 8) * ldx + col) =
                  make_float2(acc[q][2], acc[q][3]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
    }
    if constexpr (kGrouped) {
      cluster_sync();  // every rank's dxa rows are in
#pragma unroll 1
      for (int st = warp; st < kStrips; st += kFbLongWarps)
        fb_sum_ranks(dxa + (size_t)st * 16 * ldx, ldx, C, st * 16, N, rank, groups, lane);
      __syncwarp();
    }
    // dx = LN-vjp(dxa) + dout (or round(dxa) without LN) of the warp's strips;
    // a head group's dLN1 sums into the exchange rows of the warp's first strip
    float* xch = kGrouped ? dxa + ((size_t)warp * 16 + rank) * ldx : dln_w;
#pragma unroll 1
    for (int st = warp; st < kStrips; st += kFbLongWarps)
      fb_dx_strip(a, dxa + (size_t)st * 16 * ldx, xch, kGrouped ? groups * ldx : C, b, wi_d,
                  wi_h, wi_w, st, N, ldx, (kGrouped || first) && st == warp, lane, rank, groups);
    if constexpr (kGrouped) {
      cluster_sync();  // every rank's dLN1 sums are in
      if (rank == 0 && a.ln_s != nullptr)
        fb_sum_dln(dln_w, dxa + (size_t)warp * 16 * ldx, ldx, C, groups, first, lane);
      cluster_sync();  // the other ranks are done with this block's dxa rows
    } else {
      named_barrier(1, kConsumers);  // the next window's row tile overlays other warps' dxa rows
    }
  }
}

// One launch of `kernel` on `blocks` blocks of `threads`, in clusters of
// a.groups blocks (cudaLaunchKernelEx) where heads split into groups.
template <class Kernel>
cudaError_t launch_fb(Kernel kernel, const FoldBwdMmaArgs& a, unsigned blocks, unsigned threads,
                      size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (a.groups == 1) {
    kernel<<<blocks, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.groups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kChunked>
cudaError_t launch_fb_long(const FoldBwdMmaArgs& a, unsigned blocks, size_t smem,
                           cudaStream_t stream) {
  constexpr unsigned kThreads = (kFbLongWarps + 1) * kWarp;
  return a.groups > 1
             ? launch_fb(fold_attn_bwd_long_kernel<16, kChunked, true>, a, blocks, kThreads, smem,
                         stream)
             : launch_fb(fold_attn_bwd_long_kernel<16, kChunked, false>, a, blocks, kThreads,
                         smem, stream);
}

template <int kNt, int kHd, bool kChunked>
cudaError_t launch_fb_instance(const FoldBwdMmaArgs& a, unsigned blocks, size_t smem,
                               cudaStream_t stream) {
  constexpr unsigned kThreads = (kNt / 2 + 1) * kWarp;
  return a.groups > 1
             ? launch_fb(fold_attn_bwd_mma_kernel<kNt, kHd, kChunked, true>, a, blocks, kThreads,
                         smem, stream)
             : launch_fb(fold_attn_bwd_mma_kernel<kNt, kHd, kChunked, false>, a, blocks,
                         kThreads, smem, stream);
}

template <int kNt, int kHd>
cudaError_t launch_fb_as(const FoldBwdMmaArgs& a, unsigned blocks, size_t smem,
                         cudaStream_t stream) {
  return a.depth_chunks > 1 ? launch_fb_instance<kNt, kHd, true>(a, blocks, smem, stream)
                            : launch_fb_instance<kNt, kHd, false>(a, blocks, smem, stream);
}

constexpr int kFbMaxGroups = 8;  // the portable cluster size

// Windows a block (with head groups: a cluster) walks, so that about
// kFbBlocks blocks run: ops/fold_attn.py:fold_bwd_blocks mirrors it.
inline int fb_chunk(long long windows, int groups) {
  return (int)((windows * groups + kFbBlocks - 1) / kFbBlocks);
}

struct FbWorkspace {
  size_t row, o, dqkv, dqkvb, dln, dbias, atb, bytes;
  int chunks, blocks, chunk, strips;  // chunks: of windows, one a cluster; blocks: chunks x groups
};

inline FbWorkspace fb_workspace(int B, int D, int H, int W, int C, int nh, int wd, int wh,
                                int ww, int groups) {
  const int n = wd * wh * ww;
  const size_t T = (size_t)B * D * H * W, bf = 2;
  const long long windows = (long long)B * (D / wd) * (H / wh) * (W / ww);
  FbWorkspace l;
  l.chunk = fb_chunk(windows, groups);
  l.chunks = (int)((windows + l.chunk - 1) / l.chunk);
  l.blocks = l.chunks * groups;
  // partial rows a block: a strip's, or in the long layout a warp's (two strips)
  l.strips = fa_padded_rows(n) == kFaLongTokens ? kFbLongWarps : fa_padded_rows(n) / 16;
  const size_t atb_a = atb_mma_partial_floats((int)T, C, 3 * C);
  const size_t atb_b = atb_mma_partial_floats((int)T, C, C);
  size_t o = 0;
  l.row = o;   o = align256(o + bf * T * C);
  l.o = o;     o = align256(o + bf * T * C);
  l.dqkv = o;  o = align256(o + bf * T * 3 * C);
  l.dqkvb = o; o = align256(o + sizeof(float) * l.chunks * l.strips * 3 * C);
  l.dln = o;   o = align256(o + sizeof(float) * l.chunks * l.strips * 2 * C);
  l.dbias = o; o = align256(o + sizeof(float) * l.chunks * nh * (size_t)n * n);
  l.atb = o;   o = align256(o + sizeof(float) * (atb_a > atb_b ? atb_a : atb_b));
  l.bytes = o;
  return l;
}

}  // namespace vadcl

extern "C" {

long long vadcl_fold_attn_bwd_bf16_smem_bytes(int n, int c, int nh) {
  return (long long)vadcl::fb_smem_bytes(n, c, c / nh);
}

long long vadcl_fold_attn_bwd_bf16_workspace_bytes(int B, int D, int H, int W, int C, int nh,
                                                   int wd, int wh, int ww, int groups) {
  return (long long)vadcl::fb_workspace(B, D, H, W, C, nh, wd, wh, ww, groups).bytes;
}

// Partials of d(bias) (nH x N x N floats each) this body sums: one per chunk
// of windows (a cluster of `groups` blocks with head groups).
long long vadcl_fold_attn_bwd_bf16_dbias_partials(int B, int D, int H, int W, int C, int nh,
                                                  int wd, int wh, int ww, int groups) {
  return (long long)vadcl::fb_workspace(B, D, H, W, C, nh, wd, wh, ww, groups).chunks;
}

// x, dout (B, D, H, W, C) bf16; wpack, biasp, maskp: kernel A's packs
// (ops/fold_attn.py); qkv_b (3C,) fp32 (zeros without a bias); the gradients
// fp32 except dx (bf16).  groups: the head groups a window's heads split into
// (ops/fold_attn.py:fold_bwd_head_groups; a divisor of nh, at most 8).
int vadcl_fold_attn_bwd_bf16(const void* x, const void* dout, const float* ln_s,
                             const float* ln_b, const void* wpack, const float* qkv_b,
                             const float* biasp, const float* maskp, void* dx, float* dln_s,
                             float* dln_b, float* dqkv_w, float* dqkv_b, float* dproj_w,
                             float* dproj_b, float* dbias, void* workspace, int B, int D, int H,
                             int W, int C, int nh, int wd, int wh, int ww, int sd, int sh, int sw,
                             float scale, int residual, int groups, void* stream) {
  using namespace vadcl;
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = wd * wh * ww;
  if (B <= 0 || D % wd || H % wh || W % ww || !fb_eligible(n, C, nh))
    return cudaErrorInvalidValue;
  if ((ln_s != nullptr) != (residual != 0)) return cudaErrorInvalidValue;
  if (groups < 1 || groups > kFbMaxGroups || nh % groups) return cudaErrorInvalidValue;
  const int hd = C / nh, chunks = fb_depth_chunks(n, C, hd);
  const size_t smem = fb_block_layout(n, C, hd, chunks).bytes;
  const FbWorkspace l = fb_workspace(B, D, H, W, C, nh, wd, wh, ww, groups);
  char* ws = static_cast<char*>(workspace);
  FoldBwdMmaArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(dout), ln_s, ln_b,
                   static_cast<const bf16*>(wpack), qkv_b, biasp, maskp, static_cast<bf16*>(dx),
                   reinterpret_cast<bf16*>(ws + l.row), reinterpret_cast<bf16*>(ws + l.o),
                   reinterpret_cast<bf16*>(ws + l.dqkv),
                   reinterpret_cast<float*>(ws + l.dqkvb), reinterpret_cast<float*>(ws + l.dln),
                   reinterpret_cast<float*>(ws + l.dbias),
                   B, D, H, W, C, nh, wd, wh, ww, sd, sh, sw, scale, residual, l.chunk, chunks,
                   groups};
  cudaError_t err;
  const bool wide = fa_padded_rows(n) == kFaMaxTokens;
  if (fa_padded_rows(n) == kFaLongTokens)  // head width 16 (fb_eligible)
    err = chunks > 1 ? launch_fb_long<true>(a, l.blocks, smem, s)
                     : launch_fb_long<false>(a, l.blocks, smem, s);
  else if (hd == 16)
    err = wide ? launch_fb_as<14, 16>(a, l.blocks, smem, s) : launch_fb_as<8, 16>(a, l.blocks, smem, s);
  else
    err = wide ? launch_fb_as<14, 32>(a, l.blocks, smem, s) : launch_fb_as<8, 32>(a, l.blocks, smem, s);
  if (err != cudaSuccess) return err;
  // the second pass
  const int T = B * D * H * W, rows = l.chunks * l.strips;
  float* part = reinterpret_cast<float*>(ws + l.atb);
  if ((err = launch_atb_mma(a.row_ws, nullptr, a.dqkv_ws, nullptr, T, C, 3 * C, part, dqkv_w,
                            nullptr, s)))
    return err;
  if ((err = launch_atb_mma(a.o_ws, nullptr, a.dout, nullptr, T, C, C, part, dproj_w, dproj_b,
                            s)))
    return err;
  if ((err = launch_sum_rows(a.dqkvb_part, dqkv_b, rows, 3 * C, 3 * C, s))) return err;
  if (ln_s != nullptr) {
    if ((err = launch_sum_rows(a.dln_part, dln_s, rows, C, 2 * C, s))) return err;
    if ((err = launch_sum_rows(a.dln_part + C, dln_b, rows, C, 2 * C, s))) return err;
  }
  return launch_sum_rows(a.dbias_part, dbias, l.chunks, (long long)nh * n * n,
                         (long long)nh * n * n, s);
}

}  // extern "C"
