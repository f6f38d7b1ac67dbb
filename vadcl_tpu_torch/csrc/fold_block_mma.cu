// The whole-Swin-block forward for Hopper (bf16):
//   y = y1 + fc2(gelu(fc1(LN2 y1))),   y1 = round(x + proj(attention(LN1 x)))
// per (8,7,7)-shrunk window of the unpartitioned (B, D, H, W, C) tensor, the
// shift roll folded into the addressing.
//
// Replaces vadcl_tpu/ops/pallas_attn_fold.py:_fold_kernel with mlp= (entry
// folded_full_block_trainable through pallas_attn_fold.py:1400; the tail is
// _mlp_tail_rows) for bf16 windows of at most 112 tokens at head width 16 or
// 32, C % 16 == 0, C <= 192, a hidden width divisible by 64 and a block within
// 227 KB (ops/fold_attn.py:fold_block_fwd_body picks); fold_attn.cu's
// vadcl_fold_block (PR 4's body, fold_attn.cuh:fold_attn_tc_body) keeps fp32
// and every other geometry.
//
// Numerical contract: fold_block_plain's, what kernels A then B give: y1
// rounds to bf16; LN2 is fp32 (fast variance), z = round(LN2 y1); h =
// round(z.W1 + b1), g = round(gelu(h)) with erff; fc2 sums in fp32 over the
// whole hidden width; y = round(y1 + (fc2 + b2)).  Every product is one bf16
// mma.sync.m16n8k16 pass with fp32 accumulation.
//
// Design: the backward's step 1 followed by a forward MLP on the same strips.
// A window is padded to Np = 64 or 112 rows and cut into strips of 16; warp w
// owns strip w from LN1 to the store.  A block walks a chunk of consecutive
// windows; one producer warp streams, per window, kernel A's pack
// (ops/fold_attn.py:pack_fold_weights: nH head slices, then the projection
// slices) and then kernel B's pack (ops/ln_mlp.py:pack_mlp_weights) in pieces
// of 32 hidden columns through one two-stage cp.async.bulk / mbarrier ring:
// the same packs the backward reads, so in a training step they are made once.
//   1. fold_block_mma.cuh:bb_attn_strip: LN1, per head q, k and v, the scores
//      in registers on top of the packed bias and mask, P = e / l (ex2, fa_div),
//      o = round(P).V into the warp's rows of the o tile, then y1 =
//      round(x + o.W_proj + proj_b) into the warp's rows of the LN1 tile;
//   2. LN2 of those rows into the warp's rows of the o tile (dead by then):
//      z = round(LN2 y1); per ring piece h = z.W1[:, piece] (16 x 32, four
//      n8 accumulator tiles), + b1, GELU, each value rounded, and the
//      accumulator tiles, two neighbouring n8 tiles a k16 A fragment (mma.cuh),
//      are fc2's A operand straight from the registers: fc2 accumulates the
//      warp's 16 x C output tile in registers across the hidden width;
//   3. y = round(y1 + (fc2 + b2)) into the warp's y1 rows, then stored 16 bytes
//      a lane, a token row contiguous, by the folded addressing.
// The K and V tiles are double-buffered by a head count that runs on across
// the chunk's windows, so one named barrier of the window's strips a head is
// the only synchronisation: every other tile a warp touches is its own rows.
// Shared memory: the ring (the larger of a head slice and a 32-column piece),
// the LN1 / y1 tile, K and V of two heads, the o / z tile: 92.8 KB at N = 98,
// C = 96 (two blocks an SM), 157 KB at C = 192 (one), 110 KB at N = 49, C =
// 192 (two).  C is a template bucket (the fc2 tile of C <= 96 or <= 192 in
// registers), as in the backward.  Tried on the same card and not kept (none
// faster; tools/block_fwd_clocks_torch.py --variant): the fc1 loop unrolled
// over the bucket, GELU and fc2 interleaved by halves of a piece, three
// blocks an SM at 64 rows.
//
// What bounds it: at enc stage 0, batch 16 (100,352 tokens, C = 96, hidden
// 384) the products are 26 GFLOP (0.026 ms at 989 TFLOP/s) and the bytes 40
// MB (0.012 ms); what the warps spend is issue time and latency.  Clocks
// stamped into a copy (tools/block_fwd_clocks_torch.py; an H100 80GB HBM3 at
// 700 W) read step 1 and step 2
// about equal a window (56-63K and 58K clocks a warp), the ring waits of
// step 2 4% of it; without the erff GELU (4C a token at about 40 issue
// slots) the call reads 14% less, without the MLP products 22-25% less: each
// piece runs fc1 -> GELU -> fc2 as one dependent chain a warp, and every warp
// reads the piece's weights from shared memory for its own 16 rows.  Left on the table:
// wgmma for step 2, a warpgroup of four strips reading each piece once and
// fc2 left in flight behind the next piece's GELU (it needs an instance per
// exact C: a wgmma in a data-dependent branch is serialised).
#include "fold_block_mma.cuh"
#include "mlp_tail.cuh"  // gelu_erf

namespace vadcl {

constexpr int kFbBlocks = 132;  // windows are chunked to this many blocks an SM's worth

struct FbLayout {
  size_t stage, ring, row, kv, o, bytes;
};

// Shared memory of one block for a window of n tokens, width c, head width hd.
__host__ __device__ inline FbLayout fb_layout(int n, int c, int hd) {
  const size_t np = fa_padded_rows(n), bf = 2;
  const size_t a_stage = bf * (size_t)c * fa_ldw(hd);
  const size_t b_stage = bf * 2 * (size_t)c * kBbPiece;
  const size_t tile = bf * np * (c + kFaPad);
  FbLayout l;
  l.stage = a_stage > b_stage ? a_stage : b_stage;
  size_t o = kFaBarrierBytes;
  l.ring = o;  o += 2 * l.stage;
  l.row = o;   o += tile;
  l.kv = o;    o += bf * 2 * 2 * np * fa_ldkv(hd);
  l.o = o;     o += tile;
  l.bytes = o;
  return l;
}

inline bool fb_eligible(int n, int c, int nh, int ch) {
  if (nh <= 0 || c % nh || c % 16 || c > kBbMaxC || n <= 0 || n > kFaMaxTokens || ch <= 0 ||
      ch % kBbPackChunk)
    return false;
  const int hd = c / nh;
  return (hd == 16 || hd == 32) && fb_layout(n, c, hd).bytes <= (size_t)kMaxSmemBytes;
}

struct FbArgs {
  const __nv_bfloat16* x;
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
  const float* b2;             // (C,)
  __nv_bfloat16* out;
  int B, D, H, W, C, nh, Ch, wd, wh, ww;
  int sd, sh, sw;
  float scale;
  int chunk;  // windows per block
};

// Blocks an SM of an instance: two at head width 16 where two blocks' shared
// memory fits, i.e. C <= 96 (128 registers a thread at 112 rows) or 64 rows
// (dec stage 0; tools/block_fwd_clocks_torch.py --variant one_block_64 times
// one there), else one.
__host__ __device__ constexpr int fb_blocks_per_sm(int nt, int hd, int ct) {
  return hd == 16 && (ct == 6 || nt == 8) ? 2 : 1;
}

// kNt = Np / 8 (8 or 14), kHd the head width (16 or 32), kCt the 16-column
// tiles of the fc2 output a warp holds (6: C <= 96, 12: C <= 192).
template <int kNt, int kHd, int kCt>
__global__ void __launch_bounds__((kNt / 2 + 1) * kWarp, fb_blocks_per_sm(kNt, kHd, kCt))
    fold_block_mma_kernel(FbArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kStrips = kNt / 2, kP = kBbPiece / 16;
  constexpr int kLdw = fa_ldw(kHd);
  extern __shared__ __align__(128) unsigned char sm[];

  const int C = a.C, nh = a.nh, ldr = C + kFaPad;
  const int N = a.wd * a.wh * a.ww;
  const FbLayout L = fb_layout(N, C, kHd);
  const int npc = bb_proj_slices(C, kHd);
  const int npieces = a.Ch / kBbPiece;
  const uint32_t slice_bytes = (uint32_t)(sizeof(bf16) * C * kLdw);
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
    // producer: per window kernel A's nH + ceil(C / 3hd) slices, then kernel
    // B's pack in pieces of 32 hidden columns
    if (lane == 0) {
      const int items = nh + npc + npieces;
      int seq = 0;
      for (long long widx = wbeg; widx < wend; ++widx)
        for (int item = 0; item < items; ++item, ++seq) {
          const int s = seq & 1, use = seq >> 1;
          if (use > 0) mbar_wait(empty + s, (uint32_t)((use - 1) & 1));
          unsigned char* dst = ring + (size_t)s * L.stage;
          if (item < nh + npc) {
            mbar_expect_tx(full + s, slice_bytes);
            bulk_copy_g2s(dst, a.wpack + (size_t)item * C * kLdw, slice_bytes, full + s);
          } else {
            // hidden columns 32q .. 32q + 31: W1's as [4][C][8], then W2's as
            // [C / 8][32][8]
            const int q = item - nh - npc, half = q & 1;
            const bf16* chunk = a.mpack + (size_t)(q >> 1) * 2 * C * kBbPackChunk;
            mbar_expect_tx(full + s, 2 * half_bytes);
            bulk_copy_g2s(dst, chunk + (size_t)half * 4 * C * 8, half_bytes, full + s);
            const bf16* w2 = chunk + (size_t)C * kBbPackChunk + (size_t)half * kBbPiece * 8;
            for (int cg = 0; cg < C / 8; ++cg)
              bulk_copy_g2s(dst + half_bytes + (size_t)cg * kBbPiece * 8 * sizeof(bf16),
                            w2 + (size_t)cg * kBbPackChunk * 8, kBbPiece * 8 * sizeof(bf16),
                            full + s);
          }
        }
    }
    return;
  }

  const int strip = warp, g = lane >> 2, t = lane & 3;
  bf16* rows = reinterpret_cast<bf16*>(sm + L.row) + (size_t)strip * 16 * ldr;  // LN1, then y1
  bf16* ot = reinterpret_cast<bf16*>(sm + L.o) + (size_t)strip * 16 * ldr;      // o, then z
  const float pre = 1.f / a.scale, post = a.scale * kLog2e;
  const int nct = C / 16;
  int seq = 0;

  for (long long widx = wbeg; widx < wend; ++widx) {
    const int win = (int)(widx % nw), b = (int)(widx / nw);
    const int wi_d = win / (nwh * nww), wi_h = (win / nww) % nwh, wi_w = win % nww;
    const int i0 = strip * 16 + g, i1 = i0 + 8;  // the fragment rows of this lane
    const long long tok0 = bb_tok(a, b, wi_d, wi_h, wi_w, i0, N);
    const long long tok1 = bb_tok(a, b, wi_d, wi_h, wi_w, i1, N);
    const float4* bfrag =
        reinterpret_cast<const float4*>(a.biasp) + (size_t)strip * kNt * kWarp + lane;
    const float4* mfrag =
        a.maskp != nullptr ? reinterpret_cast<const float4*>(a.maskp) +
                                 ((size_t)win * kStrips + strip) * kNt * kWarp + lane
                           : nullptr;
    // the token of the row this lane's pair normalises (rows lane / 2)
    const long long tr = bb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + (lane >> 1), N);

    // ---- step 1: y1 into the warp's rows ----
    warp_ln_16rows(tr < 0 ? nullptr : a.x + tr * C, C, a.ln_s, a.ln_b,
                   reinterpret_cast<uint4*>(rows + (size_t)(lane >> 1) * ldr), 1, nullptr, lane);
    __syncwarp();
    bb_attn_strip<kNt, kHd>(a, ring, L.stage, full, empty, seq,
                            (int)(((widx - wbeg) * nh) & 1), reinterpret_cast<bf16*>(sm + L.kv),
                            ot, rows, ldr, bfrag, mfrag, pre, post,
                            tok0 < 0 ? -1 : tok0 * C, tok1 < 0 ? -1 : tok1 * C, nullptr, strip,
                            lane);
    __syncwarp();  // the y1 rows are complete; the o rows are dead

    // ---- step 2: z = round(LN2 y1) over the o rows, the MLP in registers ----
    warp_ln_16rows(tr < 0 ? nullptr : rows + (size_t)(lane >> 1) * ldr, C, a.ln2_s, a.ln2_b,
                   reinterpret_cast<uint4*>(ot + (size_t)(lane >> 1) * ldr), 1, nullptr, lane);
    __syncwarp();
    float acc[2 * kCt][4];
#pragma unroll
    for (int i = 0; i < 2 * kCt; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int q = 0; q < npieces; ++q, ++seq) {
      const int s = seq & 1;
      mbar_wait(full + s, (uint32_t)((seq >> 1) & 1));
      // W1's columns at element (c, n): ((n / 8) * C + c) * 8 + n % 8;
      // W2's rows at element (n, c): ((c / 8) * 32 + n) * 8 + c % 8
      const bf16* w1s = reinterpret_cast<const bf16*>(ring + (size_t)s * L.stage);
      const bf16* w2s = w1s + (size_t)C * kBbPiece;
      float h[2 * kP][4];
#pragma unroll
      for (int i = 0; i < 2 * kP; ++i) h[i][0] = h[i][1] = h[i][2] = h[i][3] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t az[4];
        ldsm_x4(az, a_frag_row(ot + k0, ldr, lane));
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          uint32_t bw[4];
          ldsm_x4_t(bw, w1s + ((size_t)(2 * p + (lane >> 4)) * C + k0 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * 8);
          mma_bf16(h[2 * p], az, bw[0], bw[1]);
          mma_bf16(h[2 * p + 1], az, bw[2], bw[3]);
        }
      }
      // g = round(gelu(round(h + b1))), as fc2's A fragments (k = the piece's columns)
      uint32_t ga[kP][4];
#pragma unroll
      for (int nt = 0; nt < 2 * kP; ++nt) {
        const float2 bb =
            *reinterpret_cast<const float2*>(a.b1 + q * kBbPiece + nt * 8 + 2 * t);
        h[nt][0] = gelu_erf(round_to<bf16>(h[nt][0] + bb.x));
        h[nt][1] = gelu_erf(round_to<bf16>(h[nt][1] + bb.y));
        h[nt][2] = gelu_erf(round_to<bf16>(h[nt][2] + bb.x));
        h[nt][3] = gelu_erf(round_to<bf16>(h[nt][3] + bb.y));
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) acc_to_a(ga[p], h[2 * p], h[2 * p + 1]);
      // fc2: B (k = hidden, n = c) stored [c / 8][k][c % 8], two n-tiles a load
#pragma unroll
      for (int np = 0; np < kCt; ++np) {
        if (np >= nct) break;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          uint32_t bf[4];
          ldsm_x4_t(bf, w2s + ((size_t)(2 * np + (lane >> 4)) * kBbPiece + 16 * p + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * 8);
          mma_bf16(acc[2 * np], ga[p], bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], ga[p], bf[2], bf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    // ---- step 3: y = round(y1 + (fc2 + b2)) into the y1 rows, then stored ----
#pragma unroll
    for (int nt = 0; nt < 2 * kCt; ++nt) {
      if (nt >= 2 * nct) break;
      const int col = nt * 8 + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(a.b2 + col);
      uint32_t* p0 = reinterpret_cast<uint32_t*>(rows + g * ldr + col);
      uint32_t* p1 = reinterpret_cast<uint32_t*>(rows + (g + 8) * ldr + col);
      const float2 y0 = unpack_bf16(*p0), y1 = unpack_bf16(*p1);
      *p0 = pack_bf16(y0.x + (acc[nt][0] + bb.x), y0.y + (acc[nt][1] + bb.y));
      *p1 = pack_bf16(y1.x + (acc[nt][2] + bb.x), y1.y + (acc[nt][3] + bb.y));
    }
    __syncwarp();
    const int vecs = C / 8;
    for (int e = lane; e < 16 * vecs; e += kWarp) {
      const int r = e / vecs, v = e % vecs;
      const long long tk = bb_tok(a, b, wi_d, wi_h, wi_w, strip * 16 + r, N);
      if (tk >= 0)
        reinterpret_cast<uint4*>(a.out + tk * C)[v] =
            *reinterpret_cast<const uint4*>(rows + (size_t)r * ldr + v * 8);
    }
    __syncwarp();  // the next window's LN1 overwrites the rows
  }
}

template <int kNt, int kHd, int kCt>
cudaError_t launch_fb_as(const FbArgs& a, unsigned blocks, size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(fold_block_mma_kernel<kNt, kHd, kCt>, smem);
  if (err != cudaSuccess) return err;
  fold_block_mma_kernel<kNt, kHd, kCt><<<blocks, (kNt / 2 + 1) * kWarp, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kNt, int kHd>
cudaError_t launch_fb_nt(const FbArgs& a, unsigned blocks, size_t smem, cudaStream_t stream) {
  return a.C <= 96 ? launch_fb_as<kNt, kHd, 6>(a, blocks, smem, stream)
                   : launch_fb_as<kNt, kHd, 12>(a, blocks, smem, stream);
}

}  // namespace vadcl

extern "C" {

long long vadcl_fold_block_bf16_smem_bytes(int n, int c, int nh) {
  return (long long)vadcl::fb_layout(n, c, c / nh).bytes;
}

// x, out (B, D, H, W, C) bf16; wpack, biasp, maskp: kernel A's packs; mpack:
// kernel B's pack of (w1, w2); qkv_b (3C,) fp32 (zeros without a bias); the
// other vectors fp32, 16-byte aligned.
int vadcl_fold_block_bf16(const void* x, const float* ln_s, const float* ln_b, const void* wpack,
                          const float* qkv_b, const float* proj_b, const float* biasp,
                          const float* maskp, const float* ln2_s, const float* ln2_b,
                          const void* mpack, const float* b1, const float* b2, void* out, int B,
                          int D, int H, int W, int C, int nh, int Ch, int wd, int wh, int ww,
                          int sd, int sh, int sw, float scale, void* stream) {
  using namespace vadcl;
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = wd * wh * ww;
  if (B <= 0 || D % wd || H % wh || W % ww || !fb_eligible(n, C, nh, Ch))
    return cudaErrorInvalidValue;
  const int hd = C / nh;
  const size_t smem = fb_layout(n, C, hd).bytes;
  const long long windows = (long long)B * (D / wd) * (H / wh) * (W / ww);
  const long long target =
      (long long)kFbBlocks * fb_blocks_per_sm(fa_padded_rows(n) / 8, hd, C <= 96 ? 6 : 12);
  const int chunk = (int)((windows + target - 1) / target);
  const unsigned blocks = (unsigned)((windows + chunk - 1) / chunk);
  FbArgs a{static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(wpack), qkv_b,
           proj_b, biasp, maskp, ln2_s, ln2_b, static_cast<const bf16*>(mpack), b1, b2,
           static_cast<bf16*>(out), B, D, H, W, C, nh, Ch, wd, wh, ww, sd, sh, sw, scale, chunk};
  const bool wide = fa_padded_rows(n) == kFaMaxTokens;
  if (hd == 16)
    return wide ? launch_fb_nt<14, 16>(a, blocks, smem, s) : launch_fb_nt<8, 16>(a, blocks, smem, s);
  return wide ? launch_fb_nt<14, 32>(a, blocks, smem, s) : launch_fb_nt<8, 32>(a, blocks, smem, s);
}

}  // extern "C"
