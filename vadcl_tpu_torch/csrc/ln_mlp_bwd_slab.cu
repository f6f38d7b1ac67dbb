// Kernel 5's tensor-core body above C = 192 (bf16): the backward of
// y = x + fc2(gelu(fc1(LN2(x)))) over (T, C) tokens (dx, dLN2, dW1, db1, dW2,
// db2).
//
// Replaces vadcl_tpu/ops/pallas_mlp.py:_bwd_kernel (entry _vjp_bwd) for bf16
// tokens at C % 16 == 0, 192 < C <= 592 and a hidden width divisible by 64
// (ops/ln_mlp.py:mlp_bwd_body picks it; ln_mlp_bwd_slab counts it and forces
// it from C = 16, kBsMinC, to time it beside ln_mlp_bwd_mma.cu's body).  The
// narrow body keeps C <= 192; ln_mlp_bwd.cu's CUDA-core body keeps fp32,
// widths off 16 and C above 592.
//
// Numerical contract: ln_mlp_bwd_plain's, as ln_mlp_bwd_mma.cu states it.  The
// recompute rounds z = LN2(x) before fc1 and h before GELU; every backward
// product is the fp32 product of fp32 operands.  On the tensor cores:
//   * h = round(z) . W1 and dg = dy . W2^T have exact bf16 operands: one
//     bf16 wgmma pass each with fp32 accumulation;
//   * dz = dh . W1^T has one fp32 operand, dh = dg * gelu'(round(h + b1)):
//     split in registers into hi = round(dh) and lo = round(dh - hi), both
//     fed as register A operands, hi . W1^T + lo . W1^T summed in the fp32
//     accumulator (2 passes);
//   * dW2 = g^T . dy (2 passes) and dW1 = z^T . dh (3 passes) run in the
//     second pass (reduce_mma.cu:launch_atb_mma) on z, g and dh written as
//     hi/lo bf16 pairs (g and dh by pass 1, z by the dx pass).
// No fp32 operand is rounded once to bf16 or TF32.  Every sum is in a fixed
// order with no float atomics: two runs give the same bits.
//
// What held the narrow body at C <= 192: a warp's 16 x C dz accumulator in
// registers with C a template parameter, and its block (128 tokens of round(z)
// and dy rows beside a two-stage ring of 64-column chunks) needs 283,776 B at
// C = 256 (ops/ln_mlp.py:mlp_bwd_mma_smem_bytes).
//
// Design, after ln_mlp_slab.cu (kernel B's slab body):
//   * A block's unit of work is (64 tokens, one slab of CS columns of dz): one
//     consumer warpgroup keeps dz[:, slab] as a 64 x CS fp32 wgmma accumulator
//     (CS / 2 registers a thread: 128 at CS = 256) whatever C is; C runs at run
//     time.  The instance table kBsShapes (ops/ln_mlp.py:MLP_BWD_SLAB_SHAPES)
//     is kernel B's kMsShapes up to C_max = 592: CS = 256 with 64-column hidden
//     chunks up to C = 256 (one slab: nothing is computed twice, the Swin-B
//     width's inner stages), CS = 128 with 16-column chunks above (C / 128
//     slabs; h and dg recomputed once per slab).  The block holds the 64 x C
//     round(z) and dy tiles (bf16, wgmma's K-major layout) beside a ring of at
//     least two stages; above C = 592 they outgrow 227 KB (230,464 B at 592),
//     and streaming z and dy by depth chunks is left for later.
//   * The weights arrive as kernel B's slab pack (ops/ln_mlp.py:pack_mlp_slabs,
//     the forward's cached entry: a step packs once).  A stage is W1[:, chunk]
//     (C x HC, N-major) and W2[chunk, :] (every slab's HC x CS piece, the
//     columns past C zero), copied by a producer warp with cp.async.bulk onto
//     one mbarrier; the consumer hands a stage back on its "empty" mbarrier
//     once the wgmmas that read it completed.  The same tiles serve three
//     products: W1 N-major as fc1's B, the W2 pieces read K-major as W2^T's B
//     (dg: k = c, n = hidden), and W1 read K-major as W1^T's B (dz: k = hidden,
//     n = c), with no second pack.
//   * Per chunk the warpgroup walks HS hidden columns at a time (32 at CS =
//     256, 16 at CS = 128): h (64 x HS) as C / 16 wgmmas from shared memory,
//     dg the same from the dy tile, a wait, then in registers hb =
//     round(h + b1), g = gelu(hb), dh = dg * gelu'(hb) (one erff for both),
//     the slab-0 items writing g and dh as hi/lo pairs, then dz += dh_hi .
//     W1^T + dh_lo . W1^T as CS / 32 register-A wgmmas each, left in flight
//     behind the next sub-chunk's h and dg.  No ordinary instruction writes an
//     accumulator a wgmma has in flight: h and dg start each sub-chunk with
//     scale-d 0 (ptxas note C7515 otherwise), dz is zeroed only after the item's
//     last wait.
//   * A warp normalises its 16 tokens into the round(z) tile with kernel B's
//     own routine (mma.cuh:warp_ln_16rows), and copies dy into the dy tile.
//   * dz[:, slab] goes to the workspace in fp32 (T x C, every slab its own
//     columns), and ln_mlp_bwd_slab_dx_kernel forms dx = dy + LN-vjp(dz) per
//     row (its row sums span the slabs), the per-block dLN2 column sums in
//     row order (sum_rows adds those in block order) and z's hi/lo pairs.
// Workspace at (6272, 256) hidden 1024: z, g, dh as hi/lo pairs 57.8 MB, dz
// 6.4 MB, the dLN2 partials and the second pass's 1024-token partials.
//
// What bounds it at (6272, 256) hidden 1024: the contract's fp32 products,
// 16.4 GFLOP, 0.2454 ms at 67 TFLOP/s; as run, the nine split-bf16 passes
// (h, dg, dz hi/lo here, dW2 2 and dW1 3 in the second pass) are 29.6 GFLOP,
// 0.030 ms at 989 TFLOP/s, and the workspace written once and read once about
// 0.035 ms at 3.35 TB/s.  The erff GELU and its derivative cost issue slots per
// hidden value, which no wgmma overlaps (one consumer warpgroup).  Left on the
// table: a second consumer warpgroup to overlap GELU with the products, z
// and dy streamed by depth above 592, the second pass fused into the first,
// 16-byte stores of g and dh.
#include "mlp_bwd.cuh"
#include "mma.cuh"
#include "reduce.cuh"
#include "reduce_mma.cuh"

namespace vadcl {

constexpr int kBsRows = 64;         // tokens of a work item (wgmma's M)
constexpr int kBsConsumers = 128;   // one consumer warpgroup
constexpr int kBsThreads = kBsConsumers + kWarp;  // and a producer warp
constexpr int kBsMaxStages = 4;     // ring stages the barrier area holds
constexpr int kBsMinC = 16;         // (the route gives C <= 192 to ln_mlp_bwd_mma.cu)
constexpr int kBsHidden = 64;       // the hidden width is a multiple of this
constexpr size_t kBsBarrierBytes = 2 * 8 * kBsMaxStages;

// One instance: dz columns per slab, hidden columns per streamed chunk (kernel
// B's pack: ln_mlp_slab.cu:kMsShapes), and the widest C it takes.
struct BsShape {
  int slab, chunk, max_c;
};
constexpr BsShape kBsShapes[] = {{256, 64, 256}, {128, 16, 592}};
constexpr int kBsShapeCount = sizeof(kBsShapes) / sizeof(kBsShapes[0]);

inline int bs_shape(int C) {
  if (C < kBsMinC || C % 16 != 0) return -1;
  for (int i = 0; i < kBsShapeCount; ++i)
    if (C <= kBsShapes[i].max_c) return i;
  return -1;
}

// A ring stage: W1[:, chunk] (C x HC), then W2[chunk, slab] for every slab.
inline size_t bs_stage_bytes(int C, int inst) {
  const BsShape& sh = kBsShapes[inst];
  const size_t slabs = (C + sh.slab - 1) / sh.slab;
  return sizeof(__nv_bfloat16) * (size_t)sh.chunk * ((size_t)C + slabs * sh.slab);
}

// The barriers, `stages` ring stages, then the round(z) and dy tiles.
inline size_t bs_smem_bytes(int C, int inst, int stages) {
  return kBsBarrierBytes + stages * bs_stage_bytes(C, inst) +
         2 * sizeof(__nv_bfloat16) * kBsRows * (size_t)C;
}

struct BsPlan {
  int inst, stages, slabs, blocks;
  size_t smem;
};

// As many stages as fit, up to kBsMaxStages (two at least); one block per SM
// at most, persistent over the (token tile, slab) items.
inline bool bs_plan(int ntok, int C, int Ch, int sms, BsPlan* p) {
  const int inst = bs_shape(C);
  if (inst < 0 || Ch <= 0 || Ch % kBsHidden != 0 || ntok <= 0) return false;
  p->inst = inst;
  p->slabs = (C + kBsShapes[inst].slab - 1) / kBsShapes[inst].slab;
  p->stages = kBsMaxStages;
  while (p->stages >= 2 && bs_smem_bytes(C, inst, p->stages) > (size_t)kMaxSmemBytes)
    --p->stages;
  if (p->stages < 2) return false;
  const int items = (ntok + kBsRows - 1) / kBsRows * p->slabs;
  p->blocks = items < sms ? items : sms;
  p->smem = bs_smem_bytes(C, inst, p->stages);
  return true;
}

struct BsArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dy;
  const float* ln_s;
  const float* ln_b;
  const __nv_bfloat16* w1p;  // (Ch / HC, C * HC): pack_mlp_slabs
  const __nv_bfloat16* w2p;  // (slabs, Ch / HC, HC * CS)
  const float* b1;
  __nv_bfloat16 *g_hi, *g_lo, *dh_hi, *dh_lo;  // (T, Ch) x 2
  float* dz;                                    // (T, C)
  int ntok, C, Ch, stages;
};

// gelu(h) (gelu_erf's bits) and gelu'(h) (dgelu_erf's) from one erff.
__device__ __forceinline__ void gelu_and_grad(float h, float& g, float& dg) {
  const float cdf = 0.5f * (1.f + erff(h * 0.7071067811865476f));
  g = h * cdf;
  dg = cdf + h * expf(-0.5f * h * h) * 0.3989422804014327f;
}

// CS dz columns a work item, HC hidden columns a ring chunk (kBsShapes).
template <int CS, int HC>
__global__ void __launch_bounds__(kBsThreads, 1) ln_mlp_bwd_slab_kernel(BsArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int HS = HC < 32 ? HC : 32;  // hidden columns taken at a time from a chunk
  static_assert(CS % 32 == 0 && CS <= 256 && HC % HS == 0 && (HS == 16 || HS == 32), "shape");
  extern __shared__ __align__(128) unsigned char sm[];
  const int C = a.C, stages = a.stages;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kBsMaxStages;
  unsigned char* ring = sm + kBsBarrierBytes;
  const int nchunks = a.Ch / HC;
  const int slabs = (C + CS - 1) / CS;
  const uint32_t w1_bytes = (uint32_t)(sizeof(bf16) * (size_t)HC * C);
  constexpr uint32_t kPieceBytes = sizeof(bf16) * HC * CS;
  const uint32_t stage_bytes = w1_bytes + slabs * kPieceBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier

  const int items = (a.ntok + kBsRows - 1) / kBsRows * slabs;

  if (warp == 4) {
    // producer: chunk i of this block's sequence goes to stage i % stages
    if (lane == 0) {
      int i = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        for (int j = 0; j < nchunks; ++j, ++i) {
          const int s = i % stages, use = i / stages;
          if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
          mbar_expect_tx(full + s, stage_bytes);
          unsigned char* dst = ring + (size_t)s * stage_bytes;
          bulk_copy_g2s(dst, a.w1p + (size_t)j * HC * C, w1_bytes, full + s);
          for (int p = 0; p < slabs; ++p)
            bulk_copy_g2s(dst + w1_bytes + (size_t)p * kPieceBytes,
                          a.w2p + ((size_t)p * nchunks + j) * HC * CS, kPieceBytes, full + s);
        }
      }
    }
    return;
  }

  const int wq = warp;  // warp within the consumer warpgroup: rows 16 wq ..
  bf16* zg = reinterpret_cast<bf16*>(ring + (size_t)stages * stage_bytes);  // [C / 8][64][8]
  bf16* dyg = zg + (size_t)kBsRows * C;                                      // the same
  const int g = lane >> 2, t = lane & 3;
  int seq = 0;  // chunks this block has consumed (its ring position)

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / slabs, slab = it % slabs;
    const int row0 = tile * kBsRows + wq * 16;  // this warp's first row
    const bool writes = slab == 0;              // the item that writes g and dh

    // LN2 of the warp's 16 rows into the round(z) tile, dy copied into the dy
    // tile (kernel B's routine: the forward's round(z) bits); rows past the
    // end are zeros
    {
      const int r = lane >> 1, row = row0 + r;
      const bool ok = row < a.ntok;
      warp_ln_16rows(ok ? a.x + (size_t)row * C : nullptr, C, a.ln_s, a.ln_b,
                     reinterpret_cast<uint4*>(zg) + wq * 16 + r, kBsRows, nullptr, lane);
      warp_ln_16rows(ok ? a.dy + (size_t)row * C : nullptr, C, nullptr, nullptr,
                     reinterpret_cast<uint4*>(dyg) + wq * 16 + r, kBsRows, nullptr, lane);
    }
    fence_async_shared();  // wgmma reads both tiles through the asynchronous proxy
    named_barrier(1, kBsConsumers);

    float dz[CS / 32][16];
#pragma unroll
    for (int p = 0; p < CS / 32; ++p)
#pragma unroll
      for (int e = 0; e < 16; ++e) dz[p][e] = 0.f;

    int prev = -1;  // the stage whose release waits for its last dz wgmmas
    for (int j = 0; j < nchunks; ++j, ++seq) {
      const int s = seq % stages;
      mbar_wait(full + s, (uint32_t)((seq / stages) & 1));
      // W1[:, chunk] at element (c, n): ((n / 8) C + c) 8 + n % 8; W2[chunk, slab p]
      // at element (n, c'): piece p + ((c' / 8) HC + n) 8 + c' % 8
      const bf16* w1s = reinterpret_cast<const bf16*>(ring + (size_t)s * stage_bytes);
      const bf16* w2s = w1s + (size_t)HC * C;
#pragma unroll 1
      for (int q = 0; q < HC / HS; ++q) {
        // h = round(z) . W1[:, sub-chunk q]: B N-major, next 8 k rows 128 B on,
        // next 8 columns C * 16 B on; each wgmma its own commit group, the
        // first overwriting h (scale 0)
        float h[HS / 2], dg[HS / 2];
        for (int k0 = 0; k0 < C; k0 += 16) {
          wgmma_fence();
          const uint64_t da = wgmma_desc(zg + (size_t)(k0 / 8) * kBsRows * 8, kBsRows * 16, 128);
          const uint64_t db = wgmma_desc(w1s + ((size_t)(q * HS / 8) * C + k0) * 8, 128, C * 16);
          wgmma_k16_ss(h, da, db, k0 > 0);
          wgmma_commit();
        }
        // dg = dy . W2[sub-chunk q, :]^T: B K-major (n = hidden, k = c) from the
        // slab pieces, next 8 k (c) HC * 16 B on, next 8 n 128 B on
        for (int k0 = 0; k0 < C; k0 += 16) {
          wgmma_fence();
          const uint64_t da = wgmma_desc(dyg + (size_t)(k0 / 8) * kBsRows * 8, kBsRows * 16, 128);
          const int piece = k0 / CS, cp = k0 % CS;
          const uint64_t db = wgmma_desc(
              w2s + (size_t)piece * HC * CS + ((size_t)(cp / 8) * HC + q * HS) * 8, HC * 16, 128);
          wgmma_k16_ss_kb(dg, da, db, k0 > 0);
          wgmma_commit();
        }
        wgmma_wait_all();  // (also the previous sub-chunk's dz, which read its stage)
        if (q == 0) {
          if (prev >= 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + prev);
          }
          prev = s;
        }
        // hb = round(h + b1), g = gelu(hb), dh = dg * gelu'(hb); dh's hi and lo
        // parts as the A fragments of dz's 16-deep steps
        uint32_t ahi[HS / 16][4], alo[HS / 16][4];
#pragma unroll
        for (int nt = 0; nt < HS / 8; ++nt) {
          const int col = j * HC + q * HS + nt * 8 + 2 * t;
          const float2 bb = *reinterpret_cast<const float2*>(a.b1 + col);
          float gv[4], dv[4], hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dgl;
            gelu_and_grad(round_to<bf16>(h[4 * nt + e] + ((e & 1) ? bb.y : bb.x)), gv[e], dgl);
            dv[e] = dg[4 * nt + e] * dgl;
            split_bf16(dv[e], hi[e], lo[e]);
          }
          if (writes) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = row0 + g + 8 * hh;
              if (row < a.ntok) {
                const size_t off = (size_t)row * a.Ch + col;
                store_split2(a.g_hi, a.g_lo, off, gv[2 * hh], gv[2 * hh + 1]);
                *reinterpret_cast<uint32_t*>(a.dh_hi + off) = pack_bf16(hi[2 * hh], hi[2 * hh + 1]);
                *reinterpret_cast<uint32_t*>(a.dh_lo + off) = pack_bf16(lo[2 * hh], lo[2 * hh + 1]);
              }
            }
          }
          ahi[nt >> 1][(nt & 1) * 2] = pack_bf16(hi[0], hi[1]);      // row g
          ahi[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(hi[2], hi[3]);  // row g + 8
          alo[nt >> 1][(nt & 1) * 2] = pack_bf16(lo[0], lo[1]);
          alo[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(lo[2], lo[3]);
        }
        // dz[:, slab] += dh_hi . W1^T + dh_lo . W1^T: B K-major (n = c, k = hidden)
        // from W1's tiles, next 8 k C * 16 B on, next 8 n 128 B on.  Columns at
        // or past C read any tile of the stage and are never stored.
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < HS / 16; ++k2) {
#pragma unroll
          for (int p = 0; p < CS / 32; ++p) {
            const int c0 = slab * CS + 32 * p;
            const uint64_t db = wgmma_desc(
                w1s + ((size_t)((q * HS + 16 * k2) / 8) * C + (c0 < C ? c0 : 0)) * 8, C * 16, 128);
            wgmma_k16_rs_kb(dz[p], ahi[k2], db, 1);
            wgmma_k16_rs_kb(dz[p], alo[k2], db, 1);
          }
        }
        wgmma_commit();  // left in flight: the next sub-chunk's h and dg are issued behind it
      }
    }
    wgmma_wait_all();
    __syncwarp();  // the last chunk's stage, which its dz wgmmas were still reading
    if (lane == 0) mbar_arrive(empty + prev);

    // dz[:, slab] in fp32 to the workspace (columns below C, rows below T)
#pragma unroll
    for (int p = 0; p < CS / 32; ++p) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = slab * CS + p * 32 + i * 8 + 2 * t;
        if (col >= C) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + g + 8 * hh;
          if (row < a.ntok)
            *reinterpret_cast<float2*>(a.dz + (size_t)row * C + col) =
                make_float2(dz[p][4 * i + 2 * hh], dz[p][4 * i + 2 * hh + 1]);
        }
      }
    }
    // the next item's LN2 overwrites the tiles, which the other warps' wgmmas
    // may still read
    named_barrier(1, kBsConsumers);
  }
}

// dx = dy + rstd (dz s - mean(dz s) - xhat mean(dz s xhat)) for kBvRows tokens
// a block (a warp per row for the row sums, then a thread per column over
// the rows in order), the block's dLN2 partials (sum dz xhat, then sum dz),
// and z = xhat s + b as hi/lo bf16 pairs for the second pass's dW1.
constexpr int kBvRows = 32;
constexpr int kBvThreads = 256;

__global__ void __launch_bounds__(kBvThreads)
    ln_mlp_bwd_slab_dx_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ dy,
                              const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                              const float* __restrict__ dz, __nv_bfloat16* __restrict__ dx,
                              __nv_bfloat16* __restrict__ z_hi, __nv_bfloat16* __restrict__ z_lo,
                              float* __restrict__ dln_part, int ntok, int C) {
  __shared__ float st[kBvRows][4];  // mean, rstd, mean(dz s), mean(dz s xhat)
  const int r0 = blockIdx.x * kBvRows;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int r = warp; r < kBvRows; r += kBvThreads / kWarp) {
    const int row = r0 + r;
    if (row >= ntok) break;
    const __nv_bfloat16* xr = x + (size_t)row * C;
    const float* zr = dz + (size_t)row * C;
    float m, rstd;
    warp_ln_stats(xr, C, &m, &rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float d = zr[c] * ln_s[c];
      s1 += d;
      s2 += d * ((__bfloat162float(xr[c]) - m) * rstd);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) st[r][0] = m, st[r][1] = rstd, st[r][2] = s1 / C, st[r][3] = s2 / C;
  }
  __syncthreads();
  const int rows = min(kBvRows, ntok - r0);
  for (int c = threadIdx.x; c < C; c += kBvThreads) {
    const float sc = ln_s[c], sb = ln_b[c];
    float cx = 0.f, cz = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t off = (size_t)(r0 + r) * C + c;
      const float xh = (__bfloat162float(x[off]) - st[r][0]) * st[r][1];
      const float d = dz[off];
      dx[off] = __float2bfloat16(__bfloat162float(dy[off]) +
                                 st[r][1] * (d * sc - st[r][2] - xh * st[r][3]));
      float hi, lo;
      split_bf16(xh * sc + sb, hi, lo);
      z_hi[off] = __float2bfloat16(hi);
      z_lo[off] = __float2bfloat16(lo);
      cx += d * xh;
      cz += d;
    }
    dln_part[(size_t)blockIdx.x * 2 * C + c] = cx;
    dln_part[(size_t)blockIdx.x * 2 * C + C + c] = cz;
  }
}

struct BsWorkspace {
  size_t zh, zl, gh, gl, dhh, dhl, dz, dln, atb, bytes;
};

inline BsWorkspace bs_workspace(int ntok, int C, int Ch) {
  const size_t T = ntok, bf = 2, blocks = (ntok + kBvRows - 1) / kBvRows;
  const size_t atb = atb_mma_partial_floats(ntok, Ch, C) > atb_mma_partial_floats(ntok, C, Ch)
                         ? atb_mma_partial_floats(ntok, Ch, C)
                         : atb_mma_partial_floats(ntok, C, Ch);
  BsWorkspace l;
  size_t o = 0;
  l.zh = o;  o = align256(o + bf * T * C);
  l.zl = o;  o = align256(o + bf * T * C);
  l.gh = o;  o = align256(o + bf * T * Ch);
  l.gl = o;  o = align256(o + bf * T * Ch);
  l.dhh = o; o = align256(o + bf * T * Ch);
  l.dhl = o; o = align256(o + bf * T * Ch);
  l.dz = o;  o = align256(o + sizeof(float) * T * C);
  l.dln = o; o = align256(o + sizeof(float) * blocks * 2 * C);
  l.atb = o; o = align256(o + sizeof(float) * atb);
  l.bytes = o;
  return l;
}

}  // namespace vadcl

extern "C" {

// The instance a width takes (an index of kBsShapes), -1 where none does.
int vadcl_ln_mlp_bwd_slab_shape(int C) { return vadcl::bs_shape(C); }

// Shared memory of one block of the instance at C with `stages` ring stages.
long long vadcl_ln_mlp_bwd_slab_smem_bytes(int C, int stages) {
  const int i = vadcl::bs_shape(C);
  return i < 0 ? -1 : (long long)vadcl::bs_smem_bytes(C, i, stages);
}

long long vadcl_ln_mlp_bwd_slab_workspace_bytes(int ntok, int C, int Ch) {
  return (long long)vadcl::bs_workspace(ntok, C, Ch).bytes;
}

// x, dy (T, C) bf16; w1p, w2p: ops/ln_mlp.py:pack_mlp_slabs of (w1, w2) for the
// width's instance; the gradients fp32 except dx (bf16).
int vadcl_ln_mlp_bwd_slab(const void* x, const void* dy, const float* ln_s, const float* ln_b,
                          const void* w1p, const void* w2p, const float* b1, void* dx,
                          float* dls, float* dlb, float* dw1, float* db1, float* dw2, float* db2,
                          void* workspace, int ntok, int C, int Ch, void* stream) {
  using namespace vadcl;
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BsPlan p;
  if (!bs_plan(ntok, C, Ch, sm_count(), &p)) return cudaErrorInvalidValue;
  const BsWorkspace l = bs_workspace(ntok, C, Ch);
  char* ws = static_cast<char*>(workspace);
  auto at = [&](size_t off) { return reinterpret_cast<bf16*>(ws + off); };
  float* dz = reinterpret_cast<float*>(ws + l.dz);
  float* dln = reinterpret_cast<float*>(ws + l.dln);
  float* part = reinterpret_cast<float*>(ws + l.atb);
  const BsArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(dy), ln_s, ln_b,
                 static_cast<const bf16*>(w1p), static_cast<const bf16*>(w2p), b1,
                 at(l.gh), at(l.gl), at(l.dhh), at(l.dhl), dz, ntok, C, Ch, p.stages};
  using Kernel = void (*)(BsArgs);
  static const Kernel kernels[kBsShapeCount] = {
      ln_mlp_bwd_slab_kernel<kBsShapes[0].slab, kBsShapes[0].chunk>,
      ln_mlp_bwd_slab_kernel<kBsShapes[1].slab, kBsShapes[1].chunk>};
  const Kernel kernel = kernels[p.inst];
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, kBsThreads, p.smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int vblocks = (ntok + kBvRows - 1) / kBvRows;
  ln_mlp_bwd_slab_dx_kernel<<<vblocks, kBvThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), ln_s, ln_b, dz,
      static_cast<bf16*>(dx), at(l.zh), at(l.zl), dln, ntok, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the second pass: dW2 = g^T . dy (+ db2 = colsum dy), dW1 = z^T . dh (+ db1 = colsum dh)
  if ((err = launch_atb_mma(a.g_hi, a.g_lo, a.dy, nullptr, ntok, Ch, C, part, dw2, db2, s)))
    return err;
  if ((err = launch_atb_mma(at(l.zh), at(l.zl), a.dh_hi, a.dh_lo, ntok, C, Ch, part, dw1, db1, s)))
    return err;
  if ((err = launch_sum_rows(dln, dls, vblocks, C, 2 * C, s))) return err;
  return launch_sum_rows(dln + C, dlb, vblocks, C, 2 * C, s);
}

}  // extern "C"
