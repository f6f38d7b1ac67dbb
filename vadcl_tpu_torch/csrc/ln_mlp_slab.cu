// Kernel B's tensor-core body above C = 192 (bf16): y = x + fc2(gelu(fc1(LN2(x))))
// over (T, C) tokens.
//
// Replaces vadcl_tpu/ops/pallas_mlp.py:_fwd_kernel (entry fused_ln_mlp) at the
// widths ln_mlp.cu's wgmma body does not hold: C % 16 == 0, 192 < C <= 1024,
// a hidden width divisible by 64 (ops/ln_mlp.py:mlp_fwd_body picks it;
// ln_mlp_slab counts it).  It runs any C % 16 == 0 from 16 (ln_mlp_slab
// forces it), so that it can be timed beside the wgmma body at C <= 192.
// The cast boundaries are _fwd_kernel's and the wgmma body's: z, h and g
// round to bf16, fc2's sum, b2 and the residual are fp32, GELU is erff.
//
// What held the wgmma body at C <= 192: its 64 x C fp32 fc2 accumulator sits in
// one consumer warpgroup's registers (C / 2 a thread: 448 at C = 896), C is a
// template parameter, and its z tile, raw-x rows and two-stage ring of
// 64-column weight chunks outgrow 227 KB above C ~ 600.  A 64-token tile at
// C = 896 has 57,344 fp32 accumulators, most of the SM's 65,536 registers, so
// no split of fc2's columns over the warpgroups of one block holds them.
//
// Design: the output columns are cut into slabs of CS columns (a template
// parameter, not C), and a block's unit of work is (64 or 128 tokens, one
// slab).  It recomputes LN2 and the whole of fc1 for its tokens, and runs fc2
// for its slab's columns only, so its accumulator is 64 x CS a warpgroup
// (CS / 2 registers a thread, 128 at CS = 256) whatever C is.  C runs at run
// time: fc1's depth loop is a loop over C / 16 wgmmas on one accumulator,
// which the compiler keeps asynchronous (a branch around a wgmma, an
// accumulator indexed at run time, or one written by ordinary instructions
// while a wgmma is in flight would serialise them).
//   * The instance table kMsShapes (mirrored by ops/ln_mlp.py:MLP_SLAB_SHAPES)
//     has CS = 256 with 64-column hidden chunks up to C = 256 (one slab: no
//     work is repeated, the Swin-B width's inner stages), and CS = 128 with
//     16-column chunks up to C = 1024 (C / 128 slabs, fc1 repeated once per
//     slab: a 64 x C z tile and two stages of (C x 16 of W1, 16 x 128 of W2)
//     fit 227 KB at C = 1024).  Above 1024, and at C % 16 != 0, the CUDA-core
//     body of ln_mlp.cu runs.
//   * The weights are packed once per parameter version
//     (ops/ln_mlp.py:pack_mlp_slabs): W1 by hidden chunk (C x HC in wgmma's
//     N-major core-matrix layout) and W2 by (slab, chunk) (HC x CS, the columns
//     past C zero), so each chunk is two contiguous cp.async.bulk copies onto
//     one mbarrier.  A producer warpgroup (registers given up by setmaxnreg)
//     keeps a ring of up to four stages in flight; consumer warps hand a stage
//     back on its "empty" mbarrier once the wgmmas that read it completed.
//   * A block is one or two consumer warpgroups (64 tokens each, the same slab;
//     one where two would leave SMs without work or two z tiles do not fit),
//     persistent over the (token tile, slab) items.  A consumer warp
//     normalises 16 tokens into the warpgroup's K-major z tile; per chunk the
//     warpgroup runs fc1 as C / 16 wgmma.m64nHCk16 from shared memory, adds
//     b1, rounds, applies GELU, rounds, and feeds the pairs back as the
//     register A operand of fc2 (CS / 32 wgmma.m64n32k16 a k step), left in
//     flight behind the next chunk's fc1.  The epilogue adds b2 and the
//     residual in fp32, reading x and writing y four bytes a lane (the z tile
//     holds no raw rows: at C = 1024 it alone is 128 KB).
// What bounds it: 4 T C H flops over 989 TFLOP/s, times (1 + slabs) / 2 for
// fc1's repeats at CS = 128; the erff GELU's issue slots (T H of them, ~40
// instructions each) beside them; and the W1 and W2 chunks streamed from L2
// once per work item (2 C H bytes per 64 or 128 tokens).  Left on the table:
// one fc1 shared by several slabs' warpgroups where their accumulators fit, a
// cheaper erf, TMA multicast of the chunks across a cluster.
#include "mlp_tail.cuh"
#include "mma.cuh"

namespace vadcl {

constexpr int kMsWgThreads = 128;  // a warpgroup
constexpr int kMsRows = 64;        // tokens of a consumer warpgroup (wgmma's M)
constexpr int kMsGroups = 2;       // consumer warpgroups of a full block
constexpr int kMsMaxStages = 4;    // ring stages the barrier area holds
constexpr int kMsMinC = 16;        // (the route gives C <= 192 to ln_mlp.cu's wgmma body)
constexpr int kMsHidden = 64;      // the hidden width is a multiple of this

// One instance: output columns per slab, hidden columns per streamed chunk,
// and the widest C it takes.
struct MsShape {
  int slab, chunk, max_c;
};
constexpr MsShape kMsShapes[] = {{256, 64, 256}, {128, 16, 1024}};
constexpr int kMsShapeCount = sizeof(kMsShapes) / sizeof(kMsShapes[0]);

// The instance a width takes, else -1.
inline int ms_shape(int C) {
  if (C < kMsMinC || C % 16 != 0) return -1;
  for (int i = 0; i < kMsShapeCount; ++i)
    if (C <= kMsShapes[i].max_c) return i;
  return -1;
}

// A ring stage: W1[:, chunk] (C x HC) then W2[chunk, slab] (HC x CS).
__host__ __device__ inline size_t ms_stage_bytes(int c, int slab, int chunk) {
  return sizeof(__nv_bfloat16) * (size_t)chunk * ((size_t)c + slab);
}
// A consumer warpgroup's z tile (64 x C, K-major).
__host__ __device__ inline size_t ms_group_bytes(int c) {
  return sizeof(__nv_bfloat16) * kMsRows * (size_t)c;
}
constexpr size_t kMsBarrierBytes = 2 * 8 * kMsMaxStages;

inline size_t ms_smem_bytes(int c, int inst, int groups, int stages) {
  const MsShape& sh = kMsShapes[inst];
  return kMsBarrierBytes + groups * ms_group_bytes(c) +
         stages * ms_stage_bytes(c, sh.slab, sh.chunk);
}

struct MsPlan {
  int inst, groups, stages, slabs, blocks;
  size_t smem;
};

// Two consumer warpgroups unless the work items would then leave SMs idle or
// two z tiles leave no room for a two-stage ring; as many stages as fit, up
// to kMsMaxStages; one block per SM at most.
inline bool ms_plan(int ntok, int C, int Ch, int sms, MsPlan* p) {
  const int inst = ms_shape(C);
  if (inst < 0 || Ch <= 0 || Ch % kMsHidden != 0 || ntok <= 0) return false;
  const MsShape& sh = kMsShapes[inst];
  p->inst = inst;
  p->slabs = (C + sh.slab - 1) / sh.slab;
  for (int groups = kMsGroups; groups >= 1; --groups) {
    const int items = (ntok + kMsRows * groups - 1) / (kMsRows * groups) * p->slabs;
    if (groups > 1 && items < sms) continue;
    int stages = kMsMaxStages;
    while (stages >= 2 && ms_smem_bytes(C, inst, groups, stages) > (size_t)kMaxSmemBytes)
      --stages;
    if (stages < 2) continue;
    p->groups = groups;
    p->stages = stages;
    p->blocks = items < sms ? items : sms;
    p->smem = ms_smem_bytes(C, inst, groups, stages);
    return true;
  }
  return false;
}

// CS output columns a work item, HC hidden columns a chunk (kMsShapes).
template <int CS, int HC>
__global__ void __launch_bounds__((kMsGroups + 1) * kMsWgThreads, 1)
    ln_mlp_slab_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_s,
                       const float* __restrict__ ln_b, const __nv_bfloat16* __restrict__ w1p,
                       const __nv_bfloat16* __restrict__ w2p, const float* __restrict__ b1,
                       const float* __restrict__ b2, __nv_bfloat16* __restrict__ y, int ntok,
                       int C, int Ch, int stages) {
  using bf16 = __nv_bfloat16;
  static_assert(CS % 32 == 0 && CS <= 256 && (HC == 16 || HC == 64), "shape");
  extern __shared__ __align__(128) unsigned char sm[];
  const int ngroups = blockDim.x / kMsWgThreads - 1;  // consumer warpgroups; the last produces
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kMsMaxStages;
  unsigned char* ring = sm + kMsBarrierBytes;
  const int nchunks = Ch / HC;
  const int slabs = (C + CS - 1) / CS;
  const uint32_t w1_bytes = (uint32_t)(sizeof(bf16) * (size_t)HC * C);
  constexpr uint32_t kW2Bytes = sizeof(bf16) * HC * CS;
  const size_t stage_bytes = (size_t)w1_bytes + kW2Bytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * ngroups);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier

  const int tile_rows = kMsRows * ngroups;
  const int items = (ntok + tile_rows - 1) / tile_rows * slabs;

  if (warp >= 4 * ngroups) {
    set_max_registers_dec<24>();
    // producer: chunk i of this block's sequence goes to stage i % stages
    if (warp == 4 * ngroups && lane == 0) {
      int i = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int slab = it % slabs;
        for (int j = 0; j < nchunks; ++j, ++i) {
          const int s = i % stages, use = i / stages;
          if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
          mbar_expect_tx(full + s, (uint32_t)stage_bytes);
          unsigned char* dst = ring + (size_t)s * stage_bytes;
          bulk_copy_g2s(dst, w1p + (size_t)j * HC * C, w1_bytes, full + s);
          bulk_copy_g2s(dst + w1_bytes, w2p + ((size_t)slab * nchunks + j) * HC * CS, kW2Bytes,
                        full + s);
        }
      }
    }
    return;
  }

  set_max_registers_inc<240>();
  const int wg = warp / 4, wq = warp % 4;  // warpgroup, warp within it (rows 16 wq ..)
  bf16* zg = reinterpret_cast<bf16*>(ring + (size_t)stages * stage_bytes +
                                     (size_t)wg * ms_group_bytes(C));  // [C / 8][64][8]
  const int g = lane >> 2, t = lane & 3;
  int seq = 0;  // chunks this block has consumed (its ring position)

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / slabs, slab = it % slabs;
    const int row0 = tile * tile_rows + wg * kMsRows + wq * 16;  // this warp's first row

    // LN2 of this warp's 16 tokens into the warpgroup's z tile (rows past the
    // end are zeros: a warpgroup past the end multiplies zero rows, no branch
    // around a wgmma)
    {
      const int r = lane >> 1;
      warp_ln_16rows(row0 + r < ntok ? x + (size_t)(row0 + r) * C : nullptr, C, ln_s, ln_b,
                     reinterpret_cast<uint4*>(zg) + wq * 16 + r, kMsRows, nullptr, lane);
    }
    fence_async_shared();  // wgmma reads z through the asynchronous proxy
    named_barrier(1 + wg, kMsWgThreads);

    float acc[CS / 32][16];
#pragma unroll
    for (int p = 0; p < CS / 32; ++p)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[p][e] = 0.f;

    int prev = -1;  // the stage whose release waits for its fc2 to complete
    for (int j = 0; j < nchunks; ++j, ++seq) {
      const int s = seq % stages;
      mbar_wait(full + s, (uint32_t)((seq / stages) & 1));
      const bf16* w1s = reinterpret_cast<const bf16*>(ring + (size_t)s * stage_bytes);
      const bf16* w2s = w1s + (size_t)HC * C;
      // fc1: h (64 x HC) = z . W1[:, chunk], one wgmma per 16 of C, each its own
      // commit group.  The first overwrites h (scale 0): registers zeroed
      // while the previous chunk's fc2 is in flight would make the compiler
      // serialise every wgmma of the kernel (ptxas C7515).
      float h[HC / 2];
      for (int k0 = 0; k0 < C; k0 += 16) {
        wgmma_fence();
        // A: k-chunks k0/8, k0/8 + 1 of z (1024 B apart), 8-row groups 128 B apart
        const uint64_t da = wgmma_desc(zg + (size_t)(k0 / 8) * kMsRows * 8, kMsRows * 16, 128);
        // B: rows k0.. of the chunk; next 8 rows 128 B on, next 8 columns C * 16 B on
        const uint64_t db = wgmma_desc(w1s + (size_t)k0 * 8, 128, C * 16);
        wgmma_k16_ss(h, da, db, k0 > 0);
        wgmma_commit();
      }
      wgmma_wait_all();  // (also the previous chunk's fc2, which read its stage)
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + prev);
      }
      prev = s;
      // + b1 -> bf16 -> exact GELU -> bf16, packed as fc2's A fragments
      uint32_t ga[HC / 16][4];
#pragma unroll
      for (int nt = 0; nt < HC / 8; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(b1 + j * HC + nt * 8 + 2 * t);
        const float g0 = gelu_erf(round_to<bf16>(h[4 * nt] + bb.x));
        const float g1 = gelu_erf(round_to<bf16>(h[4 * nt + 1] + bb.y));
        const float g2 = gelu_erf(round_to<bf16>(h[4 * nt + 2] + bb.x));
        const float g3 = gelu_erf(round_to<bf16>(h[4 * nt + 3] + bb.y));
        ga[nt >> 1][(nt & 1) * 2] = pack_bf16(g0, g1);      // row g
        ga[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(g2, g3);  // row g + 8
      }
      // fc2: acc (64 x CS) += g . W2[chunk, slab], 32 output columns a wgmma
      wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < HC / 16; ++k2) {
#pragma unroll
        for (int p = 0; p < CS / 32; ++p) {
          // B: rows 16 k2.. of the chunk, columns 32 p..; next 8 rows 128 B on,
          // next 8 columns HC * 16 B on
          const uint64_t db =
              wgmma_desc(w2s + ((size_t)(4 * p) * HC + 16 * k2) * 8, 128, HC * 16);
          wgmma_k16_rs(acc[p], ga[k2], db, 1);
        }
      }
      wgmma_commit();  // left in flight: the next chunk's fc1 is issued behind it
    }
    wgmma_wait_all();
    __syncwarp();  // the last chunk's stage, which its fc2 was still reading
    if (lane == 0) mbar_arrive(empty + prev);

    // y = x + (acc + b2) in fp32 over the slab's columns below C
    const int col0 = slab * CS;
#pragma unroll
    for (int p = 0; p < CS / 32; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = col0 + p * 32 + q * 8 + 2 * t;
        if (col < C) {
          const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + g + 8 * hh;
            if (row < ntok) {
              const size_t off = (size_t)row * C + col;
              const float2 xf = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + off));
              *reinterpret_cast<uint32_t*>(y + off) =
                  pack_bf16(xf.x + (acc[p][4 * q + 2 * hh] + bb.x),
                            xf.y + (acc[p][4 * q + 2 * hh + 1] + bb.y));
            }
          }
        }
      }
    }
    // the next item's LN2 overwrites z, which the other warps' fc1 may still read
    named_barrier(1 + wg, kMsWgThreads);
  }
}

cudaError_t launch_ln_mlp_slab(const void* x, const float* ln_s, const float* ln_b,
                               const void* w1p, const void* w2p, const float* b1,
                               const float* b2, void* y, int ntok, int C, int Ch,
                               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  MsPlan p;
  if (!ms_plan(ntok, C, Ch, sm_count(), &p)) return cudaErrorInvalidValue;
  using Kernel = void (*)(const bf16*, const float*, const float*, const bf16*, const bf16*,
                          const float*, const float*, bf16*, int, int, int, int);
  static const Kernel kernels[kMsShapeCount] = {
      ln_mlp_slab_kernel<kMsShapes[0].slab, kMsShapes[0].chunk>,
      ln_mlp_slab_kernel<kMsShapes[1].slab, kMsShapes[1].chunk>};
  const Kernel kernel = kernels[p.inst];
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, (p.groups + 1) * kMsWgThreads, p.smem, stream>>>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w1p),
      static_cast<const bf16*>(w2p), b1, b2, static_cast<bf16*>(y), ntok, C, Ch, p.stages);
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

// The instance a width takes (an index of kMsShapes), -1 where none does.
int vadcl_ln_mlp_slab_shape(int C) { return vadcl::ms_shape(C); }

// Shared memory of one block of the instance at C with `groups` consumer
// warpgroups and `stages` ring stages.
long long vadcl_ln_mlp_slab_smem_bytes(int C, int groups, int stages) {
  const int i = vadcl::ms_shape(C);
  return i < 0 ? -1 : (long long)vadcl::ms_smem_bytes(C, i, groups, stages);
}

// bf16; w1p (Ch / HC, C * HC) and w2p (slabs, Ch / HC, HC * CS) packed by
// ops/ln_mlp.py:pack_mlp_slabs for the width's instance.
int vadcl_ln_mlp_slab(const void* x, const float* ln_s, const float* ln_b, const void* w1p,
                      const void* w2p, const float* b1, const float* b2, void* y, int ntok,
                      int C, int Ch, void* stream) {
  return vadcl::launch_ln_mlp_slab(x, ln_s, ln_b, w1p, w2p, b1, b2, y, ntok, C, Ch,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
