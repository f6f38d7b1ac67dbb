// Fused Swin block tail:  y = x + fc2(gelu(fc1(LN2(x))))  over (T, C) tokens.
//
// Replaces vadcl_tpu/ops/pallas_mlp.py:_fwd_kernel (entry fused_ln_mlp).
//
// LN2 runs in fp32 (flax fast variance); the hidden width is walked in chunks
// of columns: h = z . W1[:, chunk] + b1 -> round to the compute dtype ->
// exact-erf GELU -> round -> accumulate g . W2[chunk, :] into an fp32
// (tokens x C) tile.  The hidden activation never reaches device memory.
// Cast boundaries are those of _fwd_kernel: z, h and g round to the compute
// dtype; the fc2 sum, b2 and the residual add are fp32.  GELU uses CUDA's erff
// (exact to ~2 ulp) where the Pallas kernel uses the Abramowitz-Stegun 7.1.26
// form (1.5e-7 abs error).
//
// Three bodies, picked by width (ops/ln_mlp.py:mlp_fwd_body).
//
// bf16 at C % 16 == 0, C <= 192 and a hidden width divisible by 128 (every
// preset's widths): ln_mlp_wgmma_kernel, a
// persistent grid of at most one block per SM.  A block is two consumer
// warpgroups (64 tokens each; one where the token count would leave SMs
// without a block) and a producer warpgroup, and no block-wide barrier after
// set-up:
//   * The weights come packed by hidden chunk (ops/ln_mlp.py:pack_mlp_weights:
//     chunk j is W1[:, 64j:64j+64] then W2[64j:64j+64, :], each in the N-major
//     core-matrix layout wgmma reads its B operand in), so one chunk is one
//     contiguous cp.async.bulk copy and needs no re-layout on the card.  The
//     producer's first lane keeps a ring of chunks in flight; a copy completes
//     on the stage's "full" mbarrier, and the consumer warps hand a stage back
//     on its "empty" mbarrier once the wgmmas that read it have completed.
//     Where the whole packed pair fits beside the token tiles (C <= 96: 147
//     KB) the ring has one stage per chunk and is filled once per block, not
//     once per token tile.  At C = 192 (590 KB) the ring has two stages of 49
//     KB and the chunks are streamed again from L2 for every token tile, the
//     next chunk in flight while this one is multiplied: re-streaming was
//     taken over "chunk outermost, several token tiles in flight" because the
//     fc2 accumulator of a second token tile (96 more registers a thread)
//     does not fit beside the first.
//   * A consumer warp normalises 16 tokens (lanes in pairs per row, 16-byte
//     loads, all of a tile's loads in flight together) into the warpgroup's z
//     tile, stored in wgmma's K-major core-matrix layout, and keeps the raw
//     rows for the residual.  Per chunk the warpgroup runs fc1 as C/16
//     wgmma.m64n64k16 (A = z and B = the W1 slice through shared-memory
//     descriptors) into a 64 x 64 fp32 accumulator in registers, adds b1,
//     rounds, applies GELU and rounds there, and feeds the packed pairs
//     straight back as the register A operand of fc2 (the accumulator layout
//     of two neighbouring 8-column tiles is the A layout of one k-step, see
//     mma.cuh): 4 x C/32 wgmma.m64n32k16 (m64n16k16 where C is a multiple of 16
//     but not of 32) into the 64 x C fp32 accumulator that stays in registers
//     across chunks.  fc2 is left in flight behind the next
//     chunk's fc1; the hidden activation never touches shared memory.  The
//     epilogue adds b2 and the residual in fp32 in the warp's x rows and
//     writes them out 16 bytes per lane.  One named barrier per warpgroup after
//     LN2 and one at the end of a tile; the two warpgroups run independently,
//     so one's LN2 or GELU overlaps the other's products.
//   * The producer warpgroup gives its registers up (setmaxnreg) so that the
//     consumers can hold 232 each.  C is a template parameter (16 .. 192 in
//     steps of 16): a wgmma inside a data-dependent branch is serialised by
//     the compiler.  The last tile's missing rows are zero rows, masked at the
//     store.
// It needs C % 16 == 0, C <= 192 and the hidden width a multiple of 64 (the
// wrapper asks for 128, the whole-block kernel's chunk).
// What bounds it: the erff GELU, 4C per token at ~40 issue slots each on eight
// warps per SM, costs more issue time than the products cost tensor-core time;
// at C = 192 the two-round grid (196 tiles of 128 tokens on 132 SMs at batch
// 16) leaves a quarter of the card idle in the second round.  Left on the
// table: a cheaper erf of the same accuracy, 64-token tiles with two blocks per
// SM at C = 192, TMA multicast of the weight chunks across a cluster.
//
// bf16 at C % 16 == 0, 192 < C <= 1024 and a hidden width divisible by 64:
// ln_mlp_slab.cu's tensor-core body (output columns in slabs across blocks).
//
// fp32 (the path the model's exact comparisons run) and bf16 at every other
// width (C % 16 != 0, C above 1024): ln_mlp_kernel<T>, CUDA-core loops in fp32
// on T loads and stores, one block per token tile of 32 tokens, or of 16, 8,
// ... 1 where 32 tokens' fp32 rows outgrow 227 KB (C above 844;
// mlp_tokens), so that it takes every width up to C = 28,992 (the card has
// run it up to C = 4,096, 4 tokens a block; the 2- and 1-token tiles above
// C = 7,200 have not run there); z, h and g
// rounded to T (the sums' order does not depend on the tile).  Its chunk
// loop lives in mlp_tail.cuh, which the whole-Swin-block kernel
// (fold_attn.cuh) shares (its fp32 instance) together with the WMMA tail that
// kernel still runs.  What bounds it: every product on the fp32 units, and
// both weight matrices re-read from L2 by every block of 32 tokens.
#include "mlp_tail.cuh"
#include "mma.cuh"

namespace vadcl {

constexpr int kMlpThreads = 256;
constexpr int kTokens = 32;  // tokens of a block where they fit

inline size_t mlp_smem_bytes(int c, int tokens) {
  return sizeof(float) * (2 * (size_t)tokens * c + (size_t)tokens * kMlpChunk);
}

// Tokens a block holds: the most of 32, 16, ..., 1 whose block fits 227 KB
// (0 above C = 28,992).
inline int mlp_tokens(int c) {
  for (int t = kTokens; t >= 1; t /= 2)
    if (mlp_smem_bytes(c, t) <= (size_t)kMaxSmemBytes) return t;
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kMlpThreads)
    ln_mlp_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, T* __restrict__ y, int ntok, int C, int Ch,
                  int tokens) {
  extern __shared__ __align__(16) float smem[];
  float* z = smem;                 // tokens*C   LN output
  float* acc = z + tokens * C;     // tokens*C   fc2 accumulator
  float* g = acc + tokens * C;     // tokens*kMlpChunk  GELU chunk

  const int t0 = blockIdx.x * tokens;
  const int nt = min(tokens, ntok - t0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp, nwarps = nthr / kWarp;

  for (int t = warp; t < nt; t += nwarps) {
    const T* xt = x + (size_t)(t0 + t) * C;
    float mu, rstd;
    warp_ln_stats(xt, C, &mu, &rstd);
    for (int c = lane; c < C; c += kWarp)
      z[t * C + c] = round_to<T>((to_f(xt[c]) - mu) * rstd * ln_s[c] + ln_b[c]);
  }
  mlp_chunks_f32(z, acc, g, w1, b1, w2, nt, C, Ch);

  for (int idx = tid; idx < nt * C; idx += nthr) {
    const int t = idx / C, c = idx % C;
    const size_t off = (size_t)(t0 + t) * C + c;
    y[off] = from_f<T>(to_f(x[off]) + (acc[idx] + b2[c]));
  }
}

// The CUDA-core body in either dtype (is_bf16: __nv_bfloat16 x, weights and
// y; weights as they are, not packed).
cudaError_t launch_ln_mlp(const void* x, const float* ln_s, const float* ln_b,
                          const void* w1, const float* b1, const void* w2,
                          const float* b2, void* y, int ntok, int C, int Ch, int is_bf16,
                          cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int tokens = mlp_tokens(C);
  if (tokens == 0 || ntok <= 0) return cudaErrorInvalidValue;
  const size_t smem = mlp_smem_bytes(C, tokens);
  const int blocks = (ntok + tokens - 1) / tokens;
  cudaError_t err;
  if (is_bf16) {
    if ((err = allow_smem(ln_mlp_kernel<bf16>, smem)) != cudaSuccess) return err;
    ln_mlp_kernel<bf16><<<blocks, kMlpThreads, smem, stream>>>(
        static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w1), b1,
        static_cast<const bf16*>(w2), b2, static_cast<bf16*>(y), ntok, C, Ch, tokens);
  } else {
    if ((err = allow_smem(ln_mlp_kernel<float>, smem)) != cudaSuccess) return err;
    ln_mlp_kernel<float><<<blocks, kMlpThreads, smem, stream>>>(
        static_cast<const float*>(x), ln_s, ln_b, static_cast<const float*>(w1), b1,
        static_cast<const float*>(w2), b2, static_cast<float*>(y), ntok, C, Ch, tokens);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma with the hidden activation in registers and
// the packed weights streamed through an mbarrier ring (see the header).
// ---------------------------------------------------------------------------
constexpr int kMmaChunk = 64;      // hidden columns per packed chunk
constexpr int kMmaPad = 8;         // elements of padding per row of the raw-x rows
constexpr int kMmaGroups = 2;      // consumer warpgroups of a full block (64 tokens each)
constexpr int kMmaMaxStages = 16;  // ring stages the barrier area holds
constexpr int kMmaMaxC = 192;
constexpr int kWgThreads = 128;    // a warpgroup
constexpr int kWgRows = 64;        // tokens per warpgroup tile (wgmma's M)

inline bool mlp_mma_eligible(int c, int ch) {
  return c > 0 && c % 16 == 0 && c <= kMmaMaxC && ch > 0 && ch % kMmaChunk == 0;
}

// One packed chunk: W1[:, chunk] (C x 64) then W2[chunk, :] (64 x C), both in
// wgmma's N-major layout ([n / 8][k][n % 8]).
__host__ __device__ inline size_t mlp_chunk_bytes(int c) {
  return sizeof(__nv_bfloat16) * 2 * (size_t)c * kMmaChunk;
}

// A consumer warpgroup's tiles: z = LN2(x) (64 x C in wgmma's K-major layout)
// and the raw x rows kept for the residual (64 x (C + 8), row-major).
__host__ __device__ inline size_t mlp_group_bytes(int c) {
  return sizeof(__nv_bfloat16) * kWgRows * ((size_t)c + (size_t)(c + kMmaPad));
}

constexpr size_t kMlpBarrierBytes = 2 * 8 * kMmaMaxStages;

struct MlpPlan {
  int groups, stages, persistent, blocks;
  size_t smem;
};

// Consumer warpgroups per block (one where two would leave SMs without a
// block), ring stages (as many chunks as fit, all of them where the packed
// matrices fit whole), grid.
inline MlpPlan mlp_plan(int ntok, int c, int ch, int sms) {
  MlpPlan p;
  p.groups = kMmaGroups;
  if ((ntok + kWgRows * p.groups - 1) / (kWgRows * p.groups) < sms) p.groups = 1;
  const int nchunks = ch / kMmaChunk;
  const size_t fixed = kMlpBarrierBytes + p.groups * mlp_group_bytes(c);
  const size_t room = (size_t)kMaxSmemBytes > fixed ? (size_t)kMaxSmemBytes - fixed : 0;
  int stages = (int)(room / mlp_chunk_bytes(c));
  if (stages > nchunks) stages = nchunks;
  if (stages > kMmaMaxStages) stages = kMmaMaxStages;
  p.stages = stages;
  p.persistent = stages == nchunks;
  const int tiles = (ntok + kWgRows * p.groups - 1) / (kWgRows * p.groups);
  p.blocks = tiles < sms ? tiles : sms;
  p.smem = fixed + (size_t)stages * mlp_chunk_bytes(c);
  return p;
}

// C is a template parameter (a multiple of 16): every wgmma then sits in
// straight-line code, which the compiler needs to leave them asynchronous.
template <int C>
__global__ void __launch_bounds__((kMmaGroups + 1) * kWgThreads, 1)
    ln_mlp_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, const __nv_bfloat16* __restrict__ wpack,
                        const float* __restrict__ b1, const float* __restrict__ b2,
                        __nv_bfloat16* __restrict__ y, int ntok, int Ch, int stages,
                        int persistent) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char sm[];
  const int ngroups = blockDim.x / kWgThreads - 1;  // consumer warpgroups; the last produces
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kMmaMaxStages;
  unsigned char* ring = sm + kMlpBarrierBytes;
  const int nchunks = Ch / kMmaChunk;
  const uint32_t chunk_bytes = (uint32_t)mlp_chunk_bytes(C);
  const int ld = C + kMmaPad;
  constexpr int kN2 = C % 32 == 0 ? 32 : 16;  // output columns per fc2 wgmma

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * ngroups);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier

  const int tile_rows = kWgRows * ngroups;
  const int ntiles = (ntok + tile_rows - 1) / tile_rows;
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (warp >= 4 * ngroups) {
    // the producer warpgroup hands its registers to the consumers (a block of
    // 384 threads starts with 168 each; fc2's 64 x 192 accumulator alone is 96)
    set_max_registers_dec<40>();
    // producer: chunk i of this block's sequence goes to stage i % stages
    if (warp == 4 * ngroups && lane == 0) {
      const int total = persistent ? nchunks : my_tiles * nchunks;
      for (int i = 0; i < total; ++i) {
        const int s = i % stages, use = i / stages;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        mbar_expect_tx(full + s, chunk_bytes);
        bulk_copy_g2s(ring + (size_t)s * chunk_bytes,
                      reinterpret_cast<const unsigned char*>(wpack) +
                          (size_t)(i % nchunks) * chunk_bytes,
                      chunk_bytes, full + s);
      }
    }
    return;
  }

  set_max_registers_inc<232>();
  const int wg = warp / 4, wq = warp % 4;  // warpgroup, warp within it (rows 16 wq ..)
  unsigned char* gbase = ring + (size_t)stages * chunk_bytes + (size_t)wg * mlp_group_bytes(C);
  bf16* zg = reinterpret_cast<bf16*>(gbase);                  // [C / 8][64][8]
  bf16* xs = zg + (size_t)kWgRows * C + (size_t)wq * 16 * ld;  // this warp's raw x rows
  const int g = lane >> 2, t = lane & 3;
  int seq = 0;  // chunks this block has consumed (ring position when streaming)

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int grow0 = tile * tile_rows + wg * kWgRows;  // the warpgroup's first row
    const int row0 = grow0 + wq * 16;                   // this warp's
    const bool active = grow0 < ntok;                   // uniform over the warpgroup

    // LN2 of this warp's 16 tokens: raw x into xs, z into the warpgroup's tile
    {
      const int r = lane >> 1;
      warp_ln_16rows(row0 + r < ntok ? x + (size_t)(row0 + r) * C : nullptr, C, ln_s, ln_b,
                     reinterpret_cast<uint4*>(zg) + wq * 16 + r, kWgRows, xs + r * ld, lane);
    }
    fence_async_shared();  // wgmma reads z through the asynchronous proxy
    named_barrier(1 + wg, kWgThreads);

    float acc[C / kN2][kN2 / 2];
#pragma unroll
    for (int i = 0; i < C / kN2; ++i)
#pragma unroll
      for (int e = 0; e < kN2 / 2; ++e) acc[i][e] = 0.f;

    int prev = -1;  // the stage whose release waits for its fc2 to complete
    for (int j = 0; j < nchunks; ++j, ++seq) {
      const int s = persistent ? j : seq % stages;
      const uint32_t parity = persistent ? 0u : (uint32_t)((seq / stages) & 1);
      mbar_wait(full + s, parity);
      {  // (a warpgroup past the end multiplies zero rows: no branch around a wgmma)
        const bf16* w1s = reinterpret_cast<const bf16*>(ring + (size_t)s * chunk_bytes);
        const bf16* w2s = w1s + (size_t)C * kMmaChunk;
        // fc1: h (64 x 64) = z . W1[:, chunk], one wgmma per 16 of C
        float h[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) h[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int k0 = 0; k0 < C; k0 += 16) {
          // A: k-chunks k0/8 and k0/8 + 1 of z (1024 B apart), 8-row groups 128 B apart
          const uint64_t da = wgmma_desc(zg + (size_t)(k0 / 8) * kWgRows * 8, kWgRows * 16, 128);
          // B: rows k0.. of the slice; next 8 rows 128 B on, next 8 columns C * 16 B on
          const uint64_t db = wgmma_desc(w1s + (size_t)k0 * 8, 128, C * 16);
          wgmma_m64n64k16_ss(h, da, db, k0 > 0);
        }
        wgmma_commit();
        wgmma_wait_all();  // (also the previous chunk's fc2, which read ga and its stage)
        if (!persistent && prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = s;
        // + b1 -> bf16 -> exact GELU -> bf16, packed as fc2's A fragments
        uint32_t ga[kMmaChunk / 16][4];
#pragma unroll
        for (int nt = 0; nt < kMmaChunk / 8; ++nt) {
          const float2 bb =
              *reinterpret_cast<const float2*>(b1 + j * kMmaChunk + nt * 8 + 2 * t);
          const float g0 = gelu_erf(round_to<bf16>(h[4 * nt] + bb.x));
          const float g1 = gelu_erf(round_to<bf16>(h[4 * nt + 1] + bb.y));
          const float g2 = gelu_erf(round_to<bf16>(h[4 * nt + 2] + bb.x));
          const float g3 = gelu_erf(round_to<bf16>(h[4 * nt + 3] + bb.y));
          ga[nt >> 1][(nt & 1) * 2] = pack_bf16(g0, g1);      // row g
          ga[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(g2, g3);  // row g + 8
        }
        // fc2: acc (64 x C) += g . W2[chunk, :], kN2 output columns per wgmma
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < kMmaChunk / 16; ++k2) {
#pragma unroll
          for (int p = 0; p < C / kN2; ++p) {
            // B: rows 16 k2.. of the slice, columns kN2 p..; next 8 rows 128 B on,
            // next 8 columns 64 * 16 B on
            const uint64_t db = wgmma_desc(
                w2s + ((size_t)(kN2 / 8 * p) * kMmaChunk + 16 * k2) * 8, 128, kMmaChunk * 16);
            wgmma_k16_rs(acc[p], ga[k2], db, 1);
          }
        }
        wgmma_commit();  // left in flight: the next chunk's fc1 is issued behind it
      }
    }
    wgmma_wait_all();
    if (!persistent) {  // the last chunk's stage, which its fc2 was still reading
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + prev);
    }

    if (active) {
      // y = x + (acc + b2) in fp32, rounded into the warp's x rows ...
#pragma unroll
      for (int p = 0; p < C / kN2; ++p) {
#pragma unroll
        for (int q = 0; q < kN2 / 8; ++q) {
          {
            const int col = p * kN2 + q * 8 + 2 * t;
            const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
            uint32_t* p0 = reinterpret_cast<uint32_t*>(xs + g * ld + col);
            uint32_t* p1 = reinterpret_cast<uint32_t*>(xs + (g + 8) * ld + col);
            const float2 x0 = unpack_bf16(*p0), x1 = unpack_bf16(*p1);
            *p0 = pack_bf16(x0.x + (acc[p][4 * q] + bb.x), x0.y + (acc[p][4 * q + 1] + bb.y));
            *p1 = pack_bf16(x1.x + (acc[p][4 * q + 2] + bb.x),
                            x1.y + (acc[p][4 * q + 3] + bb.y));
          }
        }
      }
      __syncwarp();
      // ... and written out 16 bytes per lane, rows contiguous
      const int vecs = C / 8;
      for (int e = lane; e < 16 * vecs; e += kWarp) {
        const int r = e / vecs, v = e % vecs;
        if (row0 + r < ntok)
          reinterpret_cast<uint4*>(y + (size_t)(row0 + r) * C)[v] =
              *reinterpret_cast<const uint4*>(xs + r * ld + v * 8);
      }
    }
    // the next tile's LN2 overwrites z, which the other warps' fc1 may still read
    named_barrier(1 + wg, kWgThreads);
  }
}

cudaError_t launch_ln_mlp_mma(const void* x, const float* ln_s, const float* ln_b,
                              const void* wpack, const float* b1, const float* b2, void* y,
                              int ntok, int C, int Ch, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (!mlp_mma_eligible(C, Ch) || ntok <= 0) return cudaErrorInvalidValue;
  const MlpPlan p = mlp_plan(ntok, C, Ch, sm_count());
  if (p.stages < 1 || (p.stages < 2 && !p.persistent) || p.smem > (size_t)kMaxSmemBytes)
    return cudaErrorInvalidValue;
  using Kernel = void (*)(const bf16*, const float*, const float*, const bf16*, const float*,
                          const float*, bf16*, int, int, int, int);
  static const Kernel kernels[kMmaMaxC / 16] = {
      ln_mlp_wgmma_kernel<16>,  ln_mlp_wgmma_kernel<32>,  ln_mlp_wgmma_kernel<48>,
      ln_mlp_wgmma_kernel<64>,  ln_mlp_wgmma_kernel<80>,  ln_mlp_wgmma_kernel<96>,
      ln_mlp_wgmma_kernel<112>, ln_mlp_wgmma_kernel<128>, ln_mlp_wgmma_kernel<144>,
      ln_mlp_wgmma_kernel<160>, ln_mlp_wgmma_kernel<176>, ln_mlp_wgmma_kernel<192>};
  const Kernel kernel = kernels[C / 16 - 1];
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, (p.groups + 1) * kWgThreads, p.smem, stream>>>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(wpack), b1, b2,
      static_cast<bf16*>(y), ntok, Ch, p.stages, p.persistent);
  return cudaGetLastError();
}

}  // namespace vadcl

// The CUDA-core body: w1 (C, Ch) and w2 (Ch, C) as they are, in the compute
// dtype (is_bf16).
extern "C" int vadcl_ln_mlp(const void* x, const float* ln_s, const float* ln_b,
                            const void* w1, const float* b1, const void* w2,
                            const float* b2, void* y, int ntok, int C, int Ch, int is_bf16,
                            void* stream) {
  return vadcl::launch_ln_mlp(x, ln_s, ln_b, w1, b1, w2, b2, y, ntok, C, Ch, is_bf16,
                              static_cast<cudaStream_t>(stream));
}

// Shared memory of one block of the CUDA-core body (-1 where no tile fits).
extern "C" long long vadcl_ln_mlp_smem_bytes(int C) {
  const int tokens = vadcl::mlp_tokens(C);
  return tokens == 0 ? -1 : (long long)vadcl::mlp_smem_bytes(C, tokens);
}

// Tokens a block of the CUDA-core body holds at width C.
extern "C" int vadcl_ln_mlp_tokens(int C) { return vadcl::mlp_tokens(C); }

// bf16: both weight matrices packed by hidden chunk (ops/ln_mlp.py:pack_mlp_weights).
extern "C" int vadcl_ln_mlp_bf16(const void* x, const float* ln_s, const float* ln_b,
                                 const void* wpack, const float* b1, const float* b2, void* y,
                                 int ntok, int C, int Ch, void* stream) {
  return vadcl::launch_ln_mlp_mma(x, ln_s, ln_b, wpack, b1, b2, y, ntok, C, Ch,
                                  static_cast<cudaStream_t>(stream));
}
