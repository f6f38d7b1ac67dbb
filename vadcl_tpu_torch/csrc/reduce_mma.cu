// The second pass of kernels 5 and 6 on the tensor cores: the weight
// gradients as sums over tokens, out = A^T . B (see reduce_mma.cuh).
//
// Precision.  A bf16 operand is exact.  An fp32 operand x (kernel 5's z, g and
// dh) arrives split by the first pass into hi = round(x) and lo = round(x - hi),
// so that x = hi + lo + r with |r| <= 2^-18 |x|.  The block sums the bf16
// products hi.hi, hi.lo (where B has a lo part) and lo.hi (where A has one)
// on mma.sync.m16n8k16 with fp32 accumulation; the dropped lo.lo term is below
// 2^-16 of the product.  So each product carries a relative error of about
// 3 x 2^-18 = 1.1e-5 against the fp32 product of the fp32 operands, and the
// sums are fp32 sums in another order.  No fp32 operand is rounded once.
//
// Design.  One block (4 warps) per (64 x 64 output tile, chunk of
// kAtbMmaChunk tokens); tokens come 32 at a time through a two-stage
// cp.async ring in shared memory, stored as they lie ([token][column], rows
// padded by 8 elements so that ldmatrix reads no bank twice).  The A operand
// (rows a, depth tokens) is the transposed ldmatrix of the [token][a] tile, the
// B operand the transposed ldmatrix of the [token][b] tile.  Each warp owns 32 x
// 32 outputs.  Blocks of the first output row also sum B's columns over their
// tokens, one thread per column in token order.  Partials go to
// (chunk, Ca, Cb) and (chunk, Cb); sum_rows (reduce.cu) adds them in chunk
// order.  No float atomics: the same bits on every run of a card.
//
// What bounds it: the operands' bytes, read once (kernel 5: 2 x T x (C + 4C)
// bf16 pairs), and the tensor-core issue of three products per tile step.
#include "mma.cuh"
#include "reduce.cuh"
#include "reduce_mma.cuh"

namespace vadcl {

constexpr int kAmTile = 64;             // output rows and columns per block
constexpr int kAmStep = 32;             // tokens per ring stage
constexpr int kAmLd = kAmTile + 8;      // shared-memory row, elements
constexpr int kAmThreads = 128;
constexpr int kAmTileElems = kAmStep * kAmLd;

struct AtbMmaArgs {
  const __nv_bfloat16* a[2];  // hi, lo (lo may be null)
  const __nv_bfloat16* b[2];
  float* partial;  // (chunks, Ca, Cb)
  float* colsum;   // (chunks, Cb) or null
  int T, Ca, Cb;
};

template <bool kALo, bool kBLo>
__global__ void __launch_bounds__(kAmThreads) atb_mma_kernel(AtbMmaArgs p) {
  using bf16 = __nv_bfloat16;
  // [stage][A hi, A lo, B hi, B lo][kAmStep][kAmLd]
  __shared__ __align__(128) bf16 sm[2][4][kAmTileElems];
  const int b0 = blockIdx.x * kAmTile, a0 = blockIdx.y * kAmTile, chunk = blockIdx.z;
  const int t_begin = chunk * kAtbMmaChunk, t_end = min(p.T, t_begin + kAtbMmaChunk);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int wa = warp >> 1, wb = warp & 1;
  const bool sums = p.colsum != nullptr && blockIdx.y == 0;

  // one stage: 32 token rows x 8 vectors of 16 bytes per present array
  auto load = [&](int stage, int t0) {
#pragma unroll
    for (int arr = 0; arr < 4; ++arr) {
      const bool is_a = arr < 2;
      const bf16* src = is_a ? p.a[arr] : p.b[arr - 2];
      if ((arr == 1 && !kALo) || (arr == 3 && !kBLo)) continue;
      const int ncol = is_a ? p.Ca : p.Cb, col0 = is_a ? a0 : b0;
#pragma unroll
      for (int e = tid; e < kAmStep * (kAmTile / 8); e += kAmThreads) {
        const int r = e / (kAmTile / 8), v = e % (kAmTile / 8);
        const int t = t0 + r, col = col0 + 8 * v;
        const bool ok = t < t_end && col < ncol;
        cp_async16(&sm[stage][arr][r * kAmLd + 8 * v],
                   ok ? src + (size_t)t * ncol + col : src, ok);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float cs = 0.f;  // column tid of B's tile (threads < 64 of a summing block)

  const int nsteps = (t_end - t_begin + kAmStep - 1) / kAmStep;
  load(0, t_begin);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) load((s + 1) & 1, t_begin + (s + 1) * kAmStep);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ah = sm[s & 1][0];
    const bf16* al = sm[s & 1][1];
    const bf16* bh = sm[s & 1][2];
    const bf16* bl = sm[s & 1][3];
#pragma unroll
    for (int kk = 0; kk < kAmStep; kk += 16) {
      uint32_t fah[2][4], fal[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_x4_t(fah[mt], a_frag_row_km(ah + kk * kAmLd + wa * 32 + mt * 16, kAmLd, lane));
        if (kALo)
          ldsm_x4_t(fal[mt], a_frag_row_km(al + kk * kAmLd + wa * 32 + mt * 16, kAmLd, lane));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t fbh[4], fbl[4];
        ldsm_x4_t(fbh, b_frag_row_kn(bh + kk * kAmLd + wb * 32 + np * 16, kAmLd, lane));
        if (kBLo) ldsm_x4_t(fbl, b_frag_row_kn(bl + kk * kAmLd + wb * 32 + np * 16, kAmLd, lane));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], fah[mt], fbh[0], fbh[1]);
          mma_bf16(acc[mt][2 * np + 1], fah[mt], fbh[2], fbh[3]);
          if (kBLo) {
            mma_bf16(acc[mt][2 * np], fah[mt], fbl[0], fbl[1]);
            mma_bf16(acc[mt][2 * np + 1], fah[mt], fbl[2], fbl[3]);
          }
          if (kALo) {
            mma_bf16(acc[mt][2 * np], fal[mt], fbh[0], fbh[1]);
            mma_bf16(acc[mt][2 * np + 1], fal[mt], fbh[2], fbh[3]);
          }
        }
      }
    }
    if (sums && tid < kAmTile) {
      for (int r = 0; r < kAmStep; ++r) {
        float v = __bfloat162float(bh[r * kAmLd + tid]);
        if (kBLo) v += __bfloat162float(bl[r * kAmLd + tid]);
        cs += v;
      }
    }
    __syncthreads();  // the next load overwrites this stage
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int b = b0 + wb * 32 + nt * 8 + 2 * t;
      if (b >= p.Cb) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int a = a0 + wa * 32 + mt * 16 + g + 8 * hr;
        if (a < p.Ca)
          *reinterpret_cast<float2*>(p.partial + ((size_t)chunk * p.Ca + a) * p.Cb + b) =
              make_float2(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
      }
    }
  if (sums && tid < kAmTile && b0 + tid < p.Cb) p.colsum[(size_t)chunk * p.Cb + b0 + tid] = cs;
}

cudaError_t launch_atb_mma(const __nv_bfloat16* a_hi, const __nv_bfloat16* a_lo,
                           const __nv_bfloat16* b_hi, const __nv_bfloat16* b_lo, int T, int Ca,
                           int Cb, float* partial, float* out, float* colsum,
                           cudaStream_t stream) {
  if (T <= 0 || Ca <= 0 || Cb <= 0 || Ca % 8 || Cb % 8) return cudaErrorInvalidValue;
  const int chunks = atb_mma_chunks(T);
  const size_t n = (size_t)Ca * Cb;
  AtbMmaArgs p{{a_hi, a_lo}, {b_hi, b_lo}, partial,
               colsum != nullptr ? partial + (size_t)chunks * n : nullptr, T, Ca, Cb};
  const dim3 grid((Cb + kAmTile - 1) / kAmTile, (Ca + kAmTile - 1) / kAmTile, chunks);
  if (a_lo != nullptr && b_lo != nullptr)
    atb_mma_kernel<true, true><<<grid, kAmThreads, 0, stream>>>(p);
  else if (a_lo != nullptr)
    atb_mma_kernel<true, false><<<grid, kAmThreads, 0, stream>>>(p);
  else if (b_lo != nullptr)
    atb_mma_kernel<false, true><<<grid, kAmThreads, 0, stream>>>(p);
  else
    atb_mma_kernel<false, false><<<grid, kAmThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = launch_sum_rows(partial, out, chunks, (long long)n, (long long)n, stream)))
    return err;
  if (colsum != nullptr)
    return launch_sum_rows(p.colsum, colsum, chunks, Cb, Cb, stream);
  return cudaSuccess;
}

}  // namespace vadcl
