// D. space_cluster_loss — replaces vadcl_tpu/ops/pallas_cluster.py:_space_kernel
//    (entry fused_space_cluster_loss).  Every channel clusters its own maps:
//    maps (Cc, BD, HW) and centers (Cc, K, HW), fp32, and per channel
//      d    = sqrt(max((|x|^2 + |c|^2) - 2 x.c, 0))   (torch.cdist's form)
//      loss = sum over rows and centers of (d * softmax(-alpha (d - d_min)))^2,
//    one partial per block, then a fixed-order sum (launch_sum_partials,
//    cluster.cu): no float atomics, the same bits on every call.
//
// What bounds it on an H100: the bytes.  At the scoring forward's (192, 32,
// 784) x (192, 128, 784) the centers are 77.1 MB and the maps 19.3 MB: 0.0288
// ms at 3.35 TB/s.  The products, 2 Cc BD K HW = 1.23 GFLOP, take 0.0184 ms
// as fp32 FMA on CUDA cores and 0.0075 ms as three TF32 passes on the tensor
// cores, so the products must stay off the critical path and each channel's
// centers must be read from device memory once, with enough bytes in flight
// to hold the memory rate.  This body reaches about half of that bound: a
// ring stage reads a 128-byte run of every row it holds, the rows 3 KB apart,
// and a block walks its chunks one after another; a block alone streams far
// below its share of the memory rate.  Left on the table: longer runs per row
// (fewer centers a block, the channel's K split over blocks and their (m, s,
// Q) merged in a second pass).
//
// Accuracy: one TF32 rounding of each operand (2^-11) moves the loss by about
// 1e-5 relative, 20-40 times the fp32 plain version's error.  So every
// product is 3xTF32: each operand splits into hi = tf32(v) and lo = tf32(v -
// hi), and hi.hi + hi.lo + lo.hi are summed in fp32 (about 2^-21 of the
// product).  The kernel's accuracy therefore does not follow
// torch.backends.cuda.matmul.allow_tf32.  The split happens on chip as the
// operands leave the ring.  Kernel C splits its centers in a pre-pass
// instead, but C's centers are 0.8 MB read by every block, while D's are read
// once in all: a pre-pass would write the hi and lo parts (154 MB at the
// flagship) and read them back, three times D's whole bound.
//
// Design:
//  - One block of two warpgroups per (channel, group of up to 64 rows).  BD
//    <= 64 (8 when training, 32 when scoring, 64 at 8-frame reconstruction) is
//    one block per channel; a larger BD is split evenly over ceil(BD / 64)
//    blocks, adjacent in blockIdx, so the later reads of a channel's centers
//    come from L2.  The rows are the products' N: 8, 16, 32 or 64 slots (a
//    template parameter), the slots past the block's rows zeros.
//  - K is walked in tiles of 128 centers, 64 a warpgroup and 16 a warp; HW in
//    chunks of 32 values.  Chunks stream through a three-stage ring filled by
//    cp.async (16-byte copies where HW % 4 == 0 and both bases are 16-byte
//    aligned, else 4-byte ones: rows of an odd HW are not 16-byte aligned); a
//    stage holds the chunk of the block's rows and of the tile's centers, and
//    the tail of HW is zero-filled.  At N = 64 the block takes 105 KB, so two
//    blocks fit an SM and 192 channels run in one wave.
//  - Products: wgmma.m64nNk8 tf32 with A, the warpgroup's 64 centers, in
//    registers: each warp loads and splits only its own 16 centers.  B, the
//    chunk's rows, is split once a chunk by the whole block into wgmma's
//    K-major layout (hi and lo, 2 N x 32 words), so no value is split twice.
//    Three wgmma a k8 step (A hi . B lo, A lo . B hi, A hi . B hi).  A body on
//    mma.sync (m16n8k8, every warp splitting every row) was slower on an H100:
//    its tensor rate and the repeated splits, not the bytes, bounded it.
//  - |x|^2 and |c|^2 are summed in fp32 from the same chunks: a row's from the
//    block's split (a thread per 16-byte group of a row, the groups summed in
//    order at the tile's end), a center's from its warp's A fragments (a lane's
//    values, then a quad reduce), once per K tile.
//  - Soft-assign without a (rows x K) tile: at the end of a K tile every warp
//    reduces its 16 centers, per row, to (m, s = sum e, Q = sum (d e)^2), e =
//    exp(-alpha (d - m)): one exp per (row, center).  One thread per row merges
//    the warps' triples in warp order, and across K tiles online: when the
//    minimum falls to m', s and Q scale by f = exp(-alpha (m - m')) and f^2.
//    The row's loss is Q / s^2; the block sums its rows in order.
//  - Ring rows are 36 words (4 mod 32): the A fragment loads (lane (g, t) ->
//    row g, column t) and the split's 16-byte reads hit distinct banks.
//  - Padding adds nothing: padded centers get e = 0 and never set m, a
//    warpgroup whose centers all lie past K skips the products, padded rows
//    are never merged.
#include <stdint.h>

#include "cluster.cuh"
#include "mma.cuh"

namespace vadcl {

constexpr int kScThreads = 256;  // two warpgroups
constexpr int kScWarps = kScThreads / kWarp;
constexpr int kScCenters = 16 * kScWarps;  // centers a K tile: 16 a warp, 64 a warpgroup
constexpr int kScMaxRows = 64;             // rows a block, at most
constexpr int kScChunk = 32;               // HW values a ring stage
constexpr int kScStride = kScChunk + 4;    // words a ring row
constexpr int kScGroups = kScChunk / 4;    // 16-byte groups (4 tf32) of a chunk row
constexpr int kScStages = 3;

// Blocks a channel takes, and the rows each holds (BD split evenly).
inline int sc_row_blocks(int BD) { return (BD + kScMaxRows - 1) / kScMaxRows; }
inline int sc_rows(int BD) {
  const int nb = sc_row_blocks(BD);
  return (BD + nb - 1) / nb;
}
// Row slots a block computes (the products' N): 8, 16, 32 or 64.
inline int sc_row_slots(int rows) {
  int n = 8;
  while (n < rows) n *= 2;
  return n;
}

// A ring stage: N row slots, then the K tile's 128 center slots.
template <int N>
__host__ __device__ constexpr int sc_stage_words() {
  return (N + kScCenters) * kScStride;
}
// The ring, the chunk's rows split (hi, lo), the |x|^2 partials, the warps'
// (m, s, Q) table and the row losses.
template <int N>
constexpr size_t sc_smem_bytes() {
  return sizeof(float) * (kScStages * sc_stage_words<N>() + 2 * N * kScChunk +
                          (kScGroups + 3 * kScWarps + 1) * N);
}

template <int N>
__global__ void __launch_bounds__(kScThreads, 2)
    space_cluster_mma_kernel(const float* __restrict__ maps, const float* __restrict__ centers,
                             float* __restrict__ partials, int BD, int HW, int K, int rows,
                             int nblk, float alpha, int vec4) {
  constexpr int kStage = sc_stage_words<N>();
  // wgmma's K-major layout of the split rows: core matrices of 8 rows x 4
  // values (128 B), the N / 8 of a 16-byte group side by side (SBO 128 B),
  // then the next group (LBO 16 N bytes); a k8 step is two groups.
  constexpr uint32_t kLbo = 16 * N, kSbo = 128;
  constexpr int kSlots = (N * kScGroups + kScThreads - 1) / kScThreads;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  uint32_t* bhi = reinterpret_cast<uint32_t*>(ring + kScStages * kStage);  // N x 32
  uint32_t* blo = bhi + N * kScChunk;
  float* xpart = reinterpret_cast<float*>(blo + N * kScChunk);  // [group][row]
  float* tab_m = xpart + kScGroups * N;                          // [warp][row]
  float* tab_s = tab_m + kScWarps * N;
  float* tab_q = tab_s + kScWarps * N;
  float* rloss = tab_q + kScWarps * N;  // [row]

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / 4;
  const int ch = blockIdx.x / nblk;
  const int r0 = (blockIdx.x - ch * nblk) * rows;
  const int nr = min(rows, BD - r0);
  const float* xin = maps + ((size_t)ch * BD + r0) * HW;
  const float* cin = centers + (size_t)ch * K * HW;
  const int nhw = (HW + kScChunk - 1) / kScChunk;
  const int nchunks = nhw * ((K + kScCenters - 1) / kScCenters);

  // Chunk ci (K tile ci / nhw, HW chunk ci % nhw) into ring stage ci % 3:
  // the block's rows, then the tile's centers up to a whole warpgroup's 64;
  // what lies past the rows, the centers or HW is zero-filled.
  auto load = [&](int ci) {
    const int kt = ci / nhw, c0 = (ci - kt * nhw) * kScChunk;
    const int k0 = kt * kScCenters, kc = min(kScCenters, K - k0);
    const int nrow = N + (kc + 63) / 64 * 64;
    const float* cbase = cin + (size_t)k0 * HW;
    float* dst = ring + (ci % kScStages) * kStage;
    if (vec4) {
      for (int u = tid; u < nrow * kScGroups; u += kScThreads) {
        const int r = u / kScGroups, c = 4 * (u % kScGroups);
        const bool ok = c0 + c < HW && (r < N ? r < nr : r - N < kc);
        const float* src = r < N ? xin + (size_t)r * HW : cbase + (size_t)(r - N) * HW;
        cp_async16(dst + r * kScStride + c, ok ? src + c0 + c : maps, ok);
      }
    } else {
      for (int u = tid; u < nrow * kScChunk; u += kScThreads) {
        const int r = u / kScChunk, c = u % kScChunk;
        const bool ok = c0 + c < HW && (r < N ? r < nr : r - N < kc);
        const float* src = r < N ? xin + (size_t)r * HW : cbase + (size_t)(r - N) * HW;
        cp_async4(dst + r * kScStride + c, ok ? src + c0 + c : maps, ok);
      }
    }
  };
#pragma unroll 1
  for (int s = 0; s < kScStages - 1; ++s) {
    if (s < nchunks) load(s);
    cp_async_commit();
  }

  // This warpgroup's products (its 64 centers x the N row slots; this warp
  // holds centers 16 warp + g, + 8 of every n8 tile), this lane's share of
  // |c|^2 of those two centers, this thread's |x|^2 share of its (row,
  // group) slots; thread tid < nr keeps row tid's running (m, s, Q).
  float acc[N / 2], csq[2] = {0.f, 0.f}, xacc[kSlots];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) xacc[i] = 0.f;
  float run_m = INFINITY, run_s = 0.f, run_q = 0.f;

  for (int ci = 0; ci < nchunks; ++ci) {
    cp_async_wait<kScStages - 2>();  // this thread's copies of chunk ci landed
    __syncthreads();                 // everyone's; chunk ci - 1 is read
    if (ci + kScStages - 1 < nchunks) load(ci + kScStages - 1);
    cp_async_commit();
    const int kt = ci / nhw;
    const int kc = min(kScCenters, K - kt * kScCenters);
    const bool last = ci - kt * nhw == nhw - 1;  // the K tile's last chunk
    const float* st = ring + (ci % kScStages) * kStage;

    // The chunk's rows, split once for both warpgroups into wgmma's layout;
    // a quarter-warp reads 8 rows of one group and writes one core matrix.
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int slot = tid + i * kScThreads;
      if (slot < N * kScGroups) {
        const int n = slot % N, grp = slot / N;
        const float4 v = *reinterpret_cast<const float4*>(st + n * kScStride + 4 * grp);
        xacc[i] = fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, fmaf(v.x, v.x, xacc[i]))));
        uint4 h, l;
        split_tf32(v.x, h.x, l.x);
        split_tf32(v.y, h.y, l.y);
        split_tf32(v.z, h.z, l.z);
        split_tf32(v.w, h.w, l.w);
        const int off = grp * (kLbo / 4) + (n / 8) * (kSbo / 4) + (n % 8) * 4;
        *reinterpret_cast<uint4*>(bhi + off) = h;
        *reinterpret_cast<uint4*>(blo + off) = l;
        if (last) {
          xpart[grp * N + n] = xacc[i];
          xacc[i] = 0.f;
        }
      }
    }
    fence_async_shared();  // the stores, visible to wgmma's reads
    __syncthreads();

    if (64 * wg < kc) {  // this warpgroup has a center in the tile
      const float* arow = st + (N + 16 * warp + g) * kScStride + t;
      uint32_t ah[kScChunk / 8][4], al[kScChunk / 8][4];
#pragma unroll
      for (int ks = 0; ks < kScChunk / 8; ++ks) {
        const float v[4] = {arow[8 * ks], arow[8 * kScStride + 8 * ks], arow[8 * ks + 4],
                            arow[8 * kScStride + 8 * ks + 4]};
        csq[0] = fmaf(v[2], v[2], fmaf(v[0], v[0], csq[0]));
        csq[1] = fmaf(v[3], v[3], fmaf(v[1], v[1], csq[1]));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[ks][e], al[ks][e]);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kScChunk / 8; ++ks) {
        const uint64_t dh = wgmma_desc(bhi + 2 * ks * (kLbo / 4), kLbo, kSbo);
        const uint64_t dl = wgmma_desc(blo + 2 * ks * (kLbo / 4), kLbo, kSbo);
        wgmma_tf32_k8_rs(acc, ah[ks], dl, 1);
        wgmma_tf32_k8_rs(acc, al[ks], dh, 1);
        wgmma_tf32_k8_rs(acc, ah[ks], dh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    if (!last) continue;

    // The K tile's products are complete: each warp's (m, s, Q) per row over
    // its 16 centers (rows g, g + 8 of the accumulator, across the lanes of
    // one t).
    if (64 * wg < kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        csq[h] += __shfl_xor_sync(0xffffffffu, csq[h], 1);
        csq[h] += __shfl_xor_sync(0xffffffffu, csq[h], 2);
      }
      const bool valid[2] = {16 * warp + g < kc, 16 * warp + g + 8 < kc};
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * t + e;
          float x2 = 0.f;
#pragma unroll
          for (int grp = 0; grp < kScGroups; ++grp) x2 += xpart[grp * N + n];
          float d[2], mn = INFINITY;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d2 = (x2 + csq[h]) - 2.f * acc[4 * j + 2 * h + e];
            d[h] = valid[h] ? sqrtf(fmaxf(d2, 0.f)) : INFINITY;
            mn = fminf(mn, d[h]);
          }
#pragma unroll
          for (int o = 4; o < kWarp; o <<= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
          float s = 0.f, q = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (valid[h]) {
              const float ev = expf(-alpha * (d[h] - mn));
              const float de = d[h] * ev;
              s += ev;
              q += de * de;
            }
#pragma unroll
          for (int o = 4; o < kWarp; o <<= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, o);
            q += __shfl_xor_sync(0xffffffffu, q, o);
          }
          if (g == 0) {
            tab_m[warp * N + n] = mn;  // INFINITY for a warp past K: never merged
            tab_s[warp * N + n] = s;
            tab_q[warp * N + n] = q;
          }
        }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      csq[0] = csq[1] = 0.f;
    }
    __syncthreads();
    if (tid < nr) {  // merge the warps with a center, in order, into row tid's state
      const int nw = (kc + 15) / 16;
      float mm = run_m;
      for (int w = 0; w < nw; ++w) mm = fminf(mm, tab_m[w * N + tid]);
      const float f = run_m == INFINITY ? 0.f : expf(-alpha * (run_m - mm));
      float s = run_s * f, q = run_q * (f * f);
      for (int w = 0; w < nw; ++w) {
        const float fw = expf(-alpha * (tab_m[w * N + tid] - mm));
        s += tab_s[w * N + tid] * fw;
        q += tab_q[w * N + tid] * (fw * fw);
      }
      run_m = mm, run_s = s, run_q = q;
    }
  }

  if (tid < nr) rloss[tid] = run_q / (run_s * run_s);
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int r = 0; r < nr; ++r) sum += rloss[r];
    partials[blockIdx.x] = sum;
  }
}

template <int N>
cudaError_t launch_space_cluster(const float* maps, const float* centers, float* partials,
                                 int Cc, int BD, int HW, int K, float alpha, int vec4,
                                 cudaStream_t s) {
  const size_t smem = sc_smem_bytes<N>();
  cudaError_t err = allow_smem(space_cluster_mma_kernel<N>, smem);
  if (err != cudaSuccess) return err;
  const int nblk = sc_row_blocks(BD);
  space_cluster_mma_kernel<N><<<Cc * nblk, kScThreads, smem, s>>>(
      maps, centers, partials, BD, HW, K, sc_rows(BD), nblk, alpha, vec4);
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

// Scratch floats the wrapper allocates: one loss partial per block; -1 for
// an empty input.
long long vadcl_space_cluster_scratch(int Cc, int BD) {
  if (Cc <= 0 || BD <= 0) return -1;
  return (long long)Cc * vadcl::sc_row_blocks(BD);
}

int vadcl_space_cluster_loss(const float* maps, const float* centers, float* scratch,
                             float* loss, int Cc, int BD, int HW, int K, float alpha,
                             void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cc <= 0 || BD <= 0 || HW <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int vec4 = HW % 4 == 0 && reinterpret_cast<uintptr_t>(maps) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(centers) % 16 == 0;
  cudaError_t err;
  switch (sc_row_slots(sc_rows(BD))) {
    case 8: err = launch_space_cluster<8>(maps, centers, scratch, Cc, BD, HW, K, alpha, vec4, s); break;
    case 16: err = launch_space_cluster<16>(maps, centers, scratch, Cc, BD, HW, K, alpha, vec4, s); break;
    case 32: err = launch_space_cluster<32>(maps, centers, scratch, Cc, BD, HW, K, alpha, vec4, s); break;
    default: err = launch_space_cluster<64>(maps, centers, scratch, Cc, BD, HW, K, alpha, vec4, s); break;
  }
  if (err != cudaSuccess) return err;
  return launch_sum_partials(scratch, Cc * sc_row_blocks(BD), loss, s);
}

}  // extern "C"
