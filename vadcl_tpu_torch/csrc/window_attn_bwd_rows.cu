// Row-tiled backward of Swin window attention over pre-partitioned windows
// (kernel 8 for windows the whole-tile body of window_attn_bwd.cu cannot
// hold):  out = proj(attention(x_windows))  ->  dx, dqkv_w, dqkv_b, dproj_w,
// dproj_b, d(bias).
//
// Replaces vadcl_tpu/ops/pallas_attn_bwd.py:_bwd_kernel (entry _bwd_call) at
// every N: the wrapper (ops/window_attn.py) sends a window here when the
// whole-tile body's plan exceeds 227 KB of shared memory (N = 147 in bf16,
// N = 196 and N = 392 in both dtypes at the flagship widths).  The same order
// and cast boundaries as window_attn_bwd.cu:
//   qkv = round(x . W_qkv + b);  P = softmax(q . k^T * scale + bias + mask)
//   (fp32), p = round(P), o = round(p . v);  do = round(dout . W_proj^T);
//   dv = p^T . do;  dp = do . v^T;  ds = P * (dp - rowsum(dp * P));
//   dss = round(ds * scale);  dq = dss . k;  dk = dss^T . q;
//   dqkv_b = colsum(dqkv) before the rounding;  dx = round(round(dqkv) . W_qkv^T).
//
// Launches on the caller's stream:
//   1. qkv = round(x . W_qkv + b) and do = round(dout . W_proj^T) into the
//      workspace (window_rows.cuh; W_proj^T and W_qkv^T come transposed from
//      the wrapper);
//   2. the core: one block per (chunk of consecutive windows, head), eight
//      warps, looping over its windows in order.  Per window it stages q, k,
//      v and do of the head (4 x Np x (hd + 8) bf16: 76.8 KB at N = 392, hd
//      16).  Phase A, a warp per strip of 16 query rows: a first walk over
//      the keys in blocks of 16 carries the running row max and sum (the
//      FlashAttention rescale), a second forms P and dp and sums rowsum(dp * P),
//      a third forms ds, adds it into the chunk's d(bias) partial, and
//      accumulates dq = dss . k and o = p . v in registers; the row statistics
//      go to shared memory.  Phase B, a warp per strip of 16 key rows: it
//      walks the query blocks, recomputes P^T and dp^T from the statistics
//      and accumulates dk = dss^T . q and dv = p^T . do.  Every output row
//      and every d(bias) element has one owner, so nothing is added
//      atomically; the dqkv column sums are summed over the strips in order.
//      bf16 on mma.sync.m16n8k16 (scores in registers, P as the register A
//      operand, e = ex2.approx.ftz, the division fa_div), head widths 16 to
//      64; fp32 on CUDA cores, one row per warp, expf;
//   3. the deterministic second pass (reduce.cu): dqkv_w = x^T . dqkv,
//      dproj_w = o^T . do, dproj_b = colsum(do), and the per-window dqkv_b and
//      per-chunk d(bias) partials summed in a fixed order;
//   4. dx = round(round(dqkv) . W_qkv^T) (window_rows.cuh).
//
// The d(bias) partials are nH x N x N floats per chunk, not per window: at
// most ceil(264 / nH) chunks of consecutive windows (two blocks per SM's
// worth of work), so at N = 392 and a training batch of 4 the workspace
// holds 43 x 6 partials (158.6 MB) where one per window would be 944 MB, and
// 22 x 12 (162.3 MB) at 12 heads (chip_smoke.py prints the sizes).
//
// What bounds it: each window's block of the core walks the keys three
// times and the queries once, and rewrites its chunk's d(bias) partial
// (read and write nH x N x N floats per window); the workspaces of launch 1
// and the second pass add device traffic.  Left on the table: wgmma, fewer
// walks, d(bias) held on chip across windows.
#include "reduce.cuh"
#include "window_rows.cuh"

namespace vadcl {

constexpr int kRowsBwdBlocks = 264;  // target (chunk, head) blocks of the core

struct RowsBwdArgs {
  const void* qkv;    // (T, 3C) round(x . W_qkv + b)
  const void* doa;    // (T, C) round(dout . W_proj^T)
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  void* o;            // (T, C) round(p . v), all heads
  void* dqkv;         // (T, 3C) round(dq | dk | dv)
  float* dqkvb_part;  // (Bn, 3C) per-window column sums of the unrounded dqkv
  float* dbias_part;  // (chunks, nH, N, N)
  int Bn, N, C, nh, nW, chunk;
  float scale;
};

// Windows per chunk of the core's grid, and the chunks that makes.
inline int rows_bwd_chunk(int Bn, int nh) {
  const int want = min(Bn, (kRowsBwdBlocks + nh - 1) / nh);
  return (Bn + want - 1) / want;
}
inline int rows_bwd_chunks(int Bn, int nh) {
  const int chunk = rows_bwd_chunk(Bn, nh);
  return (Bn + chunk - 1) / chunk;
}

inline size_t rows_bwd_smem(int n, int c, int nh, int is_bf16) {
  const size_t hd = c / nh;
  if (is_bf16) {
    const size_t np = rows_padded(n);
    return sizeof(__nv_bfloat16) * 4 * np * (hd + 8) + sizeof(float) * (3 * np + np / 16 * 3 * hd);
  }
  // fp32: rows unpadded, so that head width 32 fits at N = 392
  return sizeof(float) * (4 * (size_t)n * hd + 3 * (size_t)n + 2 * (size_t)kRowsWarps * n);
}

// Column sums of a 16 x kHd fp32 strip (rows past the window left out) into
// out[0 .. kHd): lanes 0-3 write, in the C fragment's column order.
template <int kHt>
__device__ __forceinline__ void strip_colsum(const float (&acc)[kHt][4], bool r0, bool r1,
                                             float* out, int lane) {
#pragma unroll
  for (int i = 0; i < kHt; ++i) {
    float c0 = (r0 ? acc[i][0] : 0.f) + (r1 ? acc[i][2] : 0.f);
    float c1 = (r0 ? acc[i][1] : 0.f) + (r1 ? acc[i][3] : 0.f);
#pragma unroll
    for (int o = 4; o < kWarp; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (lane < 4) out[i * 8 + 2 * lane] = c0, out[i * 8 + 2 * lane + 1] = c1;
  }
}

template <int kHd>
__global__ void __launch_bounds__(kRowsThreads) rows_bwd_bf16_kernel(RowsBwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = kHd + 8, kKs = kHd / 16, kHt = kHd / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  const int N = a.N, C = a.C, C3 = 3 * C, nh = a.nh, Np = rows_padded(N), nblk = Np / 16;
  const int chunk = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* ks = qs + (size_t)Np * kLd;
  bf16* vs = ks + (size_t)Np * kLd;
  bf16* ds_ = vs + (size_t)Np * kLd;  // do of the head
  float* mrow = reinterpret_cast<float*>(ds_ + (size_t)Np * kLd);
  float* lrow = mrow + Np;
  float* rrow = lrow + Np;
  float* csum = rrow + Np;  // [strip][3 kHd]
  const float* bias = a.bias + (size_t)h * N * N;
  float* dbias = a.dbias_part + ((size_t)chunk * nh + h) * N * N;
  const float scale = a.scale;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int w_begin = chunk * a.chunk, w_end = min(a.Bn, w_begin + a.chunk);

  for (int w = w_begin; w < w_end; ++w) {
    const bf16* qkv = static_cast<const bf16*>(a.qkv) + (size_t)w * N * C3;
    const bf16* doa = static_cast<const bf16*>(a.doa) + (size_t)w * N * C;
    bf16* o = static_cast<bf16*>(a.o) + (size_t)w * N * C;
    bf16* dqkv = static_cast<bf16*>(a.dqkv) + (size_t)w * N * C3;
    const float* mask = a.mask != nullptr ? a.mask + (size_t)(w % a.nW) * N * N : nullptr;
    const bool first = w == w_begin;

    for (int e = tid; e < 4 * Np * (kHd / 8); e += kRowsThreads) {
      const int part = e / (Np * (kHd / 8)), r = (e / (kHd / 8)) % Np, v = e % (kHd / 8);
      uint4 val = zero;
      if (r < N) {
        const bf16* src = part < 3 ? qkv + (size_t)r * C3 + part * C : doa + (size_t)r * C;
        val = *reinterpret_cast<const uint4*>(src + h * kHd + v * 8);
      }
      *reinterpret_cast<uint4*>(qs + ((size_t)part * Np + r) * kLd + v * 8) = val;
    }
    __syncthreads();

    // phase A: a warp per strip of 16 query rows
    for (int strip = warp; strip < nblk; strip += kRowsWarps) {
      const int i0 = strip * 16 + g, i1 = i0 + 8;
      uint32_t qf[kKs][4], df[kKs][4];
#pragma unroll
      for (int k = 0; k < kKs; ++k) {
        ldsm_x4(qf[k], a_frag_row(qs + (size_t)strip * 16 * kLd + k * 16, kLd, lane));
        ldsm_x4(df[k], a_frag_row(ds_ + (size_t)strip * 16 * kLd + k * 16, kLd, lane));
      }
      auto dprod = [&](int kb, float (&d)[2][4]) {  // dp = do . v^T
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
#pragma unroll
        for (int k = 0; k < kKs; ++k) {
          uint32_t vf[4];
          ldsm_x4(vf, b_frag_row_nk(vs + (size_t)kb * 16 * kLd + k * 16, kLd, lane));
          mma_bf16(d[0], df[k], vf[0], vf[1]);
          mma_bf16(d[1], df[k], vf[2], vf[3]);
        }
      };

      float m[2], l[2];
      rows_stats<kKs>(qf, ks, kLd, nblk, i0, i1, N, scale, bias, mask, lane, m, l);
      const float rinv[2] = {1.f / l[0], 1.f / l[1]};

      // rowsum(dp * P)
      float q0 = 0.f, q1 = 0.f;
      for (int kb = 0; kb < nblk; ++kb) {
        float s[2][4], p[2][4], d[2][4];
        rows_scores<kKs>(qf, ks, kLd, kb, i0, i1, N, scale, bias, mask, lane, s);
        rows_probs<false>(s, m, l, rinv, p);
        dprod(kb, d);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          q0 += d[nt][0] * p[nt][0] + d[nt][1] * p[nt][1];
          q1 += d[nt][2] * p[nt][2] + d[nt][3] * p[nt][3];
        }
      }
      q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 2);

      // ds into the d(bias) partial; dq = dss . k and o = round(P) . v
      float dq[kHt][4], oa[kHt][4];
#pragma unroll
      for (int i = 0; i < kHt; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[i][e] = oa[i][e] = 0.f;
      for (int kb = 0; kb < nblk; ++kb) {
        float s[2][4], p[2][4], d[2][4];
        rows_scores<kKs>(qf, ks, kLd, kb, i0, i1, N, scale, bias, mask, lane, s);
        rows_probs<false>(s, m, l, rinv, p);
        dprod(kb, d);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1, j = kb * 16 + nt * 8 + 2 * t + (e & 1);
            const float dsv = p[nt][e] * (d[nt][e] - (e < 2 ? q0 : q1));
            if (i < N && j < N) {
              float* db = dbias + (size_t)i * N + j;
              *db = first ? dsv : *db + dsv;
            }
            d[nt][e] = dsv * scale;
          }
        uint32_t pf[4], sf[4];
        rows_a_frag(p, pf);
        rows_a_frag(d, sf);
#pragma unroll
        for (int nq = 0; nq < kKs; ++nq) {
          uint32_t bf[4];
          ldsm_x4_t(bf, b_frag_row_kn(ks + (size_t)kb * 16 * kLd + nq * 16, kLd, lane));
          mma_bf16(dq[2 * nq], sf, bf[0], bf[1]);
          mma_bf16(dq[2 * nq + 1], sf, bf[2], bf[3]);
          ldsm_x4_t(bf, b_frag_row_kn(vs + (size_t)kb * 16 * kLd + nq * 16, kLd, lane));
          mma_bf16(oa[2 * nq], pf, bf[0], bf[1]);
          mma_bf16(oa[2 * nq + 1], pf, bf[2], bf[3]);
        }
      }
      if (t == 0) {
        mrow[i0] = m[0], lrow[i0] = l[0], rrow[i0] = q0;
        mrow[i1] = m[1], lrow[i1] = l[1], rrow[i1] = q1;
      }
      strip_store<kHt>(oa, o, C, i0, i1, N, h * kHd, t);
      strip_store<kHt>(dq, dqkv, C3, i0, i1, N, h * kHd, t);
      strip_colsum<kHt>(dq, i0 < N, i1 < N, csum + strip * 3 * kHd, lane);
    }
    __syncthreads();

    // phase B: a warp per strip of 16 key rows
    for (int strip = warp; strip < nblk; strip += kRowsWarps) {
      const int j0 = strip * 16 + g, j1 = j0 + 8;
      uint32_t kf[kKs][4], vf[kKs][4];
#pragma unroll
      for (int k = 0; k < kKs; ++k) {
        ldsm_x4(kf[k], a_frag_row(ks + (size_t)strip * 16 * kLd + k * 16, kLd, lane));
        ldsm_x4(vf[k], a_frag_row(vs + (size_t)strip * 16 * kLd + k * 16, kLd, lane));
      }
      float dk[kHt][4], dv[kHt][4];
#pragma unroll
      for (int i = 0; i < kHt; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
      for (int qb = 0; qb < nblk; ++qb) {
        float st[2][4], dt[2][4];  // S^T and dp^T: key rows g, g + 8; query columns
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = dt[nt][e] = 0.f;
#pragma unroll
        for (int k = 0; k < kKs; ++k) {
          uint32_t bf[4];
          ldsm_x4(bf, b_frag_row_nk(qs + (size_t)qb * 16 * kLd + k * 16, kLd, lane));
          mma_bf16(st[0], kf[k], bf[0], bf[1]);
          mma_bf16(st[1], kf[k], bf[2], bf[3]);
          ldsm_x4(bf, b_frag_row_nk(ds_ + (size_t)qb * 16 * kLd + k * 16, kLd, lane));
          mma_bf16(dt[0], vf[k], bf[0], bf[1]);
          mma_bf16(dt[1], vf[k], bf[2], bf[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? j0 : j1, i = qb * 16 + nt * 8 + 2 * t + (e & 1);
            float p = 0.f, dsv = 0.f;
            if (i < N && j < N) {
              float s = st[nt][e] * scale + bias[(size_t)i * N + j];
              if (mask != nullptr) s += mask[(size_t)i * N + j];
              const float l = lrow[i];
              p = fa_div(ex2_ftz((s - mrow[i]) * kLog2e), l, 1.f / l);
              dsv = p * (dt[nt][e] - rrow[i]);
            }
            st[nt][e] = p;
            dt[nt][e] = dsv * scale;
          }
        uint32_t pf[4], sf[4];
        rows_a_frag(st, pf);
        rows_a_frag(dt, sf);
#pragma unroll
        for (int nq = 0; nq < kKs; ++nq) {
          uint32_t bf[4];
          ldsm_x4_t(bf, b_frag_row_kn(ds_ + (size_t)qb * 16 * kLd + nq * 16, kLd, lane));
          mma_bf16(dv[2 * nq], pf, bf[0], bf[1]);
          mma_bf16(dv[2 * nq + 1], pf, bf[2], bf[3]);
          ldsm_x4_t(bf, b_frag_row_kn(qs + (size_t)qb * 16 * kLd + nq * 16, kLd, lane));
          mma_bf16(dk[2 * nq], sf, bf[0], bf[1]);
          mma_bf16(dk[2 * nq + 1], sf, bf[2], bf[3]);
        }
      }
      strip_store<kHt>(dk, dqkv, C3, j0, j1, N, C + h * kHd, t);
      strip_store<kHt>(dv, dqkv, C3, j0, j1, N, 2 * C + h * kHd, t);
      strip_colsum<kHt>(dk, j0 < N, j1 < N, csum + strip * 3 * kHd + kHd, lane);
      strip_colsum<kHt>(dv, j0 < N, j1 < N, csum + strip * 3 * kHd + 2 * kHd, lane);
    }
    __syncthreads();

    for (int j = tid; j < 3 * kHd; j += kRowsThreads) {
      float s = 0.f;
      for (int st = 0; st < nblk; ++st) s += csum[st * 3 * kHd + j];
      a.dqkvb_part[(size_t)w * C3 + (j / kHd) * C + h * kHd + j % kHd] = s;
    }
    __syncthreads();  // the next window reuses the shared tiles
  }
}

__global__ void __launch_bounds__(kRowsThreads) rows_bwd_f32_kernel(RowsBwdArgs a) {
  extern __shared__ __align__(16) float smf[];
  const int N = a.N, C = a.C, C3 = 3 * C, nh = a.nh, hd = C / nh, hdp = hd;
  const int chunk = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  float* qs = smf;  // q, k, v, do of the head: N x hd each
  float* ks = qs + (size_t)N * hdp;
  float* vs = ks + (size_t)N * hdp;
  float* das = vs + (size_t)N * hdp;
  float* mrow = das + (size_t)N * hdp;
  float* lrow = mrow + N;
  float* rrow = lrow + N;
  float* pw = rrow + N + (size_t)warp * 2 * N;  // this warp's P and dss of one row
  float* sw = pw + N;
  const float* bias = a.bias + (size_t)h * N * N;
  float* dbias = a.dbias_part + ((size_t)chunk * nh + h) * N * N;
  const float scale = a.scale;
  const int w_begin = chunk * a.chunk, w_end = min(a.Bn, w_begin + a.chunk);

  for (int w = w_begin; w < w_end; ++w) {
    const float* qkv = static_cast<const float*>(a.qkv) + (size_t)w * N * C3;
    const float* doa = static_cast<const float*>(a.doa) + (size_t)w * N * C;
    float* o = static_cast<float*>(a.o) + (size_t)w * N * C;
    float* dqkv = static_cast<float*>(a.dqkv) + (size_t)w * N * C3;
    const float* mask = a.mask != nullptr ? a.mask + (size_t)(w % a.nW) * N * N : nullptr;
    const bool first = w == w_begin;
    for (int e = tid; e < 4 * N * hd; e += kRowsThreads) {
      const int part = e / (N * hd), r = (e / hd) % N, d = e % hd;
      qs[((size_t)part * N + r) * hdp + d] =
          part < 3 ? qkv[(size_t)r * C3 + part * C + h * hd + d] : doa[(size_t)r * C + h * hd + d];
    }
    __syncthreads();
    auto dot = [&](const float* u, const float* v) {
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += u[d] * v[d];
      return s;
    };
    auto score = [&](int i, int j) {
      float s = dot(qs + i * hdp, ks + j * hdp) * scale + bias[(size_t)i * N + j];
      if (mask != nullptr) s += mask[(size_t)i * N + j];
      return s;
    };

    // phase A: a warp per query row
    for (int i = warp; i < N; i += kRowsWarps) {
      float m = -INFINITY, l = 0.f;
      for (int j = lane; j < N; j += kWarp) {
        const float s = score(i, j), nm = fmaxf(m, s);
        l = l * expf(m - nm) + expf(s - nm);
        m = nm;
      }
      const float M = warp_max(m);
      const float L = warp_sum(m == -INFINITY ? 0.f : l * expf(m - M)), R = 1.f / L;
      float r = 0.f;
      for (int j = lane; j < N; j += kWarp) {
        const float p = fa_div(expf(score(i, j) - M), L, R);
        const float dp = dot(das + i * hdp, vs + j * hdp);
        pw[j] = p;
        sw[j] = dp;
        r += p * dp;
      }
      r = warp_sum(r);
      for (int j = lane; j < N; j += kWarp) {
        const float dsv = pw[j] * (sw[j] - r);
        float* db = dbias + (size_t)i * N + j;
        *db = first ? dsv : *db + dsv;
        sw[j] = dsv * scale;
      }
      __syncwarp();
      for (int d = lane; d < hd; d += kWarp) {
        float oa = 0.f, dq = 0.f;
        for (int j = 0; j < N; ++j) {
          oa += pw[j] * vs[j * hdp + d];
          dq += sw[j] * ks[j * hdp + d];
        }
        o[(size_t)i * C + h * hd + d] = oa;
        dqkv[(size_t)i * C3 + h * hd + d] = dq;
      }
      if (lane == 0) mrow[i] = M, lrow[i] = L, rrow[i] = r;
      __syncwarp();
    }
    __syncthreads();

    // phase B: a warp per key row
    for (int j = warp; j < N; j += kRowsWarps) {
      for (int i = lane; i < N; i += kWarp) {
        const float l = lrow[i];
        const float p = fa_div(expf(score(i, j) - mrow[i]), l, 1.f / l);
        pw[i] = p;
        sw[i] = p * (dot(das + i * hdp, vs + j * hdp) - rrow[i]) * scale;
      }
      __syncwarp();
      for (int d = lane; d < hd; d += kWarp) {
        float dk = 0.f, dv = 0.f;
        for (int i = 0; i < N; ++i) {
          dk += sw[i] * qs[i * hdp + d];
          dv += pw[i] * das[i * hdp + d];
        }
        dqkv[(size_t)j * C3 + C + h * hd + d] = dk;
        dqkv[(size_t)j * C3 + 2 * C + h * hd + d] = dv;
      }
      __syncwarp();
    }
    __syncthreads();  // this block's dqkv rows are visible to its threads

    for (int j = tid; j < 3 * hd; j += kRowsThreads) {
      const int col = (j / hd) * C + h * hd + j % hd;
      float s = 0.f;
      for (int i = 0; i < N; ++i) s += dqkv[(size_t)i * C3 + col];
      a.dqkvb_part[(size_t)w * C3 + col] = s;
    }
    __syncthreads();
  }
}

struct RowsBwdWs {
  size_t qkv, doa, o, dqkv, dqkvb, dbias, atb, bytes;
};

inline RowsBwdWs rows_bwd_ws(int Bn, int N, int C, int nh, int is_bf16) {
  const size_t T = (size_t)Bn * N, es = is_bf16 ? 2 : 4;
  RowsBwdWs l;
  size_t o = 0;
  l.qkv = o;   o = align256(o + T * 3 * C * es);
  l.doa = o;   o = align256(o + T * C * es);
  l.o = o;     o = align256(o + T * C * es);
  l.dqkv = o;  o = align256(o + T * 3 * C * es);
  l.dqkvb = o; o = align256(o + sizeof(float) * (size_t)Bn * 3 * C);
  l.dbias = o; o = align256(o + sizeof(float) * (size_t)rows_bwd_chunks(Bn, nh) * nh * N * N);
  l.atb = o;   o = align256(o + sizeof(float) * atb_partial_floats((int)T, C, 3 * C));
  l.bytes = o;
  return l;
}

template <int kHd>
cudaError_t launch_rows_bwd_bf16(const RowsBwdArgs& a, unsigned blocks, size_t smem,
                                 cudaStream_t s) {
  const cudaError_t err = allow_smem(rows_bwd_bf16_kernel<kHd>, smem);
  if (err != cudaSuccess) return err;
  rows_bwd_bf16_kernel<kHd><<<blocks, kRowsThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace vadcl

extern "C" {

long long vadcl_window_attn_bwd_rows_smem_bytes(int n, int c, int nh, int is_bf16) {
  return (long long)vadcl::rows_bwd_smem(n, c, nh, is_bf16);
}

long long vadcl_window_attn_bwd_rows_workspace_bytes(int Bn, int N, int C, int nh, int is_bf16) {
  return (long long)vadcl::rows_bwd_ws(Bn, N, C, nh, is_bf16).bytes;
}

// Bytes of the d(bias) partials inside that workspace.
long long vadcl_window_attn_bwd_rows_dbias_bytes(int Bn, int N, int nh) {
  return (long long)sizeof(float) * vadcl::rows_bwd_chunks(Bn, nh) * nh * N * N;
}

// Kernel 8, row-tiled.  qkv_wt and proj_wt are W_qkv^T (3C, C) and W_proj^T
// (C, C), contiguous, in the compute dtype.
int vadcl_window_attn_bwd_rows(const void* x, const void* dout, const void* qkv_w,
                               const float* qkv_b, const void* qkv_wt, const void* proj_wt,
                               const float* bias, const float* mask, void* dx, float* dqkv_w,
                               float* dqkv_b, float* dproj_w, float* dproj_b, float* dbias,
                               void* workspace, int Bn, int N, int C, int nh, int nW,
                               float scale, int is_bf16, void* stream) {
  using namespace vadcl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bn <= 0 || N <= 0 || nh <= 0 || C % nh != 0 || nW <= 0) return cudaErrorInvalidValue;
  if (is_bf16 && !rows_bf16_eligible(C, nh)) return cudaErrorInvalidValue;
  const size_t smem = rows_bwd_smem(N, C, nh, is_bf16);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  const RowsBwdWs l = rows_bwd_ws(Bn, N, C, nh, is_bf16);
  char* ws = static_cast<char*>(workspace);
  const int T = Bn * N, chunks = rows_bwd_chunks(Bn, nh);
  cudaError_t err;
  if ((err = launch_rows_gemm(x, qkv_w, qkv_b, ws + l.qkv, T, C, 3 * C, 0, 1.f, is_bf16, s)))
    return err;
  if ((err = launch_rows_gemm(dout, proj_wt, nullptr, ws + l.doa, T, C, C, 0, 1.f, is_bf16, s)))
    return err;
  const RowsBwdArgs a{ws + l.qkv, ws + l.doa, bias, mask, ws + l.o, ws + l.dqkv,
                      reinterpret_cast<float*>(ws + l.dqkvb),
                      reinterpret_cast<float*>(ws + l.dbias),
                      Bn, N, C, nh, nW, rows_bwd_chunk(Bn, nh), scale};
  const unsigned blocks = (unsigned)(chunks * nh);
  if (is_bf16) {
    switch (C / nh) {
      case 16: err = launch_rows_bwd_bf16<16>(a, blocks, smem, s); break;
      case 32: err = launch_rows_bwd_bf16<32>(a, blocks, smem, s); break;
      case 48: err = launch_rows_bwd_bf16<48>(a, blocks, smem, s); break;
      default: err = launch_rows_bwd_bf16<64>(a, blocks, smem, s); break;
    }
  } else {
    if ((err = allow_smem(rows_bwd_f32_kernel, smem)) != cudaSuccess) return err;
    rows_bwd_f32_kernel<<<blocks, kRowsThreads, smem, s>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;

  float* part = reinterpret_cast<float*>(ws + l.atb);
  if ((err = launch_atb(x, is_bf16, a.dqkv, is_bf16, T, C, 3 * C, part, dqkv_w, s))) return err;
  if ((err = launch_atb(a.o, is_bf16, dout, is_bf16, T, C, C, part, dproj_w, s))) return err;
  if ((err = launch_atb(nullptr, 0, dout, is_bf16, T, 1, C, part, dproj_b, s))) return err;
  if ((err = launch_sum_rows(a.dqkvb_part, dqkv_b, Bn, 3 * C, 3 * C, s))) return err;
  if ((err = launch_sum_rows(a.dbias_part, dbias, chunks, (long long)nh * N * N,
                             (long long)nh * N * N, s)))
    return err;
  return launch_rows_gemm(a.dqkv, qkv_wt, nullptr, dx, T, 3 * C, C, 0, 1.f, is_bf16, s);
}

}  // extern "C"
