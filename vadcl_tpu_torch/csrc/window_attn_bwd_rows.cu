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
//      workspace (window_rows.cuh:launch_rows_gemm; bf16 on the forward's
//      rows_fwd_gemm_kernel; W_proj^T and W_qkv^T come transposed from the
//      wrapper);
//   2. the core, which writes o, dqkv, the per-window dqkv column sums and
//      the d(bias) partials.  bf16 at head width 16, 32, 48 or 64 and C a
//      multiple of 16: window_attn_bwd_rows_mma.cu (a block per head walking
//      groups of windows that share a mask index, the strips' bias and mask
//      staged once per group, d(bias) summed over the group on chip; above
//      N = 512 a block per chunk of windows reading them from device memory).
//      fp32 (the exact comparisons), and bf16 at every other width, here:
//      rows_bwd_f32_kernel<T>, one block per (chunk of consecutive windows,
//      head), a query (then key) row per warp on CUDA cores, expf, the
//      division fa_div, d(bias) added into the chunk's partial per window;
//      it writes dqkv unrounded in fp32 (its column sums are dqkv_b's), and
//      in bf16 round_dqkv_kernel then rounds it into the bf16 copy the
//      products read.  Where q, K, V and dout's slice of one head outgrow
//      227 KB (a head of 144 channels or wider at N = 98, 292 at N = 49),
//      rows_bwd_stream_kernel<T> streams the head's channels too, with the
//      same grid, arithmetic and outputs: each phase walks its rows eight at
//      a time (a row a warp) and builds the rows' scores and dp = do . v^T
//      over chunks of kRsDepth channels (a chunk of each of the two operands
//      in shared memory, the partial dot products kept per row and column in
//      channel order: the whole-head core's chains of fmas), then o and dq
//      (phase A) or dk and dv (phase B) chunk by chunk.  Its block holds two
//      chunk tiles, the pass's two row chunks, two rows a warp and the row
//      statistics: 340 N + 2048 bytes whatever the head width (N up to 677);
//   3. the deterministic second pass: dqkv_w = x^T . dqkv and dproj_w =
//      o^T . do with dproj_b = colsum(do), behind the tensor-core core on
//      the tensor cores (reduce_mma.cu: exact bf16 products, fp32 sums over
//      1024-token chunks in order), behind the CUDA-core core on CUDA cores
//      (reduce.cu); the per-window dqkv_b and the d(bias) partials summed in
//      a fixed order (sum_rows);
//   4. dx = round(round(dqkv) . W_qkv^T), as launch 1.
//
// The d(bias) partials are nH x N x N floats per block of the core's grid
// (bf16 staged: per block walking groups, at most rows_bwd_chunks of them;
// otherwise per chunk of consecutive windows): at most ceil(264 / nH), so at
// N = 392 and a training batch of 4 the workspace holds 43 x 6 partials
// (158.6 MB) where one per window would be 944 MB, and 22 x 12 (162.3 MB) at
// 12 heads (chip_smoke.py prints the sizes).
//
// What bounds the fp32 core: each window's block walks the keys twice and
// the queries once and rewrites its chunk's d(bias) partial per window; the
// streamed core also reads the head's four operands once per eight rows of
// each phase (from L2).
#include "reduce.cuh"
#include "reduce_mma.cuh"
#include "window_attn_bwd_rows_mma.cuh"

namespace vadcl {

struct RowsBwdArgs {
  const void* qkv;    // (T, 3C) round(x . W_qkv + b)
  const void* doa;    // (T, C) round(dout . W_proj^T)
  const float* bias;  // (nH, N, N)
  const float* mask;  // (nW, N, N) or null
  void* o;            // (T, C) round(p . v), all heads
  void* dqkv;         // (T, 3C) dq | dk | dv (the CUDA-core core: fp32, unrounded)
  float* dqkvb_part;  // (Bn, 3C) per-window column sums of the unrounded dqkv
  float* dbias_part;  // (chunks, nH, N, N)
  int Bn, N, C, nh, nW, chunk;
  float scale;
};

// The CUDA-core cores' shared memory: q, K, V and dout's slice of the whole
// head, rows unpadded so that head width 32 fits at N = 392 (the whole-head
// core), or two chunk tiles of kRsDepth channels, two row chunks and two rows
// a warp (the streamed core); both with the row statistics.
inline size_t rows_f32_bwd_smem(int n, int hd) {
  return sizeof(float) * (4 * (size_t)n * hd + 3 * (size_t)n + 2 * (size_t)kRowsWarps * n);
}
inline size_t rows_stream_bwd_smem(int n) {
  return sizeof(float) * (2 * (size_t)n * (kRsDepth + 1) + 2 * (size_t)kRowsWarps * kRsDepth +
                          2 * (size_t)kRowsWarps * n + 3 * (size_t)n);
}
// Whether the CUDA-core core streams the head's channels: where the
// whole-head core's block outgrows 227 KB.
inline bool rows_bwd_streams(int n, int hd) {
  return rows_f32_bwd_smem(n, hd) > (size_t)kMaxSmemBytes;
}

// Shared memory of one attention-core block (the bf16 tensor-core core: the
// direct layout, the least it needs; the CUDA-core core: the whole head, else
// the streamed layout).
inline size_t rows_bwd_smem(int n, int c, int nh, int is_bf16) {
  const int hd = c / nh;
  if (is_bf16 && rows_bf16_eligible(c, nh)) return rows_bwd_layout(n, hd, 0).bytes;
  return rows_bwd_streams(n, hd) ? rows_stream_bwd_smem(n) : rows_f32_bwd_smem(n, hd);
}

// T: the compute dtype of qkv, do and o; p and ds * scale round to it where
// they enter a product, as in window_attn_bwd.cu's CUDA-core body.
template <typename T>
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
    const T* qkv = static_cast<const T*>(a.qkv) + (size_t)w * N * C3;
    const T* doa = static_cast<const T*>(a.doa) + (size_t)w * N * C;
    T* o = static_cast<T*>(a.o) + (size_t)w * N * C;
    float* dqkv = static_cast<float*>(a.dqkv) + (size_t)w * N * C3;
    const float* mask = a.mask != nullptr ? a.mask + (size_t)(w % a.nW) * N * N : nullptr;
    const bool first = w == w_begin;
    for (int e = tid; e < 4 * N * hd; e += kRowsThreads) {
      const int part = e / (N * hd), r = (e / hd) % N, d = e % hd;
      qs[((size_t)part * N + r) * hdp + d] = to_f(
          part < 3 ? qkv[(size_t)r * C3 + part * C + h * hd + d] : doa[(size_t)r * C + h * hd + d]);
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
        sw[j] = round_to<T>(dsv * scale);
      }
      __syncwarp();
      for (int d = lane; d < hd; d += kWarp) {
        float oa = 0.f, dq = 0.f;
        for (int j = 0; j < N; ++j) {
          oa += round_to<T>(pw[j]) * vs[j * hdp + d];
          dq += sw[j] * ks[j * hdp + d];
        }
        o[(size_t)i * C + h * hd + d] = from_f<T>(oa);
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
        sw[i] = round_to<T>(p * (dot(das + i * hdp, vs + j * hdp) - rrow[i]) * scale);
      }
      __syncwarp();
      for (int d = lane; d < hd; d += kWarp) {
        float dk = 0.f, dv = 0.f;
        for (int i = 0; i < N; ++i) {
          dk += sw[i] * qs[i * hdp + d];
          dv += round_to<T>(pw[i]) * das[i * hdp + d];
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

// The same function with the head's channels streamed (see the header).  Per
// window: phase A walks the queries in passes of kRowsWarps rows (a row a
// warp), summing each row's scores q . k^T and dp = do . v^T over chunks of
// K and V, then its softmax statistics, P, ds, d(bias) and round(ds * scale)
// as the whole-head core does, then o and dq chunk by chunk over V and K;
// phase B walks the keys the same way over chunks of q and do, then dk and
// dv.  Every loop that holds a __syncthreads is block-uniform.
template <typename T>
__global__ void __launch_bounds__(kRowsThreads) rows_bwd_stream_kernel(RowsBwdArgs a) {
  extern __shared__ __align__(16) float smf[];
  constexpr int kLd = kRsDepth + 1;  // chunk rows padded: lanes read rows 33 floats apart
  const int N = a.N, C = a.C, C3 = 3 * C, nh = a.nh, hd = C / nh;
  const int chunk = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  float* ta = smf;                          // N x kLd: a chunk of K (phase A) or q (B)
  float* tb = ta + (size_t)N * kLd;         // N x kLd: a chunk of V (A) or do (B)
  float* ra = tb + (size_t)N * kLd + warp * kRsDepth;  // this warp's row chunk of q (A) or k (B)
  float* rb = ra + kRowsWarps * kRsDepth;              //   ... of do (A) or v (B)
  float* mrow = tb + (size_t)N * kLd + 2 * kRowsWarps * kRsDepth;
  float* lrow = mrow + N;
  float* rrow = lrow + N;
  float* pw = rrow + N + (size_t)warp * 2 * N;  // this warp's row: scores, then P
  float* sw = pw + N;                           //   dp, then round(ds * scale)
  const float* bias = a.bias + (size_t)h * N * N;
  float* dbias = a.dbias_part + ((size_t)chunk * nh + h) * N * N;
  const float scale = a.scale;
  const int w_begin = chunk * a.chunk, w_end = min(a.Bn, w_begin + a.chunk);

  for (int w = w_begin; w < w_end; ++w) {
    const T* qkv = static_cast<const T*>(a.qkv) + (size_t)w * N * C3;
    const T* doa = static_cast<const T*>(a.doa) + (size_t)w * N * C;
    T* o = static_cast<T*>(a.o) + (size_t)w * N * C;
    float* dqkv = static_cast<float*>(a.dqkv) + (size_t)w * N * C3;
    const float* mask = a.mask != nullptr ? a.mask + (size_t)(w % a.nW) * N * N : nullptr;
    const bool first = w == w_begin;
    // operand `part` (0 q, 1 k, 2 v, 3 do) of row r, channel d of the head
    auto at = [&](int part, int r, int d) {
      return to_f(part < 3 ? qkv[(size_t)r * C3 + part * C + h * hd + d]
                           : doa[(size_t)r * C + h * hd + d]);
    };
    // chunk c0 .. c0 + dc of two operands (all rows) into ta and tb, and of
    // two others at this warp's row `row` into ra and rb
    auto load = [&](int pa, int pb, int qa, int qb, int row, int c0, int dc) {
      for (int e = tid; e < N * dc; e += kRowsThreads) {
        const int r = e / dc, d = e % dc;
        ta[r * kLd + d] = at(pa, r, c0 + d);
        tb[r * kLd + d] = at(pb, r, c0 + d);
      }
      if (row < N)
        for (int d = lane; d < dc; d += kWarp) ra[d] = at(qa, row, c0 + d), rb[d] = at(qb, row, c0 + d);
    };
    // pw[j] (+)= ra . ta[j] and sw[j] (+)= rb . tb[j] over the chunk
    auto dots = [&](int c0, int dc) {
      for (int j = lane; j < N; j += kWarp) {
        float s = c0 == 0 ? 0.f : pw[j], t = c0 == 0 ? 0.f : sw[j];
        for (int d = 0; d < dc; ++d) {
          s += ra[d] * ta[j * kLd + d];
          t += rb[d] * tb[j * kLd + d];
        }
        pw[j] = s, sw[j] = t;
      }
    };

    // phase A: a warp per query row i
    for (int i0 = 0; i0 < N; i0 += kRowsWarps) {
      const int i = i0 + warp;
      for (int c0 = 0; c0 < hd; c0 += kRsDepth) {
        const int dc = min(kRsDepth, hd - c0);
        __syncthreads();
        load(1, 2, 0, 3, i, c0, dc);  // K, V; q_i, do_i
        __syncthreads();
        if (i < N) dots(c0, dc);       // pw = q_i . k_j, sw = do_i . v_j
      }
      if (i < N) {
        float m = -INFINITY, l = 0.f;
        for (int j = lane; j < N; j += kWarp) {
          float s = pw[j] * scale + bias[(size_t)i * N + j];
          if (mask != nullptr) s += mask[(size_t)i * N + j];
          pw[j] = s;
          const float nm = fmaxf(m, s);
          l = l * expf(m - nm) + expf(s - nm);
          m = nm;
        }
        const float M = warp_max(m);
        const float L = warp_sum(m == -INFINITY ? 0.f : l * expf(m - M)), R = 1.f / L;
        float r = 0.f;
        for (int j = lane; j < N; j += kWarp) {
          const float p = fa_div(expf(pw[j] - M), L, R);
          pw[j] = p;
          r += p * sw[j];
        }
        r = warp_sum(r);
        for (int j = lane; j < N; j += kWarp) {
          const float dsv = pw[j] * (sw[j] - r);
          float* db = dbias + (size_t)i * N + j;
          *db = first ? dsv : *db + dsv;
          sw[j] = round_to<T>(dsv * scale);
        }
        if (lane == 0) mrow[i] = M, lrow[i] = L, rrow[i] = r;
      }
      __syncwarp();  // (the row's P and ds are read by every lane below)
      for (int c0 = 0; c0 < hd; c0 += kRsDepth) {
        const int dc = min(kRsDepth, hd - c0);
        __syncthreads();
        load(2, 1, 0, 3, N, c0, dc);  // V, K (no row chunk)
        __syncthreads();
        if (i < N)
          for (int d = lane; d < dc; d += kWarp) {
            float oa = 0.f, dq = 0.f;
            for (int j = 0; j < N; ++j) {
              oa += round_to<T>(pw[j]) * ta[j * kLd + d];
              dq += sw[j] * tb[j * kLd + d];
            }
            o[(size_t)i * C + h * hd + c0 + d] = from_f<T>(oa);
            dqkv[(size_t)i * C3 + h * hd + c0 + d] = dq;
          }
      }
    }
    __syncthreads();  // the row statistics are complete

    // phase B: a warp per key row j
    for (int j0 = 0; j0 < N; j0 += kRowsWarps) {
      const int j = j0 + warp;
      for (int c0 = 0; c0 < hd; c0 += kRsDepth) {
        const int dc = min(kRsDepth, hd - c0);
        __syncthreads();
        load(0, 3, 1, 2, j, c0, dc);  // q, do; k_j, v_j
        __syncthreads();
        if (j < N) dots(c0, dc);       // pw[i] = k_j . q_i, sw[i] = v_j . do_i
      }
      if (j < N)
        for (int i = lane; i < N; i += kWarp) {
          float s = pw[i] * scale + bias[(size_t)i * N + j];
          if (mask != nullptr) s += mask[(size_t)i * N + j];
          const float l = lrow[i];
          const float p = fa_div(expf(s - mrow[i]), l, 1.f / l);
          pw[i] = p;
          sw[i] = round_to<T>(p * (sw[i] - rrow[i]) * scale);
        }
      __syncwarp();
      for (int c0 = 0; c0 < hd; c0 += kRsDepth) {
        const int dc = min(kRsDepth, hd - c0);
        __syncthreads();
        load(0, 3, 0, 0, N, c0, dc);  // q, do (no row chunk)
        __syncthreads();
        if (j < N)
          for (int d = lane; d < dc; d += kWarp) {
            float dk = 0.f, dv = 0.f;
            for (int i = 0; i < N; ++i) {
              dk += sw[i] * ta[i * kLd + d];
              dv += round_to<T>(pw[i]) * tb[i * kLd + d];
            }
            dqkv[(size_t)j * C3 + C + h * hd + c0 + d] = dk;
            dqkv[(size_t)j * C3 + 2 * C + h * hd + c0 + d] = dv;
          }
      }
    }
    __syncthreads();  // this block's dqkv rows are visible to its threads

    for (int e = tid; e < 3 * hd; e += kRowsThreads) {
      const int col = (e / hd) * C + h * hd + e % hd;
      float s = 0.f;
      for (int i = 0; i < N; ++i) s += dqkv[(size_t)i * C3 + col];
      a.dqkvb_part[(size_t)w * C3 + col] = s;
    }
    __syncthreads();
  }
}

// dq | dk | dv rounded to bf16, from the CUDA-core core's fp32 rows.
__global__ void round_dqkv_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                  long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

struct RowsBwdWs {
  size_t qkv, doa, o, dqkv, dqkv16, dqkvb, dbias, atb, bytes;
};

// The workspace: dqkv in the compute dtype behind the tensor-core core, in
// fp32 behind the CUDA-core core (and, in bf16, its rounded copy dqkv16).
inline RowsBwdWs rows_bwd_ws(int Bn, int N, int C, int nh, int is_bf16) {
  const size_t T = (size_t)Bn * N, es = is_bf16 ? 2 : 4;
  const bool tc = is_bf16 && rows_bf16_eligible(C, nh);
  RowsBwdWs l;
  size_t o = 0;
  l.qkv = o;   o = align256(o + T * 3 * C * es);
  l.doa = o;   o = align256(o + T * C * es);
  l.o = o;     o = align256(o + T * C * es);
  l.dqkv = o;  o = align256(o + T * 3 * C * (tc ? 2 : 4));
  l.dqkv16 = o;
  if (is_bf16 && !tc) o = align256(o + T * 3 * C * 2);
  l.dqkvb = o; o = align256(o + sizeof(float) * (size_t)Bn * 3 * C);
  l.dbias = o; o = align256(o + sizeof(float) * (size_t)rows_bwd_chunks(Bn, nh) * nh * N * N);
  l.atb = o;
  o = align256(o + sizeof(float) * (tc ? atb_mma_partial_floats((int)T, C, 3 * C)
                                       : atb_partial_floats((int)T, C, 3 * C)));
  l.bytes = o;
  return l;
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
  const bool tc = is_bf16 && rows_bf16_eligible(C, nh);
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
  float* dqkvb_part = reinterpret_cast<float*>(ws + l.dqkvb);
  float* dbias_part = reinterpret_cast<float*>(ws + l.dbias);
  float* part = reinterpret_cast<float*>(ws + l.atb);
  int partials = chunks;
  const void* dqkv = ws + l.dqkv;  // what the weight sum and dx read: round(dqkv)
  if (tc) {
    using bf16 = __nv_bfloat16;
    if ((err = launch_rows_bwd_mma_core(ws + l.qkv, ws + l.doa, bias, mask, ws + l.o,
                                        ws + l.dqkv, dqkvb_part, dbias_part, &partials, Bn, N,
                                        C, nh, nW, scale, s)))
      return err;
    const bf16* xb = static_cast<const bf16*>(x);
    if ((err = launch_atb_mma(xb, nullptr, reinterpret_cast<const bf16*>(ws + l.dqkv), nullptr,
                              T, C, 3 * C, part, dqkv_w, nullptr, s)))
      return err;
    if ((err = launch_atb_mma(reinterpret_cast<const bf16*>(ws + l.o), nullptr,
                              static_cast<const bf16*>(dout), nullptr, T, C, C, part, dproj_w,
                              dproj_b, s)))
      return err;
  } else {
    const RowsBwdArgs a{ws + l.qkv, ws + l.doa, bias, mask, ws + l.o, ws + l.dqkv,
                        dqkvb_part, dbias_part, Bn, N, C, nh, nW, rows_bwd_chunk(Bn, nh), scale};
    const unsigned grid = (unsigned)(chunks * nh);
    using Kernel = void (*)(RowsBwdArgs);
    const bool streams = rows_bwd_streams(N, C / nh);
    if (is_bf16) {
      const Kernel kernel = streams ? rows_bwd_stream_kernel<__nv_bfloat16>
                                    : rows_bwd_f32_kernel<__nv_bfloat16>;
      if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, kRowsThreads, smem, s>>>(a);
      if ((err = cudaGetLastError())) return err;
      const long long n = (long long)T * 3 * C;
      round_dqkv_kernel<<<(unsigned)((n + 1023) / 1024), 1024, 0, s>>>(
          static_cast<const float*>(a.dqkv), reinterpret_cast<__nv_bfloat16*>(ws + l.dqkv16), n);
      dqkv = ws + l.dqkv16;
    } else {
      const Kernel kernel = streams ? rows_bwd_stream_kernel<float> : rows_bwd_f32_kernel<float>;
      if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, kRowsThreads, smem, s>>>(a);
    }
    if ((err = cudaGetLastError())) return err;
    if ((err = launch_atb(x, is_bf16, dqkv, is_bf16, T, C, 3 * C, part, dqkv_w, s))) return err;
    if ((err = launch_atb(a.o, is_bf16, dout, is_bf16, T, C, C, part, dproj_w, s))) return err;
    if ((err = launch_atb(nullptr, 0, dout, is_bf16, T, 1, C, part, dproj_b, s))) return err;
  }
  if ((err = launch_sum_rows(dqkvb_part, dqkv_b, Bn, 3 * C, 3 * C, s))) return err;
  if ((err = launch_sum_rows(dbias_part, dbias, partials, (long long)nh * N * N,
                             (long long)nh * N * N, s)))
    return err;
  return launch_rows_gemm(dqkv, qkv_wt, nullptr, dx, T, 3 * C, C, 0, 1.f, is_bf16, s);
}

}  // extern "C"
