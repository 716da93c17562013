// Kernels F and H in f32: fused k-nearest-neighbour search (distance
// products and a running top-k in one pass).
//
// Replaces the TPU kernels opencv_dlco_tpu/ops/knn_pallas.py::_knn2_kernel
// (entry point knn2_fused, kernel F) and ::_knnk_kernel (entry point
// knnk_fused, kernel H), both driven by _fused_call, in their f32 mode
// (HIGHEST parity); the bf16 modes run knn_topk.cu. For queries q (B, N, D)
// and train rows t (B, M, D):
//   dist[n, m] = max(|q_n|^2 + |t_m|^2 - 2 q_n . t_m, 0)
// and per query the k smallest (dist, m) in lexicographic order (equal
// distances go to the lowest train index, as the TPU kernels' masked-min
// and keep-the-running-entry merge do), ascending; (inf, -1) fills the
// slots of a query with fewer than k real neighbours. No (N, M) matrix
// exists anywhere.
//
// Products are true f32 FFMA (no TF32); the norms are f32 sums.
//
// Bound on an H100 at 8,192 x 8,192, d = 64: the products are 2 N M d =
// 8.6 GFLOP, 0.13 ms at 67 TFLOP/s; the epilogue and the selection are ~4
// instructions per (n, m) on the CUDA cores, none an FMA, 0.27 G, 8 us at
// 33.5 T instructions/s. So the products bound it.
//
// Design: a first pass writes every row's squared norm (one warp per row).
// Then a CTA owns 128 queries and loops over the train rows in tiles of 64;
// that loop replaces the TPU grid's sequential train axis. D goes in chunks
// of at most 128 elements, so any width fits shared memory: with one chunk
// (every exported width) the queries stay in shared memory for the whole
// run; with more, each step (tile, chunk) copies the
// query chunk beside the train chunk and the products accumulate over the
// chunks of a tile. Each step reaches shared memory by cp.async into one of
// two buffers, so the next step's copy is in flight while this one
// computes, and one barrier per step orders the two. A warp owns 16
// queries x the tile's 64 rows in mma.sync's m16n8 accumulator layout, by
// FFMA (with g = lane / 4, q = lane % 4, slice j: rows g and g + 8, columns
// 8 j + 2 q + {0, 1}), and each thread turns its own accumulators
// into distances and folds them into a sorted top-KMAX (KMAX = 2, 4, 8 or
// 16 >= k) per query row it holds, in registers: no distance tile in shared
// memory. At the end the four lists of a query (one per thread of a quad)
// merge through warp shuffles. The batch is grid axis z with explicit
// strides. Ragged edges are bounds checks: padding rows are zero-filled by
// the copies and never selected.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TQ = 128;  // queries per CTA (8 warps x 16)
constexpr int TB = 64;   // train rows per tile
constexpr int NTHREADS = 256;
constexpr int IMAX = 0x7fffffff;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// widest D chunk in shared memory (two query and two train chunks fit)
constexpr int MAX_CHUNK = 128;

// shared-memory row stride in elements: padded by 1 (odd stride)
__host__ __device__ constexpr int row_stride(int d) { return d + 1; }

__host__ __device__ size_t rows_bytes(int rows, int d) {
  return align16(static_cast<size_t>(rows) * row_stride(d) * 4);
}

__host__ __device__ int n_chunks(int d) {
  return (d + MAX_CHUNK - 1) / MAX_CHUNK;
}

// the width of a chunk's rows in shared memory
__host__ __device__ int chunk_width(int d) {
  return n_chunks(d) == 1 ? d : MAX_CHUNK;
}

// one query region (resident) or two (one per buffer), two train regions
size_t smem_bytes(int d) {
  const int dc = chunk_width(d);
  return (n_chunks(d) == 1 ? 1 : 2) * rows_bytes(TQ, dc) +
         2 * rows_bytes(TB, dc);
}

// global -> shared copies that bypass registers; src_bytes 0 fills the
// destination with zeros (a padding row)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// start the copies of columns k0 .. k0 + cw - 1 of rows r0 .. r0 + ROWS - 1
// (of `rows`) into dst at row stride str, NTHREADS / ROWS threads per row;
// rows past the end are zero-filled
template <int ROWS>
__device__ __forceinline__ void load_rows_async(unsigned char* dst_raw,
                                                const float* base, int r0,
                                                int rows, int k0, int cw,
                                                int str, long long rs) {
  constexpr int TPR = NTHREADS / ROWS;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bool real = r0 + r < rows;
  const float* src = real ? base + (r0 + r) * rs + k0 : base;
  float* dst = reinterpret_cast<float*>(dst_raw) + r * str;
  for (int kk = part; kk < cw; kk += TPR)
    cp_async4(dst + kk, real ? src + kk : base, real ? 4 : 0);
}

__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// insert (d, i) into the ascending list (ld, li) if it belongs there
template <int KMAX>
__device__ __forceinline__ void insert(float (&ld)[KMAX], int (&li)[KMAX],
                                       float d, int i) {
  if (!lex_less(d, i, ld[KMAX - 1], li[KMAX - 1])) return;
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (lex_less(d, i, ld[s - 1], li[s - 1])) {
      ld[s] = ld[s - 1];
      li[s] = li[s - 1];
    } else if (lex_less(d, i, ld[s], li[s])) {
      ld[s] = d;
      li[s] = i;
    }
  }
  if (lex_less(d, i, ld[0], li[0])) {
    ld[0] = d;
    li[0] = i;
  }
}

// (|q|^2 + |t|^2) - 2 q.t, clamped at 0, with no FMA contraction
__device__ __forceinline__ float sq_dist(float nq, float nt, float g) {
  return fmaxf(__fsub_rn(__fadd_rn(nq, nt), __fmul_rn(2.f, g)), 0.f);
}

// k rounds over the four lists of a quad (lanes 4g .. 4g + 3): the lowest
// head wins and its owner pops it; the writer lane stores the row's k
// entries
template <int KMAX>
__device__ __forceinline__ void merge_quad(float (&ld)[KMAX],
                                           int (&li)[KMAX], int k,
                                           bool writer, float* od, int* oi) {
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r < k) {
      float bd = ld[0];
      int bi = li[0];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float d2 = __shfl_xor_sync(0xffffffffu, bd, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
        if (lex_less(d2, i2, bd, bi)) {
          bd = d2;
          bi = i2;
        }
      }
      if (bd == ld[0] && bi == li[0]) {  // only sentinels tie across lists
#pragma unroll
        for (int s = 0; s < KMAX - 1; ++s) {
          ld[s] = ld[s + 1];
          li[s] = li[s + 1];
        }
        ld[KMAX - 1] = INFINITY;
        li[KMAX - 1] = IMAX;
      }
      if (writer) {
        const bool real = isfinite(bd) && bi != IMAX;
        od[r] = real ? bd : INFINITY;
        oi[r] = real ? bi : -1;
      }
    }
  }
}

// squared norm of every row of x (B, rows, D): one warp per row
__global__ void __launch_bounds__(NTHREADS)
sq_norms_kernel(const float* __restrict__ x, float* __restrict__ out,
                int rows, int d, long long bs, long long rs) {
  const int r = blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* p = x + blockIdx.z * bs + r * rs;
  float s = 0.f;
  for (int kk = lane; kk < d; kk += 32) {
    const float v = p[kk];
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[static_cast<size_t>(blockIdx.z) * rows + r] = s;
}

template <int KMAX>
__global__ void __launch_bounds__(NTHREADS, KMAX <= 2 ? 4 : 2)
knn_kernel(const float* __restrict__ qv, const float* __restrict__ tv,
           const float* __restrict__ qn, const float* __restrict__ tn,
           float* __restrict__ out_d, int* __restrict__ out_i, int n, int m,
           int d, int k, long long q_bs, long long q_rs, long long t_bs,
           long long t_rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qq = lane & 3;
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * TQ;
  const int nch = n_chunks(d);
  const int dc = chunk_width(d);
  const int str = row_stride(dc);
  const size_t qbytes = rows_bytes(TQ, dc);
  const size_t tbytes = rows_bytes(TB, dc);
  unsigned char* qs_raw = smem;
  unsigned char* ts_raw = smem + (nch == 1 ? 1 : 2) * qbytes;
  const float* q = qv + b * q_bs;
  const float* t = tv + b * t_bs;
  tn += static_cast<size_t>(b) * m;

  // a step is (train tile from row m0, D chunk c); step s's copies go to
  // buffer s & 1, the query chunk too when there is more than one chunk
  const int steps = (m + TB - 1) / TB * nch;
  auto load_step = [&](int m0, int c, int buf) {
    const int k0 = c * dc, cw = min(dc, d - k0);
    if (nch > 1)
      load_rows_async<TQ>(qs_raw + buf * qbytes, q, n0, n, k0, cw, str, q_rs);
    load_rows_async<TB>(ts_raw + buf * tbytes, t, m0, m, k0, cw, str, t_rs);
    cp_async_commit();
  };
  // one chunk: the CTA's queries, once, in the first step's copy group
  if (nch == 1) load_rows_async<TQ>(qs_raw, q, n0, n, 0, d, str, q_rs);
  if (steps > 0) load_step(0, 0, 0);

  // this thread's two query rows and their norms
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const size_t qrow = static_cast<size_t>(b) * n + n0;
  const float nq0 = n0 + r0 < n ? qn[qrow + r0] : 0.f;
  const float nq1 = n0 + r1 < n ? qn[qrow + r1] : 0.f;

  float ld0[KMAX], ld1[KMAX];
  int li0[KMAX], li1[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    ld0[s] = ld1[s] = INFINITY;
    li0[s] = li1[s] = IMAX;
  }

  float acc[8][4];
  for (int s = 0, m0 = 0, c = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s arrived; step s - 1's reads are done
    const bool last_chunk = c == nch - 1;
    if (s + 1 < steps)
      load_step(last_chunk ? m0 + TB : m0, last_chunk ? 0 : c + 1,
                (s + 1) & 1);
    const int cw = min(dc, d - c * dc);
    const unsigned char* qcur = qs_raw + (nch == 1 ? 0 : (s & 1) * qbytes);
    const unsigned char* cur = ts_raw + (s & 1) * tbytes;

    // -- products: rows r0, r1 x columns j*8 + 2*qq + {0, 1} ------------------
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    {
      const float* qs = reinterpret_cast<const float*>(qcur);
      const float* ts = reinterpret_cast<const float*>(cur);
      for (int kk = 0; kk < cw; ++kk) {
        const float a0 = qs[r0 * str + kk], a1 = qs[r1 * str + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bv = ts[(j * 8 + 2 * qq + e) * str + kk];
            acc[j][e] = fmaf(a0, bv, acc[j][e]);
            acc[j][2 + e] = fmaf(a1, bv, acc[j][2 + e]);
          }
      }
    }

    // -- after a tile's last chunk: distances folded into the running top-k,
    // in registers ---------------------------------------------------------
    if (!last_chunk) {
      ++c;
      continue;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = m0 + j * 8 + 2 * qq + e;
        if (col < m) {
          const float nt = tn[col];
          insert<KMAX>(ld0, li0, sq_dist(nq0, nt, acc[j][e]), col);
          insert<KMAX>(ld1, li1, sq_dist(nq1, nt, acc[j][2 + e]), col);
        }
      }
    c = 0;
    m0 += TB;
  }

  const size_t obase = (qrow + r0) * k;
  merge_quad<KMAX>(ld0, li0, k, qq == 0 && n0 + r0 < n, out_d + obase,
                   out_i + obase);
  merge_quad<KMAX>(ld1, li1, k, qq == 0 && n0 + r1 < n,
                   out_d + obase + 8 * k, out_i + obase + 8 * k);
}

int launch_norms(const float* x, float* out, int batch, int rows, int d,
                 long long bs, long long rs, cudaStream_t stream) {
  if (rows == 0) return 0;
  const int per = NTHREADS / 32;
  const dim3 grid((rows + per - 1) / per, 1, batch);
  sq_norms_kernel<<<grid, NTHREADS, 0, stream>>>(x, out, rows, d, bs, rs);
  return static_cast<int>(cudaGetLastError());
}

template <int KMAX>
int launch(const float* q, const float* t, float* qn, float* tn, void* od,
           void* oi, int batch, int n, int m, int d, int k, long long q_bs,
           long long q_rs, long long t_bs, long long t_rs,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = launch_norms(q, qn, batch, n, d, q_bs, q_rs, stream);
  if (rc) return rc;
  rc = launch_norms(t, tn, batch, m, d, t_bs, t_rs, stream);
  if (rc) return rc;
  auto kern = knn_kernel<KMAX>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + TQ - 1) / TQ, 1, batch);
  kern<<<grid, NTHREADS, smem, stream>>>(
      q, t, qn, tn, static_cast<float*>(od), static_cast<int*>(oi), n, m, d,
      k, q_bs, q_rs, t_bs, t_rs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, N, D) and t (B, M, D) f32, rows contiguous in D, element (b, i, :)
// at base + b * bs + i * rs; qn (B, N) and tn (B, M) f32 scratch for the
// norms; od (B, N, k) f32 and oi (B, N, k) i32 contiguous. 1 <= k <= 16,
// N >= 1, D >= 1 of any width. Returns a CUDA error code (0 on success)
// after the launches; cudaErrorInvalidValue for arguments outside these
// limits or a shared-memory need above the device's opt-in limit.
extern "C" int knn_launch(const void* q, const void* t, void* qn, void* tn,
                          void* od, void* oi, int batch, int n, int m, int d,
                          int k, long long q_bs, long long q_rs,
                          long long t_bs, long long t_rs, void* stream) {
  if (k < 1 || k > 16 || n < 1 || batch < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* tf = static_cast<const float*>(t);
  float* qnf = static_cast<float*>(qn);
  float* tnf = static_cast<float*>(tn);
#define KNN_ARGS                                                        \
  qf, tf, qnf, tnf, od, oi, batch, n, m, d, k, q_bs, q_rs, t_bs, t_rs, s
  if (k <= 2) return launch<2>(KNN_ARGS);
  if (k <= 4) return launch<4>(KNN_ARGS);
  if (k <= 8) return launch<8>(KNN_ARGS);
  return launch<16>(KNN_ARGS);
#undef KNN_ARGS
}
