// Kernels F, G and H: fused k-nearest-neighbour search (distance products
// and a running top-k in one pass).
//
// Replaces the TPU kernels opencv_dlco_tpu/ops/knn_pallas.py::_knn2_kernel
// (entry points knn2_fused, kernel F, and with a batch knn2_fused_batched,
// kernel G, the SLAM pose chunk's C matching problems) and
// ::_knnk_kernel (entry point knnk_fused), both driven by _fused_call. For
// queries q (B, N, D) and train rows t (B, M, D):
//   dist[n, m] = max(|q_n|^2 + |t_m|^2 - 2 q_n . t_m, 0)
// and per query the k smallest (dist, m) in lexicographic order (equal
// distances go to the lowest train index, as the TPU kernels' masked-min
// and keep-the-running-entry merge do), ascending; (inf, -1) fills the
// slots of a query with fewer than k real neighbours. No (N, M) matrix
// exists anywhere.
//
// Modes: bf16 (q and t arrive rounded to bf16; the norms are sums of the
// rounded values in f32; the products run on the tensor cores as mma.sync
// m16n8k16 with f32 accumulation) and f32 (true f32 FFMA products, no
// TF32).
//
// Bound on an H100 at 65,536 x 65,536, d = 64, bf16: the products are
// 2 N M d = 0.55 TFLOP, 0.56 ms at 989 TFLOP/s; the epilogue and the
// selection are ~4 instructions per (n, m) on the CUDA cores, none an FMA,
// 17 G, 0.51 ms at 33.5 T instructions/s; the inputs are 17 MB. So the
// products bound it, and the selection's share comes close.
//
// Design: a first pass writes every row's squared norm (one warp per row).
// Then a CTA owns 128 queries and loops over the train rows in tiles of 64;
// that loop replaces the TPU grid's sequential train axis. D goes in chunks
// of at most DC elements (256 bf16, 128 f32), so any width fits shared
// memory: with one chunk (every exported width) the queries stay in shared
// memory for the whole run; with more, each step (tile, chunk) copies the
// query chunk beside the train chunk and the products accumulate over the
// chunks of a tile. Each step reaches shared memory by cp.async into one of
// two buffers, so the next step's copy is in flight while this one
// computes, and one barrier per step orders the two. A warp owns 16
// queries x the tile's 64 rows (bf16: 8 mma n8 fragments; f32: the same
// fragment layout by FFMA), and each thread turns its own accumulators
// into distances and folds them into a sorted top-KMAX (KMAX = 2, 4, 8 or
// 16 >= k) per query row it holds, in registers: no distance tile in shared
// memory. At the end the four lists of a query (one per thread of a quad)
// merge through warp shuffles. The batch is grid axis z with explicit
// strides. Ragged edges are bounds checks: padding rows are zero-filled by
// the copies and never selected.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TQ = 128;  // queries per CTA (8 warps x 16)
constexpr int TB = 64;   // train rows per tile
constexpr int NTHREADS = 256;
constexpr int IMAX = 0x7fffffff;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// shared-memory row stride in elements: bf16 rows padded by 8 (conflict-free
// fragments, 16-byte aligned rows), f32 rows by 1 (odd stride)
template <bool BF16>
__host__ __device__ constexpr int row_stride(int d) {
  return BF16 ? d + 8 : d + 1;
}

template <bool BF16>
__host__ __device__ size_t rows_bytes(int rows, int d) {
  return align16(static_cast<size_t>(rows) * row_stride<BF16>(d) *
                 (BF16 ? 2 : 4));
}

// widest D chunk in shared memory (two query and two train chunks fit)
template <bool BF16>
__host__ __device__ constexpr int max_chunk() {
  return BF16 ? 256 : 128;
}

template <bool BF16>
__host__ __device__ int n_chunks(int d) {
  return (d + max_chunk<BF16>() - 1) / max_chunk<BF16>();
}

// the width of a chunk's rows in shared memory
template <bool BF16>
__host__ __device__ int chunk_width(int d) {
  return n_chunks<BF16>(d) == 1 ? d : max_chunk<BF16>();
}

// one query region (resident) or two (one per buffer), two train regions
template <bool BF16>
size_t smem_bytes(int d) {
  const int dc = chunk_width<BF16>(d);
  return (n_chunks<BF16>(d) == 1 ? 1 : 2) * rows_bytes<BF16>(TQ, dc) +
         2 * rows_bytes<BF16>(TB, dc);
}

// global -> shared copies that bypass registers; src_bytes 0 fills the
// destination with zeros (a padding row)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
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
template <bool BF16, int ROWS>
__device__ __forceinline__ void load_rows_async(unsigned char* dst_raw,
                                                const void* x, int r0,
                                                int rows, int k0, int cw,
                                                int str, long long rs) {
  constexpr int TPR = NTHREADS / ROWS;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bool real = r0 + r < rows;
  if (BF16) {
    const bf16* base = static_cast<const bf16*>(x);
    const bf16* src = real ? base + (r0 + r) * rs + k0 : base;
    bf16* dst = reinterpret_cast<bf16*>(dst_raw) + r * str;
    for (int j = part; j < cw / 8; j += TPR)
      cp_async16(dst + 8 * j, real ? src + 8 * j : base, real ? 16 : 0);
  } else {
    const float* base = static_cast<const float*>(x);
    const float* src = real ? base + (r0 + r) * rs + k0 : base;
    float* dst = reinterpret_cast<float*>(dst_raw) + r * str;
    for (int kk = part; kk < cw; kk += TPR)
      cp_async4(dst + kk, real ? src + kk : base, real ? 4 : 0);
  }
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
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
sq_norms_kernel(const T* __restrict__ x, float* __restrict__ out, int rows,
                int d, long long bs, long long rs) {
  const int r = blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* p = x + blockIdx.z * bs + r * rs;
  float s = 0.f;
  for (int kk = lane; kk < d; kk += 32) {
    const float v = to_f32(p[kk]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[static_cast<size_t>(blockIdx.z) * rows + r] = s;
}

template <bool BF16, int KMAX>
__global__ void __launch_bounds__(NTHREADS, KMAX <= 2 ? 4 : 2)
knn_kernel(const void* __restrict__ qv, const void* __restrict__ tv,
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
  const int nch = n_chunks<BF16>(d);
  const int dc = chunk_width<BF16>(d);
  const int str = row_stride<BF16>(dc);
  const size_t qbytes = rows_bytes<BF16>(TQ, dc);
  const size_t tbytes = rows_bytes<BF16>(TB, dc);
  unsigned char* qs_raw = smem;
  unsigned char* ts_raw = smem + (nch == 1 ? 1 : 2) * qbytes;
  typedef typename std::conditional<BF16, bf16, float>::type T;
  const T* q = static_cast<const T*>(qv) + b * q_bs;
  const T* t = static_cast<const T*>(tv) + b * t_bs;
  tn += static_cast<size_t>(b) * m;

  // a step is (train tile from row m0, D chunk c); step s's copies go to
  // buffer s & 1, the query chunk too when there is more than one chunk
  const int steps = (m + TB - 1) / TB * nch;
  auto load_step = [&](int m0, int c, int buf) {
    const int k0 = c * dc, cw = min(dc, d - k0);
    if (nch > 1)
      load_rows_async<BF16, TQ>(qs_raw + buf * qbytes, q, n0, n, k0, cw, str,
                                q_rs);
    load_rows_async<BF16, TB>(ts_raw + buf * tbytes, t, m0, m, k0, cw, str,
                              t_rs);
    cp_async_commit();
  };
  // one chunk: the CTA's queries, once, in the first step's copy group
  if (nch == 1) load_rows_async<BF16, TQ>(qs_raw, q, n0, n, 0, d, str, q_rs);
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
    if (BF16) {
      const bf16* qs = reinterpret_cast<const bf16*>(qcur);
      const bf16* ts = reinterpret_cast<const bf16*>(cur);
      for (int kk = 0; kk < cw; kk += 16) {
        uint32_t a[4];
        const bf16* ab = &qs[r0 * str + kk + qq * 2];
        a[0] = ld_u32(ab);
        a[1] = ld_u32(ab + 8 * str);
        a[2] = ld_u32(ab + 8);
        a[3] = ld_u32(ab + 8 * str + 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* bb = &ts[(j * 8 + g) * str + kk + qq * 2];
          uint32_t bfr[2];
          bfr[0] = ld_u32(bb);
          bfr[1] = ld_u32(bb + 8);
          mma_bf16_16816(acc[j], a, bfr);
        }
      }
    } else {
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

template <typename T>
int launch_norms(const void* x, float* out, int batch, int rows, int d,
                 long long bs, long long rs, cudaStream_t stream) {
  if (rows == 0) return 0;
  const int per = NTHREADS / 32;
  const dim3 grid((rows + per - 1) / per, 1, batch);
  sq_norms_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), out, rows, d, bs, rs);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, int KMAX>
int launch(const void* q, const void* t, float* qn, float* tn, void* od,
           void* oi, int batch, int n, int m, int d, int k, long long q_bs,
           long long q_rs, long long t_bs, long long t_rs,
           cudaStream_t stream) {
  typedef typename std::conditional<BF16, bf16, float>::type T;
  const size_t smem = smem_bytes<BF16>(d);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = launch_norms<T>(q, qn, batch, n, d, q_bs, q_rs, stream);
  if (rc) return rc;
  rc = launch_norms<T>(t, tn, batch, m, d, t_bs, t_rs, stream);
  if (rc) return rc;
  auto kern = knn_kernel<BF16, KMAX>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + TQ - 1) / TQ, 1, batch);
  kern<<<grid, NTHREADS, smem, stream>>>(
      q, t, qn, tn, static_cast<float*>(od), static_cast<int*>(oi), n, m, d,
      k, q_bs, q_rs, t_bs, t_rs);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dispatch_k(const void* q, const void* t, float* qn, float* tn, void* od,
               void* oi, int batch, int n, int m, int d, int k,
               long long q_bs, long long q_rs, long long t_bs, long long t_rs,
               cudaStream_t s) {
  if (k <= 2)
    return launch<BF16, 2>(q, t, qn, tn, od, oi, batch, n, m, d, k, q_bs,
                           q_rs, t_bs, t_rs, s);
  if (k <= 4)
    return launch<BF16, 4>(q, t, qn, tn, od, oi, batch, n, m, d, k, q_bs,
                           q_rs, t_bs, t_rs, s);
  if (k <= 8)
    return launch<BF16, 8>(q, t, qn, tn, od, oi, batch, n, m, d, k, q_bs,
                           q_rs, t_bs, t_rs, s);
  return launch<BF16, 16>(q, t, qn, tn, od, oi, batch, n, m, d, k, q_bs,
                          q_rs, t_bs, t_rs, s);
}

}  // namespace

// q (B, N, D) and t (B, M, D), bf16 when bf16 != 0 else f32, rows
// contiguous in D, element (b, i, :) at base + b * bs + i * rs (bf16: bs and
// rs multiples of 8 and a 16-byte aligned base); qn (B, N) and tn (B, M) f32
// scratch for the norms; od (B, N, k) f32 and oi (B, N, k) i32 contiguous.
// 1 <= k <= 16, N >= 1, D >= 1 of any width (bf16 mode: D % 16 == 0).
// Returns a CUDA error code (0 on success) after the launches;
// cudaErrorInvalidValue for arguments outside these limits or a
// shared-memory need above the device's opt-in limit.
extern "C" int knn_launch(int bf16, const void* q, const void* t, void* qn,
                          void* tn, void* od, void* oi, int batch, int n,
                          int m, int d, int k, long long q_bs, long long q_rs,
                          long long t_bs, long long t_rs, void* stream) {
  if (k < 1 || k > 16 || n < 1 || batch < 1 || d < 1 || (bf16 && d % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* qnf = static_cast<float*>(qn);
  float* tnf = static_cast<float*>(tn);
  return bf16 ? dispatch_k<true>(q, t, qnf, tnf, od, oi, batch, n, m, d, k,
                                 q_bs, q_rs, t_bs, t_rs, s)
              : dispatch_k<false>(q, t, qnf, tnf, od, oi, batch, n, m, d, k,
                                  q_bs, q_rs, t_bs, t_rs, s);
}
