// Kernels H and F on Hopper: top-k nearest neighbours (1 <= k <= 16),
// products on wgmma and a pruned, deferred selection, in two element
// modes: bf16 and f32 (HIGHEST parity, as a 3xTF32 split product).
//
// Replaces the TPU kernels opencv_dlco_tpu/ops/knn_pallas.py::_knnk_kernel
// (entry point knnk_fused, kernel H) and ::_knn2_kernel (entry point
// knn2_fused, kernel F: the same function at k = 2), in both modes, at
// every width. For queries q (B, N, D) and train rows t (B, M, D):
//   dist[n, m] = max(|q_n|^2 + |t_m|^2 - 2 q_n . t_m, 0)
// and per query the k smallest (dist, m) in lexicographic order (equal
// distances go to the lowest train index), ascending; (inf, -1) fills the
// slots of a query with fewer than k neighbours. The expression is
// evaluated as fma(-2, g, nq + nt): 2 g is exact in f32, so the fma rounds
// once, exactly as (nq + nt) - 2 g does.
//
// bf16 mode: q and t rounded to bf16; the norms are summed in f32 from the
// rounded values, inside the kernel.
//
// f32 mode (the element path is the template parameter F32): a pre-pass
// (split_tf32, one launch for q and t) splits every element x into
//   hi = rna_tf32(x),  lo = rna_tf32(x - hi)
// (round to the 10-bit tf32 mantissa, ties away from zero; x - hi is exact
// in f32 and |x - hi| <= 2^-11 |x|, so |x - hi - lo| <= 2^-22 |x|) and
// writes both as planes of f32 words, with each row's squared norm from
// the unsplit x (summed in f64, rounded once). The kernel then forms
//   q . t = lo_q . hi_t + hi_q . lo_t + hi_q . hi_t
// as three wgmma tf32 products a k8 step; tf32 products are exact, and
// the dropped lo_q . lo_t is below 2^-22 |q_i t_i| an element. The tensor
// cores' f32 accumulation truncates, at a cost that grows with the
// accumulator's magnitude and the number of accumulating products (216
// into one accumulator over d 576 put errors of 1.7e-5 on distances near
// 2, unit-norm rows, on the card). So the small products accumulate over
// the tile in their own accumulator, where truncation costs ~2^-11 as
// much, and hi_q . hi_t in a fresh accumulator each K chunk (32
// elements: 4 products), whose sums are added in registers in chunk
// order, rounded to nearest; the two parts are added last. Three
// accumulator sets, so the f32 mode runs one consumer warpgroup (64
// queries a CTA, up to 255 registers a thread). The selection and
// epilogue are the bf16 mode's. A K chunk is 32 f32 words a row (128
// bytes, as 64 bf16), copied with both planes by one 3-D TMA box, so an
// element costs 8 bytes of shared memory against bf16's 2: the 64
// queries stay resident up to d 288, and wider rows stream them.
//
// Bound on an H100 at 65,536 x 65,536, d = 64: the products are 0.55 TFLOP,
// 0.56 ms at 989 TFLOP/s; each candidate costs ~3 CUDA-core instructions
// (an add, an fma and a min), 13 G instructions, 0.39 ms. The two run on
// different units, so the kernel can approach the larger of them only if
// they overlap. In f32 at 8,192 x 8,192, d = 576: 3 x 77.3 GFLOP of tf32
// products, 0.469 ms at 495 TFLOP/s (one f32 FFMA pass would take 1.154 ms
// at 67 TFLOP/s), beside 6 us of selection; the split reads 37.7 MB and
// writes 75.5 MB, 0.034 ms at 3.35 TB/s.
//
// Design: one launch. A CTA owns 64 NCW queries, resident in shared memory
// (NCW = 3 consumer warpgroups of 64 for k <= 12, 2 for larger k, 1 for
// rows too wide for those queries and their queues), loaded by TMA in
// 64-element K chunks of 128-byte swizzled rows, and walks the train rows
// in tiles of 64 (128 with the pair selection, below), one stage per
// (tile, K chunk), through a ring of TMA
// stages behind mbarriers. Rows too wide for even one warpgroup's resident
// queries (past 1,344 elements on an H100) stream them instead: each stage
// then carries the query chunk beside the train chunk, re-read from L2 for
// every train tile. Warp 0 of the first warpgroup issues the copies; warps
// 1 and 2 sum each arrived tile's squared train norms into a ring of norm
// slots in shared memory (+inf past the last train row; f32: they copy the
// pre-pass's norms). The query norms come from the resident tile
// (streamed: from the first train tile's stages; f32: from the pre-pass).
// Each consumer warpgroup runs
// wgmma m64n64k16 from shared memory (queries and train rows both K-major)
// and folds its tile while the other warpgroups' products run. The
// accumulator keeps one query row on the four lanes of a quad, as mma.sync
// does. The selection is latency-bound, so the third warpgroup (more warps
// to switch between, and each train tile read for 192 queries) is worth
// more than the fuller last wave that 128 queries a CTA would give.
//
// Selection: each lane keeps, per query row it holds (g and g + 8), a
// sorted list of its k best (dist, m) over the columns it sees, in
// registers: KMAX >= k slots (KMAX 2, 4, 8, 10, 12 or 16), the first
// KMAX - k pinned at -1, so the list tail is the lane's k-th best. A
// candidate is admitted only if its distance is below the row's threshold,
// an upper bound of the row's k-th best: the minimum of (a) the lane's own
// list tail, (b) the minimum of the quad's four tails and (c) the maximum
// over the quad of each lane's ceil(k/4)-th entry (together 4 ceil(k/4)
// >= k entries at or below it), all refreshed at every merge. Every listed
// column precedes every candidate in column order, so "below the bound" is
// exact for ties: a candidate at the bound's distance loses to the listed
// entries. The fast path turns the accumulators into distances in place
// and takes each row's minimum over the tile. Only when some row of the
// warp has a candidate below its threshold does the warp take the slow
// path: it first merges every lane's queue into the lists, together, if
// some queue could not take a whole tile more, then appends each column
// pair holding an admitted candidate (the other as +inf) to the lane's
// queue for its row in shared memory (10 pairs). So the merge code, the
// KMAX-deep insertions, sits once in the loop, runs rarely, and handles
// many admissions at a time. At the end the queues merge and the four
// lists of each row merge through shuffles.
//
// Pair selection (KMAX = 2: kernel F, and H at k <= 2): a lane's list is
// its two best (dist, m) per row, in registers, and there are no queues.
// The threshold is the same bound (at k = 2: the minimum of the own
// second entry, the quad's minimum second entry and the quad's maximum
// first entry). The fast path is unchanged; the warp-uniform slow path
// folds the tile's columns of each row that has a candidate below its
// threshold straight into the two-entry lists, branch-free and in column
// order, and refreshes the thresholds. A lane admits about 2 ln(M / 8)
// candidates a row, but a warp holds 64 lane-rows, so it takes the slow
// path on most of the first tiles and on a minority later. With the
// lists this small, a tile is 128
// train rows (one wgmma m64n128k16 a k16 step, 64 accumulators a thread):
// half the tiles, so half the per-tile waits, votes and barriers, and a
// product shape that keeps the tensor cores busier. When 192-query CTAs
// would not fill the card (small N), the pair selection runs 64 queries
// a CTA.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BN = 64;                      // train rows per tile
constexpr int BN_PAIR = 128;                // ... with the pair selection
constexpr int ROWB = 128;                   // bytes of a row's K chunk
constexpr int KC = 64;                      // bf16 elements per K chunk
constexpr int KC32 = 32;                    // f32 (tf32) elements per K chunk
constexpr int WGQ = 64;                     // queries per consumer warpgroup
constexpr int MAX_STAGES = 8;
constexpr int NTS = 4;                      // norm slots (tiles in flight)
constexpr int QL = 10;                      // queued column pairs per lane and row
constexpr int N_NORM_LANES = 64;            // warps 1 and 2
constexpr int IMAX = 0x7fffffff;

// elements of a K chunk, and the planes of an operand's chunk: bf16 one,
// f32 two (its tf32 hi and lo parts, lo after hi)
__host__ __device__ constexpr int k_chunk(bool f32) { return f32 ? KC32 : KC; }
__host__ __device__ constexpr int planes(bool f32) { return f32 ? 2 : 1; }

// queries a CTA holds per K chunk, in bytes
__host__ __device__ constexpr int q_chunk_bytes(int ncw, bool f32) {
  return ncw * WGQ * ROWB * planes(f32);
}

// the consumers' queues: (row, slot, consumer thread) of a column pair
// (dist or +inf, dist or +inf, first column, unused); none for the pair
// selection
__host__ __device__ constexpr int queue_bytes(int ncw, bool pair) {
  return pair ? 0 : 2 * QL * ncw * 128 * 16;
}

// train rows per tile, and the bytes of a tile's K chunk (8 or 16 KB a
// plane)
__host__ __device__ constexpr int tile_rows(bool pair) {
  return pair ? BN_PAIR : BN;
}
__host__ __device__ constexpr int train_chunk_bytes(bool pair, bool f32) {
  return tile_rows(pair) * ROWB * planes(f32);
}

// bytes of one stage: a train chunk, and with streamed queries the CTA's
// query chunk after it
__host__ __device__ constexpr int stage_bytes(int ncw, bool qstream,
                                              bool pair, bool f32) {
  return train_chunk_bytes(pair, f32) +
         (qstream ? q_chunk_bytes(ncw, f32) : 0);
}

// dynamic shared memory: alignment slack, the resident queries (none when
// streamed), the stage ring, the queues, the norm slots and the barriers
__host__ __device__ constexpr size_t smem_bytes(int ncw, int nch, int stages,
                                                bool qstream, bool pair,
                                                bool f32) {
  return 1024 +
         (qstream ? 0 : static_cast<size_t>(nch) * q_chunk_bytes(ncw, f32)) +
         static_cast<size_t>(stages) * stage_bytes(ncw, qstream, pair, f32) +
         queue_bytes(ncw, pair) + NTS * tile_rows(pair) * 4 +
         8 * (2 * MAX_STAGES + 1 + 2 * NTS);
}

// f32 row width the split pads to: whole 16-byte units (the tensor maps'
// row stride), and at least one K chunk
__host__ __device__ constexpr int split_width(int d) {
  return d < KC32 ? KC32 : (d + 3) & ~3;
}

__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// sums of squares of 8 bf16 packed in 16 bytes, added to four partial
// sums (independent chains)
__device__ __forceinline__ void add_sq8(const uint8_t* p, float (&s)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = __bfloat162float(e[i]);
    s[i & 3] = fmaf(x, x, s[i & 3]);
  }
}

// insert (v, i) into the ascending list if it is below the tail; every
// listed column precedes i, so ties stay in front of it
template <int KMAX>
__device__ __forceinline__ void insert_sorted(float (&ld)[KMAX],
                                              int (&li)[KMAX], float v,
                                              int i) {
  if (!(v < ld[KMAX - 1])) return;
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (v < ld[s - 1]) {
      ld[s] = ld[s - 1];
      li[s] = li[s - 1];
    } else if (v < ld[s]) {
      ld[s] = v;
      li[s] = i;
    }
  }
  if (v < ld[0]) {
    ld[0] = v;
    li[0] = i;
  }
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

// drop the KMAX - k pinned slots at the front of a list
template <int KMAX>
__device__ __forceinline__ void unpin(float (&ld)[KMAX], int (&li)[KMAX],
                                      int k) {
#pragma unroll
  for (int r = 0; r < KMAX - 1; ++r) {
    if (r < KMAX - k) {
#pragma unroll
      for (int s = 0; s < KMAX - 1; ++s) {
        ld[s] = ld[s + 1];
        li[s] = li[s + 1];
      }
      ld[KMAX - 1] = INFINITY;
      li[KMAX - 1] = IMAX;
    }
  }
}

// queue the column pairs (8 j + 2 q4 + {0, 1}, accumulators 4 j + h and
// 4 j + h + 1) of one row with a distance below thr: entries at q[CT * cnt]
template <int CT>
__device__ __forceinline__ void queue_pairs(const float (&acc)[32], int h,
                                            float thr, float4* q, int& cnt,
                                            int cb) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float a = acc[4 * j + h], c = acc[4 * j + h + 1];
    const bool pa = a < thr, pc = c < thr;
    if (pa || pc)
      q[CT * cnt++] = make_float4(pa ? a : INFINITY, pc ? c : INFINITY,
                                  __int_as_float(cb + 8 * j), 0.f);
  }
}

// fold a tile's columns of one row (accumulators 4 j + h and 4 j + h + 1,
// columns cb + 8 j + {0, 1}) into a two-entry list, in column order and
// without branches: a candidate below an entry shifts it down (equal
// distances keep the listed, lower column in front)
template <int NA>
__device__ __forceinline__ void fold_pairs(const float (&acc)[NA], int h,
                                           float (&ld)[2], int (&li)[2],
                                           int cb) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = fmaxf(acc[4 * j + h + e], 0.f);
      const int col = cb + 8 * j + e;
      const bool lt0 = v < ld[0], lt1 = v < ld[1];
      ld[1] = lt0 ? ld[0] : (lt1 ? v : ld[1]);
      li[1] = lt0 ? li[0] : (lt1 ? col : li[1]);
      ld[0] = lt0 ? v : ld[0];
      li[0] = lt0 ? col : li[0];
    }
}

// QS: the queries stream through the stages (else they are resident).
// F32: the operands are split f32 rows (planes hi and lo, tf32 values) and
// the squared norms come precomputed in nq_g and nt_g; else bf16 rows whose
// norms the kernel sums (nq_g and nt_g unused).
template <int KMAX, int NCW, bool QS, bool F32>
__global__ void __launch_bounds__(128 * (NCW + 1), 1)
knnk_wgmma(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_t,
           const float* __restrict__ nq_g, const float* __restrict__ nt_g,
           float* __restrict__ od, int* __restrict__ oi, int n, int m,
           int nch, int k, int stages) {
  constexpr int TQ = NCW * WGQ;
  constexpr int KCH = k_chunk(F32);               // elements per K chunk
  constexpr int QCB = q_chunk_bytes(NCW, F32);
  constexpr int CT = 128 * NCW;  // consumer threads
  constexpr bool PAIR = KMAX == 2;
  constexpr int TBN = tile_rows(PAIR);            // train rows per tile
  constexpr int TCB = train_chunk_bytes(PAIR, F32);
  constexpr int NA = TBN / 2;                     // accumulators a thread
  constexpr int sb = stage_bytes(NCW, QS, PAIR, F32);
  constexpr int QB = queue_bytes(NCW, PAIR);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023u) & ~1023u;  // resident query chunks
  uint8_t* const qs_ptr = smem_raw + (qs - raw);
  const int qres = QS ? 0 : nch * QCB;
  const uint32_t st0 = qs + qres;  // stage ring
  uint8_t* const st_ptr = qs_ptr + qres;
  float4* const queue = reinterpret_cast<float4*>(st_ptr + stages * sb);
  float* const nt_ring = reinterpret_cast<float*>(st_ptr + stages * sb + QB);
  const uint32_t bars = st0 + stages * sb + QB + NTS * TBN * 4;
  const uint32_t full = bars, empty = bars + 8 * MAX_STAGES;
  const uint32_t qfull = bars + 16 * MAX_STAGES;
  const uint32_t ntfull = qfull + 8, ntempty = ntfull + 8 * NTS;

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TQ;
  const int ntiles = (m + TBN - 1) / TBN;
  const int steps = ntiles * nch;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      // the consumer warps, and the norm lanes where they read the stage
      mbar_init(empty + 8 * s, 4 * NCW + (F32 ? 0 : N_NORM_LANES));
    }
    mbar_init(qfull, 1);
    for (int s = 0; s < NTS; ++s) {
      mbar_init(ntfull + 8 * s, N_NORM_LANES);
      mbar_init(ntempty + 8 * s, CT);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  if (wg == 0) {
    if (warp == 0 && lane == 0) {  // producer: the queries, then the stages
      // K chunk c of rows from ``row`` on (every plane of an f32 operand)
      auto load = [&](uint32_t dst, const CUtensorMap* tm, uint32_t bar,
                      int c, int row) {
        if constexpr (F32)
          tma_load_3d(dst, tm, bar, c * KCH, row, 0);
        else
          tma_load_2d(dst, tm, bar, c * KCH, row);
      };
      if (!QS) {
        mbar_expect_tx(qfull, nch * QCB);
        for (int c = 0; c < nch; ++c)
          load(qs + c * QCB, &tm_q, qfull, c, b * n + n0);
      }
      for (int it = 0; it < steps; ++it) {
        const int s = it % stages, t = it / nch, c = it - t * nch;
        mbar_wait(empty + 8 * s, ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, sb);
        load(st0 + s * sb, &tm_t, full + 8 * s, c, b * m + t * TBN);
        if (QS) load(st0 + s * sb + TCB, &tm_q, full + 8 * s, c, b * n + n0);
      }
    } else if ((warp == 1 || warp == 2) && F32) {  // train norms from nt_g
      constexpr int RL = TBN / N_NORM_LANES;
      const int r = (warp - 1) * 32 + lane;
      for (int t = 0; t < ntiles; ++t) {
        const int slot = t % NTS;
        mbar_wait(ntempty + 8 * slot, ((t / NTS) & 1) ^ 1);
#pragma unroll
        for (int h = 0; h < RL; ++h) {
          const int rr = r + N_NORM_LANES * h, row = t * TBN + rr;
          nt_ring[slot * TBN + rr] =
              row < m ? nt_g[static_cast<size_t>(b) * m + row] : INFINITY;
        }
        mbar_arrive(ntfull + 8 * slot);
      }
    } else if (warp == 1 || warp == 2) {  // train norms, rows r + 64 h
      constexpr int RL = TBN / N_NORM_LANES;      // rows a lane
      const int r = (warp - 1) * 32 + lane;
      const int rsw = r & 7;
      for (int t = 0; t < ntiles; ++t) {
        const int slot = t % NTS;
        mbar_wait(ntempty + 8 * slot, ((t / NTS) & 1) ^ 1);
        float acc[RL][4] = {};
        for (int c = 0; c < nch; ++c) {
          const int it = t * nch + c, s = it % stages;
          mbar_wait(full + 8 * s, (it / stages) & 1);
#pragma unroll
          for (int h = 0; h < RL; ++h) {
            const uint8_t* row = st_ptr + s * sb +
                                 ((r + N_NORM_LANES * h) >> 3) * 1024 +
                                 rsw * 128;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              add_sq8(row + ((j ^ rsw) << 4), acc[h]);
          }
          mbar_arrive(empty + 8 * s);
        }
#pragma unroll
        for (int h = 0; h < RL; ++h) {
          const int rr = r + N_NORM_LANES * h;
          nt_ring[slot * TBN + rr] =
              t * TBN + rr < m ? (acc[h][0] + acc[h][1]) + (acc[h][2] + acc[h][3])
                               : INFINITY;
        }
        mbar_arrive(ntfull + 8 * slot);
      }
    }
    return;
  }

  // -- consumers: warpgroup cw owns queries n0 + 64 cw .. + 63 --------------
  const int cw = wg - 1;
  const int g = lane >> 2, q4 = lane & 3;
  const int r0 = cw * WGQ + warp * 16 + g, r1 = r0 + 8;  // rows in the tile
  // query norms: each lane sums 16 of a chunk's 64 elements of rows r0 and
  // r1, the quad adds its four sums
  float sq0[4] = {0.f, 0.f, 0.f, 0.f}, sq1[4] = {0.f, 0.f, 0.f, 0.f};
  auto add_query_chunk = [&](const uint8_t* qc) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = q4 + 4 * h;
      add_sq8(qc + (r0 >> 3) * 1024 + g * 128 + ((j ^ g) << 4), sq0);
      add_sq8(qc + (r1 >> 3) * 1024 + g * 128 + ((j ^ g) << 4), sq1);
    }
  };
  float nq0 = 0.f, nq1 = 0.f;
  auto finish_query_norms = [&]() {
    nq0 = (sq0[0] + sq0[1]) + (sq0[2] + sq0[3]);
    nq1 = (sq1[0] + sq1[1]) + (sq1[2] + sq1[3]);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      nq0 += __shfl_xor_sync(0xffffffffu, nq0, off);
      nq1 += __shfl_xor_sync(0xffffffffu, nq1, off);
    }
  };
  if (!QS) {
    mbar_wait(qfull, 0);
    if constexpr (!F32) {
      for (int c = 0; c < nch; ++c) add_query_chunk(qs_ptr + c * QCB);
      finish_query_norms();
    }
  }
  if constexpr (F32) {
    const size_t row0 = static_cast<size_t>(b) * n + n0;
    nq0 = n0 + r0 < n ? nq_g[row0 + r0] : 0.f;
    nq1 = n0 + r1 < n ? nq_g[row0 + r1] : 0.f;
  }

  float ld0[KMAX], ld1[KMAX];
  int li0[KMAX], li1[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    ld0[s] = ld1[s] = s < KMAX - k ? -1.f : INFINITY;
    li0[s] = li1[s] = IMAX;
  }
  // the slot of each lane's ceil(k / 4)-th entry
  const int quarter = KMAX - k + (k + 3) / 4 - 1;
  // this thread's queues in shared memory: entry s of row h at
  // queue[(h * QL + s) * CT + ct]
  const int ct = threadIdx.x - 128;
  float4* const q0 = queue + ct;
  float4* const q1 = queue + QL * CT + ct;
  int cnt0 = 0, cnt1 = 0;
  float thr0 = INFINITY, thr1 = INFINITY;

  // refresh the thresholds from the lists: the own tail, the quad's
  // minimum tail and maximum ceil(k/4)-th entry (warp-uniform)
  auto refresh = [&]() {
    float v0 = INFINITY, v1 = INFINITY;
#pragma unroll
    for (int s = 0; s < KMAX; ++s)
      if (s == quarter) {
        v0 = ld0[s];
        v1 = ld1[s];
      }
    float m0 = ld0[KMAX - 1], m1 = ld1[KMAX - 1];
    thr0 = fminf(thr0, m0);
    thr1 = fminf(thr1, m1);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, off));
      v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, off));
      m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    thr0 = fminf(thr0, fminf(v0, m0));
    thr1 = fminf(thr1, fminf(v1, m1));
  };
  // insert every lane's queued entries into its lists, then refresh the
  // thresholds (warp-uniform)
  auto merge_queues = [&]() {
    const int rounds = __reduce_max_sync(0xffffffffu, max(cnt0, cnt1));
    for (int s = 0; s < rounds; ++s) {
      if (s < cnt0) {
        const float4 e = q0[s * CT];
        insert_sorted<KMAX>(ld0, li0, fmaxf(e.x, 0.f), __float_as_int(e.z));
        insert_sorted<KMAX>(ld0, li0, fmaxf(e.y, 0.f),
                            __float_as_int(e.z) + 1);
      }
      if (s < cnt1) {
        const float4 e = q1[s * CT];
        insert_sorted<KMAX>(ld1, li1, fmaxf(e.x, 0.f), __float_as_int(e.z));
        insert_sorted<KMAX>(ld1, li1, fmaxf(e.y, 0.f),
                            __float_as_int(e.z) + 1);
      }
    }
    cnt0 = cnt1 = 0;
    refresh();
  };

  // descriptors of the warpgroup's first query chunk (resident, or in
  // stage 0 when streamed) and of stage 0's train chunk; a byte offset o
  // inside shared memory advances a descriptor by o / 16. An f32 chunk's
  // lo plane follows its hi plane: TQ (queries) or TBN (train) rows on.
  const uint64_t da0 = sw128_desc(
      (QS ? st0 + TCB : qs) + cw * (WGQ * ROWB), 16, 1024);
  const uint64_t db0 = sw128_desc(st0, 16, 1024);
  constexpr int QLO = TQ * ROWB / 16, TLO = TBN * ROWB / 16;

  float acc[NA];
  // f32: the K chunks' hi.hi products summed in chunk order, and the small
  // products lo_q.hi_t + hi_q.lo_t of the whole tile in their own
  // accumulator
  float tot[F32 ? NA : 1], sml[F32 ? NA : 1];
  for (int t = 0; t < ntiles; ++t) {
    for (int c = 0; c < nch; ++c) {
      const int it = t * nch + c, s = it % stages;
      mbar_wait(full + 8 * s, (it / stages) & 1);
      if (!F32 && QS && t == 0) add_query_chunk(st_ptr + s * sb + TCB);
      wgmma_fence();
      const uint64_t da = da0 + (QS ? s * (sb / 16) : c * (QCB / 16));
      const uint64_t db = db0 + s * (sb / 16);
      if constexpr (F32) {
        // q.t = lo_q.hi_t + hi_q.lo_t + hi_q.hi_t: the small terms into
        // sml, the chunk's hi.hi into a fresh acc (lo_q.lo_t, below
        // 2^-22 |q_i t_i|, is left out)
#pragma unroll
        for (int kk = 0; kk < KC32 / 8; ++kk) {
          const uint64_t a = da + 2 * kk, bb = db + 2 * kk;
          if constexpr (TBN == 128) {
            wgmma_m64n128k8_tf32(sml, a + QLO, bb, (c | kk) != 0);
            wgmma_m64n128k8_tf32(sml, a, bb + TLO, 1);
            wgmma_m64n128k8_tf32(acc, a, bb, kk != 0);
          } else {
            wgmma_m64n64k8_tf32(sml, a + QLO, bb, (c | kk) != 0);
            wgmma_m64n64k8_tf32(sml, a, bb + TLO, 1);
            wgmma_m64n64k8_tf32(acc, a, bb, kk != 0);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if constexpr (TBN == 128)
            wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
          else
            wgmma_m64n64k16(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      if constexpr (F32) fence_acc(sml);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if constexpr (F32) {
#pragma unroll
        for (int i = 0; i < NA; ++i)
          tot[i] = c == 0 ? acc[i] : tot[i] + acc[i];
      }
    }
    if (!F32 && QS && t == 0) finish_query_norms();
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = tot[i] + sml[i];
    }

    // n8 slice j holds columns 8 j + 2 q4 + {0, 1} of rows r0 (acc
    // 4 j + e) and r1 (4 j + 2 + e). Fast path: the distances, in place,
    // and each row's minimum over the tile.
    // The norms come to registers first and the slot is released (H);
    // with 128-row tiles (pair selection) they are read slice by slice,
    // which keeps the registers of the 64 accumulators.
    const int slot = t % NTS;
    mbar_wait(ntfull + 8 * slot, (t / NTS) & 1);
    constexpr int NV = PAIR ? 1 : TBN / 8;
    float2 ntv[NV];
    if constexpr (!PAIR) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        ntv[j] = *reinterpret_cast<const float2*>(
            &nt_ring[slot * TBN + 8 * j + 2 * q4]);
      mbar_arrive(ntempty + 8 * slot);
    }
    float mn0 = INFINITY, mn1 = INFINITY;
#pragma unroll
    for (int j = 0; j < TBN / 8; ++j) {
      if constexpr (PAIR)
        ntv[0] = *reinterpret_cast<const float2*>(
            &nt_ring[slot * TBN + 8 * j + 2 * q4]);
      const float2 nv = ntv[PAIR ? 0 : j];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float nt = e ? nv.y : nv.x;
        acc[4 * j + e] = __fmaf_rn(-2.f, acc[4 * j + e], __fadd_rn(nq0, nt));
        acc[4 * j + 2 + e] =
            __fmaf_rn(-2.f, acc[4 * j + 2 + e], __fadd_rn(nq1, nt));
        mn0 = fminf(mn0, acc[4 * j + e]);
        mn1 = fminf(mn1, acc[4 * j + 2 + e]);
      }
    }
    if constexpr (PAIR) mbar_arrive(ntempty + 8 * slot);
    // slow path, for the whole warp when any of its rows has a candidate
    // below its threshold. Pair selection: fold the tile's columns of
    // each such row into the two-entry lists and refresh the thresholds.
    // Otherwise: make room for a tile (at most 8 pairs a row), then queue
    // every column pair with a candidate below the (possibly refreshed)
    // threshold, the other candidate of the pair as +inf
    if (__any_sync(0xffffffffu, mn0 < thr0 || mn1 < thr1)) {
      if constexpr (PAIR) {
        const int cb = t * TBN + 2 * q4;
        if (__any_sync(0xffffffffu, mn0 < thr0))
          fold_pairs(acc, 0, ld0, li0, cb);
        if (__any_sync(0xffffffffu, mn1 < thr1))
          fold_pairs(acc, 2, ld1, li1, cb);
        refresh();
      } else {
        if (__any_sync(0xffffffffu, cnt0 > QL - 8 || cnt1 > QL - 8))
          merge_queues();
        const int cb = t * TBN + 2 * q4;
        if (__any_sync(0xffffffffu, mn0 < thr0))
          queue_pairs<CT>(acc, 0, thr0, q0, cnt0, cb);
        if (__any_sync(0xffffffffu, mn1 < thr1))
          queue_pairs<CT>(acc, 2, thr1, q1, cnt1, cb);
      }
    }
  }
  if (!PAIR && __any_sync(0xffffffffu, cnt0 > 0 || cnt1 > 0)) merge_queues();

  unpin<KMAX>(ld0, li0, k);
  unpin<KMAX>(ld1, li1, k);
  const size_t o0 = (static_cast<size_t>(b) * n + n0 + r0) * k;
  const size_t o1 = o0 + 8 * static_cast<size_t>(k);
  merge_quad<KMAX>(ld0, li0, k, q4 == 0 && n0 + r0 < n, od + o0, oi + o0);
  merge_quad<KMAX>(ld1, li1, k, q4 == 0 && n0 + r1 < n, od + o1, oi + o1);
}

// Consumer warpgroups of the wide configuration: 3 (192 queries a CTA, at
// most 128 registers a thread) where the lists leave room, else 2.
template <int KMAX>
constexpr int wide_ncw() {
  return KMAX <= 12 ? 3 : 2;
}

// A launch configuration: consumer warpgroups (ncw_hi, or 1 when ncw_hi
// warpgroups' resident queries and queues do not fit), whether the queries
// stream through the stages (when not even one warpgroup's fit), stages
// (the most of 2 .. MAX_STAGES that fit) and the dynamic shared memory;
// ncw 0 when nothing fits or the device cannot be queried.
struct Config {
  int ncw = 0, stages = 0, smem = 0;
  bool qstream = false;
};

Config pick_config(int nch, int ncw_hi, bool pair, bool f32) {
  Config cfg;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return cfg;
  const int tries[3][2] = {{ncw_hi, 0}, {1, 0}, {1, 1}};
  for (const auto& tr : tries)
    for (int s = MAX_STAGES; s >= 2; --s) {
      const size_t bytes = smem_bytes(tr[0], nch, s, tr[1] != 0, pair, f32);
      if (bytes <= static_cast<size_t>(optin)) {
        cfg.ncw = tr[0];
        cfg.qstream = tr[1] != 0;
        cfg.stages = s;
        cfg.smem = static_cast<int>(bytes);
        return cfg;
      }
    }
  return cfg;
}

// The operands of a launch: bf16 rows q (B * N, d) and t (B * M, d), or
// split f32 rows, planes (2, B * N, d) and (2, B * M, d), with their
// squared norms nq (B * N) and nt (B * M).
struct Operands {
  const void* q;
  const void* t;
  const float* nq;
  const float* nt;
};

template <int KMAX, int NCW, bool QS, bool F32>
int launch(const Operands& op, float* od, int* oi, int batch, int n, int m,
           int d, int k, const Config& cfg, cudaStream_t stream) {
  CUtensorMap tq, tt;
  const uint64_t rq = static_cast<uint64_t>(batch) * n;
  const uint64_t rt = static_cast<uint64_t>(batch) * m;
  const uint32_t tbn = tile_rows(KMAX == 2);
  bool ok;
  if constexpr (F32) {
    const uint64_t row = static_cast<uint64_t>(d) * 4;
    ok = tmap_f32_planes(&tq, op.q, d, rq, 2, row, rq * row, NCW * WGQ) &&
         tmap_f32_planes(&tt, op.t, d, rt, 2, row, rt * row, tbn);
  } else {
    const uint64_t row = static_cast<uint64_t>(d) * 2;
    ok = tmap_bf16_2d(&tq, op.q, d, rq, row, KC, NCW * WGQ) &&
         tmap_bf16_2d(&tt, op.t, d, rt, row, KC, tbn);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cudaFuncSetAttribute(knnk_wgmma<KMAX, NCW, QS, F32>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           cfg.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + NCW * WGQ - 1) / (NCW * WGQ), batch);
  constexpr int KCH = k_chunk(F32);
  knnk_wgmma<KMAX, NCW, QS, F32>
      <<<grid, 128 * (NCW + 1), cfg.smem, stream>>>(
          tq, tt, op.nq, op.nt, od, oi, n, m, (d + KCH - 1) / KCH, k,
          cfg.stages);
  return static_cast<int>(cudaGetLastError());
}

template <int KMAX, bool F32>
int launch_k(const Operands& op, float* od, int* oi, int batch, int n,
             int m, int d, int k, const Config& cfg, cudaStream_t stream) {
  if constexpr (!F32) {
    constexpr int W = wide_ncw<KMAX>();
    if (cfg.ncw == W)
      return launch<KMAX, W, false, F32>(op, od, oi, batch, n, m, d, k, cfg,
                                         stream);
  }
  if (!cfg.qstream)
    return launch<KMAX, 1, false, F32>(op, od, oi, batch, n, m, d, k, cfg,
                                       stream);
  return launch<KMAX, 1, true, F32>(op, od, oi, batch, n, m, d, k, cfg,
                                    stream);
}

// The configuration for (B, N, M, d, k) and the launch of its instance;
// d is the row width of the operands (bf16: a multiple of 8, f32: of 4).
template <bool F32>
int launch_all(const Operands& op, void* od, void* oi, int batch, int n,
               int m, int d, int k, cudaStream_t s) {
  // f32: one consumer warpgroup (its chunk sums double the accumulators)
  int ncw_hi = F32 ? 1 : k <= 12 ? 3 : 2, dev = 0, sms = 0;
  if (!F32 && k <= 2 && cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      static_cast<long long>((n + 3 * WGQ - 1) / (3 * WGQ)) * batch < sms)
    ncw_hi = 1;  // pair selection on a small N: 64 queries a CTA
  constexpr int KCH = k_chunk(F32);
  const Config cfg = pick_config((d + KCH - 1) / KCH, ncw_hi, k <= 2, F32);
  if (cfg.ncw == 0) return static_cast<int>(cudaErrorInvalidValue);
  float* odf = static_cast<float*>(od);
  int* oii = static_cast<int*>(oi);
#define KNN_ARGS op, odf, oii, batch, n, m, d, k, cfg, s
  if (k <= 2) return launch_k<2, F32>(KNN_ARGS);
  if (k <= 4) return launch_k<4, F32>(KNN_ARGS);
  if (k <= 8) return launch_k<8, F32>(KNN_ARGS);
  if (k <= 10) return launch_k<10, F32>(KNN_ARGS);
  if (k <= 12) return launch_k<12, F32>(KNN_ARGS);
  return launch_k<16, F32>(KNN_ARGS);
#undef KNN_ARGS
}

// one element of the split: hi and lo into the planes, x * x into the sum
__device__ __forceinline__ void split1(float x, float* hi, float* lo,
                                       double& s) {
  const float h = tf32_rna(x);
  *hi = h;
  *lo = isfinite(x) ? tf32_rna(x - h) : 0.f;
  s = fma(static_cast<double>(x), static_cast<double>(x), s);
}

// The f32 modes' pre-pass, one launch for both operands: row r of x
// (rows, d) f32 becomes hi = tf32_rna(x) and lo = tf32_rna(x - hi) in the
// planes (2, rows, dp), zeros past d, and its squared norm from the
// unsplit x, summed in f64 (each lane's elements in order, then the lanes
// in a fixed tree) and rounded once to f32. One warp a row, q's rows
// first, then t's. VEC: d == dp, rows of whole 16-byte units, copied 16
// bytes a lane.
template <bool VEC>
__global__ void __launch_bounds__(256)
split_tf32(const float* __restrict__ q, const float* __restrict__ t,
           float* __restrict__ sq, float* __restrict__ st,
           float* __restrict__ nrm, int rq, int rt, int d, int dp) {
  const int w = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (w >= rq + rt) return;
  const bool isq = w < rq;
  const size_t r = isq ? w : w - rq, rows = isq ? rq : rt;
  const float* x = (isq ? q : t) + r * d;
  float* hi = (isq ? sq : st) + r * dp;
  float* lo = hi + rows * dp;
  double s = 0.0;
  if constexpr (VEC) {
    for (int e = 4 * lane; e < d; e += 128) {
      const float4 v = *reinterpret_cast<const float4*>(x + e);
      float4 h, l;
      split1(v.x, &h.x, &l.x, s);
      split1(v.y, &h.y, &l.y, s);
      split1(v.z, &h.z, &l.z, s);
      split1(v.w, &h.w, &l.w, s);
      *reinterpret_cast<float4*>(hi + e) = h;
      *reinterpret_cast<float4*>(lo + e) = l;
    }
  } else {
    for (int e = lane; e < dp; e += 32)
      split1(e < d ? x[e] : 0.f, hi + e, lo + e, s);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) nrm[w] = static_cast<float>(s);
}

}  // namespace

// q (B * N, D) and t (B * M, D) bf16, rows contiguous and packed (batch b's
// rows at b * N and b * M), 16-byte aligned, D % 8 == 0; od (B, N, k) f32
// and oi (B, N, k) i32 contiguous. 1 <= k <= 16 and N, M, B >= 1. Returns a
// CUDA error code (0 on success) after the launch; cudaErrorInvalidValue for
// arguments outside these limits.
extern "C" int knn_topk_launch(const void* q, const void* t, void* od,
                               void* oi, int batch, int n, int m, int d,
                               int k, void* stream) {
  if (k < 1 || k > 16 || n < 1 || m < 1 || batch < 1 || d < 8 || d % 8 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(t) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands op{q, t, nullptr, nullptr};
  return launch_all<false>(op, od, oi, batch, n, m, d, k,
                           static_cast<cudaStream_t>(stream));
}

// Bytes of the scratch knn_topk_f32_launch takes for (B, N, M, D): the
// split planes of q and t and their squared norms.
extern "C" long long knn_topk_f32_scratch_bytes(int batch, int n, int m,
                                                int d) {
  const long long rows = static_cast<long long>(batch) * (n + m);
  return rows * (2LL * split_width(d) + 1) * 4;
}

// The f32 modes (HIGHEST parity): q (B * N, D) and t (B * M, D) f32, rows
// contiguous and packed, 4-byte aligned, any D >= 1; scratch of
// knn_topk_f32_scratch_bytes, 16-byte aligned; od and oi as above. Two
// launches: the split (split_tf32), then the kernel on the split rows.
// Returns a CUDA error code (0 on success); cudaErrorInvalidValue for
// arguments outside these limits.
extern "C" int knn_topk_f32_launch(const void* q, const void* t,
                                   void* scratch, void* od, void* oi,
                                   int batch, int n, int m, int d, int k,
                                   void* stream) {
  const long long rq = static_cast<long long>(batch) * n;
  const long long rt = static_cast<long long>(batch) * m;
  if (k < 1 || k > 16 || n < 1 || m < 1 || batch < 1 || d < 1 ||
      rq + rt > 0x7fffffffLL || reinterpret_cast<uintptr_t>(q) % 4 ||
      reinterpret_cast<uintptr_t>(t) % 4 ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = split_width(d);
  float* sq = static_cast<float*>(scratch);
  float* st = sq + 2 * rq * dp;
  float* nrm = st + 2 * rt * dp;
  const float* qf = static_cast<const float*>(q);
  const float* tf = static_cast<const float*>(t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((rq + rt + 7) / 8);
  if (d == dp && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(t) % 16 == 0)
    split_tf32<true><<<blocks, 256, 0, s>>>(qf, tf, sq, st, nrm, rq, rt, d,
                                           dp);
  else
    split_tf32<false><<<blocks, 256, 0, s>>>(qf, tf, sq, st, nrm, rq, rt, d,
                                            dp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Operands op{sq, st, nrm, nrm + rq};
  return launch_all<true>(op, od, oi, batch, n, m, dp, k, s);
}

// Dynamic shared memory a CTA requests at width d: k in 3..12 (``which``
// 0, f32 2) or the pair selection, k <= 2 (``which`` 1, f32 3).
extern "C" int knn_topk_smem_bytes(int d, int which) {
  const bool f32 = which >= 2;
  const int kc = k_chunk(f32), w = f32 ? split_width(d) : d;
  return pick_config((w + kc - 1) / kc, f32 ? 1 : 3, (which & 1) != 0, f32)
      .smem;
}
