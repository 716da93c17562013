// Kernel B: the wide PR-RDA grid, n_steps block-sampled RDA steps.
//
// Replaces the TPU kernels opencv_dlco_tpu/ops/fused_rda.py::
// _fused_train_wide_kernel (entry fused_block_train_wide) and its
// bit-identical twin _fused_train_wide_pipelined_kernel
// (fused_block_train_wide_pipelined): one kernel set here serves both.
// Per step, with the sampled blocks pos[ip*tile_b : +batch] and
// neg[in*tile_b : +batch]:
//   fd   = pos - neg                           (rounded to the input dtype)
//   f    = fd . w^T          (batch, S)        w resident at the input dtype
//   viol = f > -1
//   df   = df * t/(t+B);  df += (viol^T . fd)/(t+B) per tile_b rows
//   w    = max(0, -sqrt(t+B)/gamma * (df + mu))   (stored at the input dtype)
//
// Bound on an H100 at the grid's shape (S 256, F 5120, batch 2048, bf16):
// 4*B*F*S = 10.7 GFLOP per step (10.9 us of bf16 tensor time) against
// 2*2048*5120*2 B = 41.9 MB of sampled rows (12.5 us at 3.35 TB/s): the step
// is bound by bytes, ~12.5 us.
//
// Design (bf16 splits): the (S, F) state (bf16 w + f32 df, 7.5 MiB at
// S = 256) lives in device memory and L2; each step is three launches with
// no atomics and a fixed summation order, so reruns are bit-identical:
//   phase 1 (wide_f_wgmma): f = fd . w^T, M = batch rows, N = S (256 per
//     CTA), K = F split in n_slices slices; a CTA owns 128 rows x 256 S x
//     one F slice (16 row tiles x 8 slices = 128 CTAs at batch 2048). One
//     producer warp streams pos, neg and w tiles by TMA (3 stages of 64 KB,
//     128-byte swizzle, mbarriers); each consumer warpgroup forms fd for its
//     64 rows in shared memory (f32 subtract, one bf16 rounding), writes it
//     to a (batch, F) bf16 scratch, and runs wgmma m64n256k16 on it. Each
//     sampled element is read once per step. The f32 partial f of each
//     slice goes to a (n_slices, batch, S) scratch;
//   gate (wide_gate): sums the slices in slice order, viol = f > -1,
//     written as bf16 0/1 to violT (S_pad, batch);
//   phase 2 (wide_df_wgmma): g = viol^T . fd, M = S (128 per CTA), N = F
//     (80 per CTA: 64 x 2 = 128 CTAs, one wave), K = batch whole inside the
//     CTA; violT tiles (K-major, 128-byte swizzle) and fd tiles (N-major,
//     wgmma's transposed B, 32-byte swizzle: five 16-wide atoms) by TMA in 8
//     stages of 26 KB. The df*t/(t+B) scale, the fold every tile_b rows in
//     row order and the step-end w update run in registers; two
//     accumulators let the fold of one tile_b block (the IEEE division
//     acc / (t+B), 21M a step, done branch-free by div_rn_by) overlap the
//     products of the next.
// f32 splits keep the FFMA kernels (no TF32), two launches per step.
// On the H100 (S 256, F 5120, batch 2048; chip_smoke.py's profiler row):
// 25.5 us phase 1, 4.4 us gate, 52.1 us phase 2 a step against the 12.6 us
// bound; phase 1 moves the sampled rows once but also writes the fd and
// partial-f scratch, and phase 2's fold divides 21M values a step.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int T64 = 64;

// ---- bf16 splits: wgmma ----------------------------------------------------

constexpr int WG_THREADS = 288;   // 2 consumer warpgroups + 1 producer warp
constexpr int N_CONSUMER_WARPS = 8;

// phase 1 tiles
constexpr int P1_ROWS = 128;                  // batch rows per CTA
constexpr int P1_S = 256;                     // S columns per CTA
constexpr int P1_K = 64;                      // features per stage
constexpr int P1_STAGES = 3;
constexpr int P1_ROW_BYTES = P1_ROWS * P1_K * 2;   // 16 KB (pos or neg)
constexpr int P1_W_BYTES = P1_S * P1_K * 2;        // 32 KB
constexpr int P1_STAGE = 2 * P1_ROW_BYTES + P1_W_BYTES;
constexpr int P1_SMEM = P1_STAGES * P1_STAGE + 1024 + 2 * P1_STAGES * 8;

// phase 2 tiles: S 128 x F 16 * NA (NA = 5 when 80 divides F: 5120 / 80 =
// 64 F tiles x 2 S tiles = 128 CTAs, one wave on 132 SMs; else NA = 4)
constexpr int P2_S = 128;                     // S rows per CTA
constexpr int P2_K = 64;                      // batch rows per stage
constexpr int P2_STAGES = 8;
constexpr int P2_V_BYTES = P2_S * P2_K * 2;        // 16 KB violT tile
constexpr int P2_ATOM_BYTES = P2_K * 16 * 2;       // 2 KB: 64 rows x 16 f
template <int NA>
struct P2 {
  static constexpr int F = 16 * NA;                           // features
  static constexpr int STAGE = P2_V_BYTES + NA * P2_ATOM_BYTES;
  static constexpr int SMEM = P2_STAGES * STAGE + 1024 + 2 * P2_STAGES * 8;
};

// x / d rounded to nearest, bit-identical to __fdiv_rn(x, d) for every
// float x and a float divisor d > 0 shared by many quotients, without a
// branch (a divergent branch, like __fdiv_rn's slow path, would make ptxas
// serialize the wgmma pipeline it sits in). In double, with rcp =
// __drcp_rn(d): x * rcp corrected twice by its FMA remainder is faithful
// after the first and correctly rounded after the second correction
// (Markstein: rcp within half an ulp of 1/d); no step under- or overflows
// for float operands. Rounding that double quotient to float is then the
// correctly rounded float quotient (double rounding is innocuous for a
// quotient when 53 >= 2 * 24 + 2). Zeros and infinities are their own
// quotient by d > 0; a NaN stays a NaN.
__device__ __forceinline__ float div_rn_by(float x, double d, double rcp) {
  const double xd = x;
  const double q0 = __dmul_rn(xd, rcp);
  const double q1 = __fma_rn(__fma_rn(-q0, d, xd), rcp, q0);
  const double q2 = __fma_rn(__fma_rn(-q1, d, xd), rcp, q1);
  return (x == 0.f || isinf(x)) ? x : __double2float_rn(q2);
}

__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty,
                                          int stages, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// grid (batch / 128, n_slices, ceil(S / 256)); part (n_slices, batch, s_cols)
__global__ void __launch_bounds__(WG_THREADS, 1)
wide_f_wgmma(const __grid_constant__ CUtensorMap tm_pos,
             const __grid_constant__ CUtensorMap tm_neg,
             const __grid_constant__ CUtensorMap tm_w,
             const int* __restrict__ offs, int step, int tile_b, int f_dim,
             int batch, int s_cols, bf16* __restrict__ fd_scr,
             float* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + P1_STAGES * P1_STAGE;
  const uint32_t empty = full + P1_STAGES * 8;
  const int row0 = blockIdx.x * P1_ROWS;
  const int fs = blockIdx.y, n_slices = gridDim.y;
  const int s0 = blockIdx.z * P1_S;
  const int nk = f_dim / P1_K;
  const int kt0 = fs * nk / n_slices, kt1 = (fs + 1) * nk / n_slices;
  init_ring(full, empty, P1_STAGES, N_CONSUMER_WARPS);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x == 256) {
      const int rp = offs[2 * step] * tile_b + row0;
      const int rn = offs[2 * step + 1] * tile_b + row0;
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, s = i % P1_STAGES;
        mbar_wait(empty + 8 * s, ((i / P1_STAGES) & 1) ^ 1);
        const uint32_t st = base + s * P1_STAGE;
        mbar_expect_tx(full + 8 * s, P1_STAGE);
        tma_load_2d(st, &tm_pos, full + 8 * s, kt * P1_K, rp);
        tma_load_2d(st + P1_ROW_BYTES, &tm_neg, full + 8 * s, kt * P1_K, rn);
        tma_load_2d(st + 2 * P1_ROW_BYTES, &tm_w, full + 8 * s, kt * P1_K, s0);
      }
    }
    return;
  }

  const int t = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, s = i % P1_STAGES;
    mbar_wait(full + 8 * s, (i / P1_STAGES) & 1);
    const uint32_t st = base + s * P1_STAGE;
    uint8_t* const gst = gbase + s * P1_STAGE;
    // fd = pos - neg for this warpgroup's 64 rows, in place of pos; the
    // 16-byte chunk at physical slot p of row r holds features 8 * (p ^ r%8)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int idx = t + 128 * c;
      const int r = wg * 64 + (idx >> 3), p = idx & 7;
      const int off = r * 128 + p * 16;
      const uint4 fd = sub_bf16x8(
          *reinterpret_cast<const uint4*>(gst + off),
          *reinterpret_cast<const uint4*>(gst + P1_ROW_BYTES + off));
      *reinterpret_cast<uint4*>(gst + off) = fd;
      *reinterpret_cast<uint4*>(
          &fd_scr[static_cast<size_t>(row0 + r) * f_dim + kt * P1_K +
                  8 * (p ^ (r & 7))]) = fd;
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P1_K / 16; ++kk) {
      const uint64_t da = sw128_desc(st + wg * (P1_ROW_BYTES / 2) + kk * 32,
                                     16, 1024);
      const uint64_t db = sw128_desc(st + 2 * P1_ROW_BYTES + kk * 32, 16,
                                     1024);
      wgmma_m64n256k16(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // partial f: acc slice j holds rows g, g+8 x columns 8j + 2q, +1
  const int g = lane >> 2, q = lane & 3;
  const int r = row0 + wg * 64 + warp * 16 + g;
  float* const p0 = &part[(static_cast<size_t>(fs) * batch + r) * s_cols + s0];
  float* const p8 = p0 + static_cast<size_t>(8) * s_cols;
#pragma unroll
  for (int j = 0; j < P1_S / 8; ++j) {
    *reinterpret_cast<float2*>(p0 + 8 * j + 2 * q) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(p8 + 8 * j + 2 * q) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// grid (batch / 32, s_pad / 32), block (32, 8): f summed over the slices in
// slice order, viol^T = f > -1 as bf16 0/1 (0 on padding rows s >= S)
__global__ void wide_gate(const float* __restrict__ part, int n_slices,
                          int batch, int s_cols, int s_dim,
                          bf16* __restrict__ violT) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, s0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int s = s0 + tx;
    float v = 0.f;
    if (s < s_dim) {
      float f = 0.f;
      for (int k = 0; k < n_slices; ++k)
        f = __fadd_rn(f, part[(static_cast<size_t>(k) * batch + r0 + i) *
                                  s_cols + s]);
      v = f > -1.f ? 1.f : 0.f;
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8)
    violT[static_cast<size_t>(s0 + i) * batch + r0 + tx] =
        __float2bfloat16_rn(tile[tx][i]);
}

template <int NA>
__device__ __forceinline__ void p2_wgmma(float (&acc)[8 * NA], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (NA == 5) wgmma_m64n80k16_tb(acc, da, db, scale_d);
  else wgmma_m64n64k16_tb(acc, da, db, scale_d);
}

// Phase 2: the products of stages kt0 .. kt0+n-1 (one commit group each)
// into acc, issued and left in flight; with ``zero`` the first product
// overwrites acc (scale-d 0), so no other instruction writes an
// accumulator while the other one's products are in flight.
template <int NA>
__device__ __forceinline__ void p2_issue(float (&acc)[8 * NA], int kt0, int n,
                                         bool zero, uint32_t full,
                                         uint32_t base, int wg) {
  for (int j = 0; j < n; ++j) {
    const int kt = kt0 + j, s = kt % P2_STAGES;
    mbar_wait(full + 8 * s, (kt / P2_STAGES) & 1);
    const uint32_t st = base + s * P2<NA>::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P2_K / 16; ++kk) {
      const uint64_t da = sw128_desc(st + wg * (P2_V_BYTES / 2) + kk * 32,
                                     16, 1024);
      // N-major fd tile, 32-byte swizzle: NA atoms of 16 f x 64 rows
      // (2 KB apart), 8-row groups 256 B apart, 16 rows per k16 step
      const uint64_t db = sw32_desc(st + P2_V_BYTES + kk * 512,
                                    P2_ATOM_BYTES, 256);
      p2_wgmma<NA>(acc, da, db, !(zero && j == 0 && kk == 0));
    }
    wgmma_commit();
  }
}

// Phase 2: stages kt0 .. kt0+n-1 are consumed; every consumer thread
// arrives, so no path diverges.
__device__ __forceinline__ void p2_release(int kt0, int n, uint32_t empty) {
  for (int j = 0; j < n; ++j)
    mbar_arrive(empty + 8 * ((kt0 + j) % P2_STAGES));
}

// Phase 2: one tile_b block's products are done (the caller has waited):
// fold in row order, dfr += acc / (t + B).
template <int NA>
__device__ __forceinline__ void p2_fold(float (&acc)[8 * NA],
                                        float (&dfr)[8 * NA], double tnf,
                                        double rcp) {
  fence_acc(acc);
#pragma unroll
  for (int i = 0; i < 8 * NA; ++i)
    dfr[i] = __fadd_rn(dfr[i], div_rn_by(acc[i], tnf, rcp));
}

// grid (F / (16 * NA), s_pad / 128). FE = tile_b / 64 > 0: the fold of
// block b overlaps the products of block b + 1 (two accumulators; every
// wgmma wait is in straight-line code with a static count, else ptxas
// serializes the pipeline); needs an even number of blocks. FE = 0: one
// block at a time, any tile_b.
template <int NA, int FE>
__global__ void __launch_bounds__(WG_THREADS, 1)
wide_df_wgmma(const __grid_constant__ CUtensorMap tm_viol,
              const __grid_constant__ CUtensorMap tm_fd, int tile_b,
              int f_dim, int s_dim, int batch, float* __restrict__ df,
              bf16* __restrict__ w, const float* __restrict__ mu,
              const float* __restrict__ gamma, float tf, float tnf) {
  constexpr int STAGE = P2<NA>::STAGE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + P2_STAGES * STAGE;
  const uint32_t empty = full + P2_STAGES * 8;
  const int c0 = blockIdx.x * P2<NA>::F, st0 = blockIdx.y * P2_S;
  const int nk = batch / P2_K;
  init_ring(full, empty, P2_STAGES, 2 * 128);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % P2_STAGES;
        mbar_wait(empty + 8 * s, ((kt / P2_STAGES) & 1) ^ 1);
        const uint32_t st = base + s * STAGE;
        mbar_expect_tx(full + 8 * s, STAGE);
        tma_load_2d(st, &tm_viol, full + 8 * s, kt * P2_K, st0);
        for (int a = 0; a < NA; ++a)
          tma_load_2d(st + P2_V_BYTES + a * P2_ATOM_BYTES, &tm_fd,
                      full + 8 * s, c0 + 16 * a, kt * P2_K);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  const int srow = st0 + wg * 64 + warp * 16 + g;  // and srow + 8
  const float ratio = tf / tnf;
  const double tnd = tnf, rcp = __drcp_rn(tnd);
  // slice j of the accumulator: rows srow (elements 0, 1) and srow + 8
  // (2, 3) x columns c0 + 8j + 2q, +1 -- two float2 of df per slice
  float acc0[8 * NA], acc1[8 * NA], dfr[8 * NA];
#pragma unroll
  for (int i = 0; i < 8 * NA; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NA; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = srow + 8 * h;
      float2 v = make_float2(0.f, 0.f);
      if (s < s_dim)
        v = *reinterpret_cast<const float2*>(
            &df[static_cast<size_t>(s) * f_dim + c0 + 8 * j + 2 * q]);
      dfr[4 * j + 2 * h] = __fmul_rn(v.x, ratio);
      dfr[4 * j + 2 * h + 1] = __fmul_rn(v.y, ratio);
    }
  if constexpr (FE == 0) {
    const int fe = tile_b / P2_K;  // stages per tile_b block
    for (int kt = 0; kt < nk; ++kt) {
      p2_issue<NA>(acc0, kt, 1, kt % fe == 0, full, base, wg);
      wgmma_wait<0>();
      p2_release(kt, 1, empty);
      if ((kt + 1) % fe == 0) p2_fold<NA>(acc0, dfr, tnd, rcp);
    }
  } else {
    static_assert(2 * FE <= P2_STAGES, "two blocks must fit the ring");
    const int nb = nk / FE;  // tile_b blocks, an even number
    p2_issue<NA>(acc0, 0, FE, true, full, base, wg);
    int b = 0;
    for (; b + 2 < nb; b += 2) {
      p2_issue<NA>(acc1, (b + 1) * FE, FE, true, full, base, wg);
      wgmma_wait<FE>();
      p2_release(b * FE, FE, empty);
      p2_fold<NA>(acc0, dfr, tnd, rcp);
      p2_issue<NA>(acc0, (b + 2) * FE, FE, true, full, base, wg);
      wgmma_wait<FE>();
      p2_release((b + 1) * FE, FE, empty);
      p2_fold<NA>(acc1, dfr, tnd, rcp);
    }
    p2_issue<NA>(acc1, (b + 1) * FE, FE, true, full, base, wg);
    wgmma_wait<FE>();
    p2_release(b * FE, FE, empty);
    p2_fold<NA>(acc0, dfr, tnd, rcp);
    wgmma_wait<0>();
    p2_fold<NA>(acc1, dfr, tnd, rcp);
  }

  const float nsq = -__fsqrt_rn(tnf);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = srow + 8 * h;
    if (s >= s_dim) continue;
    const float coef = __fdiv_rn(nsq, gamma[s]), m = mu[s];
#pragma unroll
    for (int j = 0; j < 2 * NA; ++j) {
      const size_t o = static_cast<size_t>(s) * f_dim + c0 + 8 * j + 2 * q;
      const float d0 = dfr[4 * j + 2 * h], d1 = dfr[4 * j + 2 * h + 1];
      *reinterpret_cast<float2*>(&df[o]) = make_float2(d0, d1);
      *reinterpret_cast<__nv_bfloat162*>(&w[o]) = __floats2bfloat162_rn(
          fmaxf(0.f, __fmul_rn(coef, __fadd_rn(d0, m))),
          fmaxf(0.f, __fmul_rn(coef, __fadd_rn(d1, m))));
    }
  }
}

// ---- f32 splits: FFMA ------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
wide_f_f32(const float* __restrict__ pos, const float* __restrict__ neg,
           const float* __restrict__ w, const int* __restrict__ offs,
           int step, int tile_b, int f_dim, int s_dim, int batch,
           bf16* __restrict__ violT) {
  constexpr int TK = 16;
  __shared__ __align__(16) float As[TK][T64 + 4];  // fd^T [k][row]
  __shared__ __align__(16) float Bs[TK][T64 + 4];  // w^T  [k][s]
  const int b0 = blockIdx.x * T64, s0 = blockIdx.y * T64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t rp = static_cast<size_t>(offs[2 * step]) * tile_b + b0;
  const size_t rn = static_cast<size_t>(offs[2 * step + 1]) * tile_b + b0;
  const int lr = tid >> 2, lk = (tid & 3) * 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < f_dim; k0 += TK) {
    const float4 pv = *reinterpret_cast<const float4*>(
        &pos[(rp + lr) * f_dim + k0 + lk]);
    const float4 nv = *reinterpret_cast<const float4*>(
        &neg[(rn + lr) * f_dim + k0 + lk]);
    As[lk + 0][lr] = pv.x - nv.x;
    As[lk + 1][lr] = pv.y - nv.y;
    As[lk + 2][lr] = pv.z - nv.z;
    As[lk + 3][lr] = pv.w - nv.w;
    float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + lr < s_dim)
      wv = *reinterpret_cast<const float4*>(
          &w[static_cast<size_t>(s0 + lr) * f_dim + k0 + lk]);
    Bs[lk + 0][lr] = wv.x;
    Bs[lk + 1][lr] = wv.y;
    Bs[lk + 2][lr] = wv.z;
    Bs[lk + 3][lr] = wv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty * 4 + i];
        b[i] = Bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const bf16 one = __float2bfloat16_rn(1.f), zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      violT[static_cast<size_t>(s0 + tx * 4 + j) * batch + b0 + ty * 4 + i] =
          acc[i][j] > -1.f ? one : zero;
}

__global__ void __launch_bounds__(NTHREADS)
wide_df_f32(const float* __restrict__ pos, const float* __restrict__ neg,
            const bf16* __restrict__ violT, const int* __restrict__ offs,
            int step, int tile_b, int f_dim, int s_dim, int batch,
            float* __restrict__ df, float* __restrict__ w,
            const float* __restrict__ mu, const float* __restrict__ gamma,
            float tf, float tnf) {
  constexpr int TK = 16;
  __shared__ __align__(16) float As[TK][T64 + 4];  // viol [row][s]
  __shared__ __align__(16) float Bs[TK][T64 + 4];  // fd   [row][f]
  const int c0 = blockIdx.x * T64, s0 = blockIdx.y * T64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t rp = static_cast<size_t>(offs[2 * step]) * tile_b;
  const size_t rn = static_cast<size_t>(offs[2 * step + 1]) * tile_b;
  const float ratio = tf / tnf;

  float acc[4][4] = {}, dfr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + ty * 4 + i;
      dfr[i][j] = s < s_dim
          ? __fmul_rn(df[static_cast<size_t>(s) * f_dim + c0 + tx * 4 + j],
                      ratio)
          : 0.f;
    }

  for (int kb = 0; kb < batch; kb += TK) {
    {  // viol^T: 64 s x 16 rows, four bf16 per thread
      const int s = tid >> 2, r4 = (tid & 3) * 4;
      const bf16* v = &violT[static_cast<size_t>(s0 + s) * batch + kb + r4];
#pragma unroll
      for (int e = 0; e < 4; ++e) As[r4 + e][s] = __bfloat162float(v[e]);
    }
    {  // fd: 16 rows x 64 f, one float4 per thread
      const int r = tid >> 4, cq = (tid & 15) * 4;
      const float4 pv = *reinterpret_cast<const float4*>(
          &pos[(rp + kb + r) * f_dim + c0 + cq]);
      const float4 nv = *reinterpret_cast<const float4*>(
          &neg[(rn + kb + r) * f_dim + c0 + cq]);
      Bs[r][cq + 0] = pv.x - nv.x;
      Bs[r][cq + 1] = pv.y - nv.y;
      Bs[r][cq + 2] = pv.z - nv.z;
      Bs[r][cq + 3] = pv.w - nv.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty * 4 + i];
        b[i] = Bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if ((kb + TK) % tile_b == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dfr[i][j] = __fadd_rn(dfr[i][j], __fdiv_rn(acc[i][j], tnf));
          acc[i][j] = 0.f;
        }
    }
  }

  const float nsq = -__fsqrt_rn(tnf);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= s_dim) continue;
    const float coef = __fdiv_rn(nsq, gamma[s]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t o = static_cast<size_t>(s) * f_dim + c0 + tx * 4 + j;
      df[o] = dfr[i][j];
      w[o] = fmaxf(0.f, __fmul_rn(coef, __fadd_rn(dfr[i][j], mu[s])));
    }
  }
}

template <int NA, int FE>
cudaError_t launch_df_t(bool first, const CUtensorMap& tm_viol,
                        const CUtensorMap& tm_fd, int tile_b, int f_dim,
                        int s_dim, int s_pad, int batch, float* df, bf16* w,
                        const float* mu, const float* gamma, float tf,
                        float tnf, cudaStream_t st) {
  if (first)
    cudaFuncSetAttribute(wide_df_wgmma<NA, FE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         P2<NA>::SMEM);
  wide_df_wgmma<NA, FE><<<dim3(f_dim / P2<NA>::F, s_pad / P2_S), WG_THREADS,
                          P2<NA>::SMEM, st>>>(tm_viol, tm_fd, tile_b, f_dim,
                                              s_dim, batch, df, w, mu, gamma,
                                              tf, tnf);
  return cudaGetLastError();
}

// Phase 2 with F tiles of 80 when 80 divides F, else 64; blocks of
// tile_b = 128 rows (the solver's tile) in pairs overlap fold and
// products, any other tile_b runs one block at a time. ``first`` sets the
// kernel's shared-memory size.
cudaError_t launch_df(bool first, const CUtensorMap& tm_viol,
                      const CUtensorMap& tm_fd, int tile_b, int f_dim,
                      int s_dim, int s_pad, int batch, float* df, bf16* w,
                      const float* mu, const float* gamma, float tf,
                      float tnf, cudaStream_t st) {
  const bool pipe = tile_b == 2 * P2_K && (batch / tile_b) % 2 == 0;
  const auto fn = f_dim % P2<5>::F == 0
      ? (pipe ? launch_df_t<5, 2> : launch_df_t<5, 0>)
      : (pipe ? launch_df_t<4, 2> : launch_df_t<4, 0>);
  return fn(first, tm_viol, tm_fd, tile_b, f_dim, s_dim, s_pad, batch, df, w,
            mu, gamma, tf, tnf, st);
}

}  // namespace

// dtype 0: f32 splits (w f32), 1: bf16 splits (w bf16). pos (n_pos, f_dim),
// neg (n_neg, f_dim); w/df (s_dim, f_dim) updated in place; mu/gamma
// (s_dim,) f32; offs (n_steps, 2) int32 in tile_b units; violT scratch
// (s_pad, batch) bf16 with s_pad = ceil128(s_dim). bf16 only: fd_scr
// (batch, f_dim) bf16 and part (n_slices, batch, ceil256(s_dim)) f32
// scratch, 16-byte aligned inputs. Requires f_dim % 64 == 0,
// tile_b % 64 == 0, batch % tile_b == 0, and for bf16 batch % 128 == 0 and
// 1 <= n_slices <= f_dim / 64. Launches 2 (f32) or 3 (bf16) kernels per
// step on ``stream``; returns a CUDA error code (cudaErrorInvalidValue when
// a tensor map cannot be encoded).
extern "C" int rda_wide_train(int dtype, const void* pos, const void* neg,
                              void* w, void* df, const void* mu,
                              const void* gamma, const void* offs,
                              void* violT, void* fd_scr, void* part,
                              int n_steps, int t0, int batch, int tile_b,
                              int f_dim, int s_dim, int n_pos, int n_neg,
                              int n_slices, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s_pad = (s_dim + P2_S - 1) / P2_S * P2_S;
  const int n_sz = (s_dim + P1_S - 1) / P1_S;
  CUtensorMap tm_pos, tm_neg, tm_w, tm_viol, tm_fd;
  if (dtype == 1) {
    const uint64_t frow = static_cast<uint64_t>(f_dim) * 2;
    if (!tmap_bf16_2d(&tm_pos, pos, f_dim, n_pos, frow, P1_K, P1_ROWS) ||
        !tmap_bf16_2d(&tm_neg, neg, f_dim, n_neg, frow, P1_K, P1_ROWS) ||
        !tmap_bf16_2d(&tm_w, w, f_dim, s_dim, frow, P1_K, P1_S) ||
        !tmap_bf16_2d(&tm_viol, violT, batch, s_pad,
                      static_cast<uint64_t>(batch) * 2, P2_K, P2_S) ||
        !tmap_bf16_2d(&tm_fd, fd_scr, f_dim, batch, frow, 16, P2_K,
                      CU_TENSOR_MAP_SWIZZLE_32B))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(wide_f_wgmma,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, P1_SMEM);
  }
  const int s_pad64 = (s_dim + T64 - 1) / T64 * T64;
  for (int step = 0; step < n_steps; ++step) {
    // same f32 arithmetic as the TPU kernel: t0 + step * batch, then + batch
    const float tf = static_cast<float>(t0) +
                     static_cast<float>(step) * static_cast<float>(batch);
    const float tnf = tf + static_cast<float>(batch);
    if (dtype == 1) {
      wide_f_wgmma<<<dim3(batch / P1_ROWS, n_slices, n_sz), WG_THREADS,
                     P1_SMEM, st>>>(
          tm_pos, tm_neg, tm_w, static_cast<const int*>(offs), step, tile_b,
          f_dim, batch, n_sz * P1_S, static_cast<bf16*>(fd_scr),
          static_cast<float*>(part));
      wide_gate<<<dim3(batch / 32, s_pad / 32), dim3(32, 8), 0, st>>>(
          static_cast<const float*>(part), n_slices, batch, n_sz * P1_S,
          s_dim, static_cast<bf16*>(violT));
      const cudaError_t e = launch_df(
          step == 0, tm_viol, tm_fd, tile_b, f_dim, s_dim, s_pad, batch,
          static_cast<float*>(df), static_cast<bf16*>(w),
          static_cast<const float*>(mu), static_cast<const float*>(gamma), tf,
          tnf, st);
      if (e != cudaSuccess) return static_cast<int>(e);
    } else {
      const dim3 grid_f(batch / T64, s_pad64 / T64);
      const dim3 grid_df(f_dim / T64, s_pad64 / T64);
      wide_f_f32<<<grid_f, NTHREADS, 0, st>>>(
          static_cast<const float*>(pos), static_cast<const float*>(neg),
          static_cast<const float*>(w), static_cast<const int*>(offs), step,
          tile_b, f_dim, s_dim, batch, static_cast<bf16*>(violT));
      wide_df_f32<<<grid_df, NTHREADS, 0, st>>>(
          static_cast<const float*>(pos), static_cast<const float*>(neg),
          static_cast<const bf16*>(violT), static_cast<const int*>(offs), step,
          tile_b, f_dim, s_dim, batch, static_cast<float*>(df),
          static_cast<float*>(w), static_cast<const float*>(mu),
          static_cast<const float*>(gamma), tf, tnf);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a CTA requests: which 1 = phase 1, 2 = phase 2 at
// F tiles of 80.
extern "C" int rda_wide_smem_bytes(int which) {
  return which == 1 ? P1_SMEM : which == 2 ? P2<5>::SMEM : 0;
}
