// Kernel B: the wide PR-RDA grid, n_steps block-sampled RDA steps.
//
// Replaces the TPU kernels opencv_dlco_tpu/ops/fused_rda.py::
// _fused_train_wide_kernel (entry fused_block_train_wide) and its
// bit-identical twin _fused_train_wide_pipelined_kernel
// (fused_block_train_wide_pipelined): one kernel pair here serves both.
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
// Design: the (S, F) state (bf16 w + f32 df, 7.5 MiB at S=256) is far beyond
// one SM's shared memory but sits in L2, so each step is two launches, with
// no atomics and a fixed summation order:
//   phase 1 (wide_f_*):  tile (64 rows x 64 S), the whole F reduction inside
//     the CTA, fd formed on the fly from the sampled rows, viol^T written as
//     bf16 0/1 to a (S_pad, batch) scratch -- no cross-CTA reduction of f is
//     needed before the gate;
//   phase 2 (wide_df_*): tile (64 S x 64 F) reducing over the batch; the
//     df*t/(t+B) scale, the per-tile_b-rows fold and the step-end w update
//     run in the epilogue.
// bf16 splits use mma.sync m16n8k16 with f32 accumulation; f32 splits use
// FFMA (no TF32). Each step reads the sampled blocks twice (once per phase).
#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int T64 = 64;

// ---- bf16 splits: tensor cores ---------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
wide_f_bf16(const bf16* __restrict__ pos, const bf16* __restrict__ neg,
            const bf16* __restrict__ w, const int* __restrict__ offs,
            int step, int tile_b, int f_dim, int s_dim, int batch,
            bf16* __restrict__ violT) {
  constexpr int LDS = T64 + 8;
  __shared__ __align__(16) bf16 As[T64 * LDS];  // fd  [row][k]
  __shared__ __align__(16) bf16 Bs[T64 * LDS];  // w   [s][k]
  const int b0 = blockIdx.x * T64, s0 = blockIdx.y * T64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mi = warp & 3, nj = warp >> 2;
  const size_t rp = static_cast<size_t>(offs[2 * step]) * tile_b + b0;
  const size_t rn = static_cast<size_t>(offs[2 * step + 1]) * tile_b + b0;

  float acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int k0 = 0; k0 < f_dim; k0 += T64) {
    for (int c = tid; c < T64 * T64 / 8; c += NTHREADS) {
      const int r = c >> 3, cc = (c & 7) * 8;
      const uint4 pv =
          *reinterpret_cast<const uint4*>(&pos[(rp + r) * f_dim + k0 + cc]);
      const uint4 nv =
          *reinterpret_cast<const uint4*>(&neg[(rn + r) * f_dim + k0 + cc]);
      *reinterpret_cast<uint4*>(&As[r * LDS + cc]) = sub_bf16x8(pv, nv);
      uint4 wv = make_uint4(0, 0, 0, 0);
      if (s0 + r < s_dim)
        wv = *reinterpret_cast<const uint4*>(
            &w[static_cast<size_t>(s0 + r) * f_dim + k0 + cc]);
      *reinterpret_cast<uint4*>(&Bs[r * LDS + cc]) = wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T64; kk += 16) {
      uint32_t a[4];
      const bf16* ab = &As[(mi * 16 + g) * LDS + kk + q * 2];
      a[0] = ld_u32(ab);
      a[1] = ld_u32(ab + 8 * LDS);
      a[2] = ld_u32(ab + 8);
      a[3] = ld_u32(ab + 8 * LDS + 8);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bf16* bb = &Bs[(nj * 32 + t * 8 + g) * LDS + kk + q * 2];
        uint32_t b[2] = {ld_u32(bb), ld_u32(bb + 8)};
        mma_bf16_16816(acc[t], a, b);
      }
    }
    __syncthreads();
  }
  const bf16 one = __float2bfloat16_rn(1.f), zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = b0 + mi * 16 + g + (i >= 2 ? 8 : 0);
      const int s = s0 + nj * 32 + t * 8 + q * 2 + (i & 1);
      violT[static_cast<size_t>(s) * batch + row] = acc[t][i] > -1.f ? one : zero;
    }
}

__global__ void __launch_bounds__(NTHREADS)
wide_df_bf16(const bf16* __restrict__ pos, const bf16* __restrict__ neg,
             const bf16* __restrict__ violT, const int* __restrict__ offs,
             int step, int tile_b, int f_dim, int s_dim, int batch,
             float* __restrict__ df, bf16* __restrict__ w,
             const float* __restrict__ mu, const float* __restrict__ gamma,
             float tf, float tnf) {
  constexpr int TKB = 32;           // batch rows per smem step
  constexpr int LDA = TKB + 8;      // viol^T tile row (bf16)
  constexpr int LDB = T64 + 8;      // fd tile row (bf16)
  __shared__ __align__(16) bf16 As[T64 * LDA];  // viol^T [s][row]
  __shared__ __align__(16) bf16 Bs[TKB * LDB];  // fd     [row][f]
  const int c0 = blockIdx.x * T64, s0 = blockIdx.y * T64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mi = warp & 3, nj = warp >> 2;
  const size_t rp = static_cast<size_t>(offs[2 * step]) * tile_b;
  const size_t rn = static_cast<size_t>(offs[2 * step + 1]) * tile_b;
  const float ratio = tf / tnf;

  float acc[4][4], dfr[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + mi * 16 + g + (i >= 2 ? 8 : 0);
      const int c = c0 + nj * 32 + t * 8 + q * 2 + (i & 1);
      acc[t][i] = 0.f;
      dfr[t][i] = s < s_dim
          ? __fmul_rn(df[static_cast<size_t>(s) * f_dim + c], ratio) : 0.f;
    }

  for (int kb = 0; kb < batch; kb += TKB) {
    {  // viol^T tile: 64 s x 32 rows = 256 x uint4, one per thread
      const int r = tid >> 2, cc = (tid & 3) * 8;
      *reinterpret_cast<uint4*>(&As[r * LDA + cc]) =
          *reinterpret_cast<const uint4*>(
              &violT[static_cast<size_t>(s0 + r) * batch + kb + cc]);
    }
    {  // fd tile: 32 rows x 64 f = 256 x uint4, one per thread
      const int r = tid >> 3, cc = (tid & 7) * 8;
      const uint4 pv = *reinterpret_cast<const uint4*>(
          &pos[(rp + kb + r) * f_dim + c0 + cc]);
      const uint4 nv = *reinterpret_cast<const uint4*>(
          &neg[(rn + kb + r) * f_dim + c0 + cc]);
      *reinterpret_cast<uint4*>(&Bs[r * LDB + cc]) = sub_bf16x8(pv, nv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TKB; kk += 16) {
      uint32_t a[4];
      const bf16* ab = &As[(mi * 16 + g) * LDA + kk + q * 2];
      a[0] = ld_u32(ab);
      a[1] = ld_u32(ab + 8 * LDA);
      a[2] = ld_u32(ab + 8);
      a[3] = ld_u32(ab + 8 * LDA + 8);
      const int k = kk + q * 2;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = nj * 32 + t * 8 + g;
        uint32_t b[2];
        b[0] = pack_bf16(Bs[k * LDB + n], Bs[(k + 1) * LDB + n]);
        b[1] = pack_bf16(Bs[(k + 8) * LDB + n], Bs[(k + 9) * LDB + n]);
        mma_bf16_16816(acc[t], a, b);
      }
    }
    __syncthreads();
    if ((kb + TKB) % tile_b == 0) {  // fold one tile_b block: df += g/(t+B)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dfr[t][i] = __fadd_rn(dfr[t][i], __fdiv_rn(acc[t][i], tnf));
          acc[t][i] = 0.f;
        }
    }
  }

  const float nsq = -__fsqrt_rn(tnf);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + mi * 16 + g + (i >= 2 ? 8 : 0);
      const int c = c0 + nj * 32 + t * 8 + q * 2 + (i & 1);
      if (s < s_dim) {
        const size_t o = static_cast<size_t>(s) * f_dim + c;
        df[o] = dfr[t][i];
        const float coef = __fdiv_rn(nsq, gamma[s]);
        w[o] = __float2bfloat16_rn(
            fmaxf(0.f, __fmul_rn(coef, __fadd_rn(dfr[t][i], mu[s]))));
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

}  // namespace

// dtype 0: f32 splits (w f32), 1: bf16 splits (w bf16). pos/neg (N, f_dim);
// w/df (s_dim, f_dim) updated in place; mu/gamma (s_dim,) f32; offs
// (n_steps, 2) int32 in tile_b units; violT scratch (ceil64(s_dim), batch)
// bf16. Requires f_dim % 64 == 0, tile_b % 64 == 0, batch % tile_b == 0.
// Launches 2 kernels per step on ``stream``; returns cudaGetLastError().
extern "C" int rda_wide_train(int dtype, const void* pos, const void* neg,
                              void* w, void* df, const void* mu,
                              const void* gamma, const void* offs,
                              void* violT, int n_steps, int t0, int batch,
                              int tile_b, int f_dim, int s_dim, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s_pad = (s_dim + T64 - 1) / T64 * T64;
  const dim3 grid_f(batch / T64, s_pad / T64);
  const dim3 grid_df(f_dim / T64, s_pad / T64);
  for (int step = 0; step < n_steps; ++step) {
    // same f32 arithmetic as the TPU kernel: t0 + step * batch, then + batch
    const float tf = static_cast<float>(t0) +
                     static_cast<float>(step) * static_cast<float>(batch);
    const float tnf = tf + static_cast<float>(batch);
    if (dtype == 1) {
      wide_f_bf16<<<grid_f, NTHREADS, 0, st>>>(
          static_cast<const bf16*>(pos), static_cast<const bf16*>(neg),
          static_cast<const bf16*>(w), static_cast<const int*>(offs), step,
          tile_b, f_dim, s_dim, batch, static_cast<bf16*>(violT));
      wide_df_bf16<<<grid_df, NTHREADS, 0, st>>>(
          static_cast<const bf16*>(pos), static_cast<const bf16*>(neg),
          static_cast<const bf16*>(violT), static_cast<const int*>(offs), step,
          tile_b, f_dim, s_dim, batch, static_cast<float*>(df),
          static_cast<bf16*>(w), static_cast<const float*>(mu),
          static_cast<const float*>(gamma), tf, tnf);
    } else {
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
