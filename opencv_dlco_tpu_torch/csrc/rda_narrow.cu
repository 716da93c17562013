// Kernel C (+ D as its mode): narrow PR-RDA steps, sweep axis S <= 8.
//
// Replaces the TPU kernels opencv_dlco_tpu/ops/fused_rda.py::
// _fused_train_kernel (entry fused_block_train: n_steps RDA steps with f32
// w, df and g) and _fused_kernel (entry fused_block_grad: one block's
// subgradient g = viol^T . fd). Per step, with the sampled blocks
// pos[ip*tile_b : +batch] and neg[in*tile_b : +batch]:
//   fd = pos - neg (input dtype);  f = fd . w_T^T  (w cast to the input dtype)
//   viol = f > -1;  g = viol^T . fd;  df = (t*df + g)/(t+B)
//   w = max(0, -sqrt(t+B)/gamma * (df + mu))
//
// Bound on an H100 at the single-run shape (F 5120, batch 2048): the step
// does 4*B*F*S FLOP (at most 0.34 GFLOP for S = 8) on 2*2048*5120*4 B =
// 83.9 MB of f32 rows (25 us at 3.35 TB/s; half that for bf16): it is bound
// by bytes, so each sampled row is read from HBM once a step.
//
// Design: one persistent cooperative launch for all n_steps, G = min(SMs,
// batch) CTAs of 512 threads. CTA c owns the rows [c*B/G, (c+1)*B/G) of
// every step's block. A row's f, viol and g contribution are row-local:
//   rows:    thread 0 streams the CTA's (pos, neg) row pairs, step after
//            step, into a ring of shared-memory stages by 1-D bulk copies
//            (TMA) behind mbarriers. Each thread owns the columns
//            2 (tid + 512 i) + {0, 1}: it forms fd for them in registers,
//            its share of the S dot products against w (in registers at
//            S <= 2, else read from L2), the warps' sums meet in shared
//            memory (one barrier a row), and every thread adds the 16 warp
//            sums in warp order, takes viol and folds viol * fd into its g
//            registers. fd never leaves the registers: the row is read
//            once. The row's stage is refilled right after that barrier,
//            with the next rows of this step or the first of the next (the
//            offsets are an input table and do not depend on w), so the
//            copies run on through the grid barriers.
//   reduce:  each CTA writes its partial g (S, F) to a scratch; a grid
//            barrier; then (s, k) elements go in tiles of 32 (one a lane),
//            tile i to CTA i mod G: warp w sums the partials of CTAs
//            [w G/16, (w+1) G/16) in CTA order, and lane l of warp 0 adds
//            the 16 warp sums in warp order. Fixed order, no atomics: the
//            same inputs give the same bits in every run. The owner
//            applies the RDA update to w and df (or, in gradient mode,
//            kernel D, writes g); a second grid barrier publishes w to the
//            next step.
// The grid barrier is a counter and a generation word in global memory
// (integer atomics; the counter returns to 0 at every barrier), and the
// cooperative launch guarantees that all G CTAs are resident. Products are
// f32 FFMA on values rounded to the input dtype.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 512;           // threads a CTA
constexpr int NW = NT / 32;       // warps a CTA
constexpr int MAX_RING = 8;       // row stages
constexpr int RED_TILE = 32;      // (s, k) elements a reduction tile

// dynamic shared memory: the row stages, then the warps' dot products
// (two rows' worth), the reduction's warp sums and the stage barriers
__host__ __device__ constexpr size_t stage_bytes(int f_dim, int elem) {
  return 2 * static_cast<size_t>(f_dim) * elem;
}
__host__ __device__ constexpr size_t tail_bytes() {
  return (2 * NW * 8 + NW * RED_TILE) * 4 + 8 * MAX_RING;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// All G CTAs meet here. bar[0] counts arrivals (back to 0 when the last
// arrives), bar[1] is the generation the last arrival advances. A wait
// that outlasts ~2^28 polls traps, so a fault fails the launch instead of
// hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == n - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      unsigned polls = 0;
      while (ld_acquire(bar + 1) == gen)
        if (++polls == (1u << 28)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// one 1-D bulk copy of ``bytes`` (a multiple of 16) global -> shared,
// counted on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// SP >= S: the S axis padded (1, 2, 4 or 8); IC: column pairs a thread
// owns (F <= 2 * 512 * IC)
template <typename T, int SP, int IC>
__global__ void __launch_bounds__(NT, 1)
narrow_persistent(const T* __restrict__ pos, const T* __restrict__ neg,
                  float* w, float* df, float* __restrict__ g_out,
                  const float* __restrict__ mu,
                  const float* __restrict__ gamma,
                  const int* __restrict__ offs, float* partial,
                  unsigned* bar, int n_steps, int t0, int batch, int tile_b,
                  int f_dim, int s_dim, int ring) {
  constexpr bool WREG = SP <= 2;  // w in registers, else read from L2
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_ctas = gridDim.x, cta = blockIdx.x;
  const uint32_t row_bytes = static_cast<uint32_t>(f_dim * sizeof(T));
  const size_t sb = stage_bytes(f_dim, sizeof(T));
  float* const red = reinterpret_cast<float*>(smem + ring * sb);  // [2][NW][8]
  float* const red2 = red + 2 * NW * 8;                           // [NW][32]
  const uint32_t full = smem_u32(red2 + NW * RED_TILE);
  const uint32_t st0 = smem_u32(smem);

  const int r_lo = static_cast<int>(static_cast<long long>(cta) * batch /
                                    n_ctas);
  const int r_hi = static_cast<int>(static_cast<long long>(cta + 1) * batch /
                                    n_ctas);
  const int nr = r_hi - r_lo;
  const int total = n_steps * nr;  // this CTA's rows over all steps

  // row u of this CTA: step u / nr, block row r_lo + u % nr
  auto issue = [&](int u) {
    const int step = u / nr, r = r_lo + u - step * nr;
    const int st = u % ring;
    const size_t rp = static_cast<size_t>(offs[2 * step]) * tile_b + r;
    const size_t rn = static_cast<size_t>(offs[2 * step + 1]) * tile_b + r;
    const uint32_t dst = st0 + static_cast<uint32_t>(st * sb);
    mbar_expect_tx(full + 8 * st, 2 * row_bytes);
    bulk_load(dst, pos + rp * f_dim, row_bytes, full + 8 * st);
    bulk_load(dst + row_bytes, neg + rn * f_dim, row_bytes, full + 8 * st);
  };
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) mbar_init(full + 8 * s, 1);
    mbar_fence_init();
    for (int u = 0; u < ring && u < total; ++u) issue(u);
  }
  __syncthreads();

  float wr[SP][IC][2];  // unused unless WREG
  auto load_w = [&]() {
    if constexpr (WREG) {
#pragma unroll
      for (int s = 0; s < SP; ++s)
#pragma unroll
        for (int i = 0; i < IC; ++i) {
          const int k = 2 * (tid + NT * i);
          float2 v = make_float2(0.f, 0.f);
          if (s < s_dim && k < f_dim)
            v = __ldcg(reinterpret_cast<const float2*>(w + s * f_dim + k));
          wr[s][i][0] = round_to<T>(v.x);
          wr[s][i][1] = round_to<T>(v.y);
        }
    }
  };
  load_w();
  float g[SP][IC][2];
#pragma unroll
  for (int s = 0; s < SP; ++s)
#pragma unroll
    for (int i = 0; i < IC; ++i) g[s][i][0] = g[s][i][1] = 0.f;

  const int n_el = s_dim * f_dim;
  const int n_tiles = (n_el + RED_TILE - 1) / RED_TILE;
  for (int step = 0, u = 0; step < n_steps; ++step) {
    // -- rows: f, viol and the partial g, each row read once -------------
    for (int rr = 0; rr < nr; ++rr, ++u) {
      const int st = u % ring;
      mbar_wait(full + 8 * st, (u / ring) & 1);
      const T* ps = reinterpret_cast<const T*>(smem + st * sb);
      const T* ns = ps + f_dim;
      float fd[IC][2];
      float dot[SP];
#pragma unroll
      for (int s = 0; s < SP; ++s) dot[s] = 0.f;
#pragma unroll
      for (int i = 0; i < IC; ++i) {
        const int k = 2 * (tid + NT * i);
        fd[i][0] = fd[i][1] = 0.f;
        if (k < f_dim) {
          const float2 p = load2(ps + k), q = load2(ns + k);
          fd[i][0] = round_to<T>(p.x - q.x);
          fd[i][1] = round_to<T>(p.y - q.y);
#pragma unroll
          for (int s = 0; s < SP; ++s) {
            float w0, w1;
            if constexpr (WREG) {
              w0 = wr[s][i][0];
              w1 = wr[s][i][1];
            } else {
              float2 v = make_float2(0.f, 0.f);
              if (s < s_dim)
                v = __ldcg(
                    reinterpret_cast<const float2*>(w + s * f_dim + k));
              w0 = round_to<T>(v.x);
              w1 = round_to<T>(v.y);
            }
            dot[s] = fmaf(fd[i][1], w1, fmaf(fd[i][0], w0, dot[s]));
          }
        }
      }
      float* const rb = red + (u & 1) * NW * 8;
#pragma unroll
      for (int s = 0; s < SP; ++s) {
        float v = dot[s];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) rb[warp * 8 + s] = v;
      }
      __syncthreads();  // the row's stage is read; the warp sums are in
      if (tid == 0 && u + ring < total) issue(u + ring);
#pragma unroll
      for (int s = 0; s < SP; ++s) {
        float f = 0.f;
#pragma unroll
        for (int ww = 0; ww < NW; ++ww) f += rb[ww * 8 + s];
        if (s < s_dim && f > -1.f) {
#pragma unroll
          for (int i = 0; i < IC; ++i) {
            g[s][i][0] += fd[i][0];
            g[s][i][1] += fd[i][1];
          }
        }
      }
    }

    // -- this CTA's partial g, then the fixed-order reduction -------------
#pragma unroll
    for (int s = 0; s < SP; ++s)
#pragma unroll
      for (int i = 0; i < IC; ++i) {
        const int k = 2 * (tid + NT * i);
        if (s < s_dim && k < f_dim)
          __stcg(reinterpret_cast<float2*>(partial +
                                           static_cast<size_t>(cta) * n_el +
                                           s * f_dim + k),
                 make_float2(g[s][i][0], g[s][i][1]));
        g[s][i][0] = g[s][i][1] = 0.f;
      }
    grid_sync(bar, n_ctas);

    const float tf = __fadd_rn(
        static_cast<float>(t0),
        __fmul_rn(static_cast<float>(step), static_cast<float>(batch)));
    const float tnf = __fadd_rn(tf, static_cast<float>(batch));
    const int c_lo = warp * n_ctas / NW, c_hi = (warp + 1) * n_ctas / NW;
    for (int tile = cta; tile < n_tiles; tile += n_ctas) {
      const int e = tile * RED_TILE + lane;
      float acc = 0.f;
      if (e < n_el) {
#pragma unroll 8
        for (int c = c_lo; c < c_hi; ++c)
          acc += __ldcg(partial + static_cast<size_t>(c) * n_el + e);
      }
      red2[warp * RED_TILE + lane] = acc;
      __syncthreads();
      if (warp == 0 && e < n_el) {
        float gs = 0.f;
#pragma unroll
        for (int ww = 0; ww < NW; ++ww) gs += red2[ww * RED_TILE + lane];
        if (g_out != nullptr) {
          g_out[e] = gs;
        } else {
          const int s = e / f_dim;
          const float dn =
              __fdiv_rn(__fadd_rn(__fmul_rn(tf, df[e]), gs), tnf);
          df[e] = dn;
          const float coef = __fdiv_rn(-__fsqrt_rn(tnf), gamma[s]);
          __stcg(w + e, fmaxf(0.f, __fmul_rn(coef, __fadd_rn(dn, mu[s]))));
        }
      }
      __syncthreads();
    }
    if (step + 1 < n_steps) {
      grid_sync(bar, n_ctas);  // w of the next step is written everywhere
      load_w();
    }
  }
}

// launch configuration of a width: the row stages that fit next to the
// fixed tail, at most MAX_RING; 0 when not even two fit
int pick_ring(int f_dim, int elem, int* smem) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t sb = stage_bytes(f_dim, elem);
  int ring = MAX_RING;
  while (ring >= 2 && ring * sb + tail_bytes() > static_cast<size_t>(optin))
    --ring;
  if (ring < 2) return 0;
  *smem = static_cast<int>(ring * sb + tail_bytes());
  return ring;
}

int n_ctas_for(int batch) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return batch < sms ? batch : sms;
}

template <typename T, int SP, int IC>
int launch(const T* pos, const T* neg, float* w, float* df, float* g_out,
           const float* mu, const float* gamma, const int* offs,
           float* partial, unsigned* bar, int n_steps, int t0, int batch,
           int tile_b, int f_dim, int s_dim, int n_ctas, cudaStream_t st) {
  int smem = 0;
  int ring = pick_ring(f_dim, sizeof(T), &smem);
  if (ring == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = narrow_persistent<T, SP, IC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&pos, &neg, &w, &df, &g_out, &mu, &gamma, &offs,
                  &partial, &bar, &n_steps, &t0, &batch, &tile_b, &f_dim,
                  &s_dim, &ring};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(n_ctas), dim3(NT), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int IC>
int launch_s(const T* pos, const T* neg, float* w, float* df, float* g_out,
             const float* mu, const float* gamma, const int* offs,
             float* partial, unsigned* bar, int n_steps, int t0, int batch,
             int tile_b, int f_dim, int s_dim, int n_ctas, cudaStream_t st) {
#define NARROW_ARGS                                                        \
  pos, neg, w, df, g_out, mu, gamma, offs, partial, bar, n_steps, t0, batch, \
      tile_b, f_dim, s_dim, n_ctas, st
  if (s_dim <= 1) return launch<T, 1, IC>(NARROW_ARGS);
  if (s_dim <= 2) return launch<T, 2, IC>(NARROW_ARGS);
  if (s_dim <= 4) return launch<T, 4, IC>(NARROW_ARGS);
  // S 5..8 takes F <= 5120 (g in registers); rda_narrow_run checks it
  if constexpr (IC <= 5) return launch<T, 8, IC>(NARROW_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_t(const void* pos, const void* neg, float* w, float* df,
             float* g_out, const float* mu, const float* gamma,
             const int* offs, float* partial, unsigned* bar, int n_steps,
             int t0, int batch, int tile_b, int f_dim, int s_dim, int n_ctas,
             cudaStream_t st) {
  const T* p = static_cast<const T*>(pos);
  const T* n = static_cast<const T*>(neg);
  if (f_dim <= 2 * NT * 5)
    return launch_s<T, 5>(p, n, w, df, g_out, mu, gamma, offs, partial, bar,
                          n_steps, t0, batch, tile_b, f_dim, s_dim, n_ctas,
                          st);
  return launch_s<T, 8>(p, n, w, df, g_out, mu, gamma, offs, partial, bar,
                        n_steps, t0, batch, tile_b, f_dim, s_dim, n_ctas, st);
#undef NARROW_ARGS
}

}  // namespace

// The CTAs of a launch at this batch (the first axis of the partial
// scratch); 0 when the device cannot be queried.
extern "C" int rda_narrow_ctas(int batch) { return n_ctas_for(batch); }

// Dynamic shared memory a CTA requests at width f_dim for rows of
// ``elem`` bytes; 0 when not even two row stages fit.
extern "C" int rda_narrow_smem_bytes(int f_dim, int elem) {
  int smem = 0;
  return pick_ring(f_dim, elem, &smem) ? smem : 0;
}

// The widest F a launch takes at this S: 5120 for S in 5..8, else 8192.
extern "C" int rda_narrow_max_f(int s_dim) {
  return s_dim > 4 ? 2 * NT * 5 : 2 * NT * 8;
}

// dtype 0: f32 splits, 1: bf16 splits. pos/neg (N, f_dim), 16-byte
// aligned; w/df (s_dim, f_dim) f32, updated in place (train mode, g_out ==
// NULL) or only read (gradient mode: n_steps must be 1, g_out (s_dim,
// f_dim) written); mu/gamma (s_dim,) f32; offs (n_steps, 2) int32 in
// tile_b units; partial scratch (rda_narrow_ctas(batch), s_dim, f_dim) f32;
// bar two uint32 words of scratch for the grid barrier, zeroed here on the
// stream before the launch. Requires 1 <= s_dim <= 8, f_dim % 8 ==
// 0 and f_dim <= rda_narrow_max_f(s_dim). Returns a CUDA error code (0 on
// success) after the launch.
extern "C" int rda_narrow_run(int dtype, const void* pos, const void* neg,
                              void* w, void* df, void* g_out, const void* mu,
                              const void* gamma, const void* offs,
                              void* partial, void* bar, int n_steps, int t0,
                              int batch, int tile_b, int f_dim, int s_dim,
                              void* stream) {
  if (s_dim < 1 || s_dim > 8 || f_dim < 8 || f_dim % 8 ||
      f_dim > rda_narrow_max_f(s_dim) || batch < 1 ||
      reinterpret_cast<uintptr_t>(pos) % 16 ||
      reinterpret_cast<uintptr_t>(neg) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_steps == 0) return 0;
  const int n_ctas = n_ctas_for(batch);
  if (n_ctas == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const wf = static_cast<float*>(w);
  float* const dff = static_cast<float*>(df);
  float* const gf = static_cast<float*>(g_out);
  const float* const muf = static_cast<const float*>(mu);
  const float* const gaf = static_cast<const float*>(gamma);
  const int* const of = static_cast<const int*>(offs);
  float* const pf = static_cast<float*>(partial);
  unsigned* const bf = static_cast<unsigned*>(bar);
  const cudaError_t e = cudaMemsetAsync(bf, 0, 2 * sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dtype == 1)
    return launch_t<bf16>(pos, neg, wf, dff, gf, muf, gaf, of, pf, bf,
                          n_steps, t0, batch, tile_b, f_dim, s_dim, n_ctas,
                          st);
  return launch_t<float>(pos, neg, wf, dff, gf, muf, gaf, of, pf, bf,
                         n_steps, t0, batch, tile_b, f_dim, s_dim, n_ctas,
                         st);
}
