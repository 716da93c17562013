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
// by bytes.
//
// Design: per step three launches, deterministic (no atomics):
//   narrow_f:    one warp per sampled row computes f for all S <= 8 and
//                writes viol (S, batch);
//   narrow_g:    grid (F / 128, batch / tile_b); each thread owns one
//                feature column and accumulates g over one tile_b block of
//                rows into a partial buffer (n_tiles, S, F);
//   narrow_upd:  sums the partials in tile order (the TPU kernel's g_s +=
//                per-tile order) and applies the RDA update to w, df in place
//                -- or, in gradient mode (kernel D), writes g.
// Products are f32 FFMA on values rounded to the input dtype.
#include "common.cuh"

namespace {

constexpr int SMAX = 8;

template <typename T>
__global__ void __launch_bounds__(128)
narrow_f(const T* __restrict__ pos, const T* __restrict__ neg,
         const float* __restrict__ w, const int* __restrict__ offs, int step,
         int tile_b, int f_dim, int s_dim, int batch,
         float* __restrict__ viol) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= batch) return;
  const size_t rp = static_cast<size_t>(offs[2 * step]) * tile_b + row;
  const size_t rn = static_cast<size_t>(offs[2 * step + 1]) * tile_b + row;
  float acc[SMAX] = {};
  for (int k = lane; k < f_dim; k += 32) {
    const float fd = round_to<T>(to_f32(pos[rp * f_dim + k]) -
                                 to_f32(neg[rn * f_dim + k]));
#pragma unroll
    for (int s = 0; s < SMAX; ++s)
      if (s < s_dim)
        acc[s] = fmaf(fd, round_to<T>(w[static_cast<size_t>(s) * f_dim + k]),
                      acc[s]);
  }
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    float v = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && s < s_dim)
      viol[static_cast<size_t>(s) * batch + row] = v > -1.f ? 1.f : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
narrow_g(const T* __restrict__ pos, const T* __restrict__ neg,
         const float* __restrict__ viol, const int* __restrict__ offs,
         int step, int tile_b, int f_dim, int s_dim, int batch,
         float* __restrict__ partial) {
  const int k = blockIdx.x * 128 + threadIdx.x;
  const int tile = blockIdx.y;
  if (k >= f_dim) return;
  const int r0 = tile * tile_b;
  const size_t rp = static_cast<size_t>(offs[2 * step]) * tile_b + r0;
  const size_t rn = static_cast<size_t>(offs[2 * step + 1]) * tile_b + r0;
  float g[SMAX] = {};
  for (int b = 0; b < tile_b; ++b) {
    const float fd = round_to<T>(to_f32(pos[(rp + b) * f_dim + k]) -
                                 to_f32(neg[(rn + b) * f_dim + k]));
#pragma unroll
    for (int s = 0; s < SMAX; ++s)
      if (s < s_dim)
        g[s] = fmaf(viol[static_cast<size_t>(s) * batch + r0 + b], fd, g[s]);
  }
#pragma unroll
  for (int s = 0; s < SMAX; ++s)
    if (s < s_dim)
      partial[(static_cast<size_t>(tile) * s_dim + s) * f_dim + k] = g[s];
}

__global__ void __launch_bounds__(256)
narrow_upd(const float* __restrict__ partial, int n_tiles, int f_dim,
           int s_dim, float* __restrict__ w, float* __restrict__ df,
           float* __restrict__ g_out, const float* __restrict__ mu,
           const float* __restrict__ gamma, float tf, float tnf) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= s_dim * f_dim) return;
  const int s = idx / f_dim;
  float g = 0.f;
  for (int t = 0; t < n_tiles; ++t)
    g = __fadd_rn(g, partial[static_cast<size_t>(t) * s_dim * f_dim + idx]);
  if (g_out != nullptr) {
    g_out[idx] = g;
    return;
  }
  const float dn = __fdiv_rn(__fadd_rn(__fmul_rn(tf, df[idx]), g), tnf);
  df[idx] = dn;
  const float coef = __fdiv_rn(-__fsqrt_rn(tnf), gamma[s]);
  w[idx] = fmaxf(0.f, __fmul_rn(coef, __fadd_rn(dn, mu[s])));
}

template <typename T>
int run(const T* pos, const T* neg, float* w, float* df, float* g_out,
        const float* mu, const float* gamma, const int* offs, float* viol,
        float* partial, int n_steps, int t0, int batch, int tile_b,
        int f_dim, int s_dim, cudaStream_t st) {
  const int n_tiles = batch / tile_b;
  for (int step = 0; step < n_steps; ++step) {
    const float tf = static_cast<float>(t0) +
                     static_cast<float>(step) * static_cast<float>(batch);
    const float tnf = tf + static_cast<float>(batch);
    narrow_f<T><<<(batch + 3) / 4, 128, 0, st>>>(
        pos, neg, w, offs, step, tile_b, f_dim, s_dim, batch, viol);
    narrow_g<T><<<dim3((f_dim + 127) / 128, n_tiles), 128, 0, st>>>(
        pos, neg, viol, offs, step, tile_b, f_dim, s_dim, batch, partial);
    narrow_upd<<<(s_dim * f_dim + 255) / 256, 256, 0, st>>>(
        partial, n_tiles, f_dim, s_dim, w, df, g_out, mu, gamma, tf, tnf);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: f32 splits, 1: bf16 splits. pos/neg (N, f_dim); w/df (s_dim,
// f_dim) f32, updated in place (train mode, g_out == NULL) or only read
// (gradient mode: n_steps must be 1, g_out (s_dim, f_dim) written); mu/gamma
// (s_dim,) f32; offs (n_steps, 2) int32 in tile_b units; viol scratch
// (s_dim, batch) f32; partial scratch (batch / tile_b, s_dim, f_dim) f32.
// Requires s_dim <= 8 and batch % tile_b == 0. Returns cudaGetLastError().
extern "C" int rda_narrow_run(int dtype, const void* pos, const void* neg,
                              void* w, void* df, void* g_out, const void* mu,
                              const void* gamma, const void* offs, void* viol,
                              void* partial, int n_steps, int t0, int batch,
                              int tile_b, int f_dim, int s_dim, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const wf = static_cast<float*>(w);
  float* const dff = static_cast<float*>(df);
  float* const gf = static_cast<float*>(g_out);
  const float* const muf = static_cast<const float*>(mu);
  const float* const gaf = static_cast<const float*>(gamma);
  const int* const of = static_cast<const int*>(offs);
  float* const vf = static_cast<float*>(viol);
  float* const pf = static_cast<float*>(partial);
  if (dtype == 1)
    return run<bf16>(static_cast<const bf16*>(pos),
                     static_cast<const bf16*>(neg), wf, dff, gf, muf, gaf, of,
                     vf, pf, n_steps, t0, batch, tile_b, f_dim, s_dim, st);
  return run<float>(static_cast<const float*>(pos),
                    static_cast<const float*>(neg), wf, dff, gf, muf, gaf, of,
                    vf, pf, n_steps, t0, batch, tile_b, f_dim, s_dim, st);
}
