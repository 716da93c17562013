// Kernel E: per-positive all-pairs hinge sums.
//
// Replaces the TPU kernel opencv_dlco_tpu/ops/hinge.py::_hinge_kernel
// (entry point hinge_sum_blockwise). For positives p (P,) and negatives
// n (N,), f32:
//   out[i] = sum_j max(0, (p_i + 1) - n_j)
// and the caller sums out over i (as jnp.sum does outside the Pallas call).
//
// Bound on an H100: 3 instructions per (i, j) term on the CUDA cores, none
// an FMA: a subtract and an add on the FP32 pipe (one per lane per clock,
// 33.5 T/s, half the 67 TFLOP/s FFMA peak) and a max at half that rate.
// At P = N = 50,000 either pipe needs 0.15 ms (and issuing all three, one
// warp instruction per scheduler per clock, 0.22 ms). The inputs are
// 0.4 MB, so the kernel is bound by operations.
//
// Design: a CTA owns 256 positives, two per thread, held in registers with
// their running sums; every negative streams through shared memory in
// chunks of 2048 and is read by all threads as a broadcast (no bank
// conflicts), four at a time. Each thread keeps two independent add chains.
// The ragged edges are bounds checks: a thread past P writes nothing and
// the last chunk's loop stops at N (no sentinel values). The TPU kernel's
// sequential negative-tile axis is the loop over chunks inside the CTA.
#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int PER_THREAD = 2;
constexpr int TILE_P = NTHREADS * PER_THREAD;  // positives per CTA
constexpr int CHUNK = 2048;                    // negatives per smem chunk

__global__ void __launch_bounds__(NTHREADS)
hinge_kernel(const float* __restrict__ pos, const float* __restrict__ neg,
             float* __restrict__ out, int n_pos, int n_neg) {
  __shared__ __align__(16) float ns[CHUNK];
  const int i0 = blockIdx.x * TILE_P + threadIdx.x;
  float th[PER_THREAD], acc[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int i = i0 + u * NTHREADS;
    th[u] = i < n_pos ? __fadd_rn(pos[i], 1.f) : 0.f;
    acc[u] = 0.f;
  }
  for (int j0 = 0; j0 < n_neg; j0 += CHUNK) {
    const int len = min(CHUNK, n_neg - j0);
    for (int c = threadIdx.x; c < len; c += NTHREADS) ns[c] = neg[j0 + c];
    __syncthreads();
    const int len4 = len & ~3;
    for (int c = 0; c < len4; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&ns[c]);
#pragma unroll
      for (int u = 0; u < PER_THREAD; ++u) {
        acc[u] = __fadd_rn(acc[u], fmaxf(__fsub_rn(th[u], v.x), 0.f));
        acc[u] = __fadd_rn(acc[u], fmaxf(__fsub_rn(th[u], v.y), 0.f));
        acc[u] = __fadd_rn(acc[u], fmaxf(__fsub_rn(th[u], v.z), 0.f));
        acc[u] = __fadd_rn(acc[u], fmaxf(__fsub_rn(th[u], v.w), 0.f));
      }
    }
    for (int c = len4; c < len; ++c) {
#pragma unroll
      for (int u = 0; u < PER_THREAD; ++u)
        acc[u] = __fadd_rn(acc[u], fmaxf(__fsub_rn(th[u], ns[c]), 0.f));
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int i = i0 + u * NTHREADS;
    if (i < n_pos) out[i] = acc[u];
  }
}

}  // namespace

// pos (n_pos,), neg (n_neg,), out (n_pos,), all f32 and contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int hinge_launch(const void* pos, const void* neg, void* out,
                            int n_pos, int n_neg, void* stream) {
  if (n_pos <= 0) return 0;
  const int grid = (n_pos + TILE_P - 1) / TILE_P;
  hinge_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(neg),
      static_cast<float*>(out), n_pos, n_neg);
  return static_cast<int>(cudaGetLastError());
}
