// Kernel E: all-pairs hinge sums, per positive and in total.
//
// Replaces the TPU kernel opencv_dlco_tpu/ops/hinge.py::_hinge_kernel
// (entry point hinge_sum_blockwise). For positives p (P,) and negatives
// n (N,), f32:
//   per_pos[i] = sum_j max(0, fl(fl(p_i + 1) - n_j))
//   total      = sum_i per_pos[i]
// (the TPU kernel writes the per-positive partials; jnp.sum adds them
// outside the Pallas call).
//
// Bound on an H100: 3 instructions per (i, j) term on the CUDA cores, none
// an FMA: a subtract and an add on the FP32 pipe (one per lane per clock,
// 33.5 T/s, half the 67 TFLOP/s FFMA peak) and a max at half that rate.
// At P = N = 50,000 either pipe needs 0.149 ms; issuing all three (one warp
// instruction per scheduler per clock, 528 schedulers at 1.98 GHz) needs
// 0.224 ms, the floor of this per-term form. The inputs are 0.4 MB, so the
// kernel is bound by operations. The max is taken as x + |x| = 2 max(0, x),
// an add on the FP32 pipe, and the partial halved once at the end: doubling
// and halving are exact in f32, so the sums carry the same bits as with
// fmaxf, and no term waits on the half-rate min/max unit.
//
// Design:
// - The P x N term grid is split two ways: blocks of TILE_P positives
//   times n_slices slices of the negatives, one CTA a tile. hinge_slices
//   picks n_slices so the tiles spread evenly over the SMs (the busiest SM
//   carries the fewest tile-equivalents of work it can), all resident at
//   once (the occupancy the compiler allows), at least 8 a SM where the
//   problem has that many, each slice at least MIN_SLICE negatives.
// - Each thread holds R positives in registers with R accumulators. A
//   float4 of negatives, read from shared memory as a broadcast, serves 4R
//   terms; the four terms of a positive are added in pairs before they
//   join its accumulator, so the chains are short and independent (the
//   unrolled loop issues 3.03 instructions a term).
// - A slice streams through a two-stage shared-memory ring filled by
//   cp.async: the copy of chunk c + 2 is in flight while chunk c + 1 is
//   summed.
// - Combine in a fixed order, no float atomics: every CTA writes its
//   partials to scratch[slice][i]; an integer counter per positive block
//   names the CTA that finishes the block last, which adds the slices'
//   partials in slice order into per_pos. A second counter names the last
//   block to finish, whose CTA sums per_pos in a fixed order (strided per
//   thread, then a shuffle tree) into total. Whichever CTAs finish last,
//   the sums are the same: two calls give the same bits.
// - The ragged edges are bounds checks, no sentinels: positives past P
//   write nothing; the last slice stops at N (its last < 4 negatives are
//   copied and summed one at a time); N == 0 gives zero partials. The
//   host returns before launching when P == 0.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int R = 8;                       // positives per thread
constexpr int TILE_P = NTHREADS * R;       // positives per CTA
constexpr int CHUNK = 1024;                // negatives per ring stage
constexpr int MIN_SLICE = 256;             // negatives per slice, at least
constexpr int MAX_SLICES = 64;
constexpr int MIN_RESIDENT = 8;            // CTAs per SM to hide latency

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// copy neg[j0, j0 + len) into dst (len <= CHUNK, j0 a multiple of 4)
__device__ __forceinline__ void load_chunk(float* dst, const float* neg,
                                           int j0, int len) {
  const int len4 = len & ~3;
  for (int c = threadIdx.x * 4; c < len4; c += NTHREADS * 4)
    cp_async16(dst + c, neg + j0 + c);
  if (threadIdx.x < len - len4)
    cp_async4(dst + len4 + threadIdx.x, neg + j0 + len4 + threadIdx.x);
}

// 2 max(0, x), exactly: x + |x|, one add on the FP32 pipe (|x| is an
// operand modifier), where fmaxf would take the half-rate min/max unit
__device__ __forceinline__ float relu2(float x) {
  return __fadd_rn(x, fabsf(x));
}

// twice the four terms' sum, added in pairs
__device__ __forceinline__ float hinge4x2(float th, float4 v) {
  const float a = relu2(__fsub_rn(th, v.x));
  const float b = relu2(__fsub_rn(th, v.y));
  const float c = relu2(__fsub_rn(th, v.z));
  const float d = relu2(__fsub_rn(th, v.w));
  return __fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d));
}

// sum of v over the CTA's threads in a fixed order (thread 0 gets it)
__device__ __forceinline__ float cta_sum(float v) {
  __shared__ float warp_sums[NTHREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < NTHREADS / 32; ++w) s = __fadd_rn(s, warp_sums[w]);
  }
  return s;
}

// grid (n_pos_blocks, n_slices); counters (n_pos_blocks + 1) zeroed
__global__ void __launch_bounds__(NTHREADS)
hinge_kernel(const float* __restrict__ pos, const float* __restrict__ neg,
             float* __restrict__ per_pos, float* __restrict__ total,
             float* __restrict__ scratch, unsigned* __restrict__ counters,
             int n_pos, int n_neg, int slice) {
  __shared__ __align__(16) float ring[2][CHUNK];
  __shared__ bool last;
  const int pb = blockIdx.x, k = blockIdx.y, n_slices = gridDim.y;
  const int i0 = pb * TILE_P + threadIdx.x;
  float th[R], acc[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int i = i0 + u * NTHREADS;
    th[u] = i < n_pos ? __fadd_rn(pos[i], 1.f) : 0.f;
    acc[u] = 0.f;
  }

  const int j_begin = min(k * slice, n_neg);
  const int len = min(slice, n_neg - j_begin);
  const int n_chunks = (len + CHUNK - 1) / CHUNK;
  // two groups in flight before the loop (either may be empty)
  for (int c = 0; c < 2; ++c) {
    if (c < n_chunks)
      load_chunk(ring[c], neg, j_begin + c * CHUNK,
                 min(CHUNK, len - c * CHUNK));
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_one();  // chunk c has landed (c + 1 may be in flight)
    __syncthreads();
    const float* ns = ring[c & 1];
    const int clen = min(CHUNK, len - c * CHUNK);
    const int clen4 = clen & ~3;
    const float4* ns4 = reinterpret_cast<const float4*>(ns);
#pragma unroll 4
    for (int q = 0; q < clen4 / 4; ++q) {
      const float4 v = ns4[q];
#pragma unroll
      for (int u = 0; u < R; ++u)
        acc[u] = __fadd_rn(acc[u], hinge4x2(th[u], v));
    }
    for (int c1 = clen4; c1 < clen; ++c1) {
#pragma unroll
      for (int u = 0; u < R; ++u)
        acc[u] = __fadd_rn(acc[u], relu2(__fsub_rn(th[u], ns[c1])));
    }
    __syncthreads();  // every thread is done with this stage
    if (c + 2 < n_chunks)
      load_chunk(ring[c & 1], neg, j_begin + (c + 2) * CHUNK,
                 min(CHUNK, len - (c + 2) * CHUNK));
    cp_async_commit();
  }

  // this slice's partials (acc holds twice each, exactly); the last CTA
  // of the positive block adds them
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int i = i0 + u * NTHREADS;
    if (i < n_pos)
      scratch[static_cast<size_t>(k) * n_pos + i] = 0.5f * acc[u];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[pb], 1u) == static_cast<unsigned>(n_slices - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int i = i0 + u * NTHREADS;
    if (i >= n_pos) continue;
    float s = __ldcg(&scratch[i]);
    for (int kk = 1; kk < n_slices; ++kk)
      s = __fadd_rn(s, __ldcg(&scratch[static_cast<size_t>(kk) * n_pos + i]));
    per_pos[i] = s;
  }

  // the last positive block to be complete sums per_pos into total
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[gridDim.x], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  const int n4 = n_pos / 4;
  const float4* pp4 = reinterpret_cast<const float4*>(per_pos);
  for (int q = threadIdx.x; q < n4; q += NTHREADS) {
    const float4 v = __ldcg(&pp4[q]);
    s0 = __fadd_rn(s0, v.x);
    s1 = __fadd_rn(s1, v.y);
    s2 = __fadd_rn(s2, v.z);
    s3 = __fadd_rn(s3, v.w);
  }
  if (threadIdx.x < n_pos - 4 * n4)
    s0 = __fadd_rn(s0, __ldcg(&per_pos[4 * n4 + threadIdx.x]));
  const float s = cta_sum(__fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3)));
  if (threadIdx.x == 0) total[0] = s;
}

int ceil_div(long a, long b) { return static_cast<int>((a + b - 1) / b); }

}  // namespace

// The number of negative slices for P positives and N negatives on the
// current device (>= 1), or a negative CUDA error code. Among the slice
// counts whose tiles are all resident at once, the one whose busiest SM
// carries the least work; ties go to more resident CTAs (up to 8 a SM),
// then to fewer slices.
extern "C" int hinge_slices(int n_pos, int n_neg) {
  // the SM count and the kernel's occupancy, looked up once a device
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES], occ_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev >= MAX_DEVICES) return -static_cast<int>(cudaErrorInvalidDevice);
  if (occ_of[dev] == 0) {
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, hinge_kernel,
                                                        NTHREADS, 0);
    if (e != cudaSuccess) return -static_cast<int>(e);
    sms_of[dev] = sms;
    occ_of[dev] = std::max(occ, 1);
  }
  const int sms = sms_of[dev], occ = occ_of[dev];
  const long n_pb = ceil_div(n_pos > 0 ? n_pos : 1, TILE_P);
  const int k_max = std::max(1, std::min(MAX_SLICES, n_neg / MIN_SLICE));
  int best = 1;
  double best_cost = 0.;
  long best_res = 0;
  for (int k = 1; k <= k_max; ++k) {
    const long per_sm = ceil_div(n_pb * k, sms);
    if (per_sm > occ && k > 1) break;
    const double cost = static_cast<double>(per_sm) / k;
    const long res = std::min<long>(per_sm, MIN_RESIDENT);
    if (k == 1 || cost < best_cost * (1 - 1e-9) ||
        (cost <= best_cost * (1 + 1e-9) && res > best_res)) {
      best = k;
      best_cost = cost;
      best_res = res;
    }
  }
  return best;
}

// pos (n_pos,), neg (n_neg,) f32, contiguous, neg 16-byte aligned;
// per_pos (n_pos,) f32, 16-byte aligned; total (1,) f32; scratch
// (n_slices, n_pos) f32; counters (ceil(n_pos / 1024) + 1) u32, zeroed
// here. n_slices from hinge_slices. Returns cudaGetLastError() after the
// launch.
extern "C" int hinge_launch(const void* pos, const void* neg, void* per_pos,
                            void* total, void* scratch, void* counters,
                            int n_pos, int n_neg, int n_slices, void* stream) {
  if (n_pos <= 0) return 0;
  if (n_slices < 1 || (n_neg > 0 && reinterpret_cast<uintptr_t>(neg) % 16) ||
      reinterpret_cast<uintptr_t>(per_pos) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pb = ceil_div(n_pos, TILE_P);
  // slices of whole float4s; the last one ends at N
  const int slice = 4 * ceil_div(ceil_div(n_neg, n_slices), 4);
  cudaError_t e = cudaMemsetAsync(counters, 0, (n_pb + 1) * sizeof(unsigned),
                                  st);
  if (e != cudaSuccess) return static_cast<int>(e);
  hinge_kernel<<<dim3(n_pb, n_slices), NTHREADS, 0, st>>>(
      static_cast<const float*>(pos), static_cast<const float*>(neg),
      static_cast<float*>(per_pos), static_cast<float*>(total),
      static_cast<float*>(scratch), static_cast<unsigned*>(counters), n_pos,
      n_neg, slice);
  return static_cast<int>(cudaGetLastError());
}
