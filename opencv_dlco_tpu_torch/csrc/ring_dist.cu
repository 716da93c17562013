// Kernel A: pooled ring distances of stage 3.
//
// Replaces the TPU kernel opencv_dlco_tpu/ops/pair_distance_pallas.py::
// _ring_dist_kernel (entry point ring_distances_fused). For a block of pairs
//   out[p, r] = sum_{sym<8, ch<8} (min(F.PT2, 1) - min(F.PT1, 1))^2
// over the 8 ring-major filter rows of ring r and the 8 angle channels.
//
// Bound on an H100 at the stage-3 shape (F 40960 x 4096, bf16): the two
// products are 2 * 2 * 40960 * 4096 * 8 = 5.37 GFLOP per pair, about
// 5.4 us per pair at 989 TFLOP/s bf16 dense; the bank (335 MB) is read once
// per pair block, so the kernel is bound by operations, not bytes.
//
// Design: a GEMM with M = filters, N = pairs x channels, K = pixels and two
// accumulators (side 1, side 2). A CTA owns 64 filters (8 whole rings) x 16
// pairs; 8 warps each own 16 filters (2 rings) x 8 pairs. Products run on
// the tensor cores as mma.sync m16n8k16 bf16 with f32 accumulation; one n8
// fragment is exactly one pair's 8 channels, so the epilogue truncates,
// squares the difference and sums channels and the ring's 8 symmetric rows
// with warp shuffles, in registers. Tiles stream through shared memory in
// 64-pixel steps (plain loads, no cp.async/TMA pipeline yet).
#include "common.cuh"

namespace {

constexpr int TF = 64;        // filters per CTA (8 rings)
constexpr int TP = 16;        // pairs per CTA
constexpr int NCH = 8;        // angle channels
constexpr int TK = 64;        // pixels per smem step
constexpr int LDS = TK + 8;   // padded smem row, bf16 (conflict-free frags)
constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
ring_dist_kernel(const bf16* __restrict__ filt,   // (nf, npix)
                 const bf16* __restrict__ pt1,    // (n_pad, 8, npix)
                 const bf16* __restrict__ pt2,    // (n_pad, 8, npix)
                 float* __restrict__ out,         // (n_pairs, nf / 8)
                 int nf, int npix, int n_pairs) {
  __shared__ __align__(16) bf16 As[TF * LDS];
  __shared__ __align__(16) bf16 B1[TP * NCH * LDS];
  __shared__ __align__(16) bf16 B2[TP * NCH * LDS];

  const int f0 = blockIdx.x * TF;
  const int p0 = blockIdx.y * TP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mi = warp & 3;   // 16-filter block = rings 2*mi, 2*mi+1
  const int ph = warp >> 2;  // pairs ph*8 .. ph*8+7

  float acc1[8][4], acc2[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[j][i] = acc2[j][i] = 0.f;

  for (int k0 = 0; k0 < npix; k0 += TK) {
    for (int c = tid; c < TF * TK / 8; c += NTHREADS) {
      const int r = c / (TK / 8), cc = c % (TK / 8);
      *reinterpret_cast<uint4*>(&As[r * LDS + cc * 8]) =
          *reinterpret_cast<const uint4*>(
              &filt[static_cast<size_t>(f0 + r) * npix + k0 + cc * 8]);
    }
    for (int c = tid; c < TP * NCH * TK / 8; c += NTHREADS) {
      const int r = c / (TK / 8), cc = c % (TK / 8);
      const size_t gi = static_cast<size_t>(p0 * NCH + r) * npix + k0 + cc * 8;
      *reinterpret_cast<uint4*>(&B1[r * LDS + cc * 8]) =
          *reinterpret_cast<const uint4*>(&pt1[gi]);
      *reinterpret_cast<uint4*>(&B2[r * LDS + cc * 8]) =
          *reinterpret_cast<const uint4*>(&pt2[gi]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[4];
      const bf16* ab = &As[(mi * 16 + g) * LDS + kk + q * 2];
      a[0] = ld_u32(ab);
      a[1] = ld_u32(ab + 8 * LDS);
      a[2] = ld_u32(ab + 8);
      a[3] = ld_u32(ab + 8 * LDS + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = ((ph * 8 + j) * NCH + g) * LDS + kk + q * 2;
        uint32_t b[2];
        b[0] = ld_u32(&B1[row]);
        b[1] = ld_u32(&B1[row + 8]);
        mma_bf16_16816(acc1[j], a, b);
        b[0] = ld_u32(&B2[row]);
        b[1] = ld_u32(&B2[row + 8]);
        mma_bf16_16816(acc2[j], a, b);
      }
    }
    __syncthreads();
  }

  const int n_rings = nf / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = fminf(acc2[j][i], 1.f) - fminf(acc1[j][i], 1.f);
      e[i] = d * d;
    }
    float r0 = e[0] + e[1];  // filter row g   -> ring 2*mi
    float r1 = e[2] + e[3];  // filter row g+8 -> ring 2*mi + 1
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, off);
      r1 += __shfl_xor_sync(0xffffffffu, r1, off);
    }
    const int pair = p0 + ph * 8 + j;
    if (lane == 0 && pair < n_pairs) {
      float* o = &out[static_cast<size_t>(pair) * n_rings + f0 / 8 + 2 * mi];
      o[0] = r0;
      o[1] = r1;
    }
  }
}

}  // namespace

// filt (nf, npix) bf16; pt1/pt2 (n_pad, 8, npix) bf16 with n_pad % 16 == 0
// (padding pairs zero); out (n_pairs, nf / 8) f32. nf % 64 == 0 and
// npix % 64 == 0. Returns cudaGetLastError() after the launch.
extern "C" int ring_dist_launch(const void* filt, const void* pt1,
                                const void* pt2, void* out, int nf, int npix,
                                int n_pad, int n_pairs, void* stream) {
  const dim3 grid(nf / TF, n_pad / TP);
  ring_dist_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(filt), static_cast<const bf16*>(pt1),
      static_cast<const bf16*>(pt2), static_cast<float*>(out), nf, npix,
      n_pairs);
  return static_cast<int>(cudaGetLastError());
}
