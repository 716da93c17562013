// Kernel A: pooled ring distances of stage 3.
//
// Replaces the TPU kernel opencv_dlco_tpu/ops/pair_distance_pallas.py::
// _ring_dist_kernel (entry point ring_distances_fused). For a block of pairs
//   out[p, r] = sum_{sym<8, ch<8} (min(F.PT2, 1) - min(F.PT1, 1))^2
// over the 8 ring-major filter rows of ring r and the 8 angle channels.
//
// Bound on an H100 at the stage-3 shape (F 40960 x 4096, bf16): the two
// products are 2 * 2 * 40960 * 4096 * 8 = 5.37 GFLOP per pair, 5.4 us per
// pair at 989 TFLOP/s bf16 dense; the bank (335 MB) is read from device
// memory once per call, so the kernel is bound by operations.
//
// Design: a GEMM with M = filters, N = 2 sides x 16 pairs x 8 channels,
// K = pixels. A CTA owns 128 filters (16 rings) x 16 pairs; one producer
// warp keeps a 4-stage ring of 48 KB stages full by TMA (bank tile 128 x 64
// pixels, side-1 and side-2 column tiles 128 x 64, 128-byte swizzle,
// mbarriers), and two consumer warpgroups each run wgmma m64n256k16 (64
// filters x both sides) from shared memory into 128 f32 registers a thread.
// The accumulator's n8 slice j is pair j's 8 channels (side 1 for j < 16,
// side 2 for j >= 16) with the mma.m16n8 C layout, so the epilogue truncates,
// squares the difference and sums channels and each ring's 8 symmetric rows
// with warp shuffles; the pooled descriptors never reach device memory.
// Tile order: groups of 16 filter tiles, filter tiles fastest, then pair
// tiles, so a wave of CTAs shares its bank tiles and pair tiles in L2 and
// the bank comes from device memory about once per call at any pair block.
// On the H100 (chip_smoke.py): 1.65 ms at 256 pairs against the 1.39 ms
// bound (84%), 3-10% above one cuBLAS product of the same operands; each
// CTA pulls 48 KB from L2 per 4.2 MFLOP stage. Tried and dropped: a
// persistent CTA per SM that overlapped the epilogue with the next tile's
// loads (no faster), and two-CTA clusters multicasting the column tiles
// (slower: each stage then waits for the consumers of both CTAs).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TF = 128;                       // filters per CTA (16 rings)
constexpr int TP = 16;                        // pairs per CTA
constexpr int NCH = 8;                        // angle channels
constexpr int TK = 64;                        // pixels per stage
constexpr int STAGES = 4;
constexpr int GROUP_F = 16;                   // filter tiles per raster group
constexpr int A_BYTES = TF * TK * 2;          // 16 KB bank tile
constexpr int SIDE_BYTES = TP * NCH * TK * 2; // 16 KB column tile per side
constexpr int STAGE_BYTES = A_BYTES + 2 * SIDE_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr int NTHREADS = 288;                 // 2 consumer warpgroups + 1 warp
constexpr int N_CONSUMER_WARPS = 8;

__global__ void __launch_bounds__(NTHREADS, 1)
ring_dist_wgmma(const __grid_constant__ CUtensorMap tm_f,
                const __grid_constant__ CUtensorMap tm_p1,
                const __grid_constant__ CUtensorMap tm_p2,
                float* __restrict__ out, int n_ft, int n_pt, int npix,
                int n_pairs) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * STAGE_BYTES;  // STAGES barriers
  const uint32_t empty = full + STAGES * 8;           // STAGES barriers

  // raster: groups of GROUP_F filter tiles, filter tile fastest
  const int per_group = GROUP_F * n_pt;
  const int grp = blockIdx.x / per_group;
  const int in_grp = blockIdx.x - grp * per_group;
  const int gf0 = grp * GROUP_F;
  const int gsz = min(GROUP_F, n_ft - gf0);
  const int ft = gf0 + in_grp % gsz;
  const int pt = in_grp / gsz;
  const int nk = npix / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, N_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warp: one thread issues the TMA loads
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
        const uint32_t st = base + s * STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load_2d(st, &tm_f, full + 8 * s, kt * TK, ft * TF);
        tma_load_2d(st + A_BYTES, &tm_p1, full + 8 * s, kt * TK,
                    pt * TP * NCH);
        tma_load_2d(st + A_BYTES + SIDE_BYTES, &tm_p2, full + 8 * s, kt * TK,
                    pt * TP * NCH);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns filters ft*128 + wg*64 .. +63
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t st = base + s * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t da = sw128_desc(st + wg * (A_BYTES / 2) + kk * 32, 16,
                                     1024);
      const uint64_t db = sw128_desc(st + A_BYTES + kk * 32, 16, 1024);
      wgmma_m64n256k16(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: rows g and g+8 of this warp's 16 filters are rings ring0 and
  // ring0 + 1; n8 slice j / 16 + j is pair j's side 1 / side 2
  const int n_rings = n_ft * (TF / 8);
  const int ring0 = ft * (TF / 8) + wg * 8 + warp * 2;
#pragma unroll
  for (int j = 0; j < TP; ++j) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d =
          fminf(acc[64 + 4 * j + i], 1.f) - fminf(acc[4 * j + i], 1.f);
      e[i] = d * d;
    }
    float r0 = e[0] + e[1];
    float r1 = e[2] + e[3];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, off);
      r1 += __shfl_xor_sync(0xffffffffu, r1, off);
    }
    const int pair = pt * TP + j;
    if (lane == 0 && pair < n_pairs)
      *reinterpret_cast<float2*>(
          &out[static_cast<size_t>(pair) * n_rings + ring0]) =
          make_float2(r0, r1);
  }
}

}  // namespace

// filt (nf, npix) bf16; pt1/pt2 (n_pad, 8, npix) bf16 with n_pad % 16 == 0
// (padding pairs zero); out (n_pairs, nf / 8) f32. nf % 128 == 0,
// npix % 64 == 0, all three inputs 16-byte aligned. Returns a CUDA error
// code: the launch's, or cudaErrorInvalidValue when a tensor map cannot be
// encoded.
extern "C" int ring_dist_launch(const void* filt, const void* pt1,
                                const void* pt2, void* out, int nf, int npix,
                                int n_pad, int n_pairs, void* stream) {
  CUtensorMap tm_f, tm_p1, tm_p2;
  const uint64_t row = static_cast<uint64_t>(npix) * 2;
  if (!tmap_bf16_2d(&tm_f, filt, npix, nf, row, TK, TF) ||
      !tmap_bf16_2d(&tm_p1, pt1, npix, static_cast<uint64_t>(n_pad) * NCH,
                    row, TK, TP * NCH) ||
      !tmap_bf16_2d(&tm_p2, pt2, npix, static_cast<uint64_t>(n_pad) * NCH,
                    row, TK, TP * NCH))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(ring_dist_wgmma,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  const int n_ft = nf / TF, n_pt = n_pad / TP;
  ring_dist_wgmma<<<n_ft * n_pt, NTHREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      tm_f, tm_p1, tm_p2, static_cast<float*>(out), n_ft, n_pt, npix,
      n_pairs);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a CTA of the kernel requests (``which`` unused).
extern "C" int ring_dist_smem_bytes(int which) { return SMEM_BYTES; }
