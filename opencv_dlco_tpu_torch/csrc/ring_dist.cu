// Kernel A: pooled ring distances of stage 3, in two element modes: bf16
// and f32 (HIGHEST parity, as a 3xTF32 split product).
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
//
// f32 mode (the template parameter F32; the route of precision "highest"):
// the same algorithm on split operands. Pre-passes split every element x
// into
//   hi = rna_tf32(x),  lo = rna_tf32(x - hi)
// (tf32_rna in common.cuh; |x - hi - lo| <= 2^-22 |x|) and store both as
// planes of f32 words: the bank once per stage-3 call (ring_split_bank),
// each block's columns once per block (ring_split_cols, which also lays
// them out as the tiles load them: per 8-pair tile 128 rows, side 1's 64
// then side 2's, row 8 p + c pair p's channel c, pixels contiguous; pairs
// past the block zero). Non-finite values keep hi as they are and lo 0, so
// they reach the products, and the truncation min(x, 1) keeps a NaN (fminf
// would drop it), so a non-finite input gives a non-finite row. The kernel
// forms F.PT = lo_F.hi_PT + hi_F.lo_PT + hi_F.hi_PT as three wgmma tf32
// products a k8 step (tf32 products are exact; lo_F.lo_PT, below 2^-22 of
// each term, is left out). The tensor cores' f32 accumulation truncates at
// a cost that grows with the accumulator's magnitude and the number of
// products added into it (kernel F's f32 mode met 1.7e-5 on 216 products;
// here K = 4,096 is 512 k8 steps), so the products go into a fresh
// accumulator each stage (32 pixels: 12 products), whose sums are added in
// registers in stage order, rounded to nearest: truncation then costs a
// stage's 12 adds, not K's. knn_topk.cu keeps the small products apart in
// a third accumulator as well; three sets of 64 registers a thread need
// more than a CTA of two consumer warpgroups can hold (spilled at 168
// registers a thread, and at 232 with a producer warpgroup that gives its
// registers up, 2.8x slower), while two fit in 143 without spills and
// give the same rows to within 2.5e-7 of the plain f32 version at 8,192
// pairs. Two sets of 64 fit n128, not n256: a CTA owns 128 filters x 8
// pairs (N = 2 sides x 8 pairs x 8 channels), and a stage is 32 pixels
// (one 128-byte row of f32 words) of both planes of the bank tile and of
// the column tile, 32 + 32 KB, in a ring of 3 (192 KB). Each warpgroup
// waits for its stage's products before adding them, so the two
// warpgroups' products keep the tensor cores busy in turn. Same raster and
// epilogue.
//
// Bound in f32 at 8,192 pairs: 3 x 44.0 TFLOP of tf32 products, 0.267 s at
// 495 TFLOP/s (one f32 FFMA pass of the same products: 0.657 s at 67); the
// splits read 2.8 GB and write 5.6 GB, ~2.5 ms at 3.35 TB/s. A CTA pulls
// 64 KB from L2 per 3.1 MFLOP stage (48 FLOP a byte against bf16's 87): at
// the tf32 peak the card would need ~10 TB/s from L2. A wave of 132 CTAs
// shares 16 bank tiles and ~8 pair tiles (~100 MB of split operands), more
// than L2 holds, so a bank tile comes from device memory once per wave in
// which it is used, ~250 GB a 8,192-pair call, below a third of HBM's rate
// at the bound. On the H100: 0.341 s at 8,192 pairs (78% of the bound;
// the broadcast f32 product it replaces took 4.73 s) and 10.5 ms at 256
// (80%). Tried and dropped: 8 or 32 filter tiles a raster group (3-11%
// slower), a fresh accumulator every 2 or 4 stages (4-11% slower: ptxas
// serialises the products in the divergent paths).
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TF = 128;                       // filters per CTA (16 rings)
constexpr int NCH = 8;                        // angle channels
constexpr int GROUP_F = 16;                   // filter tiles per raster group
constexpr int NTHREADS = 288;                 // 2 consumer warpgroups + 1 warp
constexpr int N_CONSUMER_WARPS = 8;
constexpr int WG_A_BYTES = 64 * 128;          // a warpgroup's 64 bank rows

// A mode's tile: pairs per CTA, pixels per stage, stages, and the planes
// and element bytes of the operands (f32: tf32 hi and lo planes).
template <bool F32>
struct Tile {
  static constexpr int TP = F32 ? 8 : 16;
  static constexpr int TK = F32 ? 32 : 64;
  static constexpr int STAGES = F32 ? 3 : 4;
  static constexpr int PLANE_A = TF * TK * (F32 ? 4 : 2);  // bank tile
  static constexpr int SIDE_BYTES = TP * NCH * TK * (F32 ? 4 : 2);
  static constexpr int PLANE_B = 2 * SIDE_BYTES;           // column tile
  static constexpr int A_BYTES = PLANE_A * (F32 ? 2 : 1);
  static constexpr int STAGE_BYTES = A_BYTES + PLANE_B * (F32 ? 2 : 1);
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  static constexpr int NA = 4 * 2 * TP;  // accumulators a thread
};

// min(x, 1) as the mode's epilogue takes it: bf16 fminf, f32 keeping a NaN
template <bool F32>
__device__ __forceinline__ float trunc1(float x) {
  if constexpr (F32)
    return x > 1.f ? 1.f : x;
  else
    return fminf(x, 1.f);
}

// F32: tm_f is the split bank (planes hi, lo) and tm_p1 the block's split
// columns (ring_split_cols' layout); tm_p2 is unused. bf16: the bank and
// the column tiles of side 1 and side 2.
template <bool F32>
__global__ void __launch_bounds__(NTHREADS, 1)
ring_dist_wgmma(const __grid_constant__ CUtensorMap tm_f,
                const __grid_constant__ CUtensorMap tm_p1,
                const __grid_constant__ CUtensorMap tm_p2,
                float* __restrict__ out, int n_ft, int n_pt, int npix,
                int n_pairs) {
  using T = Tile<F32>;
  constexpr int TP = T::TP, TK = T::TK, STAGES = T::STAGES;
  constexpr int A_BYTES = T::A_BYTES, SIDE_BYTES = T::SIDE_BYTES;
  constexpr int STAGE_BYTES = T::STAGE_BYTES;
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
        if constexpr (F32) {  // both planes of each tile, hi then lo
          tma_load_3d(st, &tm_f, full + 8 * s, kt * TK, ft * TF, 0);
          tma_load_3d(st + A_BYTES, &tm_p1, full + 8 * s, kt * TK,
                      pt * 2 * TP * NCH, 0);
        } else {
          tma_load_2d(st, &tm_f, full + 8 * s, kt * TK, ft * TF);
          tma_load_2d(st + A_BYTES, &tm_p1, full + 8 * s, kt * TK,
                      pt * TP * NCH);
          tma_load_2d(st + A_BYTES + SIDE_BYTES, &tm_p2, full + 8 * s,
                      kt * TK, pt * TP * NCH);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns filters ft*128 + wg*64 .. +63
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float acc[T::NA];
#pragma unroll
  for (int i = 0; i < T::NA; ++i) acc[i] = 0.f;

  if constexpr (F32) {
    // per k8 step the three products into acc, fresh each stage; tot sums
    // the stages' acc in order
    float tot[T::NA];
#pragma unroll
    for (int i = 0; i < T::NA; ++i) tot[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + 8 * s, (kt / STAGES) & 1);
      const uint32_t a = base + s * STAGE_BYTES + wg * WG_A_BYTES;
      const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        const uint64_t ah = sw128_desc(a + kk * 32, 16, 1024);
        const uint64_t al = sw128_desc(a + T::PLANE_A + kk * 32, 16, 1024);
        const uint64_t bh = sw128_desc(b + kk * 32, 16, 1024);
        const uint64_t bl = sw128_desc(b + T::PLANE_B + kk * 32, 16, 1024);
        wgmma_m64n128k8_tf32(acc, al, bh, kk != 0);
        wgmma_m64n128k8_tf32(acc, ah, bl, 1);
        wgmma_m64n128k8_tf32(acc, ah, bh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();  // the stage's products are done: release it
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < T::NA; ++i) tot[i] += acc[i];
    }
#pragma unroll
    for (int i = 0; i < T::NA; ++i) acc[i] = tot[i];
  } else {
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
  }

  // epilogue: rows g and g+8 of this warp's 16 filters are rings ring0 and
  // ring0 + 1; n8 slice j / TP + j is pair j's side 1 / side 2
  const int n_rings = n_ft * (TF / 8);
  const int ring0 = ft * (TF / 8) + wg * 8 + warp * 2;
#pragma unroll
  for (int j = 0; j < TP; ++j) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = trunc1<F32>(acc[4 * TP + 4 * j + i]) -
                      trunc1<F32>(acc[4 * j + i]);
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

// x split into its tf32 hi and lo parts (lo 0 where x is not finite)
__device__ __forceinline__ void split2(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = isfinite(x) ? tf32_rna(x - hi) : 0.f;
}

// The f32 mode's bank pre-pass: x (n4 float4) into the planes hi (n4) and
// lo (n4).
__global__ void __launch_bounds__(256)
ring_split_bank(const float4* __restrict__ x, float4* __restrict__ hi,
                float4* __restrict__ lo, size_t n4) {
  for (size_t i = blockIdx.x * 256ull + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * 256) {
    const float4 v = x[i];
    float4 h, l;
    split2(v.x, h.x, l.x);
    split2(v.y, h.y, l.y);
    split2(v.z, h.z, l.z);
    split2(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// The f32 mode's column pre-pass: pixel k of pair p's 8 channels on one
// side (pt (n_pairs, npix, 8) f32, 32 bytes a pixel) into rows
// (p / TP) * 128 + side * 64 + (p % TP) * 8 + c of the planes hi and lo
// (plane_floats apart); a thread a pixel, 256 pixels a CTA, kb CTAs a
// pair; pairs past n_pairs zero.
__global__ void __launch_bounds__(256)
ring_split_cols(const float* __restrict__ pt1, const float* __restrict__ pt2,
                float* __restrict__ cols, int npix, int n_pairs, int kb,
                size_t plane_floats) {
  constexpr int TP = Tile<true>::TP;
  const int p = blockIdx.x / kb;
  const int k = (blockIdx.x - p * kb) * 256 + threadIdx.x;
  const int side = blockIdx.y;
  if (k >= npix) return;
  float v[NCH];
  if (p < n_pairs) {
    const float4* src = reinterpret_cast<const float4*>(
        (side ? pt2 : pt1) + (static_cast<size_t>(p) * npix + k) * NCH);
    const float4 a = src[0], b = src[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < NCH; ++c) v[c] = 0.f;
  }
  const size_t row0 = static_cast<size_t>(p / TP) * (2 * TP * NCH) +
                      side * (TP * NCH) + (p % TP) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    float h, l;
    split2(v[c], h, l);
    const size_t o = (row0 + c) * npix + k;
    cols[o] = h;
    cols[plane_floats + o] = l;
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
  using T = Tile<false>;
  CUtensorMap tm_f, tm_p1, tm_p2;
  const uint64_t row = static_cast<uint64_t>(npix) * 2;
  if (!tmap_bf16_2d(&tm_f, filt, npix, nf, row, T::TK, TF) ||
      !tmap_bf16_2d(&tm_p1, pt1, npix, static_cast<uint64_t>(n_pad) * NCH,
                    row, T::TK, T::TP * NCH) ||
      !tmap_bf16_2d(&tm_p2, pt2, npix, static_cast<uint64_t>(n_pad) * NCH,
                    row, T::TK, T::TP * NCH))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(ring_dist_wgmma<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       T::SMEM_BYTES);
  const int n_ft = nf / TF, n_pt = n_pad / T::TP;
  ring_dist_wgmma<false><<<n_ft * n_pt, NTHREADS, T::SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      tm_f, tm_p1, tm_p2, static_cast<float*>(out), n_ft, n_pt, npix,
      n_pairs);
  return static_cast<int>(cudaGetLastError());
}

// The f32 mode's bank pre-pass: filt (nf, npix) f32 into planes (2, nf,
// npix) f32, tf32 hi then lo; n = nf * npix, a multiple of 4, both 16-byte
// aligned. Returns a CUDA error code.
extern "C" int ring_split_bank_launch(const void* filt, void* planes,
                                      long long n, void* stream) {
  if (n % 4 || reinterpret_cast<uintptr_t>(filt) % 16 ||
      reinterpret_cast<uintptr_t>(planes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n4 = static_cast<size_t>(n) / 4;
  float4* hi = static_cast<float4*>(planes);
  const unsigned blocks = static_cast<unsigned>(
      n4 / 256 + 1 < 132 * 16 ? n4 / 256 + 1 : 132 * 16);
  ring_split_bank<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(filt), hi, hi + n4, n4);
  return static_cast<int>(cudaGetLastError());
}

// The f32 mode: planes (2, nf, npix) f32 from ring_split_bank_launch;
// pt1/pt2 (n_pairs, npix, 8) f32, contiguous; scratch for the split
// columns, planes (2, n_pt * 128, npix) f32 with n_pt = ceil(n_pairs / 8);
// out (n_pairs, nf / 8) f32. nf % 128 == 0,
// npix % 32 == 0, all 16-byte aligned. Two launches: the column split
// (ring_split_cols), then the kernel. Returns a CUDA error code: the
// launches', or cudaErrorInvalidValue for arguments outside these limits.
extern "C" int ring_dist_f32_launch(const void* planes, const void* pt1,
                                    const void* pt2, void* scratch,
                                    void* out, int nf, int npix, int n_pairs,
                                    void* stream) {
  using T = Tile<true>;
  if (nf % TF || npix % T::TK || n_pairs < 1 ||
      reinterpret_cast<uintptr_t>(planes) % 16 ||
      reinterpret_cast<uintptr_t>(pt1) % 16 ||
      reinterpret_cast<uintptr_t>(pt2) % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pt = (n_pairs + T::TP - 1) / T::TP;
  const uint64_t col_rows = static_cast<uint64_t>(n_pt) * 2 * T::TP * NCH;
  const uint64_t row = static_cast<uint64_t>(npix) * 4;
  const int kb = (npix + 255) / 256;
  ring_split_cols<<<dim3(n_pt * T::TP * kb, 2), 256, 0, s>>>(
      static_cast<const float*>(pt1), static_cast<const float*>(pt2),
      static_cast<float*>(scratch), npix, n_pairs, kb, col_rows * npix);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm_f, tm_c;
  if (!tmap_f32_planes(&tm_f, planes, npix, nf, 2, row, nf * row, TF) ||
      !tmap_f32_planes(&tm_c, scratch, npix, col_rows, 2, row,
                       col_rows * row, 2 * T::TP * NCH))
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(ring_dist_wgmma<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_ft = nf / TF;
  ring_dist_wgmma<true><<<n_ft * n_pt, NTHREADS, T::SMEM_BYTES, s>>>(
      tm_f, tm_c, tm_c, static_cast<float*>(out), n_ft, n_pt, npix,
      n_pairs);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a CTA of the kernel requests: ``which`` 0 the bf16
// mode, 1 the f32 mode.
extern "C" int ring_dist_smem_bytes(int which) {
  return which ? Tile<true>::SMEM_BYTES : Tile<false>::SMEM_BYTES;
}
