// Kernel G on Hopper: batched 2-NN in true f32, the SLAM pose chunk's C
// matching problems in one launch.
//
// Replaces the TPU kernel opencv_dlco_tpu/ops/knn_pallas.py::_knn2_kernel
// as driven by knn2_fused_batched. For queries q (B, N, D) and train rows
// t (B, M, D) in f32:
//   dist[b, n, m] = max(|q_bn|^2 + |t_bm|^2 - 2 q_bn . t_bm, 0)
// with no FMA contraction in that expression, and per query the two
// smallest (dist, m) in lexicographic order (equal distances go to the
// lowest train index), ascending; (inf, -1) where fewer than two exist.
// Products are f32 FFMA (no TF32): pose estimation depends on match
// identity.
//
// Bound on an H100 at the SLAM chunk (16 x 256 x 256, d 48): 100 MFLOP of
// f32 products, 1.5 us at 67 TFLOP/s; 1.6 MB of inputs. At that size a
// launch's fixed costs are larger than the work.
//
// Design: one launch, the norms computed in the kernel (no scratch). A CTA
// owns 32 queries of one problem, so the SLAM chunk is 8 x 16 = 128 CTAs
// on 132 SMs, and scans all train rows in tiles of 256 (one tile at the
// SLAM chunk) and D in chunks of 64, both staged in shared memory: the
// queries row-major, the train tile K-major so each lane reads its columns
// as two float4s (a thread stages one train row, its 16-byte loads all in
// flight at once when the rows are aligned). Warp w owns queries
// 4w .. 4w + 3; lane l owns columns 4l .. 4l + 3 and 128 + 4l .. 128 + 4l
// + 3 of the tile, 32 f32 accumulators a thread. Query norms come from the staged query rows (a
// warp per row set, lanes over D), train norms from the staged tile (a
// thread per column). Each lane keeps a running top-2 per query over its
// columns, which it visits in increasing order, so a strict comparison
// keeps ties on the lower index; at the end five butterfly shuffles merge
// the 32 lanes' lists lexicographically.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int GQ = 32;        // queries per CTA
constexpr int GT = 256;       // train rows per tile
constexpr int DK = 64;        // D chunk
constexpr int NTHREADS = 256; // 8 warps x 4 queries
constexpr int IMAX = 0x7fffffff;
constexpr int SMEM_BYTES = (GQ * DK + DK * GT + GT) * 4;

__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

__global__ void __launch_bounds__(NTHREADS)
knn2_batched(const float* __restrict__ q, const float* __restrict__ t,
             float* __restrict__ od, int* __restrict__ oi, int n, int m,
             int d, long long q_bs, long long q_rs, long long t_bs,
             long long t_rs, bool vec) {
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);  // (GQ, DK)
  float* const ts = qs + GQ * DK;                     // (DK, GT)
  float* const nts = ts + DK * GT;                    // (GT)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, n0 = blockIdx.x * GQ;
  q += b * q_bs;
  t += b * t_bs;

  float d1[4], d2[4], nq[4];
  int i1[4], i2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    d1[r] = d2[r] = INFINITY;
    i1[r] = i2[r] = IMAX;
    nq[r] = 0.f;
  }

  for (int m0 = 0; m0 < m; m0 += GT) {
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    float nt = 0.f;
    for (int k0 = 0; k0 < d; k0 += DK) {
      const int kw = min(DK, d - k0);
      __syncthreads();  // the previous chunk's readers are done
      for (int idx = tid; idx < GQ * DK; idx += NTHREADS) {
        const int r = idx / DK, kk = idx % DK;
        qs[idx] = n0 + r < n && kk < kw ? q[(n0 + r) * q_rs + k0 + kk] : 0.f;
      }
      // thread tid stages column tid of the tile (its row of t), in
      // 16-byte loads when rows allow them, all issued before the stores
      const bool col_real = m0 + tid < m;
      const float* trow = t + (m0 + tid) * t_rs + k0;
      if (vec) {
        float4 v[DK / 4];
#pragma unroll
        for (int k4 = 0; k4 < DK / 4; ++k4)
          v[k4] = col_real && 4 * k4 < kw
                      ? reinterpret_cast<const float4*>(trow)[k4]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k4 = 0; k4 < DK / 4; ++k4) {
          ts[(4 * k4) * GT + tid] = v[k4].x;
          ts[(4 * k4 + 1) * GT + tid] = v[k4].y;
          ts[(4 * k4 + 2) * GT + tid] = v[k4].z;
          ts[(4 * k4 + 3) * GT + tid] = v[k4].w;
        }
      } else {
        for (int kk = 0; kk < DK; ++kk)
          ts[kk * GT + tid] = col_real && kk < kw ? trow[kk] : 0.f;
      }
      __syncthreads();

      if (m0 == 0) {  // the query norms, once: a warp per row, lanes over D
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* qr = qs + (4 * warp + r) * DK;
          float s = 0.f;
          for (int kk = lane; kk < kw; kk += 32) s = fmaf(qr[kk], qr[kk], s);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          nq[r] += s;
        }
      }
      for (int kk = 0; kk < kw; ++kk) {
        const float v = ts[kk * GT + tid];
        nt = fmaf(v, v, nt);
      }

      const float4* t4 = reinterpret_cast<const float4*>(ts);
      for (int kk = 0; kk < kw; ++kk) {
        const float4 b0 = t4[kk * (GT / 4) + lane];
        const float4 b1 = t4[kk * (GT / 4) + 32 + lane];
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = qs[(4 * warp + r) * DK + kk];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a, bv[c], acc[r][c]);
        }
      }
    }
    nts[tid] = m0 + tid < m ? nt : INFINITY;
    __syncthreads();

    const float4* n4 = reinterpret_cast<const float4*>(nts);
    const float4 n0v = n4[lane], n1v = n4[32 + lane];
    const float ntv[8] = {n0v.x, n0v.y, n0v.z, n0v.w,
                          n1v.x, n1v.y, n1v.z, n1v.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = m0 + (c < 4 ? 4 * lane + c : 128 + 4 * lane + c - 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float dd = fmaxf(
            __fsub_rn(__fadd_rn(nq[r], ntv[c]), __fmul_rn(2.f, acc[r][c])),
            0.f);
        if (dd < d2[r]) {
          if (dd < d1[r]) {
            d2[r] = d1[r];
            i2[r] = i1[r];
            d1[r] = dd;
            i1[r] = col;
          } else {
            d2[r] = dd;
            i2[r] = col;
          }
        }
      }
    }
  }

  // merge the 32 lanes' top-2 lists of each query (lexicographic)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float e1 = __shfl_xor_sync(0xffffffffu, d1[r], off);
      const int j1 = __shfl_xor_sync(0xffffffffu, i1[r], off);
      const float e2 = __shfl_xor_sync(0xffffffffu, d2[r], off);
      const int j2 = __shfl_xor_sync(0xffffffffu, i2[r], off);
      if (lex_less(e1, j1, d1[r], i1[r])) {
        const bool own = lex_less(d1[r], i1[r], e2, j2);
        d2[r] = own ? d1[r] : e2;
        i2[r] = own ? i1[r] : j2;
        d1[r] = e1;
        i1[r] = j1;
      } else if (lex_less(e1, j1, d2[r], i2[r])) {
        d2[r] = e1;
        i2[r] = j1;
      }
    }
    const int row = n0 + 4 * warp + r;
    if (lane == r && row < n) {
      const size_t o = (static_cast<size_t>(b) * n + row) * 2;
      const bool real1 = isfinite(d1[r]) && i1[r] != IMAX;
      const bool real2 = isfinite(d2[r]) && i2[r] != IMAX;
      od[o] = real1 ? d1[r] : INFINITY;
      oi[o] = real1 ? i1[r] : -1;
      od[o + 1] = real2 ? d2[r] : INFINITY;
      oi[o + 1] = real2 ? i2[r] : -1;
    }
  }
}

}  // namespace

// q (B, N, D) and t (B, M, D) f32, rows contiguous in D, element (b, i, :)
// at base + b * bs + i * rs; out one (2, B, N, 2) buffer of 32-bit words:
// the distances (f32) in its first half, the indices (i32) in its second.
// N, M, B, D >= 1. Returns a CUDA error code (0 on success) after the
// launch; cudaErrorInvalidValue for arguments outside these limits.
extern "C" int knn2_batched_launch(const void* q, const void* t, void* out,
                                   int batch, int n, int m, int d,
                                   long long q_bs, long long q_rs,
                                   long long t_bs, long long t_rs,
                                   void* stream) {
  if (batch < 1 || n < 1 || m < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory opt-in, once per device
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && !(configured >> dev & 1ull)) {
    e = cudaFuncSetAttribute(knn2_batched,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << dev;
  }
  float* od = static_cast<float*>(out);
  int* oi = static_cast<int*>(out) + static_cast<size_t>(batch) * n * 2;
  // 16-byte loads of train rows: aligned base, strides and width
  const bool vec = reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                   t_bs % 4 == 0 && t_rs % 4 == 0 && d % 4 == 0;
  const dim3 grid((n + GQ - 1) / GQ, batch);
  knn2_batched<<<grid, NTHREADS, SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(t), od, oi, n,
      m, d, q_bs, q_rs, t_bs, t_rs, vec);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a CTA requests (``which`` unused).
extern "C" int knn_batched_smem_bytes(int which) { return SMEM_BYTES; }
