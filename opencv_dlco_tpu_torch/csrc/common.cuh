// Shared device helpers of the port's kernels: bf16 packing and the
// mma.sync m16n8k16 bf16 tensor-core product with f32 accumulation.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and q = lane % 4:
//   A (16x16, row-major): a0 = A[g][2q..2q+1],   a1 = A[g+8][2q..2q+1],
//                         a2 = A[g][2q+8..2q+9], a3 = A[g+8][2q+8..2q+9]
//   B (16x8, "col"):      b0 = B[2q..2q+1][g],   b1 = B[2q+8..2q+9][g]
//   C/D (16x8, f32):      c0,c1 = C[g][2q..2q+1], c2,c3 = C[g+8][2q..2q+1]
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 8 bf16 of pos minus 8 bf16 of neg, subtracted in f32 and rounded to
// bf16 once (the TPU kernels form fd = pos - neg in the input dtype).
__device__ __forceinline__ uint4 sub_bf16x8(uint4 p, uint4 n) {
  const bf16* pp = reinterpret_cast<const bf16*>(&p);
  const bf16* nn = reinterpret_cast<const bf16*>(&n);
  uint4 out;
  bf16* oo = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    oo[e] = __float2bfloat16_rn(__bfloat162float(pp[e]) -
                                __bfloat162float(nn[e]));
  return out;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// round an f32 value to the storage type T and back (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
