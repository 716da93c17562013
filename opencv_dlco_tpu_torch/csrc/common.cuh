// Shared device helpers of the port's kernels: the bf16 type, bf16
// differences and rounding to a storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

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

// round an f32 value to the storage type T and back (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
