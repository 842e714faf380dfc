// Shared helpers for the hand-written kernels: dtype codes and
// float32 <-> storage-type conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed by the Python wrappers (ops/build.py DTYPE_CODES)
enum CxnDtype { CXN_F32 = 0, CXN_BF16 = 1 };

__device__ __forceinline__ float cxn_to_f32(float x) { return x; }
__device__ __forceinline__ float cxn_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T cxn_from_f32(float x);
template <> __device__ __forceinline__ float cxn_from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cxn_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round a float32 value through storage type T (round-to-nearest-even)
template <typename T> __device__ __forceinline__ float cxn_round_to(float x) {
  return cxn_to_f32(cxn_from_f32<T>(x));
}

// opt a kernel into more than 48 KB of dynamic shared memory
template <typename K>
static cudaError_t cxn_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
