// Shared helpers for the hand-written kernels: dtype codes and
// float32 <-> storage-type conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// element c of a float32 (f32 != 0) or bf16 vector, as float32
__device__ __forceinline__ float cxn_param(const void* p, int f32, int c) {
  return f32 ? static_cast<const float*>(p)[c]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]);
}

// the 16 / sizeof(T) values of T in the 16 bytes u, as float32
template <typename T>
__device__ __forceinline__ void cxn_unpack16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// V values of T at p as float32: one scalar (V == 1), or 16 bytes (V =
// 16 / sizeof(T), p 16-byte aligned)
template <typename T, int V>
__device__ __forceinline__ void cxn_load(const T* __restrict__ p, float* f) {
  if constexpr (V == 1) {
    f[0] = cxn_to_f32(p[0]);
  } else {
    cxn_unpack16<T>(*reinterpret_cast<const uint4*>(p), f);
  }
}

// V float32 values into T at p, each rounded as cxn_from_f32 rounds it:
// one scalar (V == 1), or 16 bytes (p 16-byte aligned)
template <typename T, int V>
__device__ __forceinline__ void cxn_store(T* __restrict__ p, const float* f) {
  if constexpr (V == 1) {
    p[0] = cxn_from_f32<T>(f[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(f[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// opt a kernel into more than 48 KB of dynamic shared memory
template <typename K>
static cudaError_t cxn_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
