// Row LayerNorm forward for Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `_ln_fwd_res` (its
// `pallas_call` over `_ln_fwd_kernel`).  Same function on (rows, d):
//   mean = sum(x) / d;  var = sum((x - mean)^2) / d   (two-pass, float32)
//   rstd = 1 / sqrt(var + eps)
//   y    = (x - mean) * rstd * gamma + beta, stored in x's dtype
// plus mean and rstd as (rows,) float32.  The TPU gate
// `layernorm_pallas_supported` (d % 128, row-block divisibility) is a
// TPU tiling rule and does not apply: any rows, any d whose float32 row
// fits in shared memory.
//
// What bounds it on the card: bytes.  It reads x once and writes y once
// (2 * rows * d * itemsize) for ~8 operations per element, far below
// the ~295 FLOP/byte where an H100 turns compute-bound; the least time
// is those bytes over 3.35 TB/s.
//
// Design: the TPU version tiles rows into VMEM blocks; here one thread
// block owns one row.  The row is read from device memory once, into
// shared memory as float32, and both variance passes and the output
// pass run from there, so the two-pass variance costs no second trip to
// device memory.  Reductions are warp shuffles plus one shared-memory
// step across warps.  The kernel allocates nothing, does not
// synchronise, and launches on the caller's stream.

#include "common.cuh"

namespace {

constexpr int LN_MAX_THREADS = 256;

// sum over the block; every thread gets the total
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // red[] from an earlier call has been read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

template <typename T, typename G>
__global__ void __launch_bounds__(LN_MAX_THREADS)
layernorm_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                     const G* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int d, float eps) {
  extern __shared__ float row[];  // d floats
  __shared__ float red[32];
  const size_t r = blockIdx.x;
  const T* xr = x + r * d;
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float t = cxn_to_f32(xr[c]);
    row[c] = t;
    s += t;
  }
  const float mean = block_sum(s, red) / d;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float t = row[c] - mean;
    s2 += t * t;
  }
  const float var = block_sum(s2, red) / d;
  const float rstd = 1.f / sqrtf(var + eps);
  T* yr = y + r * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    yr[c] = cxn_from_f32<T>((row[c] - mean) * rstd * cxn_to_f32(gamma[c]) +
                            cxn_to_f32(beta[c]));
  if (threadIdx.x == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

template <typename T, typename G>
cudaError_t ln_launch(const void* x, const void* g, const void* b, void* y,
                      void* mean, void* rstd, long long rows, int d,
                      float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d;
  auto kern = layernorm_fwd_kernel<T, G>;
  cudaError_t err = cxn_allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int threads = ((d + 31) / 32) * 32;
  if (threads > LN_MAX_THREADS) threads = LN_MAX_THREADS;
  kern<<<(unsigned)rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(g),
      static_cast<const G*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous in `xdtype`; gamma, beta: (d,) in `gdtype`;
// mean, rstd: (rows,) float32.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int cxn_layernorm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mean,
                                 void* rstd, long long rows, int d, float eps,
                                 int xdtype, int gdtype, void* stream) {
  if (rows < 1 || rows > 2147483647LL || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdtype == CXN_F32 && gdtype == CXN_F32)
    return (int)ln_launch<float, float>(x, gamma, beta, y, mean, rstd, rows,
                                        d, eps, st);
  if (xdtype == CXN_BF16 && gdtype == CXN_BF16)
    return (int)ln_launch<__nv_bfloat16, __nv_bfloat16>(
        x, gamma, beta, y, mean, rstd, rows, d, eps, st);
  if (xdtype == CXN_BF16 && gdtype == CXN_F32)
    return (int)ln_launch<__nv_bfloat16, float>(x, gamma, beta, y, mean,
                                                rstd, rows, d, eps, st);
  if (xdtype == CXN_F32 && gdtype == CXN_BF16)
    return (int)ln_launch<float, __nv_bfloat16>(x, gamma, beta, y, mean,
                                                rstd, rows, d, eps, st);
  return (int)cudaErrorInvalidValue;
}
