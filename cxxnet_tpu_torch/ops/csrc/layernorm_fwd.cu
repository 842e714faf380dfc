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
// Design, two routes (cxn_layernorm_fwd_route):
// - warp (d <= LNW_MAX_D = 4096): one warp owns one row at a time and
//   keeps it in registers as float32, at most LNW_MAX_EL = 128 elements
//   a lane.  Rows arrive as 16-byte vector loads (8 bf16 or 4 float32 a
//   lane a load; neighbouring lanes on neighbouring 16 bytes) when d is
//   a multiple of the vector and x, y are 16-byte aligned, else as
//   coalesced scalar loads; the tail of a row is masked.  Both moments
//   are warp shuffles from the registers (the second pass reads no
//   memory), so no barrier and no shared memory per row.  The grid is
//   persistent (a few blocks an SM): each block stages gamma and beta
//   once as float32 in shared memory and its warps walk the rows, so
//   gamma and beta are read from device memory once per block, not once
//   per row.  Stores are 16-byte; lane 0 writes mean and rstd.
// - block (wider rows): one thread block owns one row, read once into
//   shared memory as float32; both passes and the output run from there,
//   with block-wide sums (warp shuffles plus one shared-memory step).
// Neither kernel allocates, synchronises, or leaves the caller's stream.

#include <stdint.h>

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

constexpr int LNW_WARPS = 4;              // rows in flight per block
constexpr int LNW_THREADS = 32 * LNW_WARPS;
constexpr int LNW_MAX_EL = 128;           // row elements a lane holds
constexpr int LNW_MAX_D = 32 * LNW_MAX_EL;
constexpr int LNW_BLOCKS_PER_SM = 4;      // the persistent grid

__device__ __forceinline__ float ln_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The warp route: EL row elements a lane (a multiple of V), V elements a
// load; load i of lane l covers columns (32 i + l) V .. + V - 1.  With
// V > 1, V divides d, so a load is whole or past the row.
template <typename T, int EL, int V>
__global__ void __launch_bounds__(LNW_THREADS)
layernorm_fwd_warp_kernel(const T* __restrict__ x, const void* gamma,
                          const void* beta, int gf32, T* __restrict__ y,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, long long rows,
                          int d, float eps) {
  constexpr int NL = EL / V;
  // gamma, then beta, each EL * 32 floats in the order the lanes read
  // them: element e of load i of lane l at (i V + e) 32 + l, so every
  // read of a warp is one conflict-free shared-memory access
  extern __shared__ float gb[];
  for (int c = threadIdx.x; c < d; c += LNW_THREADS) {
    const int at = ((c / (32 * V)) * V + c % V) * 32 + (c / V) % 32;
    gb[at] = cxn_param(gamma, gf32, c);
    gb[EL * 32 + at] = cxn_param(beta, gf32, c);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * LNW_WARPS + (threadIdx.x >> 5);
       r < rows; r += (long long)gridDim.x * LNW_WARPS) {
    const T* xr = x + r * d;
    float v[EL];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int c0 = (i * 32 + lane) * V;
      if (c0 < d) {
        cxn_load<T, V>(xr + c0, v + i * V);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[i * V + e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[i * V + e];
    }
    const float mean = ln_warp_sum(s) / d;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int c0 = (i * 32 + lane) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float t = v[i * V + e] - mean;
        if (c0 + e < d) s2 += t * t;
      }
    }
    const float var = ln_warp_sum(s2) / d;
    const float rstd = 1.f / sqrtf(var + eps);
    T* yr = y + r * d;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int c0 = (i * 32 + lane) * V;
      if (c0 < d) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int at = (i * V + e) * 32 + lane;
          o[e] = (v[i * V + e] - mean) * rstd * gb[at] + gb[EL * 32 + at];
        }
        cxn_store<T, V>(yr + c0, o);
      }
    }
    if (lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
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

template <typename T, int EL, int V>
cudaError_t lnw_launch_el(const void* x, const void* g, const void* b,
                          int gf32, void* y, void* mean, void* rstd,
                          long long rows, int d, float eps,
                          cudaStream_t stream) {
  auto kern = layernorm_fwd_warp_kernel<T, EL, V>;
  constexpr size_t smem = 2 * sizeof(float) * EL * 32;
  // the persistent grid: as many blocks as fit at once, at most
  // LNW_BLOCKS_PER_SM an SM (the same for every call of this instance)
  static const int resident = [&] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                  LNW_THREADS, smem);
    per_sm = per_sm < LNW_BLOCKS_PER_SM ? per_sm : LNW_BLOCKS_PER_SM;
    return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }();
  const long long want = (rows + LNW_WARPS - 1) / LNW_WARPS;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  kern<<<blocks, LNW_THREADS, smem, stream>>>(
      static_cast<const T*>(x), g, b, gf32, static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, eps);
  return cudaGetLastError();
}

// the warp route at V elements a load: the fewest elements a lane that
// hold the row
template <typename T, int V>
cudaError_t lnw_launch_v(const void* x, const void* g, const void* b,
                         int gf32, void* y, void* mean, void* rstd,
                         long long rows, int d, float eps,
                         cudaStream_t st) {
  if (d <= 32 * 8)
    return lnw_launch_el<T, 8, V>(x, g, b, gf32, y, mean, rstd, rows, d,
                                  eps, st);
  if (d <= 32 * 16)
    return lnw_launch_el<T, 16, V>(x, g, b, gf32, y, mean, rstd, rows, d,
                                   eps, st);
  if (d <= 32 * 32)
    return lnw_launch_el<T, 32, V>(x, g, b, gf32, y, mean, rstd, rows, d,
                                   eps, st);
  if (d <= 32 * 64)
    return lnw_launch_el<T, 64, V>(x, g, b, gf32, y, mean, rstd, rows, d,
                                   eps, st);
  return lnw_launch_el<T, 128, V>(x, g, b, gf32, y, mean, rstd, rows, d,
                                  eps, st);
}

// the warp route: 16-byte loads where d is a multiple of the vector and
// x and y are 16-byte aligned, else scalar ones
template <typename T>
cudaError_t lnw_launch(const void* x, const void* g, const void* b,
                       int gf32, void* y, void* mean, void* rstd,
                       long long rows, int d, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec)
    return lnw_launch_v<T, V>(x, g, b, gf32, y, mean, rstd, rows, d, eps,
                              st);
  return lnw_launch_v<T, 1>(x, g, b, gf32, y, mean, rstd, rows, d, eps, st);
}

}  // namespace

// The kernel a row of width d takes: 0 the warp route, 1 the block route.
extern "C" int cxn_layernorm_fwd_route(int d) {
  return d <= LNW_MAX_D ? 0 : 1;
}

// x, y: (rows, d) contiguous in `xdtype`; gamma, beta: (d,) in `gdtype`;
// mean, rstd: (rows,) float32.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int cxn_layernorm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mean,
                                 void* rstd, long long rows, int d, float eps,
                                 int xdtype, int gdtype, void* stream) {
  if (rows < 1 || rows > 2147483647LL || d < 1 ||
      (xdtype != CXN_F32 && xdtype != CXN_BF16) ||
      (gdtype != CXN_F32 && gdtype != CXN_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cxn_layernorm_fwd_route(d) == 0) {
    const int gf32 = gdtype == CXN_F32;
    if (xdtype == CXN_F32)
      return (int)lnw_launch<float>(x, gamma, beta, gf32, y, mean, rstd,
                                    rows, d, eps, st);
    return (int)lnw_launch<__nv_bfloat16>(x, gamma, beta, gf32, y, mean,
                                          rstd, rows, d, eps, st);
  }
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
