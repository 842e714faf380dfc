// Row LayerNorm backward for Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `_ln_bwd_res` (its
// `pallas_call` over `_ln_bwd_kernel`, or `_ln_bwd_kernel_x` under
// `pallas_ln = x`).  Same function on (rows, d), all in float32:
//   xhat = (y - beta) / gamma, 0 where gamma == 0   (default: from y)
//   xhat = (x - mean) * rstd                        (save_x: from x)
//   dyg  = dy * gamma
//   dx   = rstd * (dyg - mean_d(dyg) - xhat * mean_d(dyg * xhat))
//   dgamma = sum_rows(dy * xhat),  dbeta = sum_rows(dy)
// dx is stored in x's dtype, dgamma / dbeta in gamma's.
//
// What bounds it on the card: bytes.  It reads y (or x) and dy and
// writes dx, 3 * rows * d * itemsize, for ~15 operations an element,
// far below the ~295 FLOP/byte at which an H100 turns compute-bound.
//
// Design: the TPU kernel walks row blocks in order and carries dgamma /
// dbeta in VMEM scratch across its sequential grid.  Blocks on the card
// run in no order, so the column sums take two passes, with no float
// atomics and the same result on every run:
//   1. each block owns a contiguous run of rows; per row it reads the
//      row once, keeps xhat and dyg in shared memory for the dx pass,
//      reduces the two row means over the block, writes dx, and adds the
//      row into per-column float32 partials in shared memory (a column
//      belongs to one thread, so no two threads write one partial); the
//      block then writes its partials to (blocks, d) scratch;
//   2. one thread per column sums the blocks' partials in block order
//      and casts to gamma's dtype.
// The kernels allocate nothing (the caller passes the scratch), do not
// synchronise, and launch on the caller's stream.

#include "common.cuh"

namespace {

constexpr int LNB_THREADS = 256;

__device__ float lnb_block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red[] from an earlier call has been read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

// a = y (SAVE_X false, with beta) or x (SAVE_X true, with mean)
template <typename T, typename G, bool SAVE_X>
__global__ void __launch_bounds__(LNB_THREADS)
layernorm_bwd_kernel(const T* __restrict__ a, const G* __restrict__ gamma,
                     const G* __restrict__ beta,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ part_g, float* __restrict__ part_b,
                     long long rows, int d, long long rows_per_block) {
  extern __shared__ float lnb_smem[];
  __shared__ float red[32];
  float* sX = lnb_smem;      // this row's xhat
  float* sD = sX + d;        // this row's dy * gamma
  float* sAg = sD + d;       // column partials of dy * xhat
  float* sAb = sAg + d;      // column partials of dy
  for (int c = threadIdx.x; c < d; c += blockDim.x) sAg[c] = sAb[c] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 =
      r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long long r = r0; r < r1; ++r) {
    const T* ar = a + r * d;
    const T* dyr = dy + r * d;
    const float rs = rstd[r];
    const float mu = SAVE_X ? mean[r] : 0.f;
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float g = cxn_to_f32(gamma[c]);
      const float av = cxn_to_f32(ar[c]);
      float xhat;
      if (SAVE_X) {
        xhat = (av - mu) * rs;
      } else {
        // no xhat information where gamma is exactly 0 (`_ln_bwd_kernel`)
        xhat = g == 0.f ? 0.f : (av - cxn_to_f32(beta[c])) / g;
      }
      const float dyv = cxn_to_f32(dyr[c]);
      const float dyg = dyv * g;
      sX[c] = xhat;
      sD[c] = dyg;
      s1 += dyg;
      s2 += dyg * xhat;
      sAg[c] += dyv * xhat;
      sAb[c] += dyv;
    }
    const float c1 = lnb_block_sum(s1, red) / d;
    const float c2 = lnb_block_sum(s2, red) / d;
    T* dxr = dx + r * d;
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      dxr[c] = cxn_from_f32<T>(rs * (sD[c] - c1 - sX[c] * c2));
  }
  float* pg = part_g + (size_t)blockIdx.x * d;
  float* pb = part_b + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    pg[c] = sAg[c];
    pb[c] = sAb[c];
  }
}

template <typename G>
__global__ void layernorm_bwd_colsum_kernel(const float* __restrict__ part_g,
                                            const float* __restrict__ part_b,
                                            G* __restrict__ dg,
                                            G* __restrict__ db, int nblocks,
                                            int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float sg = 0.f, sb = 0.f;
  for (int b = 0; b < nblocks; ++b) {
    sg += part_g[(size_t)b * d + c];
    sb += part_b[(size_t)b * d + c];
  }
  dg[c] = cxn_from_f32<G>(sg);
  db[c] = cxn_from_f32<G>(sb);
}

template <typename T, typename G, bool SAVE_X>
cudaError_t lnb_launch(const void* a, const void* gamma, const void* beta,
                       const void* mean, const void* rstd, const void* dy,
                       void* dx, void* part, void* dg, void* db,
                       long long rows, int d, int nblocks,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)d;
  auto kern = layernorm_bwd_kernel<T, G, SAVE_X>;
  cudaError_t err = cxn_allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int threads = ((d + 31) / 32) * 32;
  if (threads > LNB_THREADS) threads = LNB_THREADS;
  const long long per = (rows + nblocks - 1) / nblocks;
  float* part_g = static_cast<float*>(part);
  float* part_b = part_g + (size_t)nblocks * d;
  kern<<<nblocks, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const G*>(gamma),
      static_cast<const G*>(beta), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const T*>(dy),
      static_cast<T*>(dx), part_g, part_b, rows, d, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layernorm_bwd_colsum_kernel<G><<<(d + 255) / 256, 256, 0, stream>>>(
      part_g, part_b, static_cast<G*>(dg), static_cast<G*>(db), nblocks, d);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t lnb_dispatch(int save_x, const void* a, const void* gamma,
                         const void* beta, const void* mean,
                         const void* rstd, const void* dy, void* dx,
                         void* part, void* dg, void* db, long long rows,
                         int d, int nblocks, cudaStream_t st) {
  if (save_x)
    return lnb_launch<T, G, true>(a, gamma, beta, mean, rstd, dy, dx, part,
                                  dg, db, rows, d, nblocks, st);
  return lnb_launch<T, G, false>(a, gamma, beta, mean, rstd, dy, dx, part,
                                 dg, db, rows, d, nblocks, st);
}

}  // namespace

// a: (rows, d) in `xdtype`, the forward's output y (save_x = 0) or its
// input x (save_x = 1); gamma, beta: (d,) in `gdtype` (beta read only
// when save_x = 0); mean (read only when save_x = 1), rstd: (rows,)
// float32; dy, dx: (rows, d) in `xdtype`; part: 2 * nblocks * d float32
// scratch; dg, db: (d,) in `gdtype`.  `nblocks` (1..rows) sets how many
// row runs the first pass splits the rows into.  Returns
// cudaGetLastError() after the last launch (0 = launched).
extern "C" int cxn_layernorm_bwd(const void* a, const void* gamma,
                                 const void* beta, const void* mean,
                                 const void* rstd, const void* dy, void* dx,
                                 void* part, void* dg, void* db,
                                 long long rows, int d, int nblocks,
                                 int save_x, int xdtype, int gdtype,
                                 void* stream) {
  if (rows < 1 || d < 1 || nblocks < 1 || nblocks > rows ||
      nblocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdtype == CXN_F32 && gdtype == CXN_F32)
    return (int)lnb_dispatch<float, float>(save_x, a, gamma, beta, mean,
                                           rstd, dy, dx, part, dg, db, rows,
                                           d, nblocks, st);
  if (xdtype == CXN_BF16 && gdtype == CXN_BF16)
    return (int)lnb_dispatch<__nv_bfloat16, __nv_bfloat16>(
        save_x, a, gamma, beta, mean, rstd, dy, dx, part, dg, db, rows, d,
        nblocks, st);
  if (xdtype == CXN_BF16 && gdtype == CXN_F32)
    return (int)lnb_dispatch<__nv_bfloat16, float>(
        save_x, a, gamma, beta, mean, rstd, dy, dx, part, dg, db, rows, d,
        nblocks, st);
  if (xdtype == CXN_F32 && gdtype == CXN_BF16)
    return (int)lnb_dispatch<float, __nv_bfloat16>(
        save_x, a, gamma, beta, mean, rstd, dy, dx, part, dg, db, rows, d,
        nblocks, st);
  return (int)cudaErrorInvalidValue;
}
