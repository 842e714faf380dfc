// One-sweep adam update of a bf16 parameter with a float32 master, for
// Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `fused_adam_pallas` (its
// pallas_call over `_fused_adam_kernel`), the `fused_update = 1` branch of
// `AdamUpdater.apply`.  Same function, all in float32, per element:
//   g  = bf16 gradient, clipped when clip != 0 (NaN -> 0, then clamped to
//        [-clip, clip], the reference's NaN-zeroing clip)
//   g  = g - wd * w            when wd > 0 (the reference adam's sign)
//   m1 = m1 + d1 * (g - m1)    (d1, d2: the reference's decay rates)
//   m2 = m2 + d2 * (g^2 - m2)
//   w  = w - lr_t * m1 / (sqrt(m2) + 1e-8)
//   p  = bf16(w)
// with lr_t the bias-corrected step size, computed on the host in float32
// as the JAX package computes it.  m1, m2, w (the master) and p are
// written in place.
//
// What bounds it on the card: bytes.  Per element it reads g (2 bytes),
// m1, m2 and w (4 each) and writes m1, m2, w (4 each) and p (2): 28
// bytes for ~15 operations.  For the d2048 LM's 0.65 G admitted
// parameters that is ~18 GB a step, ~5.4 ms at 3.35 TB/s.
//
// Design: the TPU kernel sweeps (rows, 1024) blocks through VMEM.  Here
// one thread takes 8 consecutive elements: one 16-byte load of g, two
// float4 loads of each float32 state, the arithmetic in registers, and
// the same widths back; neighbouring threads take neighbouring 8-element
// groups, so every warp access is a full 512-byte (g, p: 256-byte) run.
// The grid strides over the tensor.  The scalars arrive by value: no
// host sync, no device scalar.  Every operation is rounded on its own
// (the __f*_rn intrinsics, which nvcc never contracts into FMAs), in the
// order of the plain torch chain, whose kernels each round once: a
// contracted multiply-add differs from it where its two terms nearly
// cancel, by more than the relative tolerance.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_MAX_BLOCKS = 132 * 16;  // a few waves of an H100
constexpr float FA_EPS = 1e-8f;

struct AdamArgs {
  float lr_t, d1, d2, wd, clip;
};

__device__ __forceinline__ void adam_elem(float g, float& m1, float& m2,
                                          float& w, const AdamArgs& a) {
  if (a.clip != 0.f) {
    g = isnan(g) ? 0.f : g;
    g = fminf(fmaxf(g, -a.clip), a.clip);
  }
  if (a.wd > 0.f) g = __fsub_rn(g, __fmul_rn(a.wd, w));
  m1 = __fadd_rn(m1, __fmul_rn(a.d1, __fsub_rn(g, m1)));
  m2 = __fadd_rn(m2, __fmul_rn(a.d2, __fsub_rn(__fmul_rn(g, g), m2)));
  w = __fsub_rn(w, __fmul_rn(a.lr_t,
                             __fdiv_rn(m1, __fadd_rn(__fsqrt_rn(m2),
                                                     FA_EPS))));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t bits) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bits));
}

__global__ void __launch_bounds__(FA_THREADS)
fused_adam_kernel(const uint4* __restrict__ g, float4* __restrict__ m1,
                  float4* __restrict__ m2, float4* __restrict__ w32,
                  uint4* __restrict__ p, long long groups, AdamArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < groups; i += stride) {
    const uint4 gv = g[i];
    const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
    float4 a1[2] = {m1[2 * i], m1[2 * i + 1]};
    float4 a2[2] = {m2[2 * i], m2[2 * i + 1]};
    float4 aw[2] = {w32[2 * i], w32[2 * i + 1]};
    float* f1 = reinterpret_cast<float*>(a1);
    float* f2 = reinterpret_cast<float*>(a2);
    float* fw = reinterpret_cast<float*>(aw);
    uint32_t out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 gg = unpack_bf16x2(gw[k]);
      adam_elem(gg.x, f1[2 * k], f2[2 * k], fw[2 * k], a);
      adam_elem(gg.y, f1[2 * k + 1], f2[2 * k + 1], fw[2 * k + 1], a);
      out[k] = pack_bf16x2(fw[2 * k], fw[2 * k + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m1[2 * i + h] = a1[h];
      m2[2 * i + h] = a2[h];
      w32[2 * i + h] = aw[h];
    }
    p[i] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

}  // namespace

// g, p: n bf16 values; m1, m2, w32: n float32 values; every pointer
// 16-byte aligned and n a positive multiple of 8 (the wrapper checks
// both and raises).  m1, m2, w32 and p are overwritten.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cxn_fused_adam(const void* g, void* m1, void* m2, void* w32,
                              void* p, long long n, float lr_t, float d1,
                              float d2, float wd, float clip, void* stream) {
  const uintptr_t addr = (uintptr_t)g | (uintptr_t)m1 | (uintptr_t)m2 |
                         (uintptr_t)w32 | (uintptr_t)p;
  if (n < 8 || n % 8 != 0 || (addr & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = n / 8;
  long long blocks = (groups + FA_THREADS - 1) / FA_THREADS;
  if (blocks > FA_MAX_BLOCKS) blocks = FA_MAX_BLOCKS;
  const AdamArgs a{lr_t, d1, d2, wd, clip};
  fused_adam_kernel<<<(unsigned)blocks, FA_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(g), static_cast<float4*>(m1),
      static_cast<float4*>(m2), static_cast<float4*>(w32),
      static_cast<uint4*>(p), groups, a);
  return (int)cudaGetLastError();
}
