// Cross-channel local response normalisation, forward and backward, for
// Hopper (sm_90a), called through ctypes, in two layouts.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `lrn_pallas` (its
// `_call_per_batch` pallas_call over `_lrn_fwd_kernel` and
// `_lrn_bwd_kernel`) on logical NCHW, entry `cxn_lrn`; and
// `lrn_pallas_hwcn` (its `_lrn_hwcn_call` pallas_call over
// `_lrn_hwcn_fwd_kernel(_u)` and `_lrn_hwcn_bwd_kernel(_u)`) on the
// (H, W, C, N) transpose, through the same entry.  Same function in both,
// all in float32:
//   norm[c] = knorm + salpha * sum_{j = c - lo .. c + hi} x[j]^2
//   y[c]    = x[c] * norm[c]^-beta
//   dx[c]   = g[c] * norm[c]^-beta
//             - 2 beta salpha x[c] * sum_{j = c - hi .. c + lo} inner[j]
//   inner[j] = g[j] x[j] norm[j]^-beta / norm[j]
// with lo = n / 2, hi = n - 1 - lo and the window clipped to [0, C); the
// backward's window is the transposed one (lo and hi swapped), which
// differs from the forward's for even n.  Each window is summed in the
// TPU kernels' order, from its lowest channel up.  norm^-0.75 is
// rsqrt(norm * sqrt(norm)), as on the TPU.  Outputs are stored in x's
// dtype.
//
// What bounds it on the card: bytes.  The forward reads x and writes y
// (2 * N*C*H*W * itemsize) for ~n + 6 operations an element, the
// backward reads x and g and writes dx: far below the ~295 FLOP/byte at
// which an H100 turns compute-bound.
//
// Design: the TPU kernels hold a (batch tile, C, H*W) or an (H rows, W,
// C, 128 images) block in VMEM and shift it along C (the (H, W, C, N)
// form because XLA keeps its activations physically in that order, so
// the transposes around it are free there; on the card they are real
// copies, made by the wrapper).  Here both layouts are (outer, C, inner)
// arrays: NCHW has outer = N and inner = H*W, (H, W, C, N) has outer =
// H*W and inner = N.  One thread owns one (outer, inner) column and
// walks its C channels (stride inner), so neighbouring threads read
// neighbouring inner addresses (coalesced: neighbouring pixels in NCHW,
// neighbouring images in (H, W, C, N)).  The forward re-reads the n
// window values of each channel, which stay in L1.  The backward needs
// inner[j] for the n channels of the transposed window: each thread
// keeps the last RING values of inner and norm^-beta in its own column
// of shared memory (no other thread reads it, so no barrier), and
// computes inner[j] once, when channel j enters the window.
#include "common.cuh"

namespace {

constexpr int LRN_THREADS = 128;
// ring of the backward: holds the transposed window (n <= LRN_RING)
constexpr int LRN_RING = 32;

__device__ __forceinline__ float lrn_pow(float norm, float beta) {
  return beta == 0.75f ? rsqrtf(norm * sqrtf(norm)) : powf(norm, -beta);
}

// norm at channel c of the column starting at `col` (stride inner)
template <typename T>
__device__ __forceinline__ float lrn_norm(const T* __restrict__ col, int c,
                                          int C, long long inner, int lo,
                                          int hi, float salpha,
                                          float knorm) {
  const int j0 = c - lo < 0 ? 0 : c - lo;
  const int j1 = c + hi > C - 1 ? C - 1 : c + hi;
  float s = 0.f;
  for (int j = j0; j <= j1; ++j) {
    const float v = cxn_to_f32(col[(long long)j * inner]);
    s += v * v;
  }
  return s * salpha + knorm;
}

template <typename T>
__global__ void __launch_bounds__(LRN_THREADS)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long cols,
               int C, long long inner, int lo, int hi, float salpha,
               float beta, float knorm) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cols) return;
  const long long base = (t / inner) * C * inner + t % inner;
  const T* col = x + base;
  for (int c = 0; c < C; ++c) {
    const float norm = lrn_norm(col, c, C, inner, lo, hi, salpha, knorm);
    const float xv = cxn_to_f32(col[(long long)c * inner]);
    y[base + (long long)c * inner] =
        cxn_from_f32<T>(xv * lrn_pow(norm, beta));
  }
}

template <typename T>
__global__ void __launch_bounds__(LRN_THREADS)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, long long cols, int C, long long inner,
               int lo, int hi, float salpha, float beta, float knorm) {
  __shared__ float ring_inner[LRN_RING][LRN_THREADS];
  __shared__ float ring_pow[LRN_RING][LRN_THREADS];
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cols) return;
  const int tid = threadIdx.x;
  const long long base = (t / inner) * C * inner + t % inner;
  const T* xc = x + base;
  const T* gc = g + base;
  const float coef = 2.f * beta * salpha;
  int next = 0;  // the next channel whose inner enters the ring
  for (int c = 0; c < C; ++c) {
    // the transposed window of c is [c - hi, c + lo]
    const int top = c + lo > C - 1 ? C - 1 : c + lo;
    for (; next <= top; ++next) {
      const float norm =
          lrn_norm(xc, next, C, inner, lo, hi, salpha, knorm);
      const float p = lrn_pow(norm, beta);
      const long long off = (long long)next * inner;
      ring_pow[next % LRN_RING][tid] = p;
      ring_inner[next % LRN_RING][tid] =
          cxn_to_f32(gc[off]) * cxn_to_f32(xc[off]) * (p / norm);
    }
    const int j0 = c - hi < 0 ? 0 : c - hi;
    float s = 0.f;
    for (int j = j0; j <= top; ++j) s += ring_inner[j % LRN_RING][tid];
    const long long off = (long long)c * inner;
    const float v = cxn_to_f32(gc[off]) * ring_pow[c % LRN_RING][tid] -
                    coef * cxn_to_f32(xc[off]) * s;
    dx[base + off] = cxn_from_f32<T>(v);
  }
}

template <typename T>
cudaError_t lrn_launch(int backward, const void* x, const void* g, void* out,
                       long long outer, int C, long long inner, int nsize,
                       float salpha, float beta, float knorm,
                       cudaStream_t st) {
  const long long cols = outer * inner;
  const int lo = nsize / 2, hi = nsize - 1 - lo;
  const long long blocks = (cols + LRN_THREADS - 1) / LRN_THREADS;
  if (backward)
    lrn_bwd_kernel<T><<<(unsigned)blocks, LRN_THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<T*>(out), cols, C, inner, lo, hi, salpha, beta, knorm);
  else
    lrn_fwd_kernel<T><<<(unsigned)blocks, LRN_THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), cols, C, inner, lo,
        hi, salpha, beta, knorm);
  return cudaGetLastError();
}

}  // namespace

// x (and g, the output gradient, for the backward): contiguous (outer, C,
// inner) in `dtype`, the window along C: logical NCHW as (N, C, H*W), its
// (H, W, C, N) transpose as (H*W, C, N); out: y (forward) or dx
// (backward), the same shape and dtype.  salpha = alpha / nsize.  The
// backward takes nsize <= 32.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int cxn_lrn(int backward, const void* x, const void* g, void* out,
                       long long outer, int C, long long inner, int nsize,
                       float salpha, float beta, float knorm, int dtype,
                       void* stream) {
  if (outer < 1 || C < 1 || inner < 1 || nsize < 1 ||
      (backward && nsize > LRN_RING) ||
      (outer * inner + LRN_THREADS - 1) / LRN_THREADS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == CXN_F32)
    return (int)lrn_launch<float>(backward, x, g, out, outer, C, inner,
                                  nsize, salpha, beta, knorm, st);
  if (dtype == CXN_BF16)
    return (int)lrn_launch<__nv_bfloat16>(backward, x, g, out, outer, C,
                                          inner, nsize, salpha, beta, knorm,
                                          st);
  return (int)cudaErrorInvalidValue;
}
