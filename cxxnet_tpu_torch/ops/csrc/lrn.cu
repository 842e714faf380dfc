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
// inner[j] for the channels of the transposed window: each thread keeps
// the last R = min(n, C) values of inner and norm^-beta in its own
// column of a ring in dynamic shared memory (no other thread reads it,
// so no barrier), and computes inner[j] once, when channel j enters the
// window.  The block shrinks from 128 to 32 threads as R grows, so the
// ring fits for R up to LRN_MAX_RING (908 channels); past that a second
// instance keeps no ring and recomputes each inner[j] of the window
// (n + 1 times the forward's reads), so every window n >= 1 runs.
#include "common.cuh"

namespace {

constexpr int LRN_THREADS = 128;
// shared memory a block may use (H100: 227 KB)
constexpr int LRN_SMEM = 232448;
// widest ring (two floats a channel) a 32-thread block holds
constexpr int LRN_MAX_RING = LRN_SMEM / (2 * 4 * 32);

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

// inner[j] = g[j] x[j] norm[j]^-beta / norm[j], and norm[j]^-beta in *p
template <typename T>
__device__ __forceinline__ float lrn_inner(const T* __restrict__ xc,
                                           const T* __restrict__ gc, int j,
                                           int C, long long inner, int lo,
                                           int hi, float salpha, float beta,
                                           float knorm, float* p) {
  const float norm = lrn_norm(xc, j, C, inner, lo, hi, salpha, knorm);
  *p = lrn_pow(norm, beta);
  const long long off = (long long)j * inner;
  return cxn_to_f32(gc[off]) * cxn_to_f32(xc[off]) * (*p / norm);
}

// RING: inner and norm^-beta of the last R channels in the thread's
// column of the dynamic shared ring ([2][R][blockDim.x] floats); else
// recomputed for every channel of every window
template <typename T, bool RING>
__global__ void __launch_bounds__(LRN_THREADS)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, long long cols, int C, long long inner,
               int lo, int hi, float salpha, float beta, float knorm,
               int R) {
  extern __shared__ float ring[];
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cols) return;
  const int nt = blockDim.x;
  float* ring_inner = ring + threadIdx.x;
  float* ring_pow = ring + (size_t)R * nt + threadIdx.x;
  const long long base = (t / inner) * C * inner + t % inner;
  const T* xc = x + base;
  const T* gc = g + base;
  const float coef = 2.f * beta * salpha;
  int next = 0;  // the next channel whose inner enters the ring
  int slot = 0;  // its ring slot (next % R, kept without a division)
  for (int c = 0; c < C; ++c) {
    // the transposed window of c is [c - hi, c + lo]
    const int top = c + lo > C - 1 ? C - 1 : c + lo;
    const int j0 = c - hi < 0 ? 0 : c - hi;
    float s = 0.f, pc;
    if constexpr (RING) {
      for (; next <= top; ++next) {
        float p;
        const float v = lrn_inner(xc, gc, next, C, inner, lo, hi, salpha,
                                  beta, knorm, &p);
        ring_pow[(size_t)slot * nt] = p;
        ring_inner[(size_t)slot * nt] = v;
        slot = slot + 1 == R ? 0 : slot + 1;
      }
      // channel top sits in the slot before `slot`; j0 and c are at most
      // R - 1 channels before it
      const int at_top = slot == 0 ? R - 1 : slot - 1;
      int at = at_top - (top - j0);
      if (at < 0) at += R;
      for (int j = j0; j <= top; ++j) {
        s += ring_inner[(size_t)at * nt];
        at = at + 1 == R ? 0 : at + 1;
      }
      const int at_c = at_top - (top - c);
      pc = ring_pow[(size_t)(at_c < 0 ? at_c + R : at_c) * nt];
    } else {
      float p;
      for (int j = j0; j <= top; ++j)
        s += lrn_inner(xc, gc, j, C, inner, lo, hi, salpha, beta, knorm, &p);
      pc = lrn_pow(lrn_norm(xc, c, C, inner, lo, hi, salpha, knorm), beta);
    }
    const long long off = (long long)c * inner;
    const float v = cxn_to_f32(gc[off]) * pc - coef * cxn_to_f32(xc[off]) * s;
    dx[base + off] = cxn_from_f32<T>(v);
  }
}

// threads of a backward block whose ring of R channels fits, largest
// first; 0 when not even a 32-thread block's ring fits
int lrn_bwd_threads(int R) {
  for (int nt = LRN_THREADS; nt >= 32; nt /= 2)
    if ((size_t)2 * 4 * R * nt <= (size_t)LRN_SMEM) return nt;
  return 0;
}

template <typename T>
cudaError_t lrn_launch(int backward, const void* x, const void* g, void* out,
                       long long outer, int C, long long inner, int nsize,
                       float salpha, float beta, float knorm,
                       cudaStream_t st) {
  const long long cols = outer * inner;
  const int lo = nsize / 2, hi = nsize - 1 - lo;
  if (!backward) {
    const long long blocks = (cols + LRN_THREADS - 1) / LRN_THREADS;
    lrn_fwd_kernel<T><<<(unsigned)blocks, LRN_THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), cols, C, inner, lo,
        hi, salpha, beta, knorm);
    return cudaGetLastError();
  }
  const int R = nsize < C ? nsize : C;
  int nt = lrn_bwd_threads(R);
  size_t smem = (size_t)2 * 4 * R * nt;
  auto kern = lrn_bwd_kernel<T, true>;
  if (nt == 0) {
    nt = LRN_THREADS;
    smem = 0;
    kern = lrn_bwd_kernel<T, false>;
  }
  cudaError_t err = cxn_allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (cols + nt - 1) / nt;
  kern<<<(unsigned)blocks, nt, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<T*>(out), cols, C, inner, lo, hi, salpha, beta, knorm, R);
  return cudaGetLastError();
}

}  // namespace

// x (and g, the output gradient, for the backward): contiguous (outer, C,
// inner) in `dtype`, the window along C: logical NCHW as (N, C, H*W), its
// (H, W, C, N) transpose as (H*W, C, N); out: y (forward) or dx
// (backward), the same shape and dtype.  salpha = alpha / nsize; any
// nsize >= 1.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int cxn_lrn(int backward, const void* x, const void* g, void* out,
                       long long outer, int C, long long inner, int nsize,
                       float salpha, float beta, float knorm, int dtype,
                       void* stream) {
  if (outer < 1 || C < 1 || inner < 1 || nsize < 1 ||
      (outer * inner + 31) / 32 > 2147483647LL)
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
