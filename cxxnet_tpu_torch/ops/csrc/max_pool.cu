// Max pooling forward and the all-ties ("mshadow unpool") backward for
// Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `max_pool_hwcn` /
// `max_pool_relu_hwcn`: the forward `_mp_hwcn_fwd` (its pallas_call over
// `_mp_hwcn_fwd_kernel`) and the backward `_mp_hwcn_bwd` (the multi-row
// and single-row pallas_calls, `relu_mask` for the relu-fused pool).
// Same function on logical NCHW:
//   y[oy, ox] = max of x over rows oy*s - pad_y + [0, kh) and columns
//               ox*s - pad_x + [0, kw), clipped to the input (the
//               reference's tail-window rule; the caller sizes the
//               output so every window holds an input element);
//   dx[iy, ix] = sum over the windows (oy, ox) that cover (iy, ix) and
//               whose max equals x[iy, ix] (every tied maximum gets the
//               window's gradient) of dy[oy, ox], masked by y > 0 under
//               RELU (the backward of relu(max_pool(x)) from the
//               pre-relu pooled y).
// The backward sums in float32 in the TPU kernel's order (window rows
// ascending, window columns descending) and stores dx in x's dtype once.
// The TPU kernel takes no padding and square windows only; this one
// takes both, so a padded pool never falls back to a plain version.
//
// What bounds it on the card: bytes.  The forward reads x and writes y,
// the backward reads x, y and dy and writes dx, with a few compares an
// element.
//
// Design: the backward is the gather form of `_mp_hwcn_bwd_kernel`:
// one thread per input element walks its <= ceil(kh/s) * ceil(kw/s)
// candidate windows.  No two threads write one output, so there are no
// atomics and every run gives the same bits.  The forward is one thread
// per output element.  Neighbouring threads own neighbouring columns,
// so loads and stores are coalesced along W.
#include "common.cuh"

namespace {

constexpr int MP_THREADS = 256;

struct PoolGeom {
  int H, W, OH, OW, kh, kw, s, py, px;
};

template <typename T>
__global__ void __launch_bounds__(MP_THREADS)
max_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                    long long total, PoolGeom g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ox = (int)(t % g.OW);
  const int oy = (int)((t / g.OW) % g.OH);
  const long long plane = t / ((long long)g.OW * g.OH);
  const T* xp = x + plane * g.H * g.W;
  const int y0 = oy * g.s - g.py, x0 = ox * g.s - g.px;
  const int ya = y0 < 0 ? 0 : y0, yb = y0 + g.kh > g.H ? g.H : y0 + g.kh;
  const int xa = x0 < 0 ? 0 : x0, xb = x0 + g.kw > g.W ? g.W : x0 + g.kw;
  float m = __int_as_float(0xff800000);  // -inf
  for (int iy = ya; iy < yb; ++iy)
    for (int ix = xa; ix < xb; ++ix)
      m = fmaxf(m, cxn_to_f32(xp[(long long)iy * g.W + ix]));
  y[t] = cxn_from_f32<T>(m);
}

// first window index covering input position a: ceil((a + pad - k + 1)/s)
__device__ __forceinline__ int mp_first(int a, int pad, int k, int s) {
  const int num = a + pad - k + 1;
  return num <= 0 ? 0 : (num + s - 1) / s;
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(MP_THREADS)
max_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ dy, T* __restrict__ dx,
                    long long total, PoolGeom g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ix = (int)(t % g.W);
  const int iy = (int)((t / g.W) % g.H);
  const long long plane = t / ((long long)g.W * g.H);
  const float xv = cxn_to_f32(x[t]);
  const T* yp = y + plane * g.OH * g.OW;
  const T* dyp = dy + plane * g.OH * g.OW;
  const int oy0 = mp_first(iy, g.py, g.kh, g.s);
  int oy1 = (iy + g.py) / g.s;
  if (oy1 > g.OH - 1) oy1 = g.OH - 1;
  const int ox0 = mp_first(ix, g.px, g.kw, g.s);
  int ox1 = (ix + g.px) / g.s;
  if (ox1 > g.OW - 1) ox1 = g.OW - 1;
  float acc = 0.f;
  for (int oy = oy0; oy <= oy1; ++oy) {
    for (int ox = ox1; ox >= ox0; --ox) {
      const long long o = (long long)oy * g.OW + ox;
      const float yv = cxn_to_f32(yp[o]);
      if (yv == xv && (!RELU || yv > 0.f)) acc += cxn_to_f32(dyp[o]);
    }
  }
  dx[t] = cxn_from_f32<T>(acc);
}

template <typename T>
cudaError_t mp_launch(int backward, int relu, const void* x, const void* y,
                      const void* dy, void* out, long long planes,
                      PoolGeom g, cudaStream_t st) {
  const long long total =
      planes * (backward ? (long long)g.H * g.W : (long long)g.OH * g.OW);
  const long long blocks = (total + MP_THREADS - 1) / MP_THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  if (!backward)
    max_pool_fwd_kernel<T><<<(unsigned)blocks, MP_THREADS, 0, st>>>(
        xt, static_cast<T*>(out), total, g);
  else if (relu)
    max_pool_bwd_kernel<T, true><<<(unsigned)blocks, MP_THREADS, 0, st>>>(
        xt, static_cast<const T*>(y), static_cast<const T*>(dy),
        static_cast<T*>(out), total, g);
  else
    max_pool_bwd_kernel<T, false><<<(unsigned)blocks, MP_THREADS, 0, st>>>(
        xt, static_cast<const T*>(y), static_cast<const T*>(dy),
        static_cast<T*>(out), total, g);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (planes = N*C, H, W) in `dtype`.  Forward (backward = 0):
// out = y, (planes, OH, OW).  Backward: y = the forward's (pre-relu)
// output, dy its gradient, both (planes, OH, OW); out = dx, like x;
// relu = 1 masks dy where y <= 0.  The caller sizes OH / OW by the
// reference rule (every window holds an input element).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cxn_max_pool(int backward, int relu, const void* x,
                            const void* y, const void* dy, void* out,
                            long long planes, int H, int W, int OH, int OW,
                            int kh, int kw, int s, int pad_y, int pad_x,
                            int dtype, void* stream) {
  if (planes < 1 || H < 1 || W < 1 || OH < 1 || OW < 1 || kh < 1 ||
      kw < 1 || s < 1 || pad_y < 0 || pad_x < 0 || pad_y >= kh ||
      pad_x >= kw)
    return (int)cudaErrorInvalidValue;
  const PoolGeom g{H, W, OH, OW, kh, kw, s, pad_y, pad_x};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == CXN_F32)
    return (int)mp_launch<float>(backward, relu, x, y, dy, out, planes, g,
                                 st);
  if (dtype == CXN_BF16)
    return (int)mp_launch<__nv_bfloat16>(backward, relu, x, y, dy, out,
                                         planes, g, st);
  return (int)cudaErrorInvalidValue;
}
