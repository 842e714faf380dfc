// Weight and bias gradient of an ungrouped strided convolution for
// Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `conv_wgrad_hwcn_pallas`
// (its pallas_call over `_cw_hwcn_kernel`), the backward of
// `ops/nn.py conv_bias_fast` under `fast_wgrad = hwcn`.  Same function on
// logical NCHW / OIHW, float32 out:
//   dW[co, ci, ky, kx] = sum_{n, oy, ox} dy[n, co, oy, ox]
//                        * x[n, ci, oy*s - pad_y + ky, ox*s - pad_x + kx]
//   db[co]             = sum_{n, oy, ox} dy[n, co, oy, ox]
// (x read as 0 outside the image).  The TPU kernel reaches it through the
// space-to-depth identity with kernel blocks of at most 3; this one
// gathers the im2col operand directly and takes any kernel size.
//
// What bounds it on the card: at AlexNet conv1 (x 256x3x227x227, dy
// 256x96x55x55, 11x11 stride 4) the bytes (x and dy read once, ~230 MB
// in bf16) and the 5.4e10 tensor-core operations are within 25% of each
// other.  The im2col gather reads x 121 / 16 ~ 7.6 times (overlapping
// windows), mostly from L2.
//
// Design: an implicit GEMM dW = dy^T . im2col(x), (CO x K) . (K x taps)
// with K = N * OH * OW (774,400 at conv1), taps = C * kh * kw (363).
// A block owns a 64 (co) x 64 (tap) tile of dW and a run of K-chunks of
// 32 positions of one image; per chunk it stages dy (64 x 32) and the
// gathered im2col slice (64 x 32) in shared memory and multiplies them:
// bf16 by mma.sync m16n8k16 with float32 accumulation (8 warps, each
// 16 co x 32 taps), float32 on the CUDA cores (4 x 4 outputs a thread).
// The TPU kernel accumulates over a sequential grid; here the K range is
// split across blocks (split-K) so the card fills, each split writes its
// float32 partial tile to scratch, and a second kernel sums the splits
// in split order.  No atomics: every run gives the same bits.  db rides
// along: the blocks of the first tap tile sum their staged dy rows.
#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int CW_BM = 64;   // co per block
constexpr int CW_BN = 64;   // taps per block
constexpr int CW_BK = 32;   // positions per chunk
constexpr int CW_THREADS = 256;
constexpr int CW_ROWS = CW_THREADS / CW_BK;  // tile rows loaded per pass

struct ConvGeom {
  int C, H, W, CO, OW, kh, kw, s, py, px, taps, P, nchunk;
  long long chunks, per_split;
};

template <typename T>
__global__ void __launch_bounds__(CW_THREADS)
conv_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          float* __restrict__ part,
                          float* __restrict__ part_b, ConvGeom g) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // row pitch: 80 bytes for bf16 (fragment loads conflict-free), 33
  // floats for float32
  constexpr int LD = BF16 ? CW_BK + 8 : CW_BK + 1;
  __shared__ __align__(16) T As[CW_BM * LD];  // dy:     [co][position]
  __shared__ __align__(16) T Bs[CW_BN * LD];  // im2col: [tap][position]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * CW_BM, n0 = blockIdx.x * CW_BN;
  const long long c0 = blockIdx.z * g.per_split;
  const long long c1 =
      c0 + g.per_split < g.chunks ? c0 + g.per_split : g.chunks;
  const bool bias_block = blockIdx.x == 0;
  const int kk = tid % CW_BK, r0 = tid / CW_BK;
  // the taps this thread gathers: rows r0 + CW_ROWS * r of the B tile
  int b_ci[CW_BN / CW_ROWS], b_ky[CW_BN / CW_ROWS], b_kx[CW_BN / CW_ROWS];
#pragma unroll
  for (int r = 0; r < CW_BN / CW_ROWS; ++r) {
    const int tap = n0 + r0 + CW_ROWS * r;
    b_ci[r] = tap < g.taps ? tap / (g.kh * g.kw) : -1;
    b_ky[r] = (tap / g.kw) % g.kh;
    b_kx[r] = tap % g.kw;
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float bacc = 0.f;
  const T zero = cxn_from_f32<T>(0.f);
  for (long long ch = c0; ch < c1; ++ch) {
    const long long n = ch / g.nchunk;
    const int p = (int)(ch % g.nchunk) * CW_BK + kk;
    const bool live = p < g.P;
    const int oy = p / g.OW, ox = p % g.OW;
    const T* dyn = dy + n * g.CO * (long long)g.P;
    const T* xn = x + n * g.C * (long long)g.H * g.W;
#pragma unroll
    for (int r = 0; r < CW_BM / CW_ROWS; ++r) {
      const int m = r0 + CW_ROWS * r;
      const int co = m0 + m;
      As[m * LD + kk] =
          live && co < g.CO ? dyn[(long long)co * g.P + p] : zero;
    }
#pragma unroll
    for (int r = 0; r < CW_BN / CW_ROWS; ++r) {
      const int iy = oy * g.s - g.py + b_ky[r];
      const int ix = ox * g.s - g.px + b_kx[r];
      const bool in = live && b_ci[r] >= 0 && iy >= 0 && iy < g.H &&
                      ix >= 0 && ix < g.W;
      Bs[(r0 + CW_ROWS * r) * LD + kk] =
          in ? xn[((long long)b_ci[r] * g.H + iy) * g.W + ix] : zero;
    }
    __syncthreads();
    if constexpr (BF16) {
      // warp (wm, wn): co rows 16 wm .. +16, taps 32 wn .. +32
      const int warp = tid / 32, lane = tid % 32;
      const int wm = warp % 4, wn = warp / 4;
      const int gq = lane / 4, tq = lane % 4;
#pragma unroll
      for (int ks = 0; ks < CW_BK / 16; ++ks) {
        uint32_t a[4];
        tc_frag_a<LD>(a, As, wm * 16 + gq, ks, tq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[2];
          tc_frag_bt<LD>(b, Bs, wn * 4 + j, ks, gq, tq);
          mma_16816(acc + 4 * j, a, b);
        }
      }
    } else {
      const int tm = tid % 16, tn = tid / 16;
#pragma unroll 4
      for (int k = 0; k < CW_BK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = cxn_to_f32(As[(tm + 16 * i) * LD + k]);
          bv[i] = cxn_to_f32(Bs[(tn + 16 * i) * LD + k]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * i + j] += av[i] * bv[j];
      }
    }
    if (bias_block && tid < CW_BM)
      for (int k = 0; k < CW_BK; ++k) bacc += cxn_to_f32(As[tid * LD + k]);
    __syncthreads();
  }
  float* pz = part + (long long)blockIdx.z * g.CO * g.taps;
  auto store = [&](int co, int tap, float v) {
    if (co < g.CO && tap < g.taps) pz[(long long)co * g.taps + tap] = v;
  };
  if constexpr (BF16) {
    const int warp = tid / 32, lane = tid % 32;
    const int wm = warp % 4, wn = warp / 4;
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = m0 + wm * 16 + gq;
      const int tap = n0 + wn * 32 + j * 8 + 2 * tq;
      store(co, tap, acc[4 * j]);
      store(co, tap + 1, acc[4 * j + 1]);
      store(co + 8, tap, acc[4 * j + 2]);
      store(co + 8, tap + 1, acc[4 * j + 3]);
    }
  } else {
    const int tm = tid % 16, tn = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(m0 + tm + 16 * i, n0 + tn + 16 * j, acc[4 * i + j]);
  }
  if (bias_block && tid < CW_BM && m0 + tid < g.CO)
    part_b[(long long)blockIdx.z * g.CO + m0 + tid] = bacc;
}

// dw[i] = sum of the splits' partials in split order (db likewise)
__global__ void conv_wgrad_reduce_kernel(const float* __restrict__ part,
                                         const float* __restrict__ part_b,
                                         float* __restrict__ dw,
                                         float* __restrict__ db, int splits,
                                         int CO, int taps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)CO * taps;
  if (i < total) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * total + i];
    dw[i] = s;
  }
  if (i < CO) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part_b[(long long)z * CO + i];
    db[i] = s;
  }
}

template <typename T>
cudaError_t cw_launch(const void* x, const void* dy, void* part,
                      void* part_b, void* dw, void* db, const ConvGeom& g,
                      int splits, cudaStream_t st) {
  const dim3 grid((g.taps + CW_BN - 1) / CW_BN, (g.CO + CW_BM - 1) / CW_BM,
                  splits);
  conv_wgrad_partial_kernel<T><<<grid, CW_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(part), static_cast<float*>(part_b), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)g.CO * g.taps;
  conv_wgrad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(part_b),
      static_cast<float*>(dw), static_cast<float*>(db), splits, g.CO, g.taps);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (N, C, H, W), dy: contiguous (N, CO, OH, OW), both in
// `dtype`; part: splits * CO * C*kh*kw float32 scratch, part_b: splits *
// CO float32 scratch; dw: (CO, C, kh, kw) float32, db: (CO,) float32.
// Split z reduces K-chunks [z * per_split, (z + 1) * per_split) of the
// N * ceil(OH*OW / 32) chunks; every split must own at least one.
// Returns cudaGetLastError() after the last launch (0 = launched).
extern "C" int cxn_conv_wgrad(const void* x, const void* dy, void* part,
                              void* part_b, void* dw, void* db, int N, int C,
                              int H, int W, int CO, int OH, int OW, int kh,
                              int kw, int s, int pad_y, int pad_x, int splits,
                              long long per_split, int dtype, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || CO < 1 || OH < 1 || OW < 1 ||
      kh < 1 || kw < 1 || s < 1 || pad_y < 0 || pad_x < 0 || splits < 1 ||
      splits > 65535 || per_split < 1)
    return (int)cudaErrorInvalidValue;
  ConvGeom g;
  g.C = C, g.H = H, g.W = W, g.CO = CO, g.OW = OW, g.kh = kh, g.kw = kw;
  g.s = s, g.py = pad_y, g.px = pad_x, g.taps = C * kh * kw, g.P = OH * OW;
  g.nchunk = (g.P + CW_BK - 1) / CW_BK;
  g.chunks = (long long)N * g.nchunk;
  g.per_split = per_split;
  if ((long long)(splits - 1) * per_split >= g.chunks ||
      (long long)splits * per_split < g.chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == CXN_F32)
    return (int)cw_launch<float>(x, dy, part, part_b, dw, db, g, splits, st);
  if (dtype == CXN_BF16)
    return (int)cw_launch<__nv_bfloat16>(x, dy, part, part_b, dw, db, g,
                                         splits, st);
  return (int)cudaErrorInvalidValue;
}
