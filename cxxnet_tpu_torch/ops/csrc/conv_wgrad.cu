// Weight and bias gradient of an ungrouped strided convolution for
// Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `conv_wgrad_hwcn_pallas`
// (its pallas_call over `_cw_hwcn_kernel`), the backward of
// `ops/nn.py conv_bias_fast` under `fast_wgrad = hwcn`, and
// `conv_wgrad_s2d_pallas` (its pallas_call over `_conv_wgrad_kernel`),
// the same backward under `fast_wgrad = pallas`: the space-to-depth
// identity the TPU kernel goes through is only an order of the taps, so
// both run these kernels on the original x.  Same function on logical
// NCHW / OIHW, float32 out:
//   dW[co, ci, ky, kx] = sum_{n, oy, ox} dy[n, co, oy, ox]
//                        * x[n, ci, oy*s - pad_y + ky, ox*s - pad_x + kx]
//   db[co]             = sum_{n, oy, ox} dy[n, co, oy, ox]
// (x read as 0 outside the image), any kernel size.
//
// What bounds it on the card: at AlexNet conv1 (x 256x3x227x227, dy
// 256x96x55x55, 11x11 stride 4) the bytes (x and dy read once, ~230 MB
// in bf16, 0.068 ms) and the 5.4e10 tensor-core operations (0.055 ms)
// are close.  An implicit GEMM, dW^T = im2col(x)^T . dy^T: (taps x K) .
// (K x CO), K = N * OH * OW (774,400 at conv1), taps = C * kh * kw (363).
//
// Two routes (cxn_conv_wgrad_route), chosen from shapes and dtype:
//
// wgmma (bf16, CO <= 96, taps + 1 <= 384, OW <= 64, the x strip of an
// output row within CW_STRIP_MAX): one block per SM owns ALL of dW for a
// contiguous range of output rows (image n, row oy), so dy and x are
// read once per block, not once per output tile.  A K-chunk is one
// output row: OW positions padded to 64, four k-steps of 16.  For each
// row the block copies, with cp.async into a staging area, the strip of
// x the row touches (C x kh input rows, columns -px .. 63 s + kw - 1 -
// px, zeros outside the image) and dy's CO rows of OW positions; x and
// dy rows start at odd bf16 offsets (227, 55, 3025 elements), so a row
// is copied in 16-byte pieces from the 16-byte boundary at or before its
// start and read back with a shift of 0 to 7 elements.  From the staging area it
// builds B (96 co x 64 positions, K-major) and the im2col operand A (384
// taps x 64 positions, K-major; one tap row a thread) in the 128-byte
// swizzle wgmma reads (csrc/flash_hopper.cuh: 16-byte chunk c of row r
// at c ^ (r % 8), tiles 1024-byte aligned).  Tap row C kh kw is the
// constant 1, so db comes out of the same products, exact in float32
// (1 times a bf16 value); padded positions and padded taps / co are
// zero in A or B and contribute exactly 0.  Three warpgroups each own
// 128 taps x 96 co (two wgmma m64n96k16 a k-step, 96 float32
// accumulators a thread).  The pipeline keeps two rows of copies in
// flight: while the products of row r run (wgmma is asynchronous), the
// copies of row r + 2 start and row r + 1, copied during the last
// row, is built into the other A / B buffers; a proxy fence makes those
// generic stores visible to wgmma.  Each block writes its float32
// partial (384 x 96) and a second kernel sums the blocks' partials in
// block order: no atomics, every run gives the same bits.
//
// mma.sync (float32, or shapes outside the wgmma route; MNIST_CONV's
// conv1 at C = 1, 3x3 stride 2): a block owns a 64 (co) x 64 (tap) tile
// of dW and a run of K-chunks of 32 positions of one image; per chunk it
// gathers dy (64 x 32) and the im2col slice (64 x 32) into shared
// memory and multiplies them: bf16 by mma.sync m16n8k16 with float32
// accumulation (8 warps, each 16 co x 32 taps), float32 on the CUDA
// cores (4 x 4 outputs a thread).  The K range is split across blocks
// (split-K) so the card fills; each split writes its float32 partial
// tile and a second kernel sums the splits in split order.  db rides
// along: the blocks of the first tap tile sum their staged dy rows.
#include <type_traits>

#include "flash_hopper.cuh"

namespace {

// ------------------------------------------------------- mma.sync route

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


// ------------------------------------------------------------ wgmma route
constexpr int CWW_TAPS = 384;     // tap rows of A: three warpgroups x 128
constexpr int CWW_CO = 96;        // co rows of B: the wgmma width N
constexpr int CWW_POS = 64;       // positions of a K-chunk (one output row)
constexpr int CWW_THREADS = 384;  // three warpgroups
constexpr int CWW_A_BYTES = CWW_TAPS * 128;
constexpr int CWW_B_BYTES = CWW_CO * 128;
// shared memory of a block: two buffers of A and B, two staging areas
// (the x strip and dy's rows of one output row) and 1 KB of alignment
// slack; the staging share left for the strip
constexpr int CW_SMEM_MAX = 232448;
constexpr int CWW_RSB_MAX = CWW_POS + 8;
constexpr int CW_STRIP_MAX =
    ((CW_SMEM_MAX - 1024) / 2 - CWW_A_BYTES - CWW_B_BYTES) / 2 -
    CWW_CO * CWW_RSB_MAX;

// RS and RSB: a staged strip row's and dy row's stride, a multiple of 8
// elements with room for the row after a shift of up to 7 (rows are
// copied in 16-byte pieces)
struct WgGeom {
  int C, H, W, CO, OH, OW, kh, kw, s, py, px, taps, RS, RSB;
  long long chunks, per_block;
};

// d (64 x 96) += A . B, A and B through descriptors of K-major tiles
__device__ __forceinline__ void wg_ss_n96(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, of which the first `bytes` (0 .. 16) are
// read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The strip row of channel ci, kernel row ky for output row oy of image
// n: flat index of its x column -px, and whether the row is in the image
__device__ __forceinline__ long long cww_row_start(const WgGeom& g,
                                                   long long n, int oy,
                                                   int ci, int ky,
                                                   bool* valid) {
  const int iy = oy * g.s - g.py + ky;
  *valid = iy >= 0 && iy < g.H;
  return ((n * g.C + ci) * g.H + iy) * (long long)g.W - g.px;
}

// flat index of dy[n, co, oy, 0]
__device__ __forceinline__ long long cww_dy_start(const WgGeom& g,
                                                  long long n, int oy,
                                                  int co) {
  return ((n * g.CO + co) * g.OH + oy) * (long long)g.OW;
}

// a staged row starts at the 16-byte boundary (8 elements) at or before
// its first element, which then sits `cw_shift` elements in
__device__ __forceinline__ int cw_shift(long long f) {
  return (int)(f - (f & ~7LL));
}

__device__ __forceinline__ uint32_t cw_pack2(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// 16-byte chunk j of row r of a K-major tile in the 128-byte swizzle
__device__ __forceinline__ uint4* cw_chunk(unsigned char* tile, int r,
                                           int j) {
  return reinterpret_cast<uint4*>(tile + r * 128 + ((j ^ (r & 7)) << 4));
}

// Start the copies of output row `ch` (image ch / OH, row ch % OH) into
// a staging area, as one cp.async group of this thread: the x strip (C x
// kh rows of RS columns) and dy's CO rows (RSB columns each).  A row is
// copied in 16-byte pieces from the 16-byte boundary at or before its
// start (cw_shift).  Strip elements outside the image are zero: pieces
// past the row's end are zero-filled by the copy; a piece that starts
// before column -px is copied whole when no padding column reads it (px
// = 0) and gathered by the thread itself otherwise.  dy elements past a
// row are not read (the build masks them).  Warp w takes rows w, w + 12,
// ...; its lanes take the pieces.
__device__ __forceinline__ void cww_copy(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ dy,
                                         __nv_bfloat16* strip,
                                         __nv_bfloat16* dyst,
                                         const WgGeom& g, long long ch) {
  const long long n = ch / g.OH;
  const int oy = (int)(ch % g.OH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int row = warp; row < g.C * g.kh; row += CWW_THREADS / 32) {
    bool valid;
    const long long f0 =
        cww_row_start(g, n, oy, row / g.kh, row % g.kh, &valid);
    const long long e0 = f0 & ~7LL;
    const int lo = cw_shift(f0) + g.px;     // first in-image element
    const int hi = lo + g.W;                // past the last one
    __nv_bfloat16* dst = strip + (long long)row * g.RS;
    for (int k = 8 * lane; k < g.RS; k += 256) {
      // elements k .. k + 7 of the row: flat e0 + k ..
      const int in = !valid || k >= hi ? 0 : (hi - k < 8 ? hi - k : 8);
      if (in > 0 && k < lo && g.px > 0) {
        __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = k + e >= lo && k + e < hi ? x[e0 + k + e] : zero;
        *reinterpret_cast<uint4*>(dst + k) =
            make_uint4(cw_pack2(v[0], v[1]), cw_pack2(v[2], v[3]),
                       cw_pack2(v[4], v[5]), cw_pack2(v[6], v[7]));
      } else {
        cp_async16(dst + k, in > 0 ? x + e0 + k : x, 2 * in);
      }
    }
  }
  for (int co = warp; co < g.CO; co += CWW_THREADS / 32) {
    const long long f0 = cww_dy_start(g, n, oy, co);
    const long long e0 = f0 & ~7LL;
    const int end = cw_shift(f0) + g.OW;    // past the row's last element
    __nv_bfloat16* dst = dyst + co * g.RSB;
    for (int k = 8 * lane; k < end; k += 256)
      cp_async16(dst + k, dy + e0 + k, 2 * (end - k < 8 ? end - k : 8));
  }
  cp_async_commit();
}

// Build the operands of output row `ch` from its staging area: this
// thread's tap row of A (a real tap: channel ci, kernel row ky, column
// kx; position ox at strip column ox s + kx) and, for co row t / 4,
// chunks 2 (t % 4) and 2 (t % 4) + 1 of B; positions >= OW and co >= CO
// are zero.
__device__ __forceinline__ void cww_build(const __nv_bfloat16* strip,
                                          const __nv_bfloat16* dyst,
                                          unsigned char* at,
                                          unsigned char* bt, bool real,
                                          int tap, int ci, int ky, int kx,
                                          const WgGeom& g, long long ch) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const long long n = ch / g.OH;
  const int oy = (int)(ch % g.OH);
  if (real) {
    bool valid;
    const long long f0 = cww_row_start(g, n, oy, ci, ky, &valid);
    const __nv_bfloat16* src =
        strip + (long long)(ci * g.kh + ky) * g.RS + kx + cw_shift(f0);
#pragma unroll
    for (int j = 0; j < CWW_POS / 8; ++j) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ox = j * 8 + 2 * e;
        w[e] = cw_pack2(ox < g.OW ? src[ox * g.s] : zero,
                        ox + 1 < g.OW ? src[(ox + 1) * g.s] : zero);
      }
      *cw_chunk(at, tap, j) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  const int r = threadIdx.x >> 2, j0 = (threadIdx.x & 3) * 2;
  const bool live = r < g.CO;
  const __nv_bfloat16* src =
      dyst + r * g.RSB + (live ? cw_shift(cww_dy_start(g, n, oy, r)) : 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ox = (j0 + h) * 8 + 2 * e;
      w[e] = cw_pack2(live && ox < g.OW ? src[ox] : zero,
                      live && ox + 1 < g.OW ? src[ox + 1] : zero);
    }
    *cw_chunk(bt, r, j0 + h) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(CWW_THREADS, 1)
conv_wgrad_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ dy,
                        float* __restrict__ part, WgGeom g) {
  extern __shared__ unsigned char smem_raw[];
  // buffers b = 0, 1: A at a0 + b A_BYTES, B at b0 + b B_BYTES; staging
  // areas b = 0, 1 at st0 + b st_len elements: the strip, then dy's rows
  unsigned char* a0 = fh_align1024(smem_raw);
  unsigned char* b0 = a0 + 2 * CWW_A_BYTES;
  __nv_bfloat16* st0 =
      reinterpret_cast<__nv_bfloat16*>(b0 + 2 * CWW_B_BYTES);
  const int strip_len = g.C * g.kh * g.RS;
  const int st_len = strip_len + CWW_CO * g.RSB;
  const int tid = threadIdx.x;
  const long long c0 = blockIdx.x * g.per_block;
  const long long c1 =
      c0 + g.per_block < g.chunks ? c0 + g.per_block : g.chunks;
  // this thread's tap row: a real tap (ci, ky, kx), or the bias row
  // (all 1 to position OW) or a padding row (0), both written once
  const int tap = tid;
  const bool real = tap < g.taps;
  const int ci = tap / (g.kh * g.kw), ky = (tap / g.kw) % g.kh,
            kx = tap % g.kw;
  if (!real) {
    const __nv_bfloat16 one = __float2bfloat16(1.f);
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int b = 0; b < 2; ++b)
      for (int j = 0; j < CWW_POS / 8; ++j) {
        __nv_bfloat16 v[8];
        for (int e = 0; e < 8; ++e)
          v[e] = tap == g.taps && j * 8 + e < g.OW ? one : zero;
        *cw_chunk(a0 + b * CWW_A_BYTES, tap, j) =
            make_uint4(cw_pack2(v[0], v[1]), cw_pack2(v[2], v[3]),
                       cw_pack2(v[4], v[5]), cw_pack2(v[6], v[7]));
      }
  }
  // warpgroup wg owns taps 128 wg .. 128 wg + 127
  const int wg = tid >> 7;
  float acc[2][48];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[h][i] = 0.f;
  // rows c0 and c0 + 1 in flight, then row c0 built
  if (c0 < c1) {
    cww_copy(x, dy, st0, st0 + strip_len, g, c0);
    if (c0 + 1 < c1) {
      cww_copy(x, dy, st0 + st_len, st0 + st_len + strip_len, g, c0 + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    cww_build(st0, st0 + strip_len, a0, b0, real, tap, ci, ky, kx, g, c0);
    fence_proxy_async();
    __syncthreads();
  }
  // Row ch: its products run on buffers i % 2 while row ch + 2's copies
  // go to staging area i % 2 (row ch's, built last iteration) and row
  // ch + 1 (copied during the last iteration) is built into buffers
  // (i + 1) % 2.
  for (long long ch = c0; ch < c1; ++ch) {
    const int cur = (int)((ch - c0) & 1), nxt = cur ^ 1;
    const uint32_t a_addr = smem_u32(a0 + cur * CWW_A_BYTES);
    const uint32_t b_addr = smem_u32(b0 + cur * CWW_B_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < CWW_POS / 16; ++kk) {
      const uint64_t db = wg_kmajor<CWW_CO>(b_addr, 0, kk);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wg_ss_n96(acc[h], wg_kmajor<CWW_TAPS>(a_addr, wg * 128 + h * 64, kk),
                  db);
    }
    wg_commit();
    if (ch + 2 < c1)
      cww_copy(x, dy, st0 + cur * st_len, st0 + cur * st_len + strip_len, g,
               ch + 2);
    if (ch + 1 < c1) {
      if (ch + 2 < c1) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();
      cww_build(st0 + nxt * st_len, st0 + nxt * st_len + strip_len,
                a0 + nxt * CWW_A_BYTES, b0 + nxt * CWW_B_BYTES, real, tap,
                ci, ky, kx, g, ch + 1);
      fence_proxy_async();
    }
    wg_wait_all();
#pragma unroll
    for (int h = 0; h < 2; ++h) wg_fence_acc<48>(acc[h]);
    __syncthreads();
  }
  // the partial: part[block][tap][co]; accumulator i of m64n96 holds row
  // 16 w + lane / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4)
  // (+ 1 for odd i)
  float* pb = part + (long long)blockIdx.x * CWW_TAPS * CWW_CO;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wg * 128 + h * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(pb + row * CWW_CO + col) =
          make_float2(acc[h][4 * j], acc[h][4 * j + 1]);
      *reinterpret_cast<float2*>(pb + (row + 8) * CWW_CO + col) =
          make_float2(acc[h][4 * j + 2], acc[h][4 * j + 3]);
    }
  }
}

// dW[co, tap] = sum of the blocks' partials [b][tap][co] in block order,
// db[co] from the bias row (tap == taps); threads run co fastest so the
// partials are read coalesced
__global__ void conv_wgrad_wgmma_reduce_kernel(const float* __restrict__ part,
                                               float* __restrict__ dw,
                                               float* __restrict__ db,
                                               int blocks, int CO, int taps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int tap = i / CWW_CO, co = i % CWW_CO;
  if (tap > taps || co >= CO) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b)
    s += part[(long long)b * CWW_TAPS * CWW_CO + i];
  if (tap < taps) dw[(long long)co * taps + tap] = s;
  else db[co] = s;
}

// the x strip's columns (positions 0 .. 63 at stride s, kw taps) and a
// strip row's stride (room for a shift of up to 7, a multiple of 8)
inline int cww_strip_cols(int s, int kw) { return (CWW_POS - 1) * s + kw; }
inline int cww_row_stride(int s, int kw) {
  return (cww_strip_cols(s, kw) + 7 + 7) & ~7;
}

size_t cww_smem(const WgGeom& g) {
  return 1024 + 2 * ((size_t)CWW_A_BYTES + CWW_B_BYTES) +
         2 * 2 * ((size_t)g.C * g.kh * g.RS + (size_t)CWW_CO * g.RSB);
}

cudaError_t cww_launch(const void* x, const void* dy, void* part, void* dw,
                       void* db, const WgGeom& g, int blocks,
                       cudaStream_t st) {
  const size_t smem = cww_smem(g);
  cudaError_t err = cxn_allow_smem(conv_wgrad_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  conv_wgrad_wgmma_kernel<<<blocks, CWW_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(part), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outs = (g.taps + 1) * CWW_CO;
  conv_wgrad_wgmma_reduce_kernel<<<(outs + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      static_cast<float*>(db), blocks, g.CO, g.taps);
  return cudaGetLastError();
}

// 1 when the wgmma route takes the conv, else 0 (the mma.sync route)
int cw_route(int C, int CO, int OW, int kh, int kw, int s, int dtype) {
  const long long strip = (long long)C * kh * cww_row_stride(s, kw);
  return dtype == CXN_BF16 && CO <= CWW_CO &&
         (long long)C * kh * kw + 1 <= CWW_TAPS && OW <= CWW_POS &&
         strip <= CW_STRIP_MAX;
}

}  // namespace

// The kernel the conv takes: 1 the wgmma route, 0 the mma.sync route,
// -1 for a geometry no route takes.
extern "C" int cxn_conv_wgrad_route(int C, int CO, int OW, int kh, int kw,
                                    int s, int dtype) {
  if (C < 1 || CO < 1 || OW < 1 || kh < 1 || kw < 1 || s < 1 ||
      (dtype != CXN_F32 && dtype != CXN_BF16))
    return -1;
  return cw_route(C, CO, OW, kh, kw, s, dtype);
}

// x: contiguous (N, C, H, W), dy: contiguous (N, CO, OH, OW), both in
// `dtype`; dw: (CO, C, kh, kw) float32, db: (CO,) float32.
// wgmma route: part is splits * 384 * 96 float32 scratch (part_b
// unused); block z reduces output rows [z * per_split, (z + 1) *
// per_split) of the N * OH.  mma.sync route: part is splits * CO *
// C*kh*kw and part_b splits * CO float32 scratch; split z reduces
// K-chunks [z * per_split, (z + 1) * per_split) of the N * ceil(OH*OW /
// 32).  Every split must own at least one.  Returns cudaGetLastError()
// after the last launch (0 = launched).
extern "C" int cxn_conv_wgrad(const void* x, const void* dy, void* part,
                              void* part_b, void* dw, void* db, int N, int C,
                              int H, int W, int CO, int OH, int OW, int kh,
                              int kw, int s, int pad_y, int pad_x, int splits,
                              long long per_split, int dtype, void* stream) {
  const int route = cxn_conv_wgrad_route(C, CO, OW, kh, kw, s, dtype);
  if (route < 0 || N < 1 || H < 1 || W < 1 || OH < 1 || pad_y < 0 ||
      pad_x < 0 || splits < 1 || splits > 65535 || per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    WgGeom g;
    g.C = C, g.H = H, g.W = W, g.CO = CO, g.OH = OH, g.OW = OW;
    g.kh = kh, g.kw = kw, g.s = s, g.py = pad_y, g.px = pad_x;
    g.taps = C * kh * kw;
    g.RS = cww_row_stride(s, kw), g.RSB = (OW + 7 + 7) & ~7;
    // x and dy are copied in 16-byte pieces
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) &
        15)
      return (int)cudaErrorMisalignedAddress;
    g.chunks = (long long)N * OH;
    g.per_block = per_split;
    if ((long long)(splits - 1) * per_split >= g.chunks ||
        (long long)splits * per_split < g.chunks)
      return (int)cudaErrorInvalidValue;
    return (int)cww_launch(x, dy, part, dw, db, g, splits, st);
  }
  ConvGeom g;
  g.C = C, g.H = H, g.W = W, g.CO = CO, g.OW = OW, g.kh = kh, g.kw = kw;
  g.s = s, g.py = pad_y, g.px = pad_x, g.taps = C * kh * kw, g.P = OH * OW;
  g.nchunk = (g.P + CW_BK - 1) / CW_BK;
  g.chunks = (long long)N * g.nchunk;
  g.per_split = per_split;
  if ((long long)(splits - 1) * per_split >= g.chunks ||
      (long long)splits * per_split < g.chunks)
    return (int)cudaErrorInvalidValue;
  if (dtype == CXN_F32)
    return (int)cw_launch<float>(x, dy, part, part_b, dw, db, g, splits, st);
  return (int)cw_launch<__nv_bfloat16>(x, dy, part, part_b, dw, db, g,
                                       splits, st);
}
