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
// Design.  The forward takes one of two routes that the caller
// (ops/pool.py `fwd_plan`) picks from the window:
// - cells (the backward's cells windows, any padding; x and y 16-byte
//   aligned): a block owns a group of whole planes and brings their x
//   into shared memory in 16-byte pieces; a thread owns one output
//   column of one plane and walks down it one output row at a time,
//   keeping in registers the maxima of the K input rows of its window
//   (over the window's columns, clipped), so a step reads only the S
//   rows that enter the window and each x row is read from shared
//   memory once a thread.  Neighbouring lanes own neighbouring columns
//   and take the same branches; y goes out through shared memory in
//   16-byte pieces.  Max is exact, so regrouping the window changes no
//   bit of y.
// - per-output (other windows, x or y off 16-byte alignment, or planes
//   too large for shared memory): one thread per output element.
// The backward is the gather form of `_mp_hwcn_bwd_kernel` (each input
// element walks its <= ceil(kh/s) * ceil(kw/s) candidate windows and
// sums in a register, so no two threads write one output: no atomics,
// the same bits on every run), on one of two routes that the caller
// (ops/pool.py `bwd_plan`) picks from the window:
// - cells (3 x 3 windows at stride 2 or 1, 2 x 2 at stride 2, any
//   padding; x and dx 16-byte aligned): a block owns a group of whole
//   planes, brings their x into shared memory and takes dx back out in
//   16-byte pieces; in between, a thread owns the S input columns
//   between two window starts of one plane and walks down the plane S
//   rows at a time, keeping the window rows it still needs in
//   registers, so each y and dy value is loaded once a thread.
//   Neighbouring lanes own neighbouring columns and take the same
//   branches: y and dy move in coalesced warp-wide loads, x and dx in
//   conflict-free shared-memory accesses, and index arithmetic is one
//   division a thread.
// - gather (other windows, x or dx off 16-byte alignment, or a plane
//   too large for shared memory): one thread per input element decodes
//   its position with 64-bit arithmetic and walks its candidate windows.

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

// The cells route, for K x K windows at stride S (D = (K - 1) / S).
// A block owns a group of whole planes.  It copies the group's x into
// shared memory in 16-byte pieces (cp.async, from the 16-byte boundary
// at or before the group; zero-filled past the tensor), computes dx in
// place there, and stores it back in 16-byte pieces (the elements it
// owns of a piece on the group's edge one by one).  Between the two,
// thread (plane, t) owns input columns c0 .. c0 + S - 1, c0 = t S -
// pad_x, and walks its plane in cells of S x S: cell row m holds input
// rows m S - pad_y .. + S - 1.  Windows (m - j, t - k), j, k = 0 .. D,
// cover the cell, and window (m - j, t - k) covers element (q, p) of it
// iff j S + q <= K - 1 and k S + p <= K - 1 (fixed at compile time).
// The thread keeps window rows m .. m - D (columns t .. t - D) in a
// register ring, each loaded once from device memory (neighbouring
// lanes load neighbouring windows), with the next MP_AHEAD cell rows'
// loads in flight.  Sums run in the gather order (window rows
// ascending, columns descending).  A window outside the output reads as
// NaN (equal to nothing); a miss adds 0.0, which leaves a float32 sum
// that starts at +0 bitwise unchanged.
constexpr int MP_AHEAD = 2;   // cell rows a thread loads ahead

// 16 bytes global -> shared, of which the first `bytes` (0 .. 16) are
// read and the rest zero-filled
__device__ __forceinline__ void mp_cp_async16(void* dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(bytes) : "memory");
}

template <typename T, int K, int S>
struct MpCellRow {
  static constexpr int D = (K - 1) / S;
  float x[S][S], wy[D + 1], wd[D + 1];
  // cell row m of thread t: x (NaN outside the input; `xp` the plane in
  // shared memory) and window row m
  __device__ __forceinline__ void load(const T* xp, const T* __restrict__ yp,
                                       const T* __restrict__ dyp, int m,
                                       int t, int c0, const PoolGeom& g) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int iy = m * S - g.py + q;
#pragma unroll
      for (int p = 0; p < S; ++p) {
        const int ix = c0 + p;
        x[q][p] = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W
                      ? cxn_to_f32(xp[iy * g.W + ix])
                      : __int_as_float(0x7fc00000);  // NaN: equals nothing
      }
    }
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      const int ox = t - k;
      const bool ok = m < g.OH && ox >= 0 && ox < g.OW;
      const int o = ok ? m * g.OW + ox : 0;
      wy[k] = ok ? cxn_to_f32(yp[o]) : __int_as_float(0x7fc00000);
      wd[k] = cxn_to_f32(dyp[o]);
    }
  }
};

// thread t's columns of one plane, x read and dx written at `xp`
template <typename T, bool RELU, int K, int S>
__device__ __forceinline__ void mp_cells_walk(T* xp,
                                              const T* __restrict__ yp,
                                              const T* __restrict__ dyp,
                                              int t, const PoolGeom& g) {
  constexpr int D = (K - 1) / S;
  const int c0 = t * S - g.px;
  const int rows = (g.H + g.py + S - 1) / S;   // cell rows
  float wy[D + 1][D + 1], wd[D + 1][D + 1];   // [j][k]: window (m - j, t - k)
#pragma unroll
  for (int j = 0; j <= D; ++j) {
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      wy[j][k] = __int_as_float(0x7fc00000);
      wd[j][k] = 0.f;
    }
  }
  // cell row m, then the MP_AHEAD rows after it, loads in flight
  MpCellRow<T, K, S> cur, ahead[MP_AHEAD];
  cur.load(xp, yp, dyp, 0, t, c0, g);
#pragma unroll
  for (int i = 0; i < MP_AHEAD; ++i)
    if (i + 1 < rows) ahead[i].load(xp, yp, dyp, i + 1, t, c0, g);
  for (int m = 0; m < rows; ++m) {
#pragma unroll
    for (int j = D; j > 0; --j) {
#pragma unroll
      for (int k = 0; k <= D; ++k) {
        wy[j][k] = wy[j - 1][k];
        wd[j][k] = wd[j - 1][k];
      }
    }
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      wy[0][k] = cur.wy[k];
      wd[0][k] = cur.wd[k];
    }
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int iy = m * S - g.py + q;
#pragma unroll
      for (int p = 0; p < S; ++p) {
        float acc = 0.f;
#pragma unroll
        for (int j = D; j >= 0; --j) {
#pragma unroll
          for (int k = 0; k <= D; ++k) {
            if (j * S + q <= K - 1 && k * S + p <= K - 1) {
              const bool hit = wy[j][k] == cur.x[q][p] &&
                               (!RELU || wy[j][k] > 0.f);
              acc += hit ? wd[j][k] : 0.f;
            }
          }
        }
        const int ix = c0 + p;
        if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
          xp[iy * g.W + ix] = cxn_from_f32<T>(acc);
      }
    }
    cur = ahead[0];
#pragma unroll
    for (int i = 0; i + 1 < MP_AHEAD; ++i) ahead[i] = ahead[i + 1];
    if (m + MP_AHEAD + 1 < rows)
      ahead[MP_AHEAD - 1].load(xp, yp, dyp, m + MP_AHEAD + 1, t, c0, g);
  }
}

// Block b owns planes [b group, min((b + 1) group, planes)); shared
// memory holds their x (then dx) after a shift of up to V - 1.
template <typename T, bool RELU, int K, int S>
__global__ void __launch_bounds__(MP_THREADS)
max_pool_bwd_cells_kernel(const T* __restrict__ x, const T* __restrict__ y,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          long long planes, int group, int cells,
                          PoolGeom g) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char mp_smem[];
  T* sx = reinterpret_cast<T*>(mp_smem);
  const int hw = g.H * g.W, ohw = g.OH * g.OW;
  const long long p0 = (long long)blockIdx.x * group;
  const int here = planes - p0 < group ? (int)(planes - p0) : group;
  const long long xs = p0 * hw, xe = xs + (long long)here * hw;
  const long long xa = xs - xs % V, xtot = planes * hw;
  const int npieces = (int)((xe - xa + V - 1) / V);
  for (int k = threadIdx.x; k < npieces; k += MP_THREADS) {
    const long long e = xa + (long long)k * V;
    mp_cp_async16(sx + k * V, x + e,
                  (int)sizeof(T) * (xtot - e < V ? (int)(xtot - e) : V));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  T* sx0 = sx + (xs - xa);   // plane p0
  for (int i = threadIdx.x; i < here * cells; i += MP_THREADS) {
    const int pl = i / cells;
    mp_cells_walk<T, RELU, K, S>(sx0 + pl * hw, y + (p0 + pl) * ohw,
                                 dy + (p0 + pl) * ohw, i - pl * cells, g);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < npieces; k += MP_THREADS) {
    const long long e0 = xa + (long long)k * V;
    if (e0 >= xs && e0 + V <= xe) {
      *reinterpret_cast<uint4*>(dx + e0) =
          *reinterpret_cast<const uint4*>(sx + k * V);
    } else {
      for (long long e = e0 > xs ? e0 : xs; e < e0 + V && e < xe; ++e)
        dx[e] = sx[e - xa];
    }
  }
}

// elements a cells-route block stages of `group` planes of hw elements
// each (x or dx, and the forward's y): the group's after a shift of up
// to V - 1, in whole 16-byte pieces
template <typename T>
__host__ __device__ __forceinline__ long long mp_cap(int group, int hw) {
  constexpr int V = 16 / sizeof(T);
  return ((long long)group * hw + 2 * V - 2) / V * V;
}

// Thread ox of one plane of the forward's cells route: x read at `xp`,
// y written at `yp` (both in shared memory).  rm[k] holds the max of
// input row oy S - pad_y + k over the window's columns (-inf for a row
// outside the input), k = 0 .. K - 1; a step keeps the last K - S of
// them and reads the S rows that follow.
template <typename T, int K, int S>
__device__ __forceinline__ void mp_fwd_cells_walk(const T* xp, T* yp, int ox,
                                                  const PoolGeom& g) {
  const float NEG = __int_as_float(0xff800000);  // -inf
  const int x0 = ox * S - g.px;
  bool ok[K];
  int col[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ok[j] = x0 + j >= 0 && x0 + j < g.W;
    col[j] = ok[j] ? x0 + j : 0;
  }
  auto row_max = [&](int iy) {
    float m = NEG;
    if (iy >= 0 && iy < g.H) {
      const T* r = xp + iy * g.W;
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (ok[j]) m = fmaxf(m, cxn_to_f32(r[col[j]]));
    }
    return m;
  };
  float rm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) rm[k] = row_max(k - g.py);
  for (int oy = 0;; ++oy) {
    float m = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) m = fmaxf(m, rm[k]);
    yp[oy * g.OW + ox] = cxn_from_f32<T>(m);
    if (oy + 1 == g.OH) break;
#pragma unroll
    for (int k = 0; k < K; ++k)
      rm[k] = k + S < K ? rm[k + S < K ? k + S : k]
                        : row_max((oy + 1) * S - g.py + k);
  }
}

// The forward's cells route.  Block b owns planes [b group, min((b + 1)
// group, planes)): their x after a shift of up to V - 1 in shared memory
// (mp_cap elements), then their y, shifted likewise.
template <typename T, int K, int S>
__global__ void __launch_bounds__(MP_THREADS)
max_pool_fwd_cells_kernel(const T* __restrict__ x, T* __restrict__ y,
                          long long planes, int group, PoolGeom g) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char mp_smem[];
  T* sx = reinterpret_cast<T*>(mp_smem);
  const int hw = g.H * g.W, ohw = g.OH * g.OW;
  T* sy = sx + mp_cap<T>(group, hw);
  const long long p0 = (long long)blockIdx.x * group;
  const int here = planes - p0 < group ? (int)(planes - p0) : group;
  const long long xs = p0 * hw, xe = xs + (long long)here * hw;
  const long long xa = xs - xs % V, xtot = planes * hw;
  const int npieces = (int)((xe - xa + V - 1) / V);
  for (int k = threadIdx.x; k < npieces; k += MP_THREADS) {
    const long long e = xa + (long long)k * V;
    mp_cp_async16(sx + k * V, x + e,
                  (int)sizeof(T) * (xtot - e < V ? (int)(xtot - e) : V));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const long long ys = p0 * ohw, ye = ys + (long long)here * ohw;
  const long long ya = ys - ys % V;
  const T* sx0 = sx + (xs - xa);   // plane p0
  T* sy0 = sy + (ys - ya);
  for (int i = threadIdx.x; i < here * g.OW; i += MP_THREADS) {
    const int pl = i / g.OW;
    mp_fwd_cells_walk<T, K, S>(sx0 + pl * hw, sy0 + pl * ohw,
                               i - pl * g.OW, g);
  }
  __syncthreads();
  const int ypieces = (int)((ye - ya + V - 1) / V);
  for (int k = threadIdx.x; k < ypieces; k += MP_THREADS) {
    const long long e0 = ya + (long long)k * V;
    if (e0 >= ys && e0 + V <= ye) {
      *reinterpret_cast<uint4*>(y + e0) =
          *reinterpret_cast<const uint4*>(sy + k * V);
    } else {
      for (long long e = e0 > ys ? e0 : ys; e < e0 + V && e < ye; ++e)
        y[e] = sy[e - ya];
    }
  }
}

template <typename T, bool RELU>
auto mp_cells_kernel(const PoolGeom& g) {
  if (g.kw == 3 && g.s == 1) return max_pool_bwd_cells_kernel<T, RELU, 3, 1>;
  if (g.kw == 2 && g.s == 2) return max_pool_bwd_cells_kernel<T, RELU, 2, 2>;
  return max_pool_bwd_cells_kernel<T, RELU, 3, 2>;
}

template <typename T>
cudaError_t mp_launch(int backward, int relu, const void* x, const void* y,
                      const void* dy, void* out, long long planes,
                      PoolGeom g, int cells, int group, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (cells > 0) {
    // the cells routes: 3 x 3 windows at stride 2 or 1, 2 x 2 at 2; a
    // thread a column cell (backward) or an output column (forward)
    const bool fits = g.kh == g.kw && ((g.kw == 3 && (g.s == 2 || g.s == 1))
                                       || (g.kw == 2 && g.s == 2));
    const size_t smem =
        sizeof(T) * (mp_cap<T>(group, g.H * g.W) +
                     (backward ? 0 : mp_cap<T>(group, g.OH * g.OW)));
    const long long blocks = (planes + group - 1) / group;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const int want = backward ? (g.W + g.px + g.s - 1) / g.s : g.OW;
    if (!fits || !aligned || group < 1 || cells != want || smem > 232448 ||
        (long long)group * cells > 2147483647LL ||
        blocks > 2147483647LL)
      return cudaErrorInvalidValue;
    if (!backward) {
      auto kern = max_pool_fwd_cells_kernel<T, 3, 2>;
      if (g.kw == 3 && g.s == 1) kern = max_pool_fwd_cells_kernel<T, 3, 1>;
      if (g.kw == 2) kern = max_pool_fwd_cells_kernel<T, 2, 2>;
      cudaError_t err = cxn_allow_smem(kern, smem);
      if (err != cudaSuccess) return err;
      kern<<<(unsigned)blocks, MP_THREADS, smem, st>>>(
          xt, static_cast<T*>(out), planes, group, g);
      return cudaGetLastError();
    }
    auto kern = relu ? mp_cells_kernel<T, true>(g)
                     : mp_cells_kernel<T, false>(g);
    cudaError_t err = cxn_allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)blocks, MP_THREADS, smem, st>>>(
        xt, static_cast<const T*>(y), static_cast<const T*>(dy),
        static_cast<T*>(out), planes, group, cells, g);
    return cudaGetLastError();
  }
  const long long total =
      planes * (backward ? (long long)g.H * g.W : (long long)g.OH * g.OW);
  const long long blocks = (total + MP_THREADS - 1) / MP_THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
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
// relu = 1 masks dy where y <= 0.  cells > 0 takes the cells route with
// `group` planes a block and `cells` threads a plane: OW in the forward
// (ops/pool.py fwd_plan; x and y 16-byte aligned), ceil((W + pad_x) /
// s) column cells in the backward (bwd_plan; x and dx 16-byte aligned);
// 0 the per-output forward or the gather backward.  A plan the kernels
// cannot run is refused (cudaErrorInvalidValue), never rerouted.  The
// caller sizes OH / OW by the reference rule (every window holds an
// input element).  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int cxn_max_pool(int backward, int relu, const void* x,
                            const void* y, const void* dy, void* out,
                            long long planes, int H, int W, int OH, int OW,
                            int kh, int kw, int s, int pad_y, int pad_x,
                            int cells, int group, int dtype,
                            void* stream) {
  if (planes < 1 || H < 1 || W < 1 || OH < 1 || OW < 1 || kh < 1 ||
      kw < 1 || s < 1 || pad_y < 0 || pad_x < 0 || pad_y >= kh ||
      pad_x >= kw || cells < 0)
    return (int)cudaErrorInvalidValue;
  const PoolGeom g{H, W, OH, OW, kh, kw, s, pad_y, pad_x};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == CXN_F32)
    return (int)mp_launch<float>(backward, relu, x, y, dy, out, planes, g,
                                 cells, group, st);
  if (dtype == CXN_BF16)
    return (int)mp_launch<__nv_bfloat16>(backward, relu, x, y, dy, out,
                                         planes, g, cells, group, st);
  return (int)cudaErrorInvalidValue;
}
