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
// dx is stored in x's dtype, dgamma / dbeta in gamma's.  1 / gamma is
// taken once per column (the division is not repeated per element).
//
// What bounds it on the card: bytes.  It reads y (or x) and dy and
// writes dx, 3 * rows * d * itemsize, for ~15 operations an element,
// far below the ~295 FLOP/byte at which an H100 turns compute-bound.
//
// Design: the TPU kernel walks row blocks in order and carries dgamma /
// dbeta in VMEM scratch across its sequential grid.  Blocks on the card
// run in no order, so the column sums end in a second pass, with no
// float atomics and the same bits on every run.  The caller
// (ops/layernorm.py `bwd_plan`) picks one of two routes from the shape:
// - register (d <= 4096): a persistent grid of 256-thread blocks; a row
//   belongs to 1, 2, 4 or 8 warps (8 / that many rows a block at once)
//   and each thread owns the same EL columns of every row it visits.
//   Its gamma, 1 / gamma and beta, and its dgamma / dbeta partials, live
//   in registers for the whole kernel.  Rows arrive by 16-byte loads (8
//   bf16 or 4 float32 a thread a load; neighbouring threads on
//   neighbouring 16 bytes) when d is a multiple of the vector and y /
//   x, dy, dx are 16-byte aligned, else by coalesced scalar loads; the
//   next row's loads are issued before this row's sums (EL = 8).  The
//   two row sums are warp shuffles, plus, with several warps a row, one
//   __syncthreads a row through a double-buffered slot.  Each row group
//   writes its partials as one row of (blocks * groups, d) scratch.
// - stream (wider rows): a block per row takes the two row sums from
//   device memory into (rows, 2) scratch; then blocks over (column
//   strip, run of rows) read each row's strip again (from L2 where it
//   still is), write dx and sum their columns into (runs, d) scratch.
// Both end in the column pass: a block per 32 columns, 16 warps each
// summing a fixed stride of the partial rows, then the warps in order.
// The kernels allocate nothing (the caller passes the scratch), do not
// synchronise, and launch on the caller's stream.

#include "common.cuh"

namespace {

constexpr int LNB_THREADS = 256;
constexpr int LNB_WARPS = LNB_THREADS / 32;
constexpr int LNB_COL_WARPS = 16;   // warps of the column pass

__device__ __forceinline__ float lnb_rcp(float g) {
  return g == 0.f ? 0.f : 1.f / g;
}

__device__ __forceinline__ float lnb_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// V elements of a row as loaded: 16 bytes (V > 1) or one scalar
template <typename T, int V>
struct LnbPiece {
  uint4 u;
  __device__ __forceinline__ void load(const T* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float at(int e) const {
    const int i = sizeof(T) == 4 ? e : e >> 1;
    const uint32_t w = i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
    if constexpr (sizeof(T) == 4) return __uint_as_float(w);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <typename T>
struct LnbPiece<T, 1> {
  float f;
  __device__ __forceinline__ void load(const T* p) { f = cxn_to_f32(*p); }
  __device__ __forceinline__ void zero() { f = 0.f; }
  __device__ __forceinline__ float at(int) const { return f; }
};

// Row r's loads of a thread (zeros past the last row or the row's end)
template <typename T, int NL, int V>
__device__ __forceinline__ void lnb_load_row(const T* __restrict__ a,
                                             const T* __restrict__ dy,
                                             long long r, long long rows,
                                             int d, int tg, int t,
                                             LnbPiece<T, V>* pa,
                                             LnbPiece<T, V>* pd) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int c0 = (i * tg + t) * V;
    if (r < rows && c0 < d) {
      pa[i].load(a + r * d + c0);
      pd[i].load(dy + r * d + c0);
    } else {
      pa[i].zero();
      pd[i].zero();
    }
  }
}

// The register route.  Load i of thread t (of the row's TG threads)
// covers columns (i TG + t) V .. + V - 1; with V > 1, V divides d, so a
// load is whole or past the row.
template <typename T, bool SAVE_X, int EL, int V>
__global__ void __launch_bounds__(LNB_THREADS, EL <= 8 ? 3 : 2)
lnb_reg_kernel(const T* __restrict__ a, const void* gamma, const void* beta,
               int gf32, const float* __restrict__ mean,
               const float* __restrict__ rstd, const T* __restrict__ dy,
               T* __restrict__ dx, float* __restrict__ part_g,
               float* __restrict__ part_b, long long rows, int d,
               int wpr) {
  constexpr int NL = EL / V;
  constexpr bool PREFETCH = EL <= 8;
  __shared__ float2 red[2][LNB_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpb = LNB_WARPS / wpr;   // rows a block holds at once
  const int grp = warp / wpr;        // this thread's row slot
  const int tg = wpr * 32;           // threads a row
  const int t = threadIdx.x - grp * tg;
  float g[EL], rg[EL], bt[EL], acc_g[EL], acc_b[EL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = (i * tg + t) * V + e, j = i * V + e;
      g[j] = c < d ? cxn_param(gamma, gf32, c) : 0.f;
      rg[j] = lnb_rcp(g[j]);
      bt[j] = !SAVE_X && c < d ? cxn_param(beta, gf32, c) : 0.f;
      acc_g[j] = acc_b[j] = 0.f;
    }
  }
  LnbPiece<T, V> pa[NL], pd[NL];
  const long long step = (long long)gridDim.x * rpb;
  long long r = (long long)blockIdx.x * rpb + grp;
  lnb_load_row<T, NL, V>(a, dy, r, rows, d, tg, t, pa, pd);
  int buf = 0;
  // every row slot of the block takes the same number of turns (the
  // __syncthreads below); a slot past the last row computes nothing
  for (long long r0 = (long long)blockIdx.x * rpb; r0 < rows;
       r0 += step, r += step, buf ^= 1) {
    LnbPiece<T, V> na[PREFETCH ? NL : 1], nd[PREFETCH ? NL : 1];
    if constexpr (PREFETCH)
      lnb_load_row<T, NL, V>(a, dy, r + step, rows, d, tg, t, na, nd);
    const bool live = r < rows;
    const float rs = live ? rstd[r] : 0.f;
    const float mu = SAVE_X && live ? mean[r] : 0.f;
    float s1 = 0.f, s2 = 0.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int j = i * V + e;
          const float av = pa[i].at(e), dv = pd[i].at(e);
          const float xh = SAVE_X ? (av - mu) * rs : (av - bt[j]) * rg[j];
          const float dyg = dv * g[j];
          s1 += dyg;
          s2 += dyg * xh;
          acc_g[j] += dv * xh;
          acc_b[j] += dv;
        }
      }
    }
    s1 = lnb_warp_sum(s1);
    s2 = lnb_warp_sum(s2);
    if (wpr > 1) {
      if (lane == 0) red[buf][warp] = make_float2(s1, s2);
      __syncthreads();
      s1 = s2 = 0.f;
      for (int w = 0; w < wpr; ++w) {
        const float2 p = red[buf][grp * wpr + w];
        s1 += p.x;
        s2 += p.y;
      }
    }
    if (live) {
      const float c1 = s1 / d, c2 = s2 / d;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int c0 = (i * tg + t) * V;
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int j = i * V + e;
          const float av = pa[i].at(e), dv = pd[i].at(e);
          const float xh = SAVE_X ? (av - mu) * rs : (av - bt[j]) * rg[j];
          o[e] = rs * (dv * g[j] - c1 - xh * c2);
        }
        if (c0 < d) cxn_store<T, V>(dx + r * d + c0, o);
      }
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        pa[i] = na[i];
        pd[i] = nd[i];
      }
    } else {
      lnb_load_row<T, NL, V>(a, dy, r + step, rows, d, tg, t, pa, pd);
    }
  }
  const long long pr = (long long)blockIdx.x * rpb + grp;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = (i * tg + t) * V + e, j = i * V + e;
      if (c < d) {
        part_g[pr * d + c] = acc_g[j];
        part_b[pr * d + c] = acc_b[j];
      }
    }
  }
}

// The stream route, first pass: a block per row, the row's two means
// (of dyg and of dyg * xhat) into stats[r].
template <typename T, bool SAVE_X, int V>
__global__ void __launch_bounds__(LNB_THREADS)
lnb_rowstats_kernel(const T* __restrict__ a, const void* gamma,
                    const void* beta, int gf32,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    const T* __restrict__ dy, float2* __restrict__ stats,
                    int d) {
  __shared__ float2 red[LNB_WARPS];
  const long long r = blockIdx.x;
  const float rs = rstd[r];
  const float mu = SAVE_X ? mean[r] : 0.f;
  float s1 = 0.f, s2 = 0.f;
  for (int c0 = threadIdx.x * V; c0 < d; c0 += LNB_THREADS * V) {
    LnbPiece<T, V> pa, pd;
    pa.load(a + r * d + c0);
    pd.load(dy + r * d + c0);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float g = cxn_param(gamma, gf32, c0 + e);
      const float av = pa.at(e);
      const float xh =
          SAVE_X ? (av - mu) * rs
                 : (av - cxn_param(beta, gf32, c0 + e)) * lnb_rcp(g);
      const float dyg = pd.at(e) * g;
      s1 += dyg;
      s2 += dyg * xh;
    }
  }
  s1 = lnb_warp_sum(s1);
  s2 = lnb_warp_sum(s2);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(s1, s2);
  __syncthreads();
  if (threadIdx.x == 0) {
    s1 = s2 = 0.f;
    for (int w = 0; w < LNB_WARPS; ++w) {
      s1 += red[w].x;
      s2 += red[w].y;
    }
    stats[r] = make_float2(s1 / d, s2 / d);
  }
}

// The stream route, second pass: block (x, y) owns the strip of V
// columns a thread starting at column x * 256 V and the rows of run y;
// writes dx there and the strip's column sums as row y of the partials.
template <typename T, bool SAVE_X, int V>
__global__ void __launch_bounds__(LNB_THREADS)
lnb_strip_kernel(const T* __restrict__ a, const void* gamma,
                 const void* beta, int gf32, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const T* __restrict__ dy,
                 T* __restrict__ dx, const float2* __restrict__ stats,
                 float* __restrict__ part_g, float* __restrict__ part_b,
                 long long rows, int d, long long per_run) {
  const int c0 = (blockIdx.x * LNB_THREADS + threadIdx.x) * V;
  if (c0 >= d) return;
  float g[V], rg[V], bt[V], acc_g[V], acc_b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    g[e] = cxn_param(gamma, gf32, c0 + e);
    rg[e] = lnb_rcp(g[e]);
    bt[e] = SAVE_X ? 0.f : cxn_param(beta, gf32, c0 + e);
    acc_g[e] = acc_b[e] = 0.f;
  }
  const long long r0 = (long long)blockIdx.y * per_run;
  const long long r1 = r0 + per_run < rows ? r0 + per_run : rows;
#pragma unroll 4
  for (long long r = r0; r < r1; ++r) {
    LnbPiece<T, V> pa, pd;
    pa.load(a + r * d + c0);
    pd.load(dy + r * d + c0);
    const float rs = rstd[r];
    const float mu = SAVE_X ? mean[r] : 0.f;
    const float2 st = stats[r];
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float av = pa.at(e), dv = pd.at(e);
      const float xh = SAVE_X ? (av - mu) * rs : (av - bt[e]) * rg[e];
      o[e] = rs * (dv * g[e] - st.x - xh * st.y);
      acc_g[e] += dv * xh;
      acc_b[e] += dv;
    }
    cxn_store<T, V>(dx + r * d + c0, o);
  }
  const long long pr = blockIdx.y;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    part_g[pr * d + c0 + e] = acc_g[e];
    part_b[pr * d + c0 + e] = acc_b[e];
  }
}

// The column pass: column blockIdx.x * 32 + lane; warp w sums partial
// rows w, w + 16, .. in order, then warp 0 adds the warps in order.
template <typename G>
__global__ void __launch_bounds__(32 * LNB_COL_WARPS)
lnb_colsum_kernel(const float* __restrict__ part_g,
                  const float* __restrict__ part_b, G* __restrict__ dg,
                  G* __restrict__ db, long long nparts, int d) {
  __shared__ float sh[2][LNB_COL_WARPS][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float sg = 0.f, sb = 0.f;
  if (c < d) {
    for (long long p = warp; p < nparts; p += LNB_COL_WARPS) {
      sg += part_g[p * d + c];
      sb += part_b[p * d + c];
    }
  }
  sh[0][warp][lane] = sg;
  sh[1][warp][lane] = sb;
  __syncthreads();
  if (warp == 0 && c < d) {
    sg = sb = 0.f;
    for (int w = 0; w < LNB_COL_WARPS; ++w) {
      sg += sh[0][w][lane];
      sb += sh[1][w][lane];
    }
    dg[c] = cxn_from_f32<G>(sg);
    db[c] = cxn_from_f32<G>(sb);
  }
}

struct LnbArgs {
  const void *a, *gamma, *beta, *mean, *rstd, *dy;
  void *dx, *scratch, *dg, *db;
  long long rows;
  int d, route, el, wpr, blocks, gf32;
  cudaStream_t st;
};

template <typename T, bool SAVE_X, int EL, int V>
cudaError_t lnb_reg_launch(const LnbArgs& p, float* part_g, float* part_b) {
  lnb_reg_kernel<T, SAVE_X, EL, V><<<p.blocks, LNB_THREADS, 0, p.st>>>(
      static_cast<const T*>(p.a), p.gamma, p.beta, p.gf32,
      static_cast<const float*>(p.mean), static_cast<const float*>(p.rstd),
      static_cast<const T*>(p.dy), static_cast<T*>(p.dx), part_g, part_b,
      p.rows, p.d, p.wpr);
  return cudaGetLastError();
}

template <typename T, bool SAVE_X, int V>
cudaError_t lnb_first_pass(const LnbArgs& p, float* part_g, float* part_b,
                           float2* stats) {
  if (p.route == 0)
    return p.el == 8 ? lnb_reg_launch<T, SAVE_X, 8, V>(p, part_g, part_b)
                     : lnb_reg_launch<T, SAVE_X, 16, V>(p, part_g, part_b);
  const T* a = static_cast<const T*>(p.a);
  const T* dy = static_cast<const T*>(p.dy);
  const float* mean = static_cast<const float*>(p.mean);
  const float* rstd = static_cast<const float*>(p.rstd);
  lnb_rowstats_kernel<T, SAVE_X, V><<<(unsigned)p.rows, LNB_THREADS, 0,
                                      p.st>>>(a, p.gamma, p.beta, p.gf32,
                                              mean, rstd, dy, stats, p.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.d + LNB_THREADS * V - 1) / (LNB_THREADS * V), p.blocks);
  const long long per_run = (p.rows + p.blocks - 1) / p.blocks;
  lnb_strip_kernel<T, SAVE_X, V><<<grid, LNB_THREADS, 0, p.st>>>(
      a, p.gamma, p.beta, p.gf32, mean, rstd, dy, static_cast<T*>(p.dx),
      stats, part_g, part_b, p.rows, p.d, per_run);
  return cudaGetLastError();
}

template <typename T>
cudaError_t lnb_run(const LnbArgs& p, int save_x, int vec, int gdtype) {
  constexpr int V = 16 / sizeof(T);
  // partial rows: a row slot of every register-route block, or a run
  const long long nparts =
      p.route == 0 ? (long long)p.blocks * (LNB_WARPS / p.wpr) : p.blocks;
  float* part_g = static_cast<float*>(p.scratch);
  float* part_b = part_g + nparts * p.d;
  float2* stats = reinterpret_cast<float2*>(part_b + nparts * p.d);
  cudaError_t err;
  if (vec)
    err = save_x ? lnb_first_pass<T, true, V>(p, part_g, part_b, stats)
                 : lnb_first_pass<T, false, V>(p, part_g, part_b, stats);
  else
    err = save_x ? lnb_first_pass<T, true, 1>(p, part_g, part_b, stats)
                 : lnb_first_pass<T, false, 1>(p, part_g, part_b, stats);
  if (err != cudaSuccess) return err;
  const unsigned cols = (p.d + 31) / 32;
  if (gdtype == CXN_F32)
    lnb_colsum_kernel<float><<<cols, 32 * LNB_COL_WARPS, 0, p.st>>>(
        part_g, part_b, static_cast<float*>(p.dg), static_cast<float*>(p.db),
        nparts, p.d);
  else
    lnb_colsum_kernel<__nv_bfloat16><<<cols, 32 * LNB_COL_WARPS, 0, p.st>>>(
        part_g, part_b, static_cast<__nv_bfloat16*>(p.dg),
        static_cast<__nv_bfloat16*>(p.db), nparts, p.d);
  return cudaGetLastError();
}

bool lnb_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// a: (rows, d) in `xdtype`, the forward's output y (save_x = 0) or its
// input x (save_x = 1); gamma, beta: (d,) in `gdtype` (beta read only
// when save_x = 0); mean (read only when save_x = 1), rstd: (rows,)
// float32; dy, dx: (rows, d) in `xdtype`; dg, db: (d,) in `gdtype`.
// The plan (ops/layernorm.py bwd_plan): route 0 (register) with `el`
// columns a thread, `wpr` warps a row and a grid of `blocks`, or route 1
// (stream) with `blocks` runs of rows; `vec` = 16-byte loads.  scratch:
// float32, 2 * nparts * d (+ 2 * rows for route 1), nparts = blocks *
// (8 / wpr) (route 0) or blocks (route 1).  Returns cudaGetLastError()
// after the last launch (0 = launched).
extern "C" int cxn_layernorm_bwd(const void* a, const void* gamma,
                                 const void* beta, const void* mean,
                                 const void* rstd, const void* dy, void* dx,
                                 void* scratch, void* dg, void* db,
                                 long long rows, int d, int route, int vec,
                                 int el, int wpr, int blocks, int save_x,
                                 int xdtype, int gdtype, void* stream) {
  const int v = xdtype == CXN_F32 ? 4 : 8;
  if (rows < 1 || d < 1 || blocks < 1 ||
      (xdtype != CXN_F32 && xdtype != CXN_BF16) ||
      (gdtype != CXN_F32 && gdtype != CXN_BF16))
    return (int)cudaErrorInvalidValue;
  if (vec && (d % v != 0 || !lnb_aligned(a) || !lnb_aligned(dy) ||
              !lnb_aligned(dx)))
    return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if ((el != 8 && el != 16) ||
        (wpr != 1 && wpr != 2 && wpr != 4 && wpr != 8) ||
        32LL * wpr * el < d)
      return (int)cudaErrorInvalidValue;
  } else if (route != 1 || rows > 2147483647LL || blocks > 65535 ||
             blocks > rows) {
    return (int)cudaErrorInvalidValue;
  }
  const LnbArgs p{a,      gamma, beta,   mean, rstd, dy,  dx,
                  scratch, dg,   db,     rows, d,    route, el,
                  wpr,    blocks, gdtype == CXN_F32,
                  static_cast<cudaStream_t>(stream)};
  if (xdtype == CXN_F32) return (int)lnb_run<float>(p, save_x, vec, gdtype);
  return (int)lnb_run<__nv_bfloat16>(p, save_x, vec, gdtype);
}
