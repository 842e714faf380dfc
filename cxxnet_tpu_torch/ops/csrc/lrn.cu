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
// rsqrt(norm * sqrt(norm)), as on the TPU, except on the window routes,
// which take norm^-beta and norm^-beta / norm as 2^(-beta lg norm) and
// 2^(-(beta + 1) lg norm) (MUFU instructions, about 2 ulp each, where
// sqrt, rsqrt and a division cost three and some twenty more).  Outputs
// are stored in x's dtype.
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
// H*W and inner = N.  A thread owns a column (or V neighbouring ones) at
// one inner position and walks along C (stride inner), so neighbouring
// threads read neighbouring inner addresses (coalesced: neighbouring
// pixels in NCHW, neighbouring images in (H, W, C, N)).
//
// The forward takes one of two routes, picked by the caller from the
// shapes (ops/lrn.py fwd_plan) and checked here:
// - window (n with a compile-time instance, LRN_WINDOWS): the backward's
//   walk below with x alone: step t brings in x[t] and writes y[t - hi]
//   from the last n x values, held in shift registers; the loads of the
//   next lrn_fwd_ahead(V) steps are in flight, each x element is loaded and
//   each y element stored once (V columns a thread in 16-byte pieces
//   where the inner axis allows it), and C is cut into chunks with an
//   n - 1 halo where the columns are too few to fill the card;
// - recompute (other windows): a column a thread, each y summing its
//   window's n values of x again (from L1).
//
// The backward takes one of three routes, picked by the caller from the
// shapes (ops/lrn.py bwd_plan) and checked here:
// - window (n with a compile-time instance, LRN_WINDOWS): the walk is
//   a pipeline in registers.  Step t brings in x[t] and g[t - hi], sums
//   norm[a] (a = t - hi) over the last n x values, forms inner[a] and
//   g[a] norm[a]^-beta, and writes dx[t - n + 1] from the last n inner
//   values.  x, inner and g norm^-beta sit in shift registers (n, n and
//   lo + 1 a column) that the unrolled loop renames instead of moving,
//   and the loads of the next lrn_ahead(V) steps are in flight while a
//   step computes, so every x and g element is loaded once a walk.  A
//   thread owns V = 16 / sizeof(T) neighbouring columns in 16-byte
//   loads and stores where the inner axis allows it ((H, W, C, N): N a
//   multiple of V), else one (NCHW rows of odd length).  Where the
//   columns are too few to fill the card, C is cut into chunks walked
//   by threads of their own, each reading the n - 1 channels on either
//   side of its chunk again (from L2 in the common case): every value
//   is the same as in one walk.
// - ring (other windows): one thread a column keeps the last R = min(n,
//   C) values of inner and norm^-beta in its own column of a ring in
//   dynamic shared memory (no other thread reads it, so no barrier), and
//   computes inner[j] once, when channel j enters the window (reloading
//   that channel's n window values of x).  The block shrinks from 128
//   to 32 threads as R grows, so the ring fits for R up to LRN_MAX_RING
//   (908 channels);
// - recompute (past that): no ring; each inner[j] of the window is
//   recomputed (n + 1 times the forward's reads), so every window n >= 1
//   runs.
// All three sum every window from its lowest channel up, in float32,
// with no atomics: dx is the same bits on every run.
#include "common.cuh"

namespace {

constexpr int LRN_THREADS = 128;
// shared memory a block may use (H100: 227 KB)
constexpr int LRN_SMEM = 232448;
// widest ring (two floats a channel) a 32-thread block holds
constexpr int LRN_MAX_RING = LRN_SMEM / (2 * 4 * 32);
// the routes (ops/lrn.py BWD_ROUTES; the forward takes window and
// recompute)
enum LrnRoute { LRN_WINDOW = 0, LRN_RING = 1, LRN_RECOMPUTE = 2 };
// steps of loads a window-route thread keeps in flight (the forward's
// thread holds one shift register, the backward's three)
__host__ __device__ constexpr int lrn_ahead(int v) { return v == 1 ? 8 : 2; }
__host__ __device__ constexpr int lrn_fwd_ahead(int v) {
  return v == 1 ? 8 : 4;
}

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

// V values of T as raw bits: one T, or 16 bytes
template <typename T, int V>
struct LrnRaw {
  uint4 u;
};
template <typename T>
struct LrnRaw<T, 1> {
  T u;
};

// 2^v and log2(v), one MUFU instruction each (~2 ulp)
__device__ __forceinline__ float lrn_ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float lrn_lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// the V values at p (0 when !ok: the channel lies outside [0, C))
template <typename T, int V>
__device__ __forceinline__ void lrn_fetch(LrnRaw<T, V>& r,
                                          const T* __restrict__ p, bool ok) {
  if constexpr (V == 1)
    r.u = ok ? p[0] : cxn_from_f32<T>(0.f);
  else
    r.u = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

template <typename T, int V>
__device__ __forceinline__ void lrn_unpack(const LrnRaw<T, V>& r, float* f) {
  if constexpr (V == 1)
    f[0] = cxn_to_f32(r.u);
  else
    cxn_unpack16<T>(r.u, f);
}

// The forward's window route for a window of N channels: thread (chunk,
// group) owns columns [V group, V group + V) of the (outer, inner) plane
// and writes their y at channels [c0, c1) of its chunk; blocks ordered as
// in lrn_bwd_window_kernel.
template <typename T, int N, int V>
__global__ void __launch_bounds__(LRN_THREADS, V == 1 ? 8 : 4)
lrn_fwd_window_kernel(const T* __restrict__ x, T* __restrict__ y,
                      long long groups, int C, long long inner, int chunk,
                      int nchunks, float salpha, float beta, float knorm) {
  constexpr int LO = N / 2, HI = N - 1 - LO, P = lrn_fwd_ahead(V);
  const long long grp =
      (long long)(blockIdx.x / nchunks) * LRN_THREADS + threadIdx.x;
  if (grp >= groups) return;
  const int c0 = (int)(blockIdx.x % nchunks) * chunk;
  const int c1 = c0 + chunk < C ? c0 + chunk : C;
  const long long per = inner / V;
  const long long o = grp / per;
  const long long base = o * C * inner + (grp - o * per) * V;
  const T* xc = x + base;
  const float nb = -beta;  // norm^-beta = 2^(nb lg norm)
  // xr[j]: x at channel t - N + 1 + j after step t, which writes y[t - HI]
  float xr[N][V];
#pragma unroll
  for (int v = 0; v < V; ++v) xr[0][v] = 0.f;
  // channels c0 - LO .. c0 + HI - 1 before the first step (t = c0 + HI),
  // then P steps of loads ahead; the walk reads x at channels < xend
  const int xend = c1 + HI < C ? c1 + HI : C;
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const int ch = c0 - LO - 1 + j;
    const bool ok = ch >= 0 && ch < xend;
    LrnRaw<T, V> r;
    lrn_fetch<T, V>(r, xc + (long long)(ok ? ch : 0) * inner, ok);
    lrn_unpack<T, V>(r, xr[j]);
  }
  const int t0 = c0 + HI;
  LrnRaw<T, V> qx[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const bool ok = t0 + j < xend;
    lrn_fetch<T, V>(qx[j], xc + (long long)(ok ? t0 + j : 0) * inner, ok);
  }
  // x at channel t + P and y at t - HI (step t); a pointer off the tensor
  // is never read: the column's base stands in
  const T* xq = xc + (long long)(t0 + P) * inner;
  T* yq = y + base + (long long)c0 * inner;
#pragma unroll N
  for (int s = 0; s < c1 - c0; ++s) {
    const int t = t0 + s;
    float xn[V];
    lrn_unpack<T, V>(qx[0], xn);
#pragma unroll
    for (int j = 0; j + 1 < P; ++j) qx[j] = qx[j + 1];
    {
      const bool ok = t + P < xend;
      lrn_fetch<T, V>(qx[P - 1], ok ? xq : xc, ok);
      xq += inner;
    }
    float out[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int j = 0; j + 1 < N; ++j) xr[j][v] = xr[j + 1][v];
      xr[N - 1][v] = xn[v];
      // the window [a - LO, a + HI] (a = t - HI) = channels t - N + 1 .. t,
      // from the lowest up
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) sq += xr[j][v] * xr[j][v];
      out[v] = xr[LO][v] * lrn_ex2(nb * lrn_lg2(sq * salpha + knorm));
    }
    cxn_store<T, V>(yq, out);
    yq += inner;
  }
}

// The window route for a window of N channels: thread (chunk, group)
// owns columns [V group, V group + V) of the (outer, inner) plane and
// writes their dx at channels [c0, c1) of its chunk.  Blocks of one
// column range take consecutive block indices, chunks fastest, so the
// channels two chunks share are read again while they sit in L2.
template <typename T, int N, int V>
__global__ void __launch_bounds__(LRN_THREADS, V == 1 ? 8 : 3)
lrn_bwd_window_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      T* __restrict__ dx, long long groups, int C,
                      long long inner, int chunk, int nchunks,
                      float salpha, float beta, float knorm) {
  constexpr int LO = N / 2, HI = N - 1 - LO, P = lrn_ahead(V);
  const long long grp =
      (long long)(blockIdx.x / nchunks) * LRN_THREADS + threadIdx.x;
  if (grp >= groups) return;
  const int c0 = (int)(blockIdx.x % nchunks) * chunk;
  const int c1 = c0 + chunk < C ? c0 + chunk : C;
  const long long per = inner / V;
  const long long o = grp / per;
  const long long base = o * C * inner + (grp - o * per) * V;
  const T* xc = x + base;
  const T* gc = g + base;
  T* dc = dx + base;
  const float coef = 2.f * beta * salpha;
  // norm^-beta = 2^(nb lg norm), norm^-beta / norm = 2^(nb1 lg norm)
  const float nb = -beta, nb1 = -beta - 1.f;
  // xr[j]: x at channel t - N + 1 + j; in[j]: inner at a - N + 1 + j;
  // gp[j]: g norm^-beta at a - LO + j (a = t - HI, after step t)
  float xr[N][V], in[N][V], gp[LO + 1][V];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int v = 0; v < V; ++v) xr[j][v] = in[j][v] = 0.f;
  }
#pragma unroll
  for (int j = 0; j <= LO; ++j) {
#pragma unroll
    for (int v = 0; v < V; ++v) gp[j][v] = 0.f;
  }
  // the N - 1 channels below the chunk, then P steps of loads ahead
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const int ch = c0 - N + j;
    LrnRaw<T, V> r;
    lrn_fetch<T, V>(r, xc + (long long)(ch < 0 ? 0 : ch) * inner, ch >= 0);
    lrn_unpack<T, V>(r, xr[j]);
  }
  // the walk reads x at channels < xend and g at channels < gend
  const int xend = c1 + N - 1 < C ? c1 + N - 1 : C;
  const int gend = c1 + LO < C ? c1 + LO : C;
  LrnRaw<T, V> qx[P], qg[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int t = c0 + j, a = t - HI;
    const bool gok = a >= 0 && a < gend;
    lrn_fetch<T, V>(qx[j], xc + (long long)(t < xend ? t : 0) * inner,
                    t < xend);
    lrn_fetch<T, V>(qg[j], gc + (long long)(gok ? a : 0) * inner, gok);
  }
  // x at channel t + P, g at t + P - HI and dx at t - N + 1 (step t);
  // a pointer off the tensor is never read: the column's base stands in
  const T* xq = xc + (long long)(c0 + P) * inner;
  const T* gq = gc + (long long)(c0 + P - HI) * inner;
  T* dq = dc + (long long)(c0 - N + 1) * inner;
  const int steps = c1 - c0 + N - 1;
#pragma unroll N
  for (int s = 0; s < steps; ++s) {
    const int t = c0 + s, a = t - HI;
    float xn[V], gn[V];
    lrn_unpack<T, V>(qx[0], xn);
    lrn_unpack<T, V>(qg[0], gn);
#pragma unroll
    for (int j = 0; j + 1 < P; ++j) {
      qx[j] = qx[j + 1];
      qg[j] = qg[j + 1];
    }
    {
      const bool xok = t + P < xend;
      const bool gok = a + P >= 0 && a + P < gend;
      lrn_fetch<T, V>(qx[P - 1], xok ? xq : xc, xok);
      lrn_fetch<T, V>(qg[P - 1], gok ? gq : gc, gok);
      xq += inner;
      gq += inner;
    }
    const bool live = a >= 0 && a < C;
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int j = 0; j + 1 < N; ++j) {
        xr[j][v] = xr[j + 1][v];
        in[j][v] = in[j + 1][v];
      }
      xr[N - 1][v] = xn[v];
#pragma unroll
      for (int j = 0; j < LO; ++j) gp[j][v] = gp[j + 1][v];
      // norm[a]: the forward window [a - LO, a + HI] = channels t - N + 1
      // .. t, from the lowest up
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) sq += xr[j][v] * xr[j][v];
      const float l = lrn_lg2(sq * salpha + knorm);
      in[N - 1][v] = live ? gn[v] * xr[LO][v] * lrn_ex2(nb1 * l) : 0.f;
      gp[LO][v] = gn[v] * lrn_ex2(nb * l);
    }
    if (s >= N - 1) {
      // dx[c], c = a - LO: the transposed window [c - HI, c + LO] is
      // inner at a - N + 1 .. a, summed from the lowest up
      float d[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = in[0][v];
#pragma unroll
        for (int j = 1; j < N; ++j) acc += in[j][v];
        d[v] = gp[0][v] - coef * xr[0][v] * acc;
      }
      cxn_store<T, V>(dq, d);
    }
    dq += inner;
  }
}

// window sizes with a window-route instance (ops/lrn.py WINDOW_SIZES)
#define LRN_WINDOWS(X) X(3) X(4) X(5) X(7)

// threads of a backward block whose ring of R channels fits, largest
// first; 0 when not even a 32-thread block's ring fits
int lrn_bwd_threads(int R) {
  for (int nt = LRN_THREADS; nt >= 32; nt /= 2)
    if ((size_t)2 * 4 * R * nt <= (size_t)LRN_SMEM) return nt;
  return 0;
}

// the window route at window N, V columns a thread: the forward (g
// null) or the backward
template <typename T, int N, int V>
cudaError_t lrn_window_launch(const T* x, const T* g, T* out,
                              long long outer, int C, long long inner,
                              int chunk, float salpha, float beta,
                              float knorm, cudaStream_t st) {
  const long long groups = outer * (inner / V);
  const int nchunks = (C + chunk - 1) / chunk;
  const long long blocks =
      (groups + LRN_THREADS - 1) / LRN_THREADS * nchunks;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (g == nullptr)
    lrn_fwd_window_kernel<T, N, V><<<(unsigned)blocks, LRN_THREADS, 0, st>>>(
        x, out, groups, C, inner, chunk, nchunks, salpha, beta, knorm);
  else
    lrn_bwd_window_kernel<T, N, V><<<(unsigned)blocks, LRN_THREADS, 0, st>>>(
        x, g, out, groups, C, inner, chunk, nchunks, salpha, beta, knorm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t lrn_launch(int backward, const void* x, const void* g, void* out,
                       long long outer, int C, long long inner, int nsize,
                       float salpha, float beta, float knorm, int route,
                       int vec, int chunk, cudaStream_t st) {
  const long long cols = outer * inner;
  const int lo = nsize / 2, hi = nsize - 1 - lo;
  const T* xt = static_cast<const T*>(x);
  const T* gt = backward ? static_cast<const T*>(g) : nullptr;
  T* ot = static_cast<T*>(out);
  if (route == LRN_WINDOW) {
    constexpr int W = 16 / sizeof(T);
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(gt) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (chunk < 1 || !(vec == 1 || (vec == W && aligned && inner % W == 0)))
      return cudaErrorInvalidValue;
#define LRN_WINDOW_CASE(n)                                                 \
    if (nsize == n)                                                        \
      return vec == 1 ? lrn_window_launch<T, n, 1>(xt, gt, ot, outer, C,   \
                                                   inner, chunk, salpha,   \
                                                   beta, knorm, st)        \
                      : lrn_window_launch<T, n, W>(xt, gt, ot, outer, C,   \
                                                   inner, chunk, salpha,   \
                                                   beta, knorm, st);
    LRN_WINDOWS(LRN_WINDOW_CASE)
#undef LRN_WINDOW_CASE
    return cudaErrorInvalidValue;
  }
  if (!backward) {
    if (route != LRN_RECOMPUTE) return cudaErrorInvalidValue;
    const long long blocks = (cols + LRN_THREADS - 1) / LRN_THREADS;
    lrn_fwd_kernel<T><<<(unsigned)blocks, LRN_THREADS, 0, st>>>(
        xt, ot, cols, C, inner, lo, hi, salpha, beta, knorm);
    return cudaGetLastError();
  }
  const int R = nsize < C ? nsize : C;
  int nt = lrn_bwd_threads(R);
  if (route != (nt > 0 ? LRN_RING : LRN_RECOMPUTE))
    return cudaErrorInvalidValue;
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
  kern<<<(unsigned)blocks, nt, smem, st>>>(xt, gt, ot, cols, C, inner, lo,
                                          hi, salpha, beta, knorm, R);
  return cudaGetLastError();
}

}  // namespace

// x (and g, the output gradient, for the backward): contiguous (outer, C,
// inner) in `dtype`, the window along C: logical NCHW as (N, C, H*W), its
// (H, W, C, N) transpose as (H*W, C, N); out: y (forward) or dx
// (backward), the same shape and dtype.  salpha = alpha / nsize; any
// nsize >= 1.  Each direction runs `route` (LrnRoute, from ops/lrn.py
// fwd_plan / bwd_plan): the window route (windows in LRN_WINDOWS) with
// `vec` columns a thread (1, or 16 / sizeof(T) with x, out and g
// 16-byte aligned and inner a multiple of it) over chunks of `chunk`
// channels; else the forward's recompute route, or the backward's ring
// route where a ring of min(nsize, C) channels fits a block and its
// recompute route where it does not.  A plan it cannot run is refused
// (cudaErrorInvalidValue), never rerouted.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int cxn_lrn(int backward, const void* x, const void* g, void* out,
                       long long outer, int C, long long inner, int nsize,
                       float salpha, float beta, float knorm, int route,
                       int vec, int chunk, int dtype, void* stream) {
  if (outer < 1 || C < 1 || inner < 1 || nsize < 1 ||
      (outer * inner + 31) / 32 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == CXN_F32)
    return (int)lrn_launch<float>(backward, x, g, out, outer, C, inner,
                                  nsize, salpha, beta, knorm, route, vec,
                                  chunk, st);
  if (dtype == CXN_BF16)
    return (int)lrn_launch<__nv_bfloat16>(backward, x, g, out, outer, C,
                                          inner, nsize, salpha, beta, knorm,
                                          route, vec, chunk, st);
  return (int)cudaErrorInvalidValue;
}
