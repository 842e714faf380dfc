// Flash-attention backward for Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `_fa_bwd` (the dq and dk/dv
// `pallas_call`s over `_fa_dq_kernel*` / `_fa_dkv_kernel*`, triangular
// and dense) and, with segment ids, `_fa_seg_bwd` (`*_tri_seg`).  The
// per-block math of all of them is `_fa_p_ds`:
//   s  = q k^T * scale, masked with NEG_INF (causal, then segments)
//   p  = exp(s - lse)                  (lse saved by the forward)
//   ds = p * (dO v^T - delta) * scale  (delta = rowsum(dO * o), float32)
//   dv = p^T dO,  dk = ds^T q,  dq = ds k
// with p cast to the input dtype before the dv product and ds before the
// dk and dq products, float32 sums, outputs in the input dtype.  The seg
// input gets no gradient.
//
// What bounds it on the card: operations.  At the training shape (64
// heads, s 4096, d 128, causal, bf16) the two passes do ~5 products of
// (s x s x d) over the live triangle, ~690 GFLOP on ~270 MB of input and
// output, far above an H100's ~295 FLOP/byte: the least time is those
// products over the tensor cores' 989 TFLOP/s.
//
// Design.  As in the JAX package, two kernels, so that no block writes
// another block's output: no atomics, and repeated runs are bitwise
// equal.
//   * dq: one block per (b*h, 64-row q-tile), looping over the k-tiles
//     up to the diagonal (the TPU's `_fa_dq_kernel_tri`, the sequential
//     grid axis turned into a loop); heaviest rows first.
//   * dk/dv: one block per (b*h, 64-row k-tile), looping over the
//     q-tiles from the diagonal on (the TPU's `_fa_dkv_kernel_tri`, whose
//     first q block is `ifirst = (j * bk) // bq`; with equal 64-row tiles
//     that is the k-tile's own index).  It works on the transposed score
//     tile s^T = k q^T, so p^T and ds^T come out of the accumulators
//     already in the A-operand layout of the dv and dk products.
//   * delta: a small pre-kernel, one warp per row.
// bf16 runs on the tensor cores (mma.sync m16n8k16, the register layout
// of flash_attn_fwd.cu): scores, p and ds never leave registers; dk and
// dv accumulators (2 x 16 x d float32 a warp) are the register budget,
// which is why the dk/dv kernel walks each q-tile in two halves of 32
// columns.  float32 runs on the CUDA cores (4 x 4 register tiles, p and
// ds staged in shared memory).  Head widths up to 128 (d a multiple of
// 8), instantiated at 32, 64 and 128 columns with zero padding.  Not
// pipelined (no cp.async / TMA, no wgmma): PERF.md has the times.  The
// kernels allocate nothing (the caller passes the delta buffer), do not
// synchronise, and launch on the caller's stream.

#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "flash_common.cuh"

namespace {

constexpr int FB_ROWS = 64;       // q or k rows per block (both kernels)
constexpr int FB_THREADS = 256;   // float32 kernels: 8 warps
constexpr int FB_SP = FB_ROWS + 1;
constexpr int FB_QH = 32;         // bf16 dk/dv: q columns per half-tile

// delta[row] = sum_c dout[row, c] * o[row, c] in float32, a warp a row
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta,
                                       long long rows, int d) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * d;
  const T* grow = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32)
    s = fmaf(cxn_to_f32(grow[c]), cxn_to_f32(orow[c]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// ------------------------------------------------------------ float32
// rows row0.. of a (s_len, d) matrix into a (64, d + 1) float tile
template <typename T>
__device__ __forceinline__ void fb_load_rows(float* dst, const T* src,
                                             int row0, int s_len, int d) {
  const int dp = d + 1;
  for (int idx = threadIdx.x; idx < FB_ROWS * d; idx += FB_THREADS) {
    const int r = idx / d, c = idx - r * d;
    const int gr = row0 + r;
    dst[r * dp + c] = gr < s_len ? cxn_to_f32(src[(size_t)gr * d + c]) : 0.f;
  }
}

__device__ __forceinline__ void fb_load_stats(float* sl, float* sd,
                                              const float* lse,
                                              const float* delta, int row0,
                                              int s_len) {
  for (int r = threadIdx.x; r < FB_ROWS; r += blockDim.x) {
    const bool ok = row0 + r < s_len;
    sl[r] = ok ? lse[row0 + r] : 0.f;
    sd[r] = ok ? delta[row0 + r] : 0.f;
  }
}

size_t fb_smem_dq(int d) {
  return sizeof(float) * (4 * (size_t)FB_ROWS * (d + 1) + FB_ROWS * FB_SP);
}
size_t fb_smem_dkv(int d) {
  return sizeof(float) * (4 * (size_t)FB_ROWS * (d + 1) +
                          2 * FB_ROWS * FB_SP);
}

// dq: this block's 64 q rows against every live k-tile.  Each thread
// computes a 4 x 4 tile of s and dO v^T, the block stages ds in shared
// memory, and each warp accumulates 8 rows of ds k (DCH columns a lane).
template <typename T, int DCH, bool SEG>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg, T* __restrict__ dq,
                    int s_len, int d, int h, int causal, float scale) {
  extern __shared__ float smem[];
  __shared__ float sL[FB_ROWS], sD[FB_ROWS];
  __shared__ int sSegK[FB_ROWS];
  const int dp = d + 1;
  float* sQ = smem;
  float* sG = sQ + FB_ROWS * dp;   // dO
  float* sK = sG + FB_ROWS * dp;
  float* sV = sK + FB_ROWS * dp;
  float* sS = sV + FB_ROWS * dp;   // ds, [q row][k col]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FB_ROWS;  // heaviest first
  const size_t base = (size_t)blockIdx.y * s_len * d;
  const size_t rbase = (size_t)blockIdx.y * s_len;
  const int* segb = SEG ? seg + (size_t)(blockIdx.y / h) * s_len : nullptr;
  fb_load_rows(sQ, q + base, q0, s_len, d);
  fb_load_rows(sG, dout + base, q0, s_len, d);
  fb_load_stats(sL, sD, lse + rbase, delta + rbase, q0, s_len);
  const int sr0 = (tid >> 4) * 4, sc0 = tid & 15;
  int segq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    segq[i] = SEG && q0 + sr0 + i < s_len ? segb[q0 + sr0 + i] : 0;
  float acc[8][DCH];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[i][c] = 0.f;

  const int q_last = min(q0 + FB_ROWS, s_len) - 1;
  const int n_kt =
      causal ? q_last / FB_ROWS + 1 : (s_len + FB_ROWS - 1) / FB_ROWS;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * FB_ROWS;
    __syncthreads();  // the previous tile's sK / sS reads are done
    fb_load_rows(sK, k + base, k0, s_len, d);
    fb_load_rows(sV, v + base, k0, s_len, d);
    if (SEG) fa_load_seg(sSegK, segb, k0, s_len);
    __syncthreads();
    float sc[4][4], gp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = gp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float qa[4], ga[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = sQ[(sr0 + i) * dp + c];
        ga[i] = sG[(sr0 + i) * dp + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = sK[(sc0 + 16 * j) * dp + c];
        va[j] = sV[(sc0 + 16 * j) * dp + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
          gp[i][j] = fmaf(ga[i], va[j], gp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = sr0 + i, cc = sc0 + 16 * j;
        const bool ok = fa_allowed<SEG>(q0 + r, k0 + cc, s_len, causal,
                                        segq[i], SEG ? sSegK[cc] : 0);
        const float p = expf((ok ? sc[i][j] * scale : FA_NEG_INF) - sL[r]);
        sS[r * FB_SP + cc] = cxn_round_to<T>(p * (gp[i][j] - sD[r]) * scale);
      }
    __syncthreads();
    for (int j = 0; j < FB_ROWS; ++j) {
      float kv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int col = lane + 32 * c;
        kv[c] = col < d ? sK[j * dp + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ds = sS[(warp * 8 + i) * FB_SP + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gq = q0 + warp * 8 + i;
    if (gq >= s_len) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) dq[base + (size_t)gq * d + col] = cxn_from_f32<T>(acc[i][c]);
    }
  }
}

// dk / dv: this block's 64 k rows against every live q-tile, on the
// transposed tile (k row, q column).
template <typename T, int DCH, bool SEG>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg, T* __restrict__ dk,
                     T* __restrict__ dv, int s_len, int d, int h, int causal,
                     float scale) {
  extern __shared__ float smem[];
  __shared__ float sL[FB_ROWS], sD[FB_ROWS];
  __shared__ int sSegQ[FB_ROWS];
  const int dp = d + 1;
  float* sK = smem;
  float* sV = sK + FB_ROWS * dp;
  float* sQ = sV + FB_ROWS * dp;
  float* sG = sQ + FB_ROWS * dp;   // dO
  float* sP = sG + FB_ROWS * dp;   // p^T, [k row][q col]
  float* sS = sP + FB_ROWS * FB_SP;  // ds^T
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * FB_ROWS;  // the longest causal columns first
  const size_t base = (size_t)blockIdx.y * s_len * d;
  const size_t rbase = (size_t)blockIdx.y * s_len;
  const int* segb = SEG ? seg + (size_t)(blockIdx.y / h) * s_len : nullptr;
  fb_load_rows(sK, k + base, k0, s_len, d);
  fb_load_rows(sV, v + base, k0, s_len, d);
  const int sr0 = (tid >> 4) * 4, sc0 = tid & 15;
  int segk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    segk[i] = SEG && k0 + sr0 + i < s_len ? segb[k0 + sr0 + i] : 0;
  float ak[8][DCH], av[8][DCH];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DCH; ++c) ak[i][c] = av[i][c] = 0.f;

  const int n_qt = (s_len + FB_ROWS - 1) / FB_ROWS;
  for (int qt = causal ? k0 / FB_ROWS : 0; qt < n_qt; ++qt) {
    const int q0 = qt * FB_ROWS;
    __syncthreads();  // the previous tile's sQ / sG / sP / sS reads are done
    fb_load_rows(sQ, q + base, q0, s_len, d);
    fb_load_rows(sG, dout + base, q0, s_len, d);
    fb_load_stats(sL, sD, lse + rbase, delta + rbase, q0, s_len);
    if (SEG) fa_load_seg(sSegQ, segb, q0, s_len);
    __syncthreads();
    float sc[4][4], gp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = gp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float ka[4], va[4], qa[4], ga[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = sK[(sr0 + i) * dp + c];
        va[i] = sV[(sr0 + i) * dp + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qa[j] = sQ[(sc0 + 16 * j) * dp + c];
        ga[j] = sG[(sc0 + 16 * j) * dp + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(ka[i], qa[j], sc[i][j]);
          gp[i][j] = fmaf(va[i], ga[j], gp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = sr0 + i, cc = sc0 + 16 * j;
        const bool ok = fa_allowed<SEG>(q0 + cc, k0 + r, s_len, causal,
                                        SEG ? sSegQ[cc] : 0, segk[i]);
        const float p = expf((ok ? sc[i][j] * scale : FA_NEG_INF) - sL[cc]);
        sP[r * FB_SP + cc] = cxn_round_to<T>(p);
        sS[r * FB_SP + cc] = cxn_round_to<T>(p * (gp[i][j] - sD[cc]) * scale);
      }
    __syncthreads();
    for (int j = 0; j < FB_ROWS; ++j) {
      float gv[DCH], qv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int col = lane + 32 * c;
        gv[c] = col < d ? sG[j * dp + col] : 0.f;
        qv[c] = col < d ? sQ[j * dp + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = sP[(warp * 8 + i) * FB_SP + j];
        const float ds = sS[(warp * 8 + i) * FB_SP + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          av[i][c] = fmaf(p, gv[c], av[i][c]);
          ak[i][c] = fmaf(ds, qv[c], ak[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gk = k0 + warp * 8 + i;
    if (gk >= s_len) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        dk[base + (size_t)gk * d + col] = cxn_from_f32<T>(ak[i][c]);
        dv[base + (size_t)gk * d + col] = cxn_from_f32<T>(av[i][c]);
      }
    }
  }
}

// --------------------------------------------------------------- bf16
// dq on the tensor cores: 4 warps x 16 q rows; per k-tile each warp
// forms s and dO v^T (16 x 64) in registers, turns them into ds and
// adds ds k to its (16 x D) accumulator.
template <int D, bool SEG>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg,
                        __nv_bfloat16* __restrict__ dq, int s_len, int d,
                        int h, int causal, float scale) {
  constexpr int LD = D + 8, NK = D / 16, NO = D / 8, NS = TC_BK / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int sSegK[TC_BK];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sG = sQ + TC_BQ * LD;  // dO
  __nv_bfloat16* sK = sG + TC_BQ * LD;
  __nv_bfloat16* sV = sK + TC_BK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;  // heaviest first
  const size_t base = (size_t)blockIdx.y * s_len * d;
  const size_t rbase = (size_t)blockIdx.y * s_len;
  const int* segb = SEG ? seg + (size_t)(blockIdx.y / h) * s_len : nullptr;
  tc_load_tile<D>(sQ, q + base, q0, s_len, d);
  tc_load_tile<D>(sG, dout + base, q0, s_len, d);
  const int r0 = warp * 16 + g;
  const int gq0 = q0 + r0, gq1 = gq0 + 8;
  const float lse0 = gq0 < s_len ? lse[rbase + gq0] : 0.f;
  const float lse1 = gq1 < s_len ? lse[rbase + gq1] : 0.f;
  const float dl0 = gq0 < s_len ? delta[rbase + gq0] : 0.f;
  const float dl1 = gq1 < s_len ? delta[rbase + gq1] : 0.f;
  const int sq0 = SEG && gq0 < s_len ? segb[gq0] : 0;
  const int sq1 = SEG && gq1 < s_len ? segb[gq1] : 0;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int q_last = min(q0 + TC_BQ, s_len) - 1;
  const int n_kt = causal ? q_last / TC_BK + 1 : (s_len + TC_BK - 1) / TC_BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TC_BK;
    __syncthreads();  // the previous tile's sK / sV reads are done
    tc_load_tile<D>(sK, k + base, k0, s_len, d);
    tc_load_tile<D>(sV, v + base, k0, s_len, d);
    if (SEG) fa_load_seg(sSegK, segb, k0, s_len);
    __syncthreads();
    float s[NS][4], gp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = gp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t aq[4], ag[4];
      tc_frag_a<LD>(aq, sQ, r0, kk, t);
      tc_frag_a<LD>(ag, sG, r0, kk, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b[2];
        tc_frag_bt<LD>(b, sK, n, kk, g, t);
        mma_16816(s[n], aq, b);
        tc_frag_bt<LD>(b, sV, n, kk, g, t);
        mma_16816(gp[n], ag, b);
      }
    }
    // ds in place of s (rows r0: elements 0,1; r0 + 8: 2,3)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n * 8 + 2 * t + (e & 1);
        const bool hi = e >= 2;
        const bool ok = fa_allowed<SEG>(hi ? gq1 : gq0, k0 + kc, s_len,
                                        causal, hi ? sq1 : sq0,
                                        SEG ? sSegK[kc] : 0);
        const float p =
            expf((ok ? s[n][e] * scale : FA_NEG_INF) - (hi ? lse1 : lse0));
        s[n][e] = p * (gp[n][e] - (hi ? dl1 : dl0)) * scale;
      }
    // dq += ds k, ds (bf16) straight from the registers
#pragma unroll
    for (int j = 0; j < TC_BK / 16; ++j) {
      uint32_t a[4];
      tc_frag_acc(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b[2];
        tc_frag_b<LD>(b, sK, j, n, g, t);
        mma_16816(acc[n], a, b);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (n * 8 >= d) break;  // zero padding columns
    if (gq0 < s_len)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)gq0 * d + col) =
          pack_f32(acc[n][0], acc[n][1]);
    if (gq1 < s_len)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)gq1 * d + col) =
          pack_f32(acc[n][2], acc[n][3]);
  }
}

// dk / dv on the tensor cores: 4 warps x 16 k rows; per q-tile (in two
// halves of 32 columns) each warp forms s^T = k q^T and v dO^T in
// registers, turns them into p^T and ds^T, and adds p^T dO and ds^T q
// to its two (16 x D) accumulators.
template <int D, bool SEG>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int s_len, int d,
                         int h, int causal, float scale) {
  constexpr int LD = D + 8, NK = D / 16, NO = D / 8, NH = FB_QH / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ float sL[TC_BQ], sD[TC_BQ];
  __shared__ int sSegQ[TC_BQ];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sV = sK + TC_BK * LD;
  __nv_bfloat16* sQ = sV + TC_BK * LD;
  __nv_bfloat16* sG = sQ + TC_BQ * LD;  // dO
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * TC_BK;  // the longest causal columns first
  const size_t base = (size_t)blockIdx.y * s_len * d;
  const size_t rbase = (size_t)blockIdx.y * s_len;
  const int* segb = SEG ? seg + (size_t)(blockIdx.y / h) * s_len : nullptr;
  tc_load_tile<D>(sK, k + base, k0, s_len, d);
  tc_load_tile<D>(sV, v + base, k0, s_len, d);
  const int r0 = warp * 16 + g;
  const int gk0 = k0 + r0, gk1 = gk0 + 8;
  const int sk0 = SEG && gk0 < s_len ? segb[gk0] : 0;
  const int sk1 = SEG && gk1 < s_len ? segb[gk1] : 0;
  float ak[NO][4], av[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  const int n_qt = (s_len + TC_BQ - 1) / TC_BQ;
  for (int qt = causal ? k0 / TC_BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * TC_BQ;
    __syncthreads();  // the previous tile's sQ / sG reads are done
    tc_load_tile<D>(sQ, q + base, q0, s_len, d);
    tc_load_tile<D>(sG, dout + base, q0, s_len, d);
    for (int r = threadIdx.x; r < TC_BQ; r += TC_THREADS) {
      const bool ok = q0 + r < s_len;
      sL[r] = ok ? lse[rbase + q0 + r] : 0.f;
      sD[r] = ok ? delta[rbase + q0 + r] : 0.f;
    }
    if (SEG) fa_load_seg(sSegQ, segb, q0, s_len);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < TC_BQ / FB_QH; ++half) {
      const int c0 = half * FB_QH;  // first q column of this half
      float st[NH][4], gt[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = gt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t ka[4], va[4];
        tc_frag_a<LD>(ka, sK, r0, kk, t);
        tc_frag_a<LD>(va, sV, r0, kk, t);
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          uint32_t b[2];
          tc_frag_bt<LD>(b, sQ + c0 * LD, n, kk, g, t);
          mma_16816(st[n], ka, b);
          tc_frag_bt<LD>(b, sG + c0 * LD, n, kk, g, t);
          mma_16816(gt[n], va, b);
        }
      }
      // p^T in place of s^T, ds^T in place of (v dO^T)
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + n * 8 + 2 * t + (e & 1);
          const bool hi = e >= 2;
          const bool ok = fa_allowed<SEG>(q0 + qc, hi ? gk1 : gk0, s_len,
                                          causal, SEG ? sSegQ[qc] : 0,
                                          hi ? sk1 : sk0);
          const float p =
              expf((ok ? st[n][e] * scale : FA_NEG_INF) - sL[qc]);
          st[n][e] = p;
          gt[n][e] = p * (gt[n][e] - sD[qc]) * scale;
        }
      // dv += p^T dO, dk += ds^T q over this half's 32 q rows
#pragma unroll
      for (int j = 0; j < FB_QH / 16; ++j) {
        uint32_t ap[4], as[4];
        tc_frag_acc(ap, st[2 * j], st[2 * j + 1]);
        tc_frag_acc(as, gt[2 * j], gt[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b[2];
          tc_frag_b<LD>(b, sG + c0 * LD, j, n, g, t);
          mma_16816(av[n], ap, b);
          tc_frag_b<LD>(b, sQ + c0 * LD, j, n, g, t);
          mma_16816(ak[n], as, b);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (n * 8 >= d) break;  // zero padding columns
    if (gk0 < s_len) {
      const size_t off = base + (size_t)gk0 * d + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_f32(ak[n][0], ak[n][1]);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_f32(av[n][0], av[n][1]);
    }
    if (gk1 < s_len) {
      const size_t off = base + (size_t)gk1 * d + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_f32(ak[n][2], ak[n][3]);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_f32(av[n][2], av[n][3]);
    }
  }
}

// ------------------------------------------------------------- launch
struct BwdArgs {
  const void *q, *k, *v;
  const int* seg;
  const void *o, *lse, *dout;
  void *delta, *dq, *dk, *dv;
  int bh, h, s, d, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t fb_launch_delta(const BwdArgs& a) {
  const long long rows = (long long)a.bh * a.s;
  const int warps = 8;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps),
                              32 * warps, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), rows, a.d);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t fb_launch_mma(const BwdArgs& a) {
  using bf = __nv_bfloat16;
  const size_t smem = sizeof(bf) * 4 * TC_BQ * (D + 8);
  const dim3 grid((a.s + TC_BQ - 1) / TC_BQ, a.bh);
  auto kdq = flash_bwd_dq_mma_kernel<D, SEG>;
  auto kdkv = flash_bwd_dkv_mma_kernel<D, SEG>;
  cudaError_t err = cxn_allow_smem(kdq, smem);
  if (err == cudaSuccess) err = cxn_allow_smem(kdkv, smem);
  if (err != cudaSuccess) return err;
  kdq<<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.seg, static_cast<bf*>(a.dq), a.s, a.d, a.h, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.seg, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.s, a.d, a.h,
      a.causal, a.scale);
  return cudaGetLastError();
}

template <int DCH, bool SEG>
cudaError_t fb_launch_f32(const BwdArgs& a) {
  const dim3 grid((a.s + FB_ROWS - 1) / FB_ROWS, a.bh);
  auto kdq = flash_bwd_dq_kernel<float, DCH, SEG>;
  auto kdkv = flash_bwd_dkv_kernel<float, DCH, SEG>;
  const size_t smem_dq = fb_smem_dq(a.d), smem_dkv = fb_smem_dkv(a.d);
  cudaError_t err = cxn_allow_smem(kdq, smem_dq);
  if (err == cudaSuccess) err = cxn_allow_smem(kdkv, smem_dkv);
  if (err != cudaSuccess) return err;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  kdq<<<grid, FB_THREADS, smem_dq, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse,
      delta, a.seg, static_cast<float*>(a.dq), a.s, a.d, a.h, a.causal,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<grid, FB_THREADS, smem_dkv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse,
      delta, a.seg, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.s, a.d, a.h, a.causal, a.scale);
  return cudaGetLastError();
}

template <bool SEG>
cudaError_t fb_dispatch(const BwdArgs& a, int dtype) {
  if (dtype == CXN_BF16) {
    if (a.d <= 32) return fb_launch_mma<32, SEG>(a);
    if (a.d <= 64) return fb_launch_mma<64, SEG>(a);
    return fb_launch_mma<128, SEG>(a);
  }
  if (a.d <= 32) return fb_launch_f32<1, SEG>(a);
  if (a.d <= 64) return fb_launch_f32<2, SEG>(a);
  return fb_launch_f32<4, SEG>(a);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, s, d) contiguous in `dtype`; lse:
// (bh, s) float32 from the forward; delta: (bh, s) float32 scratch the
// call fills; seg: NULL, or (bh / h, s) int32 segment ids.  Launches the
// delta, dq and dk/dv kernels; returns cudaGetLastError() after the last
// launch, or the first failing one's (0 = all launched).
extern "C" int cxn_flash_attn_bwd(const void* q, const void* k,
                                  const void* v, const void* seg,
                                  const void* o, const void* lse,
                                  const void* dout, void* delta, void* dq,
                                  void* dk, void* dv, int bh, int h, int s,
                                  int d, int causal, float scale, int dtype,
                                  void* stream) {
  if (bh < 1 || bh > 65535 || h < 1 || bh % h != 0 || s < 1 || d < 8 ||
      d > 128 || d % 8 != 0 || (dtype != CXN_BF16 && dtype != CXN_F32))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,  k,  v,  static_cast<const int*>(seg), o, lse, dout,
                  delta, dq, dk, dv, bh, h, s, d, causal, scale,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == CXN_BF16) {
    for (const void* p : {q, k, v, dout, (const void*)dq, (const void*)dk,
                          (const void*)dv})
      if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  }
  cudaError_t err = dtype == CXN_BF16 ? fb_launch_delta<__nv_bfloat16>(a)
                                      : fb_launch_delta<float>(a);
  if (err != cudaSuccess) return (int)err;
  return (int)(seg ? fb_dispatch<true>(a, dtype) : fb_dispatch<false>(a, dtype));
}
