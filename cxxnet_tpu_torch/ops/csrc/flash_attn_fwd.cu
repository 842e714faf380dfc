// Flash-attention forward for Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `_fa_fwd` (the triangular
// causal `pallas_call` with `_fa_fwd_kernel_tri`, and the dense one),
// whose per-block math is `_fa_fwd_step`.  Same function: for each of
// the b*h rows of q/k/v (b*h, s, d), o = softmax(q k^T * scale, masked)
// v and lse = m + log(l), with
//   * scores in float32 (bf16 inputs are exact in float32), times scale;
//   * the causal mask writing NEG_INF = -1e30 (not -inf);
//   * p cast to v's dtype before the p.V product, sums in float32;
//   * o stored in q's dtype, lse (b*h, s) in float32.
// Any s (the ragged last tile is masked) and any d that is a multiple
// of 8 up to 256.
//
// What bounds it on the card: operations.  At the served shape (16
// heads, s 4096, d 128, causal, bf16) it does ~69 GFLOP on 67 MB of
// input and output, far above the ~295 FLOP/byte at which an H100 stops
// being memory-bound, so the least time is the products over the
// tensor cores' 989 TFLOP/s.
//
// Design: the TPU grid walks (q-block, k-block) pairs in order and
// carries (acc, m, l) in VMEM scratch between grid steps.  Here one
// thread block owns one (b*h, 64-row q-tile) and loops over the k-tiles
// itself, stopping at the diagonal under the causal mask (the dead
// blocks the TPU removes from its grid with `_fa_tri_pairs` are never
// visited).  Blocks are issued heaviest-first so the long causal rows do
// not trail the grid.  Each k/v tile is read from device memory once
// into shared memory and used by all 64 query rows.  One kernel per
// dtype:
//   * bf16 (the served dtype): tensor cores through mma.sync m16n8k16
//     with scores, running max / sum and the output accumulator in
//     registers (see the section comment below), for every head width;
//   * float32: products on the CUDA cores in float32, each warp owning
//     8 query rows with their (8 x d) accumulator in registers.
// Neither is pipelined yet (no cp.async / TMA double buffering, no
// wgmma): PERF.md has their times against the bound.  The kernels
// allocate nothing, do not synchronise, and launch on the caller's
// stream.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int FA_BQ = 64;              // query rows per block
constexpr int FA_BK = 64;              // key rows per tile
constexpr int FA_THREADS = 256;        // 8 warps
constexpr int FA_ROWS_PER_WARP = FA_BQ / (FA_THREADS / 32);
constexpr int FA_SP = FA_BK + 1;       // padded score-row stride
constexpr float FA_NEG_INF = -1e30f;

size_t fa_smem_bytes(int d) {
  const size_t dp = (size_t)d + 1;
  return sizeof(float) * (FA_BQ * dp + FA_BK * dp + (size_t)FA_BK * d +
                          FA_BQ * FA_SP + 3 * FA_BQ);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// DCH = ceil(d / 32): output columns per lane (lane + 32 * c)
template <typename T, int DCH>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s_len, int d, int causal,
                 float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* sQ = smem;                      // FA_BQ x dp
  float* sK = sQ + FA_BQ * dp;           // FA_BK x dp
  float* sV = sK + FA_BK * dp;           // FA_BK x d
  float* sP = sV + FA_BK * d;            // FA_BQ x FA_SP scores, then p
  float* sM = sP + FA_BQ * FA_SP;        // running row max
  float* sL = sM + FA_BQ;                // running row sum
  float* sC = sL + FA_BQ;                // this tile's row rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;  // heaviest first
  const size_t base = (size_t)blockIdx.y * s_len * d;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int idx = tid; idx < FA_BQ * d; idx += FA_THREADS) {
    const int r = idx / d, c = idx - r * d;
    const int gr = q0 + r;
    sQ[r * dp + c] = gr < s_len ? cxn_to_f32(qb[(size_t)gr * d + c]) : 0.f;
  }
  if (tid < FA_BQ) {
    sM[tid] = FA_NEG_INF;
    sL[tid] = 0.f;
    sC[tid] = 1.f;
  }

  float acc[FA_ROWS_PER_WARP][DCH];
#pragma unroll
  for (int i = 0; i < FA_ROWS_PER_WARP; ++i)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[i][c] = 0.f;

  const int q_last = min(q0 + FA_BQ, s_len) - 1;
  const int n_kt = causal ? q_last / FA_BK + 1 : (s_len + FA_BK - 1) / FA_BK;
  const int sr0 = (tid >> 4) * 4;  // this thread's score rows sr0..sr0+3
  const int sc0 = tid & 15;        // and columns sc0 + 16 * j

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int idx = tid; idx < FA_BK * d; idx += FA_THREADS) {
      const int r = idx / d, c = idx - r * d;
      const int gr = k0 + r;
      const bool ok = gr < s_len;
      sK[r * dp + c] = ok ? cxn_to_f32(kb[(size_t)gr * d + c]) : 0.f;
      sV[r * d + c] = ok ? cxn_to_f32(vb[(size_t)gr * d + c]) : 0.f;
    }
    __syncthreads();

    // scores: a 4 x 4 register tile per thread
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(sr0 + i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sK[(sc0 + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = sr0 + i, cc = sc0 + 16 * j;
        const int gq = q0 + r, gk = k0 + cc;
        const bool ok = gk < s_len && (!causal || gk <= gq);
        sP[r * FA_SP + cc] = ok ? sc[i][j] * scale : FA_NEG_INF;
      }
    __syncthreads();

    // online softmax over this tile, one warp per 8 rows
#pragma unroll
    for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
      const int r = warp * FA_ROWS_PER_WARP + i;
      float* row = sP + r * FA_SP;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float psum = warp_sum(p0 + p1);
      row[lane] = cxn_round_to<T>(p0);  // p in v's dtype for p.V
      row[lane + 32] = cxn_round_to<T>(p1);
      __syncwarp();  // every lane has read sM[r]
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + psum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncwarp();

    // acc = acc * corr + p.V for this warp's rows
#pragma unroll
    for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
      const float corr = sC[warp * FA_ROWS_PER_WARP + i];
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[i][c] *= corr;
    }
    for (int j = 0; j < FA_BK; ++j) {
      float vv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < d ? sV[j * d + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
        const float p = sP[(warp * FA_ROWS_PER_WARP + i) * FA_SP + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
  __syncwarp();

#pragma unroll
  for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
    const int r = warp * FA_ROWS_PER_WARP + i;
    const int gq = q0 + r;
    if (gq >= s_len) continue;
    const float l = sL[r];
    T* orow = o + base + (size_t)gq * d;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) orow[col] = cxn_from_f32<T>(acc[i][c] / l);
    }
    if (lane == 0) lse[(size_t)blockIdx.y * s_len + gq] = sM[r] + logf(l);
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16 (bf16 in, float32
// accumulate), the FlashAttention-2 register layout.  One block of 4
// warps per (b*h, 64-row q-tile); each warp owns 16 query rows and keeps
// their scores (16 x 64 per k-tile), running max / sum and output
// accumulator (16 x d) in registers.  A score accumulator tile has the
// same thread-to-element map as the A operand of the next mma, so p goes
// from scores to the p.V product without touching shared memory; row
// reductions are two shuffles among the 4 lanes that share a row.  Only
// the q / k / v tiles live in shared memory.  The kernel is instantiated
// for D = d rounded up to 16; a head width with d % 16 == 8 carries a
// zero column block in shared memory (it adds nothing to the scores and
// its output columns are not stored).  Rows are read as 16-byte vectors,
// so q / k / v / o must be 16-byte aligned (the caller checks).

constexpr int TC_BQ = 64;
constexpr int TC_BK = 64;
constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 -> one operand register, the lower index in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows row0.. of a (s_len, d) matrix into a (64, D + 8) tile; rows past
// s_len and columns d..D are zero
template <int D>
__device__ __forceinline__ void tc_load_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int row0, int s_len, int d) {
  constexpr int LD = D + 8, VEC = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < TC_BQ * VEC; idx += TC_THREADS) {
    const int r = idx / VEC, c8 = (idx - r * VEC) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < s_len && c8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c8);
    *reinterpret_cast<uint4*>(dst + r * LD + c8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int s_len, int d, int causal, float scale) {
  constexpr int LD = D + 8;      // padded smem row: conflict-free reads
  constexpr int NK = D / 16;     // k-steps of the score product
  constexpr int NO = D / 8;      // n8 tiles of the output
  constexpr int NS = TC_BK / 8;  // n8 tiles of the scores
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sK = sQ + TC_BQ * LD;
  __nv_bfloat16* sV = sK + TC_BK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread in group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;  // heaviest first
  const size_t base = (size_t)blockIdx.y * s_len * d;
  tc_load_tile<D>(sQ, q + base, q0, s_len, d);

  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int gq0 = q0 + r0, gq1 = gq0 + 8;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;

  const int q_last = min(q0 + TC_BQ, s_len) - 1;
  const int n_kt = causal ? q_last / TC_BK + 1 : (s_len + TC_BK - 1) / TC_BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TC_BK;
    __syncthreads();  // the previous tile's sK / sV reads are done
    tc_load_tile<D>(sK, k + base, k0, s_len, d);
    tc_load_tile<D>(sV, v + base, k0, s_len, d);
    __syncthreads();

    // scores: 16 x 64 per warp, in NS n8 accumulator tiles
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const __nv_bfloat16* qa = sQ + r0 * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * LD), ld_u32(qa + 8),
                             ld_u32(qa + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kb = sK + (n * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t b[2] = {ld_u32(kb), ld_u32(kb + 8)};
        mma_16816(s[n], a, b);
      }
    }

    // scale, mask, online softmax (rows r0: elements 0,1; r0+8: 2,3)
    float mx0 = FA_NEG_INF, mx1 = FA_NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + n * 8 + 2 * t + (e & 1);
        const int gq = e < 2 ? gq0 : gq1;
        const bool ok = gk < s_len && (!causal || gk <= gq);
        s[n][e] = ok ? s[n][e] * scale : FA_NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
        else mx1 = fmaxf(mx1, s[n][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // acc += p.V: p (bf16) straight from the score registers
#pragma unroll
    for (int j = 0; j < TC_BK / 16; ++j) {
      const uint32_t a[4] = {pack_f32(s[2 * j][0], s[2 * j][1]),
                             pack_f32(s[2 * j][2], s[2 * j][3]),
                             pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vb = sV + (j * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vn = vb + n * 8;
        const uint32_t b[2] = {pack_bf16(vn[0], vn[LD]),
                               pack_bf16(vn[8 * LD], vn[9 * LD])};
        mma_16816(acc[n], a, b);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (n * 8 >= d) break;  // the zero column block of d % 16 == 8
    if (gq0 < s_len)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)gq0 * d + col) =
          pack_f32(acc[n][0] / l0, acc[n][1] / l0);
    if (gq1 < s_len)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)gq1 * d + col) =
          pack_f32(acc[n][2] / l1, acc[n][3] / l1);
  }
  if (t == 0) {
    if (gq0 < s_len) lse[(size_t)blockIdx.y * s_len + gq0] = m0 + logf(l0);
    if (gq1 < s_len) lse[(size_t)blockIdx.y * s_len + gq1] = m1 + logf(l1);
  }
}

template <int D>
cudaError_t fa_launch_mma(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int s, int d,
                          int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (TC_BQ + 2 * TC_BK) * (D + 8);
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t err = cxn_allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + TC_BQ - 1) / TC_BQ, bh);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s, d, causal, scale);
  return cudaGetLastError();
}

cudaError_t fa_launch_tc(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int s, int d,
                         int causal, float scale, cudaStream_t st) {
  switch ((d + 15) / 16) {
    case 1: return fa_launch_mma<16>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 2: return fa_launch_mma<32>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 3: return fa_launch_mma<48>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 4: return fa_launch_mma<64>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 5: return fa_launch_mma<80>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 6: return fa_launch_mma<96>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 7: return fa_launch_mma<112>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 8: return fa_launch_mma<128>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 9: return fa_launch_mma<144>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 10: return fa_launch_mma<160>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 11: return fa_launch_mma<176>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 12: return fa_launch_mma<192>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 13: return fa_launch_mma<208>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 14: return fa_launch_mma<224>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 15: return fa_launch_mma<240>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 16: return fa_launch_mma<256>(q, k, v, o, lse, bh, s, d, causal, scale, st);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int DCH>
cudaError_t fa_launch(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int s, int d, int causal,
                      float scale, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes(d);
  auto kern = flash_fwd_kernel<T, DCH>;
  cudaError_t err = cxn_allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + FA_BQ - 1) / FA_BQ, bh);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), s, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fa_dispatch(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int s, int d, int causal,
                        float scale, cudaStream_t st) {
  switch ((d + 31) / 32) {
    case 1: return fa_launch<T, 1>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 2: return fa_launch<T, 2>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 3: return fa_launch<T, 3>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 4: return fa_launch<T, 4>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 5: return fa_launch<T, 5>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 6: return fa_launch<T, 6>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 7: return fa_launch<T, 7>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 8: return fa_launch<T, 8>(q, k, v, o, lse, bh, s, d, causal, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (bh, s, d) contiguous in `dtype`; lse: (bh, s) float32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int cxn_flash_attn_fwd(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int bh,
                                  int s, int d, int causal, float scale,
                                  int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || s < 1 || d < 8 || d > 256 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == CXN_BF16) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
      return (int)cudaErrorMisalignedAddress;
    return (int)fa_launch_tc(q, k, v, o, lse, bh, s, d, causal, scale, st);
  }
  if (dtype == CXN_F32)
    return (int)fa_dispatch<float>(q, k, v, o, lse, bh, s, d, causal, scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}
