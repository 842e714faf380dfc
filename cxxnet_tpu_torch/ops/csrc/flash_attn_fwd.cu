// Flash-attention forward for Hopper (sm_90a), called through ctypes.
//
// Replaces: cxxnet_tpu/ops/pallas_kernels.py `_fa_fwd` (the triangular
// causal `pallas_call` with `_fa_fwd_kernel_tri`, and the dense one) and,
// with segment ids, `_fa_seg_fwd` (`_fa_fwd_kernel_tri_seg`); the
// per-block math of both is `_fa_fwd_step`.  Same function: for each of
// the b*h rows of q/k/v (b*h, s, d), o = softmax(q k^T * scale, masked)
// v and lse = m + log(l), with
//   * scores in float32 (bf16 inputs are exact in float32), times scale;
//   * the causal mask, then under segment ids the `_segment_mask` rule
//     (same non-padding segment, or the diagonal), writing
//     NEG_INF = -1e30 (not -inf);
//   * p cast to v's dtype before the p.V product, sums in float32;
//   * o stored in q's dtype, lse (b*h, s) in float32.
// Any s (the ragged last tile is masked) and any d that is a multiple
// of 8 up to 256.  Segment ids are one int32 row (b, s) per batch entry,
// shared by its h heads (row bh / h); the SEG template flag selects the
// segmented variant of each kernel, nothing else differs.
//
// What bounds it on the card: operations.  At the served shape (16
// heads, s 4096, d 128, causal, bf16) it does 2 products of the live
// (s x s x d) triangle, ~69 GFLOP on 67 MB of input and output, far
// above the ~295 FLOP/byte at which an H100 stops being memory-bound:
// the least time is the products over the tensor cores' 989 TFLOP/s,
// 0.070 ms.  Segment masking removes scores inside the live tiles but
// no tiles: tiles are skipped by causality only, as in the JAX package.
//
// Design.  The TPU grid walks (q-block, k-block) pairs in order and
// carries (acc, m, l) in VMEM scratch between grid steps; here one block
// owns a (b*h, q-tile) and loops over the k-tiles itself, stopping at the
// diagonal under the causal mask.  Blocks are issued heaviest-first (the
// last q-tiles of every head before the first ones).  Two routes:
//   * bf16, every width: wgmma fed by a TMA ring, warp-specialised
//     (flash_fwd_wgmma_kernel below).  A block of 384 threads owns 128
//     query rows: a producer warpgroup, whose first warp loads the
//     q-tile once and streams K and V tiles through a 2-stage ring in
//     shared memory (TMA, 128-byte swizzle, mbarriers; K and V of a
//     stage have barriers of their own, so a K slot is refilled once
//     both consumers' softmax of its stage is done, before their p V
//     products of it complete), and two consumer warpgroups of 64
//     query rows each.  A consumer computes S = Q K^T (wgmma, both
//     operands in shared memory), the online softmax in registers in
//     the exp2 domain (log2(e) folded into the scale; the mask
//     evaluated only on tiles that cross the diagonal or the ragged end
//     and, under SEG, on tiles whose keys do not all share the rows'
//     one nonzero segment id, which the producer checks as it stages
//     the ids), rounds p to bf16 straight from the score accumulators
//     into the A operand of O += p V (wgmma from registers, V read
//     MN-major from the ring): p never touches shared memory.  A
//     consumer issues the next stage's S before this stage's p V and
//     runs the next softmax while p V is in flight (FlashAttention-3's
//     overlap inside a warpgroup).  setmaxnreg gives the consumers 240
//     registers and the producer 24.  Instances at 64, 128, 192 and 256
//     columns; TMA fills the columns past d with zeros.
//       - Up to 128 columns the stages hold 128 key rows: Q (32 KB at
//         d 128) and two stages of K + V (128 KB).
//       - Wider, Q alone takes 64 KB at 256 columns and two 128-row
//         stages of K + V 256 KB, and a consumer's 64 x 256 float32
//         output is 128 registers a thread: the stages hold 64 key rows
//         (Q 64 KB + two stages of 64 KB, ~194 KB at 256 columns; 176
//         live registers: 128 of o, 32 of scores, 16 of p).  S is 16
//         k-steps of an m64n64 product, p V 4 k-steps of two m64n128
//         ones (192: n128 + n64).  Under the causal mask the block's
//         last stage lies above consumer 0's rows; it skips it.  Widths
//         136-192 take the 192-column instance (20% faster there than
//         the 256-column one).
//     2 products of the live tiles, as the bound counts, plus the masked
//     halves of the diagonal tiles.
//   * float32: products on the CUDA cores in float32, each warp owning
//     8 query rows with their (8 x d) accumulator in registers.
// PERF.md has their times against the bound.  The kernels allocate
// nothing, do not synchronise, and launch on the caller's stream.

#include <stdint.h>

#include "common.cuh"
#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

constexpr int FA_BQ = 64;              // query rows per block
constexpr int FA_BK = 64;              // key rows per tile
constexpr int FA_THREADS = 256;        // 8 warps
constexpr int FA_ROWS_PER_WARP = FA_BQ / (FA_THREADS / 32);
constexpr int FA_SP = FA_BK + 1;       // padded score-row stride

size_t fa_smem_bytes(int d) {
  const size_t dp = (size_t)d + 1;
  return sizeof(float) * (FA_BQ * dp + FA_BK * dp + (size_t)FA_BK * d +
                          FA_BQ * FA_SP + 3 * FA_BQ);
}

// DCH = ceil(d / 32): output columns per lane (lane + 32 * c)
template <typename T, int DCH, bool SEG>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ o, float* __restrict__ lse, int s_len,
                 int d, int h, int causal, float scale) {
  extern __shared__ float smem[];
  __shared__ int sSegK[FA_BK];
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
  const int* segb = SEG ? seg + (size_t)(blockIdx.y / h) * s_len : nullptr;

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
  int segq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    segq[i] = SEG && q0 + sr0 + i < s_len ? segb[q0 + sr0 + i] : 0;

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
    if (SEG) fa_load_seg(sSegK, segb, k0, s_len);
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
        const bool ok = fa_allowed<SEG>(q0 + r, k0 + cc, s_len, causal,
                                        segq[i], SEG ? sSegK[cc] : 0);
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
// bf16, every width: wgmma, a TMA ring and warp specialisation (see the
// header).  Thread roles: threads 0..127 the producer warpgroup (only
// its first warp works), 128..383 consumers c = 0, 1 owning query rows
// q0 + 64c ... q0 + 64c + 63.  A consumer thread holds the m64n* wgmma
// accumulator layout: rows g and g + 8 of its warp's 16 (g = lane / 4),
// columns 8i + 2t, 8i + 2t + 1 of each n8 block i (t = lane % 4), in
// registers 4i .. 4i + 3.  Up to 128 columns (not WIDE) the ring's
// stages hold 128 key rows; wider, 64 (two 128-row stages of K and V
// would not fit beside Q).
template <int D>
struct FwdTiles {
  static constexpr bool WIDE = D > 128;
  static constexpr int BM = 128;               // query rows per block
  static constexpr int BK = WIDE ? 64 : 128;   // key rows per ring stage
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_SEG = OFF_V + STAGES * KV_BYTES;
  // fh_stage_seg of the two row halves, then of each stage
  static constexpr int OFF_UNI = OFF_SEG + STAGES * BK * 4;
  static constexpr int OFF_BAR = OFF_UNI + 32;
  // Q's barrier, then `full` and `empty` of each K and each V slot
  static constexpr int SMEM = OFF_BAR + (1 + 4 * STAGES) * 8 + 1024;
  static_assert(2 + STAGES <= 8, "segment flags");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int D, bool SEG>
__global__ void __launch_bounds__(FH_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const int* __restrict__ seg,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int s_len, int d, int h,
                       int causal, float scale_log2) {
  using L = FwdTiles<D>;
  constexpr int BM = L::BM, BK = L::BK, ST = L::STAGES;
  extern __shared__ unsigned char fh_raw[];
  unsigned char* sm = fh_align1024(fh_raw);
  int* sseg = reinterpret_cast<int*>(sm + L::OFF_SEG);
  int* suni = reinterpret_cast<int*>(sm + L::OFF_UNI);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  // K and V of a stage have barriers of their own: a K slot (with the
  // stage's segment ids) is free once both consumers' softmax of the
  // stage is done, a V slot once their p V products have completed
  uint64_t* kfull = bar_q + 1;
  uint64_t* vfull = kfull + ST;
  uint64_t* kempty = vfull + ST;
  uint64_t* vempty = kempty + ST;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int n_kt = causal ? (min(q0 + BM, s_len) + BK - 1) / BK
                          : (s_len + BK - 1) / BK;
  const int* segb = SEG ? seg + (size_t)(bh / h) * s_len : nullptr;
  fh_init_barriers<2 * ST>(bar_q);

  if (threadIdx.x < 128) {  // producer
    fh_producer_regs();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (SEG)
      for (int half = 0; half < 2; ++half) {
        const int u =
            fh_stage_seg(nullptr, segb, q0 + 64 * half, 64, s_len, lane);
        if (lane == 0) suni[half] = u;
      }
    if (lane == 0) {
      mbar_arrive_tx(bar_q, L::Q_BYTES);
      tma_tile<BM, D>(sm, &tq, bar_q, q0, bh);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % ST, k0 = kt * BK;
      const uint32_t ph = (kt / ST - 1) & 1;
      if (kt >= ST) mbar_wait(&kempty[st], ph);
      if (SEG) {
        const int u = fh_stage_seg(sseg + st * BK, segb, k0, BK, s_len, lane);
        if (lane == 0) suni[2 + st] = u;
      }
      if (lane == 0) {
        mbar_arrive_tx(&kfull[st], L::KV_BYTES);
        tma_tile<BK, D>(sm + L::OFF_K + st * L::KV_BYTES, &tk, &kfull[st],
                        k0, bh);
      } else {
        mbar_arrive(&kfull[st]);
      }
      if (kt >= ST) mbar_wait(&vempty[st], ph);
      if (lane == 0) {
        mbar_arrive_tx(&vfull[st], L::KV_BYTES);
        tma_tile<BK, D>(sm + L::OFF_V + st * L::KV_BYTES, &tv, &vfull[st],
                        k0, bh);
      } else {
        mbar_arrive(&vfull[st]);
      }
    }
    return;
  }

  fh_consumer_regs();
  const int c = threadIdx.x / 128 - 1;
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * c;
  const int gq0 = r0 + 16 * w + g, gq1 = gq0 + 8;
  const int sq0 = SEG && gq0 < s_len ? segb[gq0] : 0;
  const int sq1 = SEG && gq1 < s_len ? segb[gq1] : 0;
  // Under the causal mask the consumer stops after the stage that holds
  // its last live key: with 64-row stages, consumer 0 skips the block's
  // last stage (keys q0 + 64 ..), which lies wholly above its rows.  It
  // neither waits for that stage nor frees it: the producer only waits
  // for `empty` of a slot it refills, and the block's last stage is
  // never refilled.
  const int n_c = causal ? min(r0 + 63, s_len - 1) / BK + 1 : n_kt;
  const uint32_t s_q = smem_u32(sm);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max (exp2 domain) and this thread's part of the row sums
  float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);
  const int urow = SEG ? suni[c] : 0;  // the rows' one segment, or -1

  // S = Q K^T of stage kt into s, issued and committed
  auto issue_s = [&](float* s, int kt) {
    const int st = kt % ST;
    const uint32_t s_k = smem_u32(sm + L::OFF_K + st * L::KV_BYTES);
    mbar_wait(&kfull[st], (kt / ST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<BK>(s, wg_kmajor<BM>(s_q, 64 * c, kk), wg_kmajor<BK>(s_k, 0, kk),
                kk > 0);
    wg_commit();
  };
  // O += p V of stage kt, p (bf16) from registers, V MN-major; issued
  // and committed
  auto issue_pv = [&](uint32_t (*pa)[4], int kt) {
    const int st = kt % ST;
    const uint32_t s_v = smem_u32(sm + L::OFF_V + st * L::KV_BYTES);
    mbar_wait(&vfull[st], (kt / ST) & 1);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wg_rs_cols<D, BK>(acc, pa[j], s_v, j);
    wg_commit();
  };
  // stage kt's completed scores s to p: the scale, the mask, the online
  // softmax (the running max and sums updated; the output's rescale in
  // c0, c1); then the stage's K slot is free
  auto softmax = [&](float* s, int kt, float& c0, float& c1) {
    const int st = kt % ST, k0 = kt * BK;
    wg_fence_acc<BK / 2>(s);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
    // the segment mask is all-live where rows and keys share one id
    const bool seg_mask = SEG && !(urow > 0 && suni[2 + st] == urow);
    if (seg_mask || k0 + BK > s_len || (causal && k0 + BK - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kc = 8 * (i >> 2) + 2 * t + (i & 1), gk = k0 + kc;
        const bool hi = (i & 2) != 0;
        const int gq = hi ? gq1 : gq0;
        bool ok = gk < s_len && (!causal || gk <= gq);
        if (SEG) {
          const int sq = hi ? sq1 : sq0;
          ok = ok && ((sq == sseg[st * BK + kc] && sq != 0) || gq == gk);
        }
        if (!ok) s[i] = FA_NEG_INF;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    c0 = fh_exp2(m0 - mx0);
    c1 = fh_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      s[4 * i] = fh_exp2(s[4 * i] - m0);
      s[4 * i + 1] = fh_exp2(s[4 * i + 1] - m0);
      s[4 * i + 2] = fh_exp2(s[4 * i + 2] - m1);
      s[4 * i + 3] = fh_exp2(s[4 * i + 3] - m1);
      sum0 += s[4 * i] + s[4 * i + 1];
      sum1 += s[4 * i + 2] + s[4 * i + 3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    mbar_arrive(&kempty[st]);
  };

  // Stage kt's p V overlaps stage kt + 1's S and softmax: S(kt + 1) and
  // p(kt) V(kt) are issued in that order, S(kt + 1)'s softmax runs once
  // it has completed (wait_group 1) while p V is in flight, and the
  // output is rescaled after p V completes.  The last p V is peeled off
  // the loop: a wgmma issued under a branch makes ptxas serialise them.
  float s[BK / 2], c0, c1;
  uint32_t pa[BK / 16][4];
  issue_s(s, 0);
  wg_wait_all();
  softmax(s, 0, c0, c1);  // the output is still 0: no rescale
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wg_acc_to_a(pa[j], s, j);
  for (int kt = 0; kt + 1 < n_c; ++kt) {
    issue_s(s, kt + 1);
    issue_pv(pa, kt);
    wg_wait_one();
    softmax(s, kt + 1, c0, c1);
    wg_wait_all();
    wg_fence_acc<D / 2>(acc);
    mbar_arrive(&vempty[kt % ST]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= c0;
      acc[4 * n + 1] *= c0;
      acc[4 * n + 2] *= c1;
      acc[4 * n + 3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wg_acc_to_a(pa[j], s, j);
  }
  issue_pv(pa, n_c - 1);
  wg_wait_all();
  wg_fence_acc<D / 2>(acc);
  mbar_arrive(&vempty[(n_c - 1) % ST]);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const size_t base = (size_t)bh * s_len * d;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n * 8 >= d) break;  // TMA's zero columns past d
    const int col = n * 8 + 2 * t;
    if (gq0 < s_len)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)gq0 * d + col) =
          pack_f32(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (gq1 < s_len)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)gq1 * d + col) =
          pack_f32(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
  if (t == 0) {
    float* lrow = lse + (size_t)bh * s_len;
    if (gq0 < s_len) lrow[gq0] = (m0 + log2f(l0)) * FH_LN2;
    if (gq1 < s_len) lrow[gq1] = (m1 + log2f(l1)) * FH_LN2;
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  const int* seg;
  void *o, *lse;
  int bh, h, s, d, causal;
  float scale;
  cudaStream_t stream;
};

template <int D, bool SEG>
cudaError_t fa_launch_wgmma(const FwdArgs& a) {
  using L = FwdTiles<D>;
  CUtensorMap tq, tk, tv;
  if (!fh_tensor_map(&tq, a.q, a.bh, a.s, a.d, L::BM) ||
      !fh_tensor_map(&tk, a.k, a.bh, a.s, a.d, L::BK) ||
      !fh_tensor_map(&tv, a.v, a.bh, a.s, a.d, L::BK))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D, SEG>;
  static const cudaError_t ready = fh_prepare(kern, L::SMEM);
  if (ready != cudaSuccess) return ready;
  const dim3 grid(a.bh, (a.s + L::BM - 1) / L::BM);
  kern<<<grid, FH_THREADS, L::SMEM, a.stream>>>(
      tq, tk, tv, a.seg, static_cast<__nv_bfloat16*>(a.o),
      static_cast<float*>(a.lse), a.s, a.d, a.h, a.causal,
      a.scale * FH_LOG2E);
  return cudaGetLastError();
}

template <bool SEG>
cudaError_t fa_launch_tc(const FwdArgs& a) {  // fa_route: every width
  if (a.d <= 64) return fa_launch_wgmma<64, SEG>(a);
  if (a.d <= 128) return fa_launch_wgmma<128, SEG>(a);
  if (a.d <= 192) return fa_launch_wgmma<192, SEG>(a);
  return fa_launch_wgmma<256, SEG>(a);
}

template <int DCH, bool SEG>
cudaError_t fa_launch(const FwdArgs& a) {
  const size_t smem = fa_smem_bytes(a.d);
  auto kern = flash_fwd_kernel<float, DCH, SEG>;
  cudaError_t err = cxn_allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + FA_BQ - 1) / FA_BQ, a.bh);
  kern<<<grid, FA_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.seg, static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.s, a.d, a.h, a.causal, a.scale);
  return cudaGetLastError();
}

template <bool SEG>
cudaError_t fa_dispatch_f32(const FwdArgs& a) {
  switch ((a.d + 31) / 32) {
    case 1: return fa_launch<1, SEG>(a);
    case 2: return fa_launch<2, SEG>(a);
    case 3: return fa_launch<3, SEG>(a);
    case 4: return fa_launch<4, SEG>(a);
    case 5: return fa_launch<5, SEG>(a);
    case 6: return fa_launch<6, SEG>(a);
    case 7: return fa_launch<7, SEG>(a);
    case 8: return fa_launch<8, SEG>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (bh, s, d) contiguous in `dtype`; lse: (bh, s) float32;
// seg: NULL, or (bh / h, s) int32 segment ids (0 = padding) of the
// segmented variant.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int cxn_flash_attn_fwd(const void* q, const void* k,
                                  const void* v, const void* seg, void* o,
                                  void* lse, int bh, int h, int s, int d,
                                  int causal, float scale, int dtype,
                                  void* stream) {
  if (bh < 1 || bh > 65535 || h < 1 || bh % h != 0 || s < 1 || d < 8 ||
      d > 256 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q,  k, v, static_cast<const int*>(seg), o, lse, bh, h, s,
                  d, causal, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == CXN_BF16) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
      return (int)cudaErrorMisalignedAddress;
    return (int)(seg ? fa_launch_tc<true>(a) : fa_launch_tc<false>(a));
  }
  if (dtype == CXN_F32)
    return (int)(seg ? fa_dispatch_f32<true>(a) : fa_dispatch_f32<false>(a));
  return (int)cudaErrorInvalidValue;
}

// The route (FaRoute) of a forward (backward = 0) or backward call at
// head width d in `dtype`, or -1 for a width the kernels do not take.
// Both directions take the same route at every width they take.
extern "C" int cxn_flash_attn_route(int d, int dtype, int /*backward*/) {
  if (d < 8 || d % 8 != 0 || d > 256 ||
      (dtype != CXN_BF16 && dtype != CXN_F32))
    return -1;
  return fa_route(dtype);
}
