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
// heads, s 4096, d 128, causal, bf16) the function needs 5 products of
// the live (s x s x d) triangle (s, dO v^T, dv, dk, dq), ~690 GFLOP on
// ~270 MB of input and output, far above an H100's ~295 FLOP/byte: the
// least time is those products over the tensor cores' 989 TFLOP/s,
// 0.695 ms.
//
// Design.  As in the JAX package, two kernels after a delta pre-kernel,
// so that no block writes another block's output: no atomics, and
// repeated runs are bitwise equal.  The price is that s and dO v^T are
// formed in both: 7 products against the bound's 5.
//   * delta: one warp per row, float32.
//   * bf16 (every head width, instantiated at 64, 128, 192 and 256
//     columns; TMA fills the columns past d with zeros): wgmma fed by a TMA ring,
//     warp-specialised as the forward (flash_attn_fwd.cu): 384 threads a
//     block, a producer warpgroup whose first warp issues the TMA loads
//     and stages the per-row vectors, two consumer warpgroups of 64 rows
//     with 240 registers each (setmaxnreg).
//       - dq: one block per (b*h, q-tile), heaviest first.  Q and dO stay
//         resident; 64-row K and V tiles stream through a 2-stage ring.
//         A consumer forms S = Q K^T and dP = dO V^T (wgmma from shared
//         memory), ds in registers, and dq += ds K with ds (bf16) as the
//         register A operand and K read MN-major from the ring.  Up to
//         128 columns a q-tile is 128 rows, a consumer's 64 of them on
//         every key tile.  Wider, a 128-row Q / dO pair and the ring would
//         take ~256 KB of the 227: a q-tile is 64 rows, shared by the two
//         consumers, which take the key tiles in turns (each its own ring
//         stage), and consumer 1's 64 x D float32 partial sum is added to
//         consumer 0's through shared memory at the end (a fixed order).
//       - dk/dv: one block per (b*h, k-tile), the longest causal columns
//         first; K and V resident, 64-row Q and dO tiles (with their lse
//         and delta) stream through a 2-stage ring from the diagonal on
//         (the TPU's `_fa_dkv_kernel_tri`).  It works on the transposed
//         tile: S^T = K Q^T and dP^T = V dO^T from shared memory, p^T and
//         ds^T in registers, then dv += p^T dO and dk += ds^T Q with p^T /
//         ds^T as register A operands.  Up to 128 columns a k-tile is 128
//         rows and a consumer holds both 64 x D accumulators of its 64
//         rows.  Wider, two would take 256 registers a thread of the 240,
//         and a 128-row K / V pair with the ring ~256 KB: a k-tile is 64
//         rows, and the consumers split by role: consumer 0 forms S^T,
//         p^T and dv, consumer 1 S^T, dP^T, ds^T and dk (S^T twice: 5
//         products a stage where 4 would do; handing p^T over through
//         shared memory instead ran no faster, and a ring of 4 stages of
//         32 q rows ran 1.4x slower: PERF.md).  Products wider than 128
//         columns go as 128-column pieces (and a 64-column one at 192).
//         Widths 136-192 take the 192-column instance: at head width 192
//         it ran 0.94 ms where the 256-column one ran 1.13 (PERF.md).
//     Scores go to the exp2 domain (log2(e) folded into the scale and
//     into lse as it is staged); the mask runs only on tiles that cross
//     the diagonal or the ragged end and, under SEG, on tiles whose
//     streamed rows do not all share the resident rows' one nonzero
//     segment id (checked by the producer as it stages the ids).
//   * float32: the CUDA cores (4 x 4 register tiles, p and ds staged in
//     shared memory) over 64-row tiles up to 128 columns, over 32-row
//     tiles (2 x 2 register tiles) from 136 to 256, where four 64-row
//     float32 tiles would not fit in shared memory.  wgmma in tf32 would
//     compute another function.
// PERF.md has the times.  The kernels allocate nothing (the caller passes
// the delta buffer), do not synchronise, and launch on the caller's
// stream.

#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

constexpr int FB_THREADS = 256;   // CUDA-core kernels: 8 warps

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
// rows row0.. of a (s_len, d) matrix into an (R, d + 1) tile
template <int R>
__device__ __forceinline__ void fb_load_rows(float* dst, const float* src,
                                             int row0, int s_len, int d) {
  const int dp = d + 1;
  for (int idx = threadIdx.x; idx < R * d; idx += FB_THREADS) {
    const int r = idx / d, c = idx - r * d;
    const int gr = row0 + r;
    dst[r * dp + c] = gr < s_len ? src[(size_t)gr * d + c] : 0.f;
  }
}

template <int R>
__device__ __forceinline__ void fb_load_stats(float* sl, float* sd,
                                              const float* lse,
                                              const float* delta, int row0,
                                              int s_len) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const bool ok = row0 + r < s_len;
    sl[r] = ok ? lse[row0 + r] : 0.f;
    sd[r] = ok ? delta[row0 + r] : 0.f;
  }
}

size_t fb_smem_dq(int d, int r) {
  return sizeof(float) * (4 * (size_t)r * (d + 1) + r * (r + 1));
}
size_t fb_smem_dkv(int d, int r) {
  return sizeof(float) * (4 * (size_t)r * (d + 1) + 2 * r * (r + 1));
}

// dq: this block's R q rows (R = 64, or 32 for heads wider than 128)
// against every live k-tile.  Each thread computes an R/16 x R/16 tile
// of s and dO v^T, the block stages ds in shared memory, and each warp
// accumulates R/8 rows of ds k (DCH columns a lane).
template <int DCH, bool SEG, int R>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg, float* __restrict__ dq,
                    int s_len, int d, int h, int causal, float scale) {
  constexpr int RT = R / 16, AR = R / 8, SP = R + 1;
  extern __shared__ float smem[];
  __shared__ float sL[R], sD[R];
  __shared__ int sSegK[64];  // fa_load_seg stages 64 ids
  const int dp = d + 1;
  float* sQ = smem;
  float* sG = sQ + R * dp;   // dO
  float* sK = sG + R * dp;
  float* sV = sK + R * dp;
  float* sS = sV + R * dp;   // ds, [q row][k col]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // heaviest first
  const size_t base = (size_t)blockIdx.y * s_len * d;
  const size_t rbase = (size_t)blockIdx.y * s_len;
  const int* segb = SEG ? seg + (size_t)(blockIdx.y / h) * s_len : nullptr;
  fb_load_rows<R>(sQ, q + base, q0, s_len, d);
  fb_load_rows<R>(sG, dout + base, q0, s_len, d);
  fb_load_stats<R>(sL, sD, lse + rbase, delta + rbase, q0, s_len);
  const int sr0 = (tid >> 4) * RT, sc0 = tid & 15;
  int segq[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
    segq[i] = SEG && q0 + sr0 + i < s_len ? segb[q0 + sr0 + i] : 0;
  float acc[AR][DCH];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[i][c] = 0.f;

  const int q_last = min(q0 + R, s_len) - 1;
  const int n_kt = causal ? q_last / R + 1 : (s_len + R - 1) / R;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the previous tile's sK / sS reads are done
    fb_load_rows<R>(sK, k + base, k0, s_len, d);
    fb_load_rows<R>(sV, v + base, k0, s_len, d);
    if (SEG) fa_load_seg(sSegK, segb, k0, s_len);
    __syncthreads();
    float sc[RT][RT], gp[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) sc[i][j] = gp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float qa[RT], ga[RT], ka[RT], va[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        qa[i] = sQ[(sr0 + i) * dp + c];
        ga[i] = sG[(sr0 + i) * dp + c];
      }
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        ka[j] = sK[(sc0 + 16 * j) * dp + c];
        va[j] = sV[(sc0 + 16 * j) * dp + c];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
          gp[i][j] = fmaf(ga[i], va[j], gp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int r = sr0 + i, cc = sc0 + 16 * j;
        const bool ok = fa_allowed<SEG>(q0 + r, k0 + cc, s_len, causal,
                                        segq[i], SEG ? sSegK[cc] : 0);
        const float p = expf((ok ? sc[i][j] * scale : FA_NEG_INF) - sL[r]);
        sS[r * SP + cc] = p * (gp[i][j] - sD[r]) * scale;
      }
    __syncthreads();
    for (int j = 0; j < R; ++j) {
      float kv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int col = lane + 32 * c;
        kv[c] = col < d ? sK[j * dp + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        const float ds = sS[(warp * AR + i) * SP + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int gq = q0 + warp * AR + i;
    if (gq >= s_len) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) dq[base + (size_t)gq * d + col] = acc[i][c];
    }
  }
}

// dk / dv: this block's R k rows against every live q-tile, on the
// transposed tile (k row, q column).
template <int DCH, bool SEG, int R>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg, float* __restrict__ dk,
                     float* __restrict__ dv, int s_len, int d, int h,
                     int causal, float scale) {
  constexpr int RT = R / 16, AR = R / 8, SP = R + 1;
  extern __shared__ float smem[];
  __shared__ float sL[R], sD[R];
  __shared__ int sSegQ[64];
  const int dp = d + 1;
  float* sK = smem;
  float* sV = sK + R * dp;
  float* sQ = sV + R * dp;
  float* sG = sQ + R * dp;   // dO
  float* sP = sG + R * dp;   // p^T, [k row][q col]
  float* sS = sP + R * SP;  // ds^T
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * R;  // the longest causal columns first
  const size_t base = (size_t)blockIdx.y * s_len * d;
  const size_t rbase = (size_t)blockIdx.y * s_len;
  const int* segb = SEG ? seg + (size_t)(blockIdx.y / h) * s_len : nullptr;
  fb_load_rows<R>(sK, k + base, k0, s_len, d);
  fb_load_rows<R>(sV, v + base, k0, s_len, d);
  const int sr0 = (tid >> 4) * RT, sc0 = tid & 15;
  int segk[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
    segk[i] = SEG && k0 + sr0 + i < s_len ? segb[k0 + sr0 + i] : 0;
  float ak[AR][DCH], av[AR][DCH];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int c = 0; c < DCH; ++c) ak[i][c] = av[i][c] = 0.f;

  const int n_qt = (s_len + R - 1) / R;
  for (int qt = causal ? k0 / R : 0; qt < n_qt; ++qt) {
    const int q0 = qt * R;
    __syncthreads();  // the previous tile's sQ / sG / sP / sS reads are done
    fb_load_rows<R>(sQ, q + base, q0, s_len, d);
    fb_load_rows<R>(sG, dout + base, q0, s_len, d);
    fb_load_stats<R>(sL, sD, lse + rbase, delta + rbase, q0, s_len);
    if (SEG) fa_load_seg(sSegQ, segb, q0, s_len);
    __syncthreads();
    float sc[RT][RT], gp[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) sc[i][j] = gp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float ka[RT], va[RT], qa[RT], ga[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        ka[i] = sK[(sr0 + i) * dp + c];
        va[i] = sV[(sr0 + i) * dp + c];
      }
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        qa[j] = sQ[(sc0 + 16 * j) * dp + c];
        ga[j] = sG[(sc0 + 16 * j) * dp + c];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          sc[i][j] = fmaf(ka[i], qa[j], sc[i][j]);
          gp[i][j] = fmaf(va[i], ga[j], gp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int r = sr0 + i, cc = sc0 + 16 * j;
        const bool ok = fa_allowed<SEG>(q0 + cc, k0 + r, s_len, causal,
                                        SEG ? sSegQ[cc] : 0, segk[i]);
        const float p = expf((ok ? sc[i][j] * scale : FA_NEG_INF) - sL[cc]);
        sP[r * SP + cc] = p;
        sS[r * SP + cc] = p * (gp[i][j] - sD[cc]) * scale;
      }
    __syncthreads();
    for (int j = 0; j < R; ++j) {
      float gv[DCH], qv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int col = lane + 32 * c;
        gv[c] = col < d ? sG[j * dp + col] : 0.f;
        qv[c] = col < d ? sQ[j * dp + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        const float p = sP[(warp * AR + i) * SP + j];
        const float ds = sS[(warp * AR + i) * SP + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          av[i][c] = fmaf(p, gv[c], av[i][c]);
          ak[i][c] = fmaf(ds, qv[c], ak[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int gk = k0 + warp * AR + i;
    if (gk >= s_len) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        dk[base + (size_t)gk * d + col] = ak[i][c];
        dv[base + (size_t)gk * d + col] = av[i][c];
      }
    }
  }
}

// --------------------------------------------------------------- bf16
// Thread roles as in flash_fwd_wgmma_kernel: threads 0..127 the producer
// warpgroup (its first warp works), 128..383 consumers c = 0, 1; a
// consumer thread holds the m64n* accumulator layout (rows g, g + 8 of
// its warp's 16; columns 8i + 2t, 8i + 2t + 1 of n8 block i in registers
// 4i .. 4i + 3).  Up to 128 columns (not WIDE) the consumers own rows
// 64c .. 64c + 63 of a 128-row block; wider they share one 64-row block
// (see the file's header).
template <int D>
struct DqTiles {
  static constexpr bool WIDE = D > 128;
  static constexpr int BM = WIDE ? 64 : 128;   // query rows per block
  static constexpr int BK = 64;                // key rows per ring stage
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * D * 2;   // resident Q or dO
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V stage
  static constexpr int OFF_G = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_SEG = OFF_V + STAGES * KV_BYTES;
  // fh_stage_seg of the row halves, then of each stage
  static constexpr int OFF_UNI = OFF_SEG + STAGES * BK * 4;
  static constexpr int OFF_BAR = OFF_UNI + 32;
  static constexpr int SMEM = OFF_BAR + (1 + 2 * STAGES) * 8 + 1024;
  // WIDE: consumer 1's float32 partial dq, over the ring once it is done
  static_assert(!WIDE || BM * D * 4 <= 2 * STAGES * KV_BYTES, "dq sum");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int D>
struct DkvTiles {
  static constexpr bool WIDE = D > 128;
  static constexpr int BN = WIDE ? 64 : 128;   // key rows per block
  static constexpr int BQ = 64;                // query rows per ring stage
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BN * D * 2;  // resident K or V
  static constexpr int Q_BYTES = BQ * D * 2;   // one Q or dO stage
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_G = OFF_Q + STAGES * Q_BYTES;
  // per stage: BQ values each of lse * log2(e), delta, segment id
  static constexpr int OFF_VEC = OFF_G + STAGES * Q_BYTES;
  // fh_stage_seg of the row halves, then of each stage
  static constexpr int OFF_UNI = OFF_VEC + STAGES * 3 * BQ * 4;
  static constexpr int OFF_BAR = OFF_UNI + 32;
  static constexpr int SMEM = OFF_BAR + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

template <int D, bool SEG>
__global__ void __launch_bounds__(FH_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ seg,
                          __nv_bfloat16* __restrict__ dq, int s_len, int d,
                          int h, int causal, float scale, float scale_log2) {
  using L = DqTiles<D>;
  constexpr int BM = L::BM, BK = L::BK, ST = L::STAGES;
  constexpr bool WIDE = L::WIDE;
  extern __shared__ unsigned char fh_raw[];
  unsigned char* sm = fh_align1024(fh_raw);
  int* sseg = reinterpret_cast<int*>(sm + L::OFF_SEG);
  int* suni = reinterpret_cast<int*>(sm + L::OFF_UNI);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int n_kt = causal ? (min(q0 + BM, s_len) + BK - 1) / BK
                          : (s_len + BK - 1) / BK;
  const int* segb = SEG ? seg + (size_t)(bh / h) * s_len : nullptr;
  // WIDE: each stage is read by the one consumer whose turn it is
  fh_init_barriers<ST>(bar_q, WIDE ? 128 : 256);

  if (threadIdx.x < 128) {  // producer
    fh_producer_regs();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (SEG)
      for (int half = 0; half < BM / 64; ++half) {
        const int u =
            fh_stage_seg(nullptr, segb, q0 + 64 * half, 64, s_len, lane);
        if (lane == 0) suni[half] = u;
      }
    if (lane == 0) {
      mbar_arrive_tx(bar_q, 2 * L::Q_BYTES);
      tma_tile<BM, D>(sm, &tq, bar_q, q0, bh);
      tma_tile<BM, D>(sm + L::OFF_G, &tg, bar_q, q0, bh);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % ST, k0 = kt * BK;
      if (kt >= ST) mbar_wait(&empty[st], (kt / ST - 1) & 1);
      if (SEG) {
        const int u = fh_stage_seg(sseg + st * BK, segb, k0, BK, s_len, lane);
        if (lane == 0) suni[2 + st] = u;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[st], 2 * L::KV_BYTES);
        tma_tile<BK, D>(sm + L::OFF_K + st * L::KV_BYTES, &tk, &full[st],
                        k0, bh);
        tma_tile<BK, D>(sm + L::OFF_V + st * L::KV_BYTES, &tv, &full[st],
                        k0, bh);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  fh_consumer_regs();
  const int c = threadIdx.x / 128 - 1;
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = WIDE ? 0 : 64 * c;  // the consumer's rows in the block
  const int r0 = q0 + row;
  const int gq0 = r0 + 16 * w + g, gq1 = gq0 + 8;
  const size_t rbase = (size_t)bh * s_len;
  const float ls0 = gq0 < s_len ? lse[rbase + gq0] * FH_LOG2E : 0.f;
  const float ls1 = gq1 < s_len ? lse[rbase + gq1] * FH_LOG2E : 0.f;
  const float dl0 = gq0 < s_len ? delta[rbase + gq0] : 0.f;
  const float dl1 = gq1 < s_len ? delta[rbase + gq1] : 0.f;
  const int sq0 = SEG && gq0 < s_len ? segb[gq0] : 0;
  const int sq1 = SEG && gq1 < s_len ? segb[gq1] : 0;
  const uint32_t s_q = smem_u32(sm), s_g = smem_u32(sm + L::OFF_G);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);
  const int urow = SEG ? suni[row / 64] : 0;  // the rows' one segment, or -1
  // WIDE: consumer c takes key tiles c, c + 2, ..., all in ring stage c
  for (int kt = WIDE ? c : 0; kt < n_kt; kt += WIDE ? 2 : 1) {
    const int st = kt % ST, k0 = kt * BK;
    const uint32_t s_k = smem_u32(sm + L::OFF_K + st * L::KV_BYTES);
    const uint32_t s_v = smem_u32(sm + L::OFF_V + st * L::KV_BYTES);
    mbar_wait(&full[st], (kt / ST) & 1);
    float sc[BK / 2], dp[BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<BK>(sc, wg_kmajor<BM>(s_q, row, kk), wg_kmajor<BK>(s_k, 0, kk),
                kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<BK>(dp, wg_kmajor<BM>(s_g, row, kk), wg_kmajor<BK>(s_v, 0, kk),
                kk > 0);
    wg_commit();
    wg_wait_all();
    wg_fence_acc<BK / 2>(sc);
    wg_fence_acc<BK / 2>(dp);

#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
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
        if (!ok) sc[i] = FA_NEG_INF;
      }
    }
    // ds in place of dP
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const bool hi = (i & 2) != 0;
      const float p = fh_exp2(sc[i] - (hi ? ls1 : ls0));
      dp[i] = p * (dp[i] - (hi ? dl1 : dl0)) * scale;
    }
    // dq += ds K: ds (bf16) from the registers, K MN-major
    uint32_t sa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wg_acc_to_a(sa[j], dp, j);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wg_rs_cols<D, BK>(acc, sa[j], s_k, j);
    wg_commit();
    wg_wait_all();
    wg_fence_acc<D / 2>(acc);
    mbar_arrive(&empty[st]);
  }

  if constexpr (WIDE) {
    // dq = consumer 0's sum + consumer 1's, through the ring, which no
    // load or product reads once both consumers are past their tiles
    float* part = reinterpret_cast<float*>(sm + L::OFF_K);
    const int ct = threadIdx.x & 127;
    fh_named_sync(1, 256);
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) part[i * 128 + ct] = acc[i];
    }
    fh_named_sync(1, 256);
    if (c == 1) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += part[i * 128 + ct];
  }
  const size_t base = rbase * d;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n * 8 >= d) break;  // TMA's zero columns past d
    const int col = n * 8 + 2 * t;
    if (gq0 < s_len)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)gq0 * d + col) =
          pack_f32(acc[4 * n], acc[4 * n + 1]);
    if (gq1 < s_len)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)gq1 * d + col) =
          pack_f32(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// The dk/dv producer: K and V of the block's BN key rows once, then the
// 64-row Q and dO tiles of every live q-tile with their lse * log2(e),
// delta and segment ids, through the ring.
template <int D, bool SEG>
__device__ __forceinline__ void fb_dkv_produce(
    unsigned char* sm, const CUtensorMap* tq, const CUtensorMap* tg,
    const CUtensorMap* tk, const CUtensorMap* tv, const float* lse,
    const float* delta, const int* segb, int bh, int k0, int q_first,
    int n_it, int s_len, int lane) {
  using L = DkvTiles<D>;
  constexpr int BN = L::BN, BQ = L::BQ, ST = L::STAGES;
  float* svec = reinterpret_cast<float*>(sm + L::OFF_VEC);
  int* suni = reinterpret_cast<int*>(sm + L::OFF_UNI);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + ST;
  const size_t rbase = (size_t)bh * s_len;
  if (SEG)
    for (int half = 0; half < BN / 64; ++half) {
      const int u = fh_stage_seg(nullptr, segb, k0 + 64 * half, 64, s_len,
                                 lane);
      if (lane == 0) suni[half] = u;
    }
  if (lane == 0) {
    mbar_arrive_tx(bar_kv, 2 * L::KV_BYTES);
    tma_tile<BN, D>(sm, tk, bar_kv, k0, bh);
    tma_tile<BN, D>(sm + L::OFF_V, tv, bar_kv, k0, bh);
  }
  for (int it = 0; it < n_it; ++it) {
    const int st = it % ST, q0 = (q_first + it) * BQ;
    if (it >= ST) mbar_wait(&empty[st], (it / ST - 1) & 1);
    float* vec = svec + st * 3 * BQ;
    for (int r = lane; r < BQ; r += 32) {
      const bool ok = q0 + r < s_len;
      vec[r] = ok ? lse[rbase + q0 + r] * FH_LOG2E : 0.f;
      vec[BQ + r] = ok ? delta[rbase + q0 + r] : 0.f;
    }
    if (SEG) {
      const int u = fh_stage_seg(reinterpret_cast<int*>(vec) + 2 * BQ, segb,
                                 q0, BQ, s_len, lane);
      if (lane == 0) suni[2 + st] = u;
    }
    if (lane == 0) {
      mbar_arrive_tx(&full[st], 2 * L::Q_BYTES);
      tma_tile<BQ, D>(sm + L::OFF_Q + st * L::Q_BYTES, tq, &full[st], q0,
                      bh);
      tma_tile<BQ, D>(sm + L::OFF_G + st * L::Q_BYTES, tg, &full[st], q0,
                      bh);
    } else {
      mbar_arrive(&full[st]);
    }
  }
}

// S^T (k rows gk0, gk1 of the thread, the stage's 64 q columns from q0)
// to the exp2 domain and masked where the tile needs it: rows `urow`
// share one nonzero segment (else -1), the stage's columns `ucol`.
template <bool SEG>
__device__ __forceinline__ void fb_mask_st(float* sc, float scale_log2,
                                           int q0, int kr0, int gk0,
                                           int gk1, int sk0, int sk1,
                                           const int* vs, int urow, int ucol,
                                           int s_len, int causal, int t) {
  constexpr int BQ = 64;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sc[i] *= scale_log2;
  const bool seg_mask = SEG && !(urow > 0 && ucol == urow);
  if (seg_mask || q0 + BQ > s_len || (causal && kr0 + 63 > q0)) {
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int qc = 8 * (i >> 2) + 2 * t + (i & 1), gq = q0 + qc;
      const bool hi = (i & 2) != 0;
      const int gk = hi ? gk1 : gk0;
      bool ok = gq < s_len && (!causal || gk <= gq);
      if (SEG) {
        const int sk = hi ? sk1 : sk0;
        ok = ok && ((vs[qc] == sk && sk != 0) || gq == gk);
      }
      if (!ok) sc[i] = FA_NEG_INF;
    }
  }
}

// rows gk0, gk1 of a 64 x D float32 accumulator into columns [0, d) of
// a (bh, s, d) bf16 output at `base`
template <int D>
__device__ __forceinline__ void fb_store_rows(__nv_bfloat16* out,
                                              const float* acc, size_t base,
                                              int gk0, int gk1, int s_len,
                                              int d, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n * 8 >= d) break;  // TMA's zero columns past d
    const int col = n * 8 + 2 * t;
    if (gk0 < s_len)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)gk0 * d + col) =
          pack_f32(acc[4 * n], acc[4 * n + 1]);
    if (gk1 < s_len)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)gk1 * d + col) =
          pack_f32(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// dk/dv up to 128 columns: consumer c owns k rows 64c .. 64c + 63 of the
// block's 128 and both of their accumulators
template <int D, bool SEG>
__global__ void __launch_bounds__(FH_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ seg,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int s_len, int d,
                           int h, int causal, float scale,
                           float scale_log2) {
  using L = DkvTiles<D>;
  static_assert(!L::WIDE, "the wide dk/dv kernel takes D > 128");
  constexpr int BN = L::BN, BQ = L::BQ, ST = L::STAGES;
  extern __shared__ unsigned char fh_raw[];
  unsigned char* sm = fh_align1024(fh_raw);
  const float* svec = reinterpret_cast<const float*>(sm + L::OFF_VEC);
  const int* suni = reinterpret_cast<const int*>(sm + L::OFF_UNI);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + ST;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;  // the longest causal columns first
  const int q_first = causal ? k0 / BQ : 0;
  const int n_it = (s_len + BQ - 1) / BQ - q_first;
  const int* segb = SEG ? seg + (size_t)(bh / h) * s_len : nullptr;
  fh_init_barriers<ST>(bar_kv);

  if (threadIdx.x < 128) {  // producer
    fh_producer_regs();
    if (threadIdx.x >= 32) return;
    fb_dkv_produce<D, SEG>(sm, &tq, &tg, &tk, &tv, lse, delta, segb, bh, k0,
                           q_first, n_it, s_len, threadIdx.x);
    return;
  }

  fh_consumer_regs();
  const int c = threadIdx.x / 128 - 1;
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + 64 * c;
  const int gk0 = kr0 + 16 * w + g, gk1 = gk0 + 8;
  const int sk0 = SEG && gk0 < s_len ? segb[gk0] : 0;
  const int sk1 = SEG && gk1 < s_len ? segb[gk1] : 0;
  const uint32_t s_k = smem_u32(sm), s_v = smem_u32(sm + L::OFF_V);
  float ak[D / 2], av[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;
  mbar_wait(bar_kv, 0);
  const int urow = SEG ? suni[c] : 0;  // the rows' one segment, or -1
  for (int it = 0; it < n_it; ++it) {
    const int st = it % ST, q0 = (q_first + it) * BQ;
    const uint32_t s_qt = smem_u32(sm + L::OFF_Q + st * L::Q_BYTES);
    const uint32_t s_g = smem_u32(sm + L::OFF_G + st * L::Q_BYTES);
    const float* vl = svec + st * 3 * BQ;  // lse * log2(e) by q column
    const float* vd = vl + BQ;             // delta
    const int* vs = reinterpret_cast<const int*>(vl + 2 * BQ);
    mbar_wait(&full[st], (it / ST) & 1);
    float sc[BQ / 2], dp[BQ / 2];  // S^T and dP^T: k rows, q columns
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<BQ>(sc, wg_kmajor<BN>(s_k, 64 * c, kk),
                wg_kmajor<BQ>(s_qt, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<BQ>(dp, wg_kmajor<BN>(s_v, 64 * c, kk),
                wg_kmajor<BQ>(s_g, 0, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    wg_fence_acc<BQ / 2>(sc);
    wg_fence_acc<BQ / 2>(dp);
    fb_mask_st<SEG>(sc, scale_log2, q0, kr0, gk0, gk1, sk0, sk1, vs, urow,
                    SEG ? suni[2 + st] : 0, s_len, causal, t);
    // p^T in place of S^T, ds^T in place of dP^T
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
      const float p = fh_exp2(sc[i] - vl[qc]);
      sc[i] = p;
      dp[i] = p * (dp[i] - vd[qc]) * scale;
    }
    // dv += p^T dO, dk += ds^T Q: register A operands, dO / Q MN-major
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      wg_acc_to_a(pa[j], sc, j);
      wg_acc_to_a(sa[j], dp, j);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) wg_rs_cols<D, BQ>(av, pa[j], s_g, j);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) wg_rs_cols<D, BQ>(ak, sa[j], s_qt, j);
    wg_commit();
    wg_wait_all();
    wg_fence_acc<D / 2>(av);
    wg_fence_acc<D / 2>(ak);
    mbar_arrive(&empty[st]);
  }
  const size_t base = (size_t)bh * s_len * d;
  fb_store_rows<D>(dk, ak, base, gk0, gk1, s_len, d, t);
  fb_store_rows<D>(dv, av, base, gk0, gk1, s_len, d, t);
}

// dk/dv above 128 columns: both consumers on the block's 64 k rows,
// consumer 0 forms p^T and dv, consumer 1 ds^T and dk (one 64 x D
// accumulator each)
template <int D, bool SEG>
__global__ void __launch_bounds__(FH_THREADS, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ seg,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int s_len, int d,
                          int h, int causal, float scale,
                          float scale_log2) {
  using L = DkvTiles<D>;
  static_assert(L::WIDE && L::BN == 64, "the wide dk/dv kernel");
  constexpr int BN = L::BN, BQ = L::BQ, ST = L::STAGES;
  extern __shared__ unsigned char fh_raw[];
  unsigned char* sm = fh_align1024(fh_raw);
  const float* svec = reinterpret_cast<const float*>(sm + L::OFF_VEC);
  const int* suni = reinterpret_cast<const int*>(sm + L::OFF_UNI);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + ST;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;  // the longest causal columns first
  const int q_first = causal ? k0 / BQ : 0;
  const int n_it = (s_len + BQ - 1) / BQ - q_first;
  const int* segb = SEG ? seg + (size_t)(bh / h) * s_len : nullptr;
  fh_init_barriers<ST>(bar_kv);

  if (threadIdx.x < 128) {  // producer
    fh_producer_regs();
    if (threadIdx.x >= 32) return;
    fb_dkv_produce<D, SEG>(sm, &tq, &tg, &tk, &tv, lse, delta, segb, bh, k0,
                           q_first, n_it, s_len, threadIdx.x);
    return;
  }

  fh_consumer_regs();
  const int c = threadIdx.x / 128 - 1;  // 0: dv, 1: dk
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int gk0 = k0 + 16 * w + g, gk1 = gk0 + 8;
  const int sk0 = SEG && gk0 < s_len ? segb[gk0] : 0;
  const int sk1 = SEG && gk1 < s_len ? segb[gk1] : 0;
  const uint32_t s_k = smem_u32(sm), s_v = smem_u32(sm + L::OFF_V);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_kv, 0);
  const int urow = SEG ? suni[0] : 0;  // the rows' one segment, or -1
  for (int it = 0; it < n_it; ++it) {
    const int st = it % ST, q0 = (q_first + it) * BQ;
    const uint32_t s_qt = smem_u32(sm + L::OFF_Q + st * L::Q_BYTES);
    const uint32_t s_g = smem_u32(sm + L::OFF_G + st * L::Q_BYTES);
    const float* vl = svec + st * 3 * BQ;  // lse * log2(e) by q column
    const float* vd = vl + BQ;             // delta
    const int* vs = reinterpret_cast<const int*>(vl + 2 * BQ);
    mbar_wait(&full[st], (it / ST) & 1);
    float sc[BQ / 2], dp[BQ / 2];  // S^T and dP^T: k rows, q columns
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<BQ>(sc, wg_kmajor<BN>(s_k, 0, kk), wg_kmajor<BQ>(s_qt, 0, kk),
                kk > 0);
    if (c == 1) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg_ss<BQ>(dp, wg_kmajor<BN>(s_v, 0, kk), wg_kmajor<BQ>(s_g, 0, kk),
                  kk > 0);
    }
    wg_commit();
    wg_wait_all();
    wg_fence_acc<BQ / 2>(sc);
    wg_fence_acc<BQ / 2>(dp);
    fb_mask_st<SEG>(sc, scale_log2, q0, k0, gk0, gk1, sk0, sk1, vs, urow,
                    SEG ? suni[2 + st] : 0, s_len, causal, t);
    // p^T (consumer 0) or ds^T (consumer 1) in place of S^T
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
        sc[i] = fh_exp2(sc[i] - vl[qc]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
        const float p = fh_exp2(sc[i] - vl[qc]);
        sc[i] = p * (dp[i] - vd[qc]) * scale;
      }
    }
    // dv += p^T dO or dk += ds^T Q: the register A operand, dO / Q
    // MN-major
    uint32_t fa[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) wg_acc_to_a(fa[j], sc, j);
    const uint32_t s_b = c == 0 ? s_g : s_qt;
    wg_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) wg_rs_cols<D, BQ>(acc, fa[j], s_b, j);
    wg_commit();
    wg_wait_all();
    wg_fence_acc<D / 2>(acc);
    mbar_arrive(&empty[st]);
  }
  fb_store_rows<D>(c == 0 ? dv : dk, acc, (size_t)bh * s_len * d, gk0, gk1,
                   s_len, d, t);
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
cudaError_t fb_launch_wgmma(const BwdArgs& a) {
  using bf = __nv_bfloat16;
  using Q = DqTiles<D>;
  using KV = DkvTiles<D>;
  // the dq kernel's resident Q / dO and streamed K / V tiles, and the
  // dk/dv kernel's resident K / V and streamed Q / dO tiles
  CUtensorMap q_dq, g_dq, k_dq, v_dq, q_kv, g_kv, k_kv, v_kv;
  const struct {
    CUtensorMap* map;
    const void* base;
    int rows;
  } maps[] = {{&q_dq, a.q, Q::BM},   {&g_dq, a.dout, Q::BM},
              {&k_dq, a.k, Q::BK},   {&v_dq, a.v, Q::BK},
              {&q_kv, a.q, KV::BQ},  {&g_kv, a.dout, KV::BQ},
              {&k_kv, a.k, KV::BN},  {&v_kv, a.v, KV::BN}};
  for (const auto& m : maps)
    if (!fh_tensor_map(m.map, m.base, a.bh, a.s, a.d, m.rows))
      return cudaErrorInvalidValue;
  auto kdq = flash_bwd_dq_wgmma_kernel<D, SEG>;
  auto kdkv = [] {
    if constexpr (KV::WIDE) return flash_bwd_dkv_wide_kernel<D, SEG>;
    else return flash_bwd_dkv_wgmma_kernel<D, SEG>;
  }();
  static const cudaError_t ready_dq = fh_prepare(kdq, Q::SMEM);
  static const cudaError_t ready_dkv = fh_prepare(kdkv, KV::SMEM);
  if (ready_dq != cudaSuccess) return ready_dq;
  if (ready_dkv != cudaSuccess) return ready_dkv;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const float sl2 = a.scale * FH_LOG2E;
  kdq<<<dim3(a.bh, (a.s + Q::BM - 1) / Q::BM), FH_THREADS, Q::SMEM,
        a.stream>>>(q_dq, g_dq, k_dq, v_dq, lse, delta, a.seg,
                    static_cast<bf*>(a.dq), a.s, a.d, a.h, a.causal,
                    a.scale, sl2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<dim3(a.bh, (a.s + KV::BN - 1) / KV::BN), FH_THREADS, KV::SMEM,
         a.stream>>>(q_kv, g_kv, k_kv, v_kv, lse, delta, a.seg,
                     static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.s,
                     a.d, a.h, a.causal, a.scale, sl2);
  return cudaGetLastError();
}

template <int DCH, bool SEG, int R>
cudaError_t fb_launch_simt(const BwdArgs& a) {
  const dim3 grid((a.s + R - 1) / R, a.bh);
  auto kdq = flash_bwd_dq_kernel<DCH, SEG, R>;
  auto kdkv = flash_bwd_dkv_kernel<DCH, SEG, R>;
  const size_t smem_dq = fb_smem_dq(a.d, R), smem_dkv = fb_smem_dkv(a.d, R);
  cudaError_t err = cxn_allow_smem(kdq, smem_dq);
  if (err == cudaSuccess) err = cxn_allow_smem(kdkv, smem_dkv);
  if (err != cudaSuccess) return err;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  kdq<<<grid, FB_THREADS, smem_dq, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      lse, delta, a.seg, static_cast<float*>(a.dq), a.s, a.d, a.h, a.causal,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<grid, FB_THREADS, smem_dkv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      lse, delta, a.seg, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.s, a.d, a.h, a.causal, a.scale);
  return cudaGetLastError();
}

template <bool SEG>
cudaError_t fb_dispatch(const BwdArgs& a, int dtype) {
  if (dtype == CXN_BF16) {  // fa_route: FA_ROUTE_WGMMA at every width
    if (a.d <= 64) return fb_launch_wgmma<64, SEG>(a);
    if (a.d <= 128) return fb_launch_wgmma<128, SEG>(a);
    if (a.d <= 192) return fb_launch_wgmma<192, SEG>(a);
    return fb_launch_wgmma<256, SEG>(a);
  }
  // float32 on the CUDA cores: 64-row tiles up to 128 columns, 32-row
  // tiles above (four (R, d + 1) float32 tiles must fit in shared memory)
  if (a.d > 128) return fb_launch_simt<8, SEG, 32>(a);
  if (a.d <= 32) return fb_launch_simt<1, SEG, 64>(a);
  if (a.d <= 64) return fb_launch_simt<2, SEG, 64>(a);
  return fb_launch_simt<4, SEG, 64>(a);
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
      d > 256 || d % 8 != 0 || (dtype != CXN_BF16 && dtype != CXN_F32))
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
