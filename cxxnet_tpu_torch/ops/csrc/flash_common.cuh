// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu; conv_wgrad.cu takes the mma.sync helpers): the mask
// rule, warp reductions, the bf16 tensor-core helpers (mma.sync
// m16n8k16 and its operand packing; tc_frag_acc packs wgmma
// accumulators, whose rows of a warp share its layout) and the route a
// flash call takes.
#pragma once

#include <stdint.h>

#include "common.cuh"

constexpr float FA_NEG_INF = -1e30f;

// The mask of the JAX package (`_causal_mask`, then `_segment_mask`):
// a score (gq, gk) is live when both positions exist, it is causal, and
// under segment ids (SEG) the two share a non-padding segment or sit on
// the diagonal.  The diagonal stays live, so no existing row is ever
// fully masked (the online softmax keeps l > 0).
template <bool SEG>
__device__ __forceinline__ bool fa_allowed(int gq, int gk, int s_len,
                                           int causal, int segq, int segk) {
  bool ok = gq < s_len && gk < s_len && (!causal || gk <= gq);
  if (SEG) ok = ok && ((segq == segk && segq != 0) || gq == gk);
  return ok;
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

// c += a . b for one m16n8k16 tile, bf16 in, float32 accumulate.
// Operand layouts (g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                a3 = A[g+8][2t+8..]
//   B (16 x 8):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8):  c0, c1 = C[g][2t..], c2, c3 = C[g+8][2t..]
// so the accumulators of two neighbouring n8 tiles are the A operand of
// a product over their 16 columns.
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
__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A operand (16 rows from `row0`, k-step kk) from a tile of row stride LD
template <int LD>
__device__ __forceinline__ void tc_frag_a(uint32_t* a,
                                          const __nv_bfloat16* tile,
                                          int row0, int kk, int t) {
  const __nv_bfloat16* p = tile + row0 * LD + kk * 16 + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * LD);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * LD + 8);
}

// B operand B[k][n] = tile[n8 * 8 + n][kk * 16 + k]: the tile's rows
// are the product's columns (scores q.k^T: B = K^T)
template <int LD>
__device__ __forceinline__ void tc_frag_bt(uint32_t* b,
                                           const __nv_bfloat16* tile,
                                           int n8, int kk, int g, int t) {
  const __nv_bfloat16* p = tile + (n8 * 8 + g) * LD + kk * 16 + 2 * t;
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// A operand of k-step j from the accumulators of n8 tiles 2j and 2j+1
__device__ __forceinline__ void tc_frag_acc(uint32_t* a, const float* lo,
                                            const float* hi) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// 64 segment ids from `row0` (0 past s_len) into shared memory
__device__ __forceinline__ void fa_load_seg(int* dst, const int* segb,
                                            int row0, int s_len) {
  for (int r = threadIdx.x; r < 64; r += blockDim.x)
    dst[r] = row0 + r < s_len ? segb[row0 + r] : 0;
}

// The kernel a call takes (cxn_flash_attn_route): float32 on the CUDA
// cores; bf16, forward and backward, through wgmma at every head width.
enum FaRoute { FA_ROUTE_SIMT = 0, FA_ROUTE_WGMMA = 1 };
inline int fa_route(int dtype) {
  return dtype == CXN_BF16 ? FA_ROUTE_WGMMA : FA_ROUTE_SIMT;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}
