// Hopper pieces of the bf16 flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): TMA tensor maps, mbarriers, warpgroup register
// hand-over (setmaxnreg) and the wgmma products.
//
// Tiles in shared memory.  A tile of R rows x D bf16 columns (D a
// multiple of 64) is D / 64 column blocks of R rows x 128 bytes, each
// written by one TMA box {64 columns, R rows} in the 128-byte swizzle:
// the 16-byte chunk c of row r lands at chunk c ^ (r % 8).  Blocks start
// 1024-byte aligned, so a wgmma descriptor in the same swizzle mode reads
// them back (base offset 0).  Rows past s and columns past d arrive as
// zeros (TMA's out-of-bounds fill); the kernels mask such keys, since a
// zero row scores 0, not NEG_INF.
//
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled,
// taken through cudaGetDriverEntryPointByVersion, so the library links
// no libcuda; kernels take them as `const __grid_constant__ CUtensorMap`.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "flash_common.cuh"

constexpr int FH_COLS = 64;        // bf16 columns of one 128-byte row
constexpr int FH_THREADS = 384;    // producer + two consumer warpgroups
constexpr int FH_PRODUCER_REGS = 24;
constexpr int FH_CONSUMER_REGS = 240;
constexpr float FH_LOG2E = 1.4426950408889634f;
constexpr float FH_LN2 = 0.6931471805599453f;

// ------------------------------------------------------------ host side
typedef CUresult (*FhEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static FhEncodeTiled fh_encode_fn() {
  static FhEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<FhEncodeTiled>(p);
  }
  return fn;
}

// The map of a (bh, s, d) bf16 tensor read in boxes of {64 columns,
// `rows` rows, one b*h slice}, 128-byte swizzle, zero fill out of bounds.
static bool fh_tensor_map(CUtensorMap* map, const void* base, int bh, int s,
                          int d, int rows) {
  FhEncodeTiled encode = fh_encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)FH_COLS, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Refuse to launch a warp-specialised kernel that ptxas compiled with
// fewer registers than the consumers' setmaxnreg asks for (they would
// wait for registers forever), and opt it into its shared memory.
template <typename K>
static cudaError_t fh_prepare(K kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * FH_THREADS <
      FH_PRODUCER_REGS * 128 + FH_CONSUMER_REGS * 256)
    return cudaErrorInvalidConfiguration;
  return cxn_allow_smem(kernel, smem);
}

// ---------------------------------------------------------- device side
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address of dynamic shared memory (the
// launch asks for 1 KB of slack)
__device__ __forceinline__ unsigned char* fh_align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void fh_producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
               :: "n"(FH_PRODUCER_REGS));
}
__device__ __forceinline__ void fh_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(FH_CONSUMER_REGS));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// arrive and announce `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// Barriers at `bars`: one for the tiles loaded once (the producer's lane
// 0 and their TMA bytes), then per ring stage `full` (the producer
// warp's 32 lanes and the stage's TMA bytes) and `empty` (every thread
// of the `readers` consumers that read the stage, after its products on
// the stage have completed).
template <int ST>
__device__ __forceinline__ void fh_init_barriers(uint64_t* bars,
                                                 int readers = 256) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(bars + 1 + i, 32);
      mbar_init(bars + 1 + ST + i, readers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Segment ids of rows row0 .. row0 + n - 1 (0 past s_len) into dst (when
// not null), by the producer warp's lanes; every lane returns the id
// they all share, or -1 when they differ.  A tile whose keys all share
// the query rows' one nonzero id needs no segment mask.
__device__ __forceinline__ int fh_stage_seg(int* dst, const int* segb,
                                            int row0, int n, int s_len,
                                            int lane) {
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int r = lane; r < n; r += 32) {
    const int v = row0 + r < s_len ? segb[row0 + r] : 0;
    if (dst != nullptr) dst[r] = v;
    lo = min(lo, v);
    hi = max(hi, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  return lo == hi ? lo : -1;
}

// one TMA box at (column c0, row c1, slice c2) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows row0.. of a tile of R rows x D columns: D / 64 boxes
template <int R, int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int cb = 0; cb < D / FH_COLS; ++cb)
    tma_load(dst + cb * R * 128, map, bar, cb * FH_COLS, row0, bh);
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// Operand of k-step kk (16 columns) of a K-major tile of R rows from
// `tile`, starting at row `row0` (a multiple of 8): the reduction axis is
// the tile's columns.  Rows go in groups of 8 at 1024 bytes; the k-step
// is a 32-byte offset inside the swizzled 128-byte row.
template <int R>
__device__ __forceinline__ uint64_t wg_kmajor(uint32_t tile, int row0,
                                              int kk) {
  return wg_desc(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32,
                 16, 1024);
}

// B operand of k-step j (rows 16j..16j+15 of the reduction axis) of an
// MN-major tile of R rows: the product's columns are the tile's columns,
// in 64-column blocks R * 128 bytes apart (LBO); 8-row groups 1024 bytes
// apart (SBO).
template <int R>
__device__ __forceinline__ uint64_t wg_mnmajor(uint32_t tile, int j) {
  return wg_desc(tile + j * 2048, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most the last committed group is in flight
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void wg_fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float fh_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64) = A . B (+ d when accumulate), A and B through
// descriptors of K-major tiles
__device__ __forceinline__ void wg_ss_n64(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) = A . B (+ d when accumulate), A and B through
// descriptors of K-major tiles
__device__ __forceinline__ void wg_ss_n128(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A . B, A (64 x 16) from registers, B through the
// descriptor of an MN-major tile
__device__ __forceinline__ void wg_rs_t_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A . B, A (64 x 16) from registers, B through the
// descriptor of an MN-major tile
__device__ __forceinline__ void wg_rs_t_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wg_ss(float* d, uint64_t da, uint64_t db,
                                      int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wg_ss_n64(d, da, db, accumulate);
  else wg_ss_n128(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void wg_rs_t(float* d, const uint32_t* a,
                                        uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wg_rs_t_n64(d, a, db);
  else wg_rs_t_n128(d, a, db);
}

// d (64 x D) += A . B, A (64 x 16) from registers, B k-step j of an
// MN-major tile of R rows and D columns at `tile`: one wgmma up to 128
// columns, wider in pieces of 128 (and a last one of 64) columns, each
// piece's 64-column blocks R * 128 bytes on from the last.
template <int D, int R>
__device__ __forceinline__ void wg_rs_cols(float* d, const uint32_t* a,
                                           uint32_t tile, int j) {
  static_assert(D % 64 == 0 && D <= 256, "wgmma columns");
  if constexpr (D <= 128) {
    wg_rs_t<D>(d, a, wg_mnmajor<R>(tile, j));
  } else {
    wg_rs_t<128>(d, a, wg_mnmajor<R>(tile, j));
    wg_rs_cols<D - 128, R>(d + 64, a, tile + 2 * R * 128, j);
  }
}

// bar.sync on named barrier `id` (1..15) by `threads` threads (a
// multiple of 32), leaving barrier 0 (__syncthreads) to the block
__device__ __forceinline__ void fh_named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The A operand of k-step j (16 columns) of a product whose left factor
// is an accumulator of m64nN: its n8 tiles 2j and 2j+1, rounded to bf16.
__device__ __forceinline__ void wg_acc_to_a(uint32_t* a, const float* acc,
                                            int j) {
  tc_frag_acc(a, acc + 8 * j, acc + 8 * j + 4);
}
