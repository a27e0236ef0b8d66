// Hopper (sm_90a) building blocks of the attention kernels that run on
// wgmma, TMA and mbarriers: the packed forwards K1 (flash_fwd.cu
// `flash_fwd_sm90_kernel`) and K5 (flash_fwd_proj.cu), the packed backward K2
// (flash_bwd.cu `flash_bwd_dkv_sm90_kernel`, `flash_bwd_dq_sm90_kernel`), the
// ring step K6 at Dh 128 (ring_attention.cu `ring_step_sm90_kernel`), and the
// [B, H, L, Dh] entry's long calls at Dh 64 and 128 (K3 `flash_long_fwd_kernel`,
// K4 `flash_long_bwd_dkv_kernel`, `flash_long_bwd_dq_kernel`); and the
// bf16 kernels at head dims 256 to 512 (flash_fwd.cu
// `flash_fwd_wide_sm90_kernel`, K1 and K3; flash_fwd_proj.cu
// `flash_fwd_proj_wide_sm90_kernel`, K5; flash_bwd.cu
// `flash_bwd_dkv_wide_sm90_kernel`, `flash_bwd_dq_wide_sm90_kernel`, K2 and K4).
//
//   - host: TMA tensor maps for one head's [L, D] rows (D = 64 to 512) of a
//     strided [B, L, H, D] or [B, H, L, D] operand, and for a row-major 2-D
//     matrix, encoded through cuTensorMapEncodeTiled, which the runtime
//     hands out (cudaGetDriverEntryPoint: the library links no libcuda);
//   - device: mbarrier, TMA (cp.async.bulk.tensor), plain bulk copy, wgmma
//     and fence wrappers in inline PTX, the wgmma shared-memory descriptor
//     for the 128-byte swizzle, rotate-half RoPE of a swizzled q tile in
//     place, the producer's K/V tile loop and the consumer warpgroup's
//     attention loop over one head's keys (`sm90_attend`), from an empty
//     state or from one the caller carries (the ring step), and the key
//     extent of a q tile (`key_extent`, `visit_keys`): how far into the keys
//     the tile must look, so that key tiles past each row's last real key
//     are skipped.
//
// Layout. Every tile in shared memory is a stack of "boxes" of R rows x 64
// bf16 values (128 bytes a row) in the 128-byte swizzle that TMA writes and
// wgmma reads: the 16-byte chunk c of row r sits at chunk c ^ (r % 8). A
// D-wide row (Dh) is D / 64 boxes, box i holding columns 64 i .. 64 i + 63
// (a 128-wide row two, a 64-wide row one). Boxes start on 1024-byte
// boundaries. Operands whose rows are the
// product's output rows or columns (Q and K of S = Q K^T, K and V of the
// backward's transposed scores) are K-major (Dh contiguous); operands whose
// rows are the reduction axis (V of P V, wo, dO and Q of the backward's dV
// and dK, K of its dQ) are read MN-major, with the transpose bit of wgmma
// set.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)

#include "flash_common.cuh"

namespace {

// ---- host: tensor maps -------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// Error codes of the C entries beyond CUDA's own: the CUresult of a tensor
// map that cuTensorMapEncodeTiled could not encode, offset by this.
constexpr int TMA_ERROR_BASE = 10000;

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

// One head's rows of a bf16 operand with a contiguous head dim of D (64 to
// 512, a multiple of 64: D / 64 boxes a row) and (row, head, batch) strides
// in elements. Boxes of `box_rows` rows
// x 64 columns, 128-byte swizzle; rows past L read as zeros. The dims are
// ordered by stride (the packed layouts and the text tower's views have
// heads inside a row, the [B, H, L, D] tensors rows inside a head);
// `heads_inner` tells the kernel which order its coordinates take. Returns
// 0 or an error code.
inline int encode_head_map(CUtensorMap* map, const void* base, int L, int H, int B,
                           long long sl, long long sh, long long sb, int box_rows,
                           int* heads_inner, int D = 128) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  *heads_inner = sh < sl ? 1 : 0;
  const cuuint64_t dims_hi[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t dims_lo[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t str_hi[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint64_t str_lo[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box_hi[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t box_lo[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const bool hi = *heads_inner != 0;
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                  hi ? dims_hi : dims_lo, hi ? str_hi : str_lo, hi ? box_hi : box_lo, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ERROR_BASE + static_cast<int>(r);
}

// A row-major [rows, cols] bf16 matrix in boxes of 64 x 64, 128-byte swizzle.
inline int encode_matrix_map(CUtensorMap* map, const void* base, int rows, int cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t str[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                  str, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ERROR_BASE + static_cast<int>(r);
}

// The current device's number of SMs (a persistent grid's size).
inline cudaError_t num_sms(int* n) {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *n = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) cached[dev] = *n;
  return err;
}

// ---- device: barriers, TMA, fences -------------------------------------------

constexpr int BOX_ROW_BYTES = 128;  // 64 bf16 values, the swizzle's span

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and announce `bytes` of TMA traffic that will complete the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Announce `bytes` of TMA traffic that will complete the phase, without
// arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a pipeline fault) traps after 2^26 polls, each of which may sleep
// in try_wait: the launch then fails with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One box of a head map (encode_head_map) into shared memory at `dst`.
__device__ __forceinline__ void tma_load_head(const CUtensorMap* map, uint32_t dst,
                                              uint64_t* bar, int col, int row, int h, int b,
                                              int heads_inner) {
  const int c1 = heads_inner ? h : row;
  const int c2 = heads_inner ? row : h;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(c1), "r"(c2),
      "r"(b)
      : "memory");
}

// One 64 x 64 box of a matrix map (encode_matrix_map) at (row, col).
__device__ __forceinline__ void tma_load_matrix(const CUtensorMap* map, uint32_t dst,
                                                uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// `bytes` of device memory at `src` into shared memory at `dst` (both
// 16-byte aligned, `bytes` a multiple of 16), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Writes of the generic proxy (st.shared) made visible to the async proxy
// (wgmma operand reads) of the threads that synchronise after it.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Barrier over the 256 threads of two consumer warpgroups (id 3) that share
// their rows (the wide forwards' split 2, flash_fwd.cu and flash_fwd_proj.cu;
// the wide backward's two roles, flash_bwd.cu).
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- device: wgmma -----------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler keeps every access to them on its side of the commit/wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused; MN-major: the stride between 64-wide blocks
// along M/N) and stride byte offset (the stride between groups of 8 rows
// of 128 bytes). Adding n to it advances the start by 16 n bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory
// (descriptors), D in the accumulator layout; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A and B K-major in shared memory
// (descriptors), D in the accumulator layout; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]: as wgmma_ss_n32.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory
// (descriptors), D in the accumulator layout; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= Q K^T for a key tile of BK (16 to 128) keys: the n-BK product.
template <int BK>
__device__ __forceinline__ void wgmma_ss_keys(float (&d)[BK / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(d, da, db, accumulate);
  } else if constexpr (BK == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else if constexpr (BK == 32) {
    wgmma_ss_n32(d, da, db, accumulate);
  } else {
    static_assert(BK == 16, "key tiles of 16, 32, 64 or 128");
    wgmma_ss_n16(d, da, db, accumulate);
  }
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers (per warp, the
// m16n8k16 A-fragment layout of its 16 rows), B MN-major in shared memory
// (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (per warp, the
// m16n8k16 A-fragment layout of its 16 rows), B MN-major in shared memory
// (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x D] += A[64 x 16] B[16 x D] with A in registers and B MN-major: the
// n128 or the n64 product, by the head dim.
template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128_tb(d, a, db);
  } else {
    static_assert(D == 64, "head dims 64 and 128");
    wgmma_rs_n64_tb(d, a, db);
  }
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A K-major, B MN-major (the
// transpose bit set), both in shared memory; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A K-major, B MN-major (the
// transpose bit set), both in shared memory; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The 64-column slice j (columns 64 j ..) of an accumulator in the wgmma
// layout, as the accumulator of an n64 product (32 registers), and the
// 128-column slice j (columns 128 j ..) as that of an n128 product: the
// registers of a column block are contiguous (4 a block of 8 columns).
template <int N>
__device__ __forceinline__ float (&acc_cols64(float (&d)[N], int j))[32] {
  return *reinterpret_cast<float(*)[32]>(&d[32 * j]);
}

template <int N>
__device__ __forceinline__ float (&acc_cols128(float (&d)[N], int j))[64] {
  return *reinterpret_cast<float(*)[64]>(&d[64 * j]);
}

// ---- device: the attention of one head ------------------------------------

// Pipeline position: the stage of the ring and the parity of its phase.
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  template <int NST>
  __device__ __forceinline__ void advance() {
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Rotate-half RoPE of one 16-byte chunk of each half of a row: x1 holds
// columns d0 .. d0 + 7, x2 columns d0 + 64 .., `t` the row's sin and cos
// tables at columns d0 .. d0 + 7 and d0 + 64 .. (load_rope_tables).
// rope_pair's arithmetic and bf16 rounding points, so the result matches
// the plain version bit for bit (bf16x2 instructions, rounding each product
// and sum once, do not: they differ in the last bit of about one value in
// eight on the H100).
struct RopeTables {
  float4 s1[2], s2[2], c1[2], c2[2];  // sin d, sin d + D/2, cos d, cos d + D/2
};

template <int D = 128>
__device__ __forceinline__ void load_rope_tables(RopeTables& t, const float* sin,
                                                 const float* cos, long long pos, int d0) {
  const float4* s4 = reinterpret_cast<const float4*>(sin + pos * D + d0);
  const float4* c4 = reinterpret_cast<const float4*>(cos + pos * D + d0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t.s1[h] = __ldg(s4 + h);
    t.s2[h] = __ldg(s4 + D / 8 + h);
    t.c1[h] = __ldg(c4 + h);
    t.c2[h] = __ldg(c4 + D / 8 + h);
  }
}

__device__ __forceinline__ void rope_chunk(uint4& a, uint4& b, const RopeTables& t) {
  __nv_bfloat16* x1 = reinterpret_cast<__nv_bfloat16*>(&a);
  __nv_bfloat16* x2 = reinterpret_cast<__nv_bfloat16*>(&b);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // values 4h .. 4h + 3 of the chunk
    const float sv1[4] = {t.s1[h].x, t.s1[h].y, t.s1[h].z, t.s1[h].w};
    const float sv2[4] = {t.s2[h].x, t.s2[h].y, t.s2[h].z, t.s2[h].w};
    const float cv1[4] = {t.c1[h].x, t.c1[h].y, t.c1[h].z, t.c1[h].w};
    const float cv2[4] = {t.c2[h].x, t.c2[h].y, t.c2[h].z, t.c2[h].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * h + e;
      rope_pair(__bfloat162float(x1[k]), __bfloat162float(x2[k]), sv1[e], sv2[e], cv1[e],
                cv2[e], x1[k], x2[k]);
    }
  }
}

// Rotate-half RoPE, in place, of 64 rows of a swizzled D-wide q tile whose
// first row is token row0, by the 128 threads of one warpgroup (`tid`
// 0..127); rows at or past L stay. At D = 128 `box0` holds columns 0-63 and
// `box1` columns 64-127: column d and column d + 64 of a row sit at the same
// offset of the two boxes, so one 16-byte chunk of each holds 8 whole
// rotate-half pairs. At D = 64 the row is one box (`box1` unused): logical
// chunk c (columns 8c ..) pairs with chunk c + 4, each at its swizzled place.
template <int D = 128>
__device__ __forceinline__ void rope_q_rows(unsigned char* box0, unsigned char* box1,
                                            const float* sin, const float* cos, int row0,
                                            int L, int tid) {
  if constexpr (D == 128) {
    for (int i = tid; i < 64 * 8; i += 128) {
      const int r = i >> 3, pc = i & 7;
      if (row0 + r >= L) continue;
      const int off = r * BOX_ROW_BYTES + pc * 16;
      RopeTables t;
      load_rope_tables<128>(t, sin, cos, row0 + r, (pc ^ (r & 7)) * 8);
      uint4 a = *reinterpret_cast<const uint4*>(box0 + off);
      uint4 b = *reinterpret_cast<const uint4*>(box1 + off);
      rope_chunk(a, b, t);
      *reinterpret_cast<uint4*>(box0 + off) = a;
      *reinterpret_cast<uint4*>(box1 + off) = b;
    }
  } else {
    static_assert(D == 64, "head dims 64 and 128");
    for (int i = tid; i < 64 * 4; i += 128) {
      const int r = i >> 2, c = i & 3;
      if (row0 + r >= L) continue;
      const int oa = r * BOX_ROW_BYTES + (c ^ (r & 7)) * 16;
      const int ob = r * BOX_ROW_BYTES + ((c + 4) ^ (r & 7)) * 16;
      RopeTables t;
      load_rope_tables<64>(t, sin, cos, row0 + r, c * 8);
      uint4 a = *reinterpret_cast<const uint4*>(box0 + oa);
      uint4 b = *reinterpret_cast<const uint4*>(box0 + ob);
      rope_chunk(a, b, t);
      *reinterpret_cast<uint4*>(box0 + oa) = a;
      *reinterpret_cast<uint4*>(box0 + ob) = b;
    }
  }
}

// Rotate-half RoPE, in place, of 64 rows of a swizzled q tile of D = 256 to
// 512 columns (D / 64 boxes `box_stride` bytes apart from `box0`) whose
// first row is token row0, by `nthr` threads (`tid` 0 .. nthr - 1); rows at
// or past L stay. Column d pairs with d + D / 2: box i with box i + D / 128,
// at the same offset of the two (the box width divides D / 2), so one 16-byte
// chunk of each holds 8 whole rotate-half pairs, as at D = 128.
template <int D>
__device__ __forceinline__ void rope_q_rows_wide(unsigned char* box0, int box_stride,
                                                 const float* sin, const float* cos, int row0,
                                                 int L, int tid, int nthr) {
  constexpr int HB = D / 128;  // box pairs of a row
  static_assert(D % 128 == 0 && D >= 256, "head dims 256, 384, 512");
  for (int i = tid; i < 64 * HB * 8; i += nthr) {
    const int r = i / (HB * 8), bi = (i / 8) % HB, pc = i & 7;
    if (row0 + r >= L) continue;
    const int off = bi * box_stride + r * BOX_ROW_BYTES + pc * 16;
    RopeTables t;
    load_rope_tables<D>(t, sin, cos, row0 + r, 64 * bi + (pc ^ (r & 7)) * 8);
    uint4 a = *reinterpret_cast<const uint4*>(box0 + off);
    uint4 b = *reinterpret_cast<const uint4*>(box0 + off + HB * box_stride);
    rope_chunk(a, b, t);
    *reinterpret_cast<uint4*>(box0 + off) = a;
    *reinterpret_cast<uint4*>(box0 + off + HB * box_stride) = b;
  }
}

// ---- the key extent: which key tiles a q tile must visit --------------------
//
// A key that a row cannot attend (masked, or after the row under causal
// masking) scores -FLT_MAX. Once the row's running maximum m is that of a
// real key (finite, far above -FLT_MAX), such a key's exp2(-FLT_MAX - m) is
// 0 and the rescale exp2(m - m) is 1, so visiting a tile of such keys leaves
// (m, l, acc) and every gradient sum bit for bit as they were: the tile may
// be skipped. Keys past a row's last real key come after every real one, so
// a q tile stops at the extent below, when each of its rows has a real key.
// A row with none (a fully masked row: P = 1/Lk on every key) needs every
// key, and then the tile visits all of them.

// e: 1 + the index of the last nonzero mask byte of the row (0: none); f:
// the index of the first (Lk: none). Without a mask, e = Lk and f = 0. All
// 32 lanes of a warp call it and get the same values.
__device__ __forceinline__ void key_extent(const uint8_t* mrow, int Lk, int lane, int& e,
                                           int& f) {
  if (mrow == nullptr) {
    e = Lk;
    f = 0;
    return;
  }
  e = 0;
  f = Lk;
  if ((reinterpret_cast<uintptr_t>(mrow) & 15) == 0 && Lk % 16 == 0) {
    // 16 bytes a lane: a row of 512 bytes in one round
    for (int c0 = lane * 16; c0 < Lk; c0 += 32 * 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(mrow + c0);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int byte = 0; byte < 4; ++byte) {
          if ((ws[q] >> (8 * byte)) & 0xffu) {
            e = c0 + 4 * q + byte + 1;
            f = min(f, c0 + 4 * q + byte);
          }
        }
      }
    }
  } else {
  constexpr int U = 8;  // loads in flight a lane: a row of 512 bytes takes two rounds
  for (int i0 = lane; i0 < Lk; i0 += 32 * U) {
    uint8_t x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = i0 + 32 * u < Lk ? mrow[i0 + 32 * u] : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (x[u] != 0) {
        e = i0 + 32 * u + 1;
        f = min(f, i0 + 32 * u);
      }
    }
  }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    e = max(e, __shfl_xor_sync(0xffffffffu, e, off));
    f = min(f, __shfl_xor_sync(0xffffffffu, f, off));
  }
}

// The keys [0, n) that the q rows [q0, q0 + rows) (those < Lq) must visit:
// min(Lk, e, causal ? last row + 1 : Lk) when every row has a real key
// (e > 0, and under causal masking f <= q0), else Lk. At least 1.
__device__ __forceinline__ int visit_keys(int e, int f, int Lq, int Lk, int q0, int rows,
                                          int causal) {
  if (e == 0 || (causal && f > q0)) return Lk;
  const int last = min(q0 + rows, Lq) - 1;
  return causal ? min(min(Lk, e), last + 1) : min(Lk, e);
}

// A tile of BK keys of one head: K's D/64 boxes, then V's, in one stage of
// the ring (stage s at `ring + s * STAGE`), and the keys' mask as MW words
// (BK / 32, or one for a tile of 16 keys) at `mask_s + s * MASK` (bit k % 32
// of word k / 32: key k of the tile exists and is not masked; the callers
// give mask_s at least MASK bytes a stage).
template <int BK, int D = 128>
struct KVRing {
  static constexpr int BOXES = D / 64;  // boxes of one operand's row
  static constexpr int BOX = BK * BOX_ROW_BYTES;
  static constexpr int STAGE = 2 * BOXES * BOX;
  static constexpr int MW = (BK + 31) / 32;
  static constexpr int MASK = 4 * MW;
};

// The producer side of one head's keys, tiles 0 .. ntiles - 1: one warp
// (all 32 lanes call it) waits for a free stage, lane 0 starts the TMA
// loads (announcing their bytes on the stage's `full` barrier), the lanes
// read the tile's mask bytes (when there is a mask) while those are in
// flight and vote them into the stage's mask words, and every lane arrives
// (32 arrivals complete the phase with the bytes).
template <int BK, int NST, int D = 128>
__device__ __forceinline__ void produce_kv(const CUtensorMap* tk, int k_hi,
                                           const CUtensorMap* tv, int v_hi, int h, int b,
                                           int Lk, int ntiles, const uint8_t* mrow,
                                           uint32_t ring, uint8_t* mask_s, uint64_t* full,
                                           uint64_t* empty, Pipe& pp, int lane) {
  using R = KVRing<BK, D>;
  for (int j = 0; j < ntiles; ++j) {
    mbar_wait(&empty[pp.stage], pp.phase ^ 1);
    if (lane == 0) {
      const uint32_t st = ring + pp.stage * R::STAGE;
      mbar_expect_tx(&full[pp.stage], R::STAGE);
#pragma unroll
      for (int c = 0; c < R::BOXES; ++c) {
        tma_load_head(tk, st + c * R::BOX, &full[pp.stage], 64 * c, j * BK, h, b, k_hi);
        tma_load_head(tv, st + (R::BOXES + c) * R::BOX, &full[pp.stage], 64 * c, j * BK, h,
                      b, v_hi);
      }
    }
    if (mrow != nullptr) {  // the loads of a lane in flight together
      uint8_t x[R::MW];
#pragma unroll
      for (int u = 0; u < R::MW; ++u) {
        const int key = j * BK + lane + 32 * u;
        x[u] = (lane + 32 * u < BK && key < Lk) ? mrow[key] : 0;
      }
      uint32_t* words = reinterpret_cast<uint32_t*>(mask_s + pp.stage * R::MASK);
#pragma unroll
      for (int u = 0; u < R::MW; ++u) {
        const uint32_t w = __ballot_sync(0xffffffffu, x[u] != 0);
        if (lane == 0) words[u] = w;  // released by lane 0's arrival below
      }
    }
    mbar_arrive(&full[pp.stage]);
    pp.advance<NST>();
  }
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The consumer side: one warpgroup's 64 q rows against the key tiles 0 ..
// ntiles - 1 of one head (those produce_kv loads; keys >= Lk do not exist),
// online softmax, everything in registers. `q_box0` is the shared address
// of the rows' first box (columns 0-63), `q_box_stride` the bytes from one
// of their boxes to the next. The warpgroup computes the output columns c0
// .. c0 + DO - 1 (c0 a multiple of 64; all D by default): at head dims 384
// and 512 two warpgroups share 64 rows, each with half the columns, and
// their P must agree bit for bit: each computes the same S with the same
// products in the same order or, with XS, half of its depth, the two halves
// summed through `sx` (exchange below). On return this thread holds, for its rows
// row_a = q0 + 16 * warp + lane / 4 and row_b = row_a + 8, the un-normalised
// output (o[4 j + e]: column c0 + 8 j + 2 (lane % 4) + (e & 1), row_a for e < 2),
// the row maxima m_r (log2 units, scale folded in) and the row sums l_r
// (>= 1, reduced over the row's four threads). The warpgroup has released
// every stage it read (every consumer thread arrives on `empty`) and, when
// `q_release` is given, arrived there once its last S product was in. With
// FRESH (the default) the state starts empty; without, it goes on from the
// state the caller put in `o`, `m_r` and `l_r` (a row sum carried whole by
// one thread of the row's four and 0 in the others, so that the reduction
// at the end counts it once; the empty state is o = 0, m = -inf, l = 0):
// the ring step folds one K/V chunk after another in.
//
// Per key tile j: S_j = Q K_j^T as D/16 wgmma of 64 x BK x 16 from shared
// memory; the scale, the mask (from the tile's bytes in shared memory), the
// running maximum and P_j = exp2(S_j - m) in registers; P_j rounded to bf16
// becomes, without leaving the registers, the A operand of O += P_j V_j,
// BK/16 steps of wgmma of 64 x 128 x 16 (and one of 64 x 64 x 16 where DO is
// not a multiple of 128) over the DO columns, with V read MN-major. The two
// products overlap the softmax: S_j is issued together with O += P_{j-1}
// V_{j-1}, and the softmax of S_j runs while the tensor cores do the
// latter; O is rescaled once that product is in.
template <int BK, int NST, bool FRESH = true, int D = 128, int DO = D, bool XS = false>
__device__ __forceinline__ void sm90_attend(uint32_t q_box0, uint32_t q_box_stride,
                                            uint32_t ring, const uint8_t* mask_s,
                                            bool has_mask, uint64_t* full, uint64_t* empty,
                                            Pipe& pp, uint64_t* q_release, int row_a,
                                            int Lk, int ntiles, float scale_log2, int causal,
                                            float (&o)[DO / 2], float (&m_r)[2],
                                            float (&l_r)[2], int c0 = 0, float* sx = nullptr) {
  using R = KVRing<BK, D>;
  constexpr int NS = BK / 2;  // S accumulator registers
  constexpr int NO = DO / 2;  // O accumulator registers
  constexpr uint32_t WFULL = BK >= 32 ? ~0u : (1u << BK) - 1u;  // a mask word, every key
  static_assert(DO % 64 == 0 && D % DO == 0, "O in whole 64-column blocks");
  // XS: the two warpgroups that share these rows (DO = D / 2) split the
  // depth of Q K^T too, each the half at its own columns (KS of the D / 16
  // steps), and sum the two partial S through `sx`
  constexpr int KS = XS ? D / 32 : D / 16;
  static_assert(!XS || (2 * DO == D && KS % 4 == 0), "a depth split of two whole-box halves");
  const int ks0 = XS ? (c0 / DO) * KS : 0;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int row_b = row_a + 8;

  float s[NS];
  uint32_t pf[BK / 16][4];  // P of the previous tile, bf16, as A fragments

  auto issue_s = [&](int stage) {  // S = Q K^T on the stage's K tile
    const uint32_t qb = q_box0 + (ks0 / 4) * q_box_stride;
    const uint32_t kb = ring + stage * R::STAGE + (ks0 / 4) * R::BOX;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {  // 16 columns of Dh a step: 32 bytes
      const uint64_t da = make_desc(qb + (ks / 4) * q_box_stride, 16, 1024) + (ks % 4) * 2;
      const uint64_t db = make_desc(kb + (ks / 4) * R::BOX, 16, 1024) + (ks % 4) * 2;
      wgmma_ss_keys<BK>(s, da, db, ks > 0);
    }
    wgmma_commit();
  };
  // XS: this warpgroup's partial S of tile j into its half of the buffer of
  // the tile's parity, the other's added once both are in (two buffers: the
  // next tile's write waits for no reader); each thread holds the same S
  // entries in both, and s0 + s1 == s1 + s0, so both sums agree bit for bit
  auto exchange = [&](int j) {
    if constexpr (XS) {
      constexpr int N4 = NS / 4;
      const int tid = threadIdx.x % 128, cw = c0 / DO;
      float4* buf = reinterpret_cast<float4*>(sx) + (j & 1) * 2 * N4 * 128 + tid;
#pragma unroll
      for (int i = 0; i < N4; ++i) {
        buf[(cw * N4 + i) * 128] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      }
      pair_sync();
#pragma unroll
      for (int i = 0; i < N4; ++i) {
        const float4 v = buf[((1 - cw) * N4 + i) * 128];
        s[4 * i] += v.x;
        s[4 * i + 1] += v.y;
        s[4 * i + 2] += v.z;
        s[4 * i + 3] += v.w;
      }
    }
  };
  auto issue_pv = [&](int stage) {  // O += P V on the stage's V tile, columns c0 ..
    const uint32_t vt = ring + stage * R::STAGE + (R::BOXES + c0 / 64) * R::BOX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys a step: 16 rows of 128 bytes
#pragma unroll
      for (int c = 0; c < DO / 128; ++c) {  // 128 columns (two boxes) a product
        wgmma_rs_n128_tb(acc_cols128(o, c), pf[kk],
                         make_desc(vt + 2 * c * R::BOX, R::BOX, 1024) +
                             kk * (16 * BOX_ROW_BYTES / 16));
      }
      if constexpr (DO % 128 != 0) {  // the last 64 columns
        wgmma_rs_n64_tb(acc_cols64(o, DO / 64 - 1), pf[kk],
                        make_desc(vt + (DO / 64 - 1) * R::BOX, R::BOX, 1024) +
                            kk * (16 * BOX_ROW_BYTES / 16));
      }
    }
    wgmma_commit();
  };
  // scale and mask S_j in place, fold its row maxima into m_r; returns the
  // factors that rescale the running sums and output
  auto softmax = [&](int j, int stage, float (&alpha)[2]) {
    const int kv0 = j * BK;
    float mx[2] = {-INFINITY, -INFINITY};
    uint32_t mw[R::MW];  // the tile's mask words
    uint32_t every = WFULL;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(mask_s + stage * R::MASK);
#pragma unroll
    for (int w = 0; w < R::MW; ++w) {
      mw[w] = has_mask ? words[w] : WFULL;
      every &= mw[w];
    }
    if (every == WFULL && !causal && kv0 + BK <= Lk) {  // every key exists, none masked
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] *= scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
      // this thread's keys nt * 8 + 2 t + c of the tile: bit 8 (nt % 4) + c
      // of its mask word nt / 4 shifted down by 2 t
      // (selects, no branches: a branch an element made a masked call far
      // slower than an unmasked one)
#pragma unroll
      for (int w = 0; w < R::MW; ++w) mw[w] >>= 2 * t;
      // the tile's keys kl that exist (kl < exist) and that rows a and b may
      // attend under causal masking (kl <= lim)
      const int exist = Lk - kv0 - 2 * t;
      const int lim[2] = {causal ? row_a - kv0 - 2 * t : BK, causal ? row_b - kv0 - 2 * t : BK};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = nt * 8 + (e & 1);  // the key's place in the tile, less 2 t
          const bool valid = (mw[nt >> 2] >> (8 * (nt & 3) + (e & 1))) & 1u;
          float x = s[4 * nt + e] * scale_log2;
          x = valid && kl <= lim[e >> 1] ? x : -FLT_MAX;
          x = kl < exist ? x : -INFINITY;  // does not exist: probability exactly 0
          s[4 * nt + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key kv0 < Lk scores finite, so the new max is finite
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = fast_exp2(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
    // P = exp2(S - m), in place; l sums the fp32 values
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(s[i] - m_r[r]);
      l_r[r] += s[i];
    }
  };
  // P rounded to bf16 as the A fragments of P V: n8 blocks 2 kk and 2 kk + 1
  // of S are the k16 slice kk of P
  auto pack_p = [&]() {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const int kk = nt >> 1, hi = nt & 1;
      pf[kk][hi * 2 + 0] = pack_bf16(s[4 * nt + 0], s[4 * nt + 1]);  // row_a
      pf[kk][hi * 2 + 1] = pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);  // row_b
    }
  };

  if constexpr (FRESH) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    m_r[0] = m_r[1] = -INFINITY;
    l_r[0] = l_r[1] = 0.f;  // this thread's partial row sums
  }

  float alpha[2];
  mbar_wait(&full[pp.stage], pp.phase);
  wgmma_fence();
  issue_s(pp.stage);
  wgmma_wait<0>();
  fence_regs(s);
  exchange(0);
  softmax(0, pp.stage, alpha);  // alpha = 0 against the empty state
  if constexpr (!FRESH) {  // a carried output is rescaled to the new maxima
#pragma unroll
    for (int jn = 0; jn < DO / 8; ++jn) {
      o[4 * jn + 0] *= alpha[0];
      o[4 * jn + 1] *= alpha[0];
      o[4 * jn + 2] *= alpha[1];
      o[4 * jn + 3] *= alpha[1];
    }
  }
  pack_p();
  int prev = pp.stage;
  pp.advance<NST>();
  for (int j = 1; j < ntiles; ++j) {
    mbar_wait(&full[pp.stage], pp.phase);
    fence_regs(o);
      wgmma_fence();
    issue_s(pp.stage);
    issue_pv(prev);
      wgmma_wait<1>();  // S_j is in; O += P_{j-1} V_{j-1} may still run
    fence_regs(s);
    exchange(j);
    softmax(j, pp.stage, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    mbar_arrive(&empty[prev]);
#pragma unroll
    for (int jn = 0; jn < DO / 8; ++jn) {
      o[4 * jn + 0] *= alpha[0];
      o[4 * jn + 1] *= alpha[0];
      o[4 * jn + 2] *= alpha[1];
      o[4 * jn + 3] *= alpha[1];
    }
    pack_p();
    prev = pp.stage;
    pp.advance<NST>();
  }
  if (q_release != nullptr) mbar_arrive(q_release);  // every S is in: q is free
  fence_regs(o);
  wgmma_fence();
  issue_pv(prev);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pf);
  mbar_arrive(&empty[prev]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
}

// Row statistics for the backward ([2, B*H, Lq] fp32: maxima, then sums),
// by the first thread of each row's four.
__device__ __forceinline__ void write_stats(float* stats, long long bh, long long nbh, int Lq,
                                            int row_a, const float (&m_r)[2],
                                            const float (&l_r)[2]) {
  if (stats == nullptr || (threadIdx.x & 3) != 0) return;
  float* sm = stats + bh * Lq;
  float* sl = sm + nbh * Lq;
  if (row_a < Lq) { sm[row_a] = m_r[0]; sl[row_a] = l_r[0]; }
  if (row_a + 8 < Lq) { sm[row_a + 8] = m_r[1]; sl[row_a + 8] = l_r[1]; }
}

}  // namespace
