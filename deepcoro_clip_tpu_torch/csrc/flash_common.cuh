// Device helpers shared by the flash-attention forward (flash_fwd.cu) and
// backward (flash_bwd.cu) kernels: mma.sync / ldmatrix / cp.async wrappers,
// the padded 64-row shared-memory tile loader, and rotate-half RoPE with
// the plain version's bf16 rounding points.
//
// Tiles are 64 rows of D bf16 values, each row padded by PAD elements so
// that ldmatrix reads are free of bank conflicts. Every operand is a base
// pointer plus (batch, head, row) strides in elements with the head dim
// contiguous.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;  // query rows per tile: 4 warps x 16 rows
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;  // bf16 elements of row padding: conflict-free ldmatrix
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;

// Host side: let `kernel` take `bytes` of dynamic shared memory (more than
// the 48 KB a kernel gets unasked). The attribute stays with the function
// on a device, so it is set at the kernel's first launch there and not
// again; `ready` is the caller's static flag array for this kernel.
inline cudaError_t allow_smem_once(const void* kernel, int bytes,
                                   bool (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) ready[dev] = true;
  return err;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two floats -> bf16x2 in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One rotate-half pair (x1 at d, x2 at d + Dh/2) of RoPE: tables rounded to
// bf16, each product and the sum rounded to bf16, as the plain version's
// elementwise bf16 ops round, so the rotated q/k match it bit for bit.
__device__ __forceinline__ void rope_pair(float x1, float x2, float s1, float s2,
                                          float c1, float c2,
                                          __nv_bfloat16& y1, __nv_bfloat16& y2) {
  s1 = bf16_round(s1); s2 = bf16_round(s2);
  c1 = bf16_round(c1); c2 = bf16_round(c2);
  y1 = __float2bfloat16_rn(bf16_round(x1 * c1) + bf16_round(-x2 * s1));
  y2 = __float2bfloat16_rn(bf16_round(x2 * c2) + bf16_round(x1 * s2));
}

// Rows [row0, row0 + 64) of a strided [L, D] operand into a padded shared
// tile by cp.async; rows at or past L are zero-filled (so 0-probability
// keys never meet uninitialised shared memory in a product).
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* s, const __nv_bfloat16* g,
                                                long long sl, int row0, int L) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < L;
    const __nv_bfloat16* src = g + (long long)(ok ? row0 + r : 0) * sl + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(s + r * (D + PAD) + c * 8)),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// RoPE pre-pass: x [B, H, L, D] (strided) -> out [B, H, L, D] contiguous,
// rotated once. One thread per row and 8 rotate-half pairs. Grid:
// (ceil(L * D / 16 / 256), B * H), 256 threads.
template <int D>
__global__ void __launch_bounds__(256) rope_rows_kernel(
    const __nv_bfloat16* x, long long sb, long long sh, long long sl, int H, int L,
    const float* sin, const float* cos, __nv_bfloat16* out) {
  constexpr int HALF = D / 2, CH = HALF / 8;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = idx / CH, c = (idx % CH) * 8;
  if (row >= L) return;
  const __nv_bfloat16* src = x + b * sb + h * sh + row * sl;
  __nv_bfloat16* dst = out + ((long long)bh * L + row) * D;
  const uint4 a1 = *reinterpret_cast<const uint4*>(src + c);
  const uint4 a2 = *reinterpret_cast<const uint4*>(src + c + HALF);
  const __nv_bfloat16* x1 = reinterpret_cast<const __nv_bfloat16*>(&a1);
  const __nv_bfloat16* x2 = reinterpret_cast<const __nv_bfloat16*>(&a2);
  const float* sr = sin + (long long)row * D;
  const float* cr = cos + (long long)row * D;
  uint4 o1, o2;
  __nv_bfloat16* y1 = reinterpret_cast<__nv_bfloat16*>(&o1);
  __nv_bfloat16* y2 = reinterpret_cast<__nv_bfloat16*>(&o2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = c + i;
    rope_pair(__bfloat162float(x1[i]), __bfloat162float(x2[i]), sr[d], sr[d + HALF],
              cr[d], cr[d + HALF], y1[i], y2[i]);
  }
  *reinterpret_cast<uint4*>(dst + c) = o1;
  *reinterpret_cast<uint4*>(dst + c + HALF) = o2;
}

template <int D>
cudaError_t launch_rope_rows(const __nv_bfloat16* x, long long sb, long long sh,
                             long long sl, int B, int H, int L, const float* sin,
                             const float* cos, __nv_bfloat16* out, cudaStream_t stream) {
  constexpr int CH = D / 16;
  const dim3 grid((L * CH + 255) / 256, B * H);
  rope_rows_kernel<D><<<grid, 256, 0, stream>>>(x, sb, sh, sl, H, L, sin, cos, out);
  return cudaGetLastError();
}

}  // namespace
