// Device helpers shared by the flash-attention forward (flash_fwd.cu), the
// forward with the fused output projection (flash_fwd_proj.cu), the
// backward (flash_bwd.cu), the short-sequence kernels (flash_short.cu) and
// the ring-attention step (ring_attention.cu) kernels: mma.sync / ldmatrix /
// cp.async wrappers, the padded shared-memory row loader, rotate-half RoPE
// with the plain version's bf16 rounding points (and its pre-pass kernels),
// the gradient row stores through the transpose of RoPE, the mma.sync
// attention of one q tile over one head's keys (`attend_head`, the ring
// step's at Dh 64), and the warp helpers of the fp32 kernels.
//
// Tiles are 64 rows of D bf16 values, each row padded by PAD elements so
// that ldmatrix reads are free of bank conflicts. Every operand is a base
// pointer plus (batch, head, row) strides in elements with the head dim
// contiguous.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
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

// Rows [row0, row0 + ROWS) of a strided [L, D] operand into shared rows of
// `ld` elements by cp.async; rows at or past L are zero-filled (so
// 0-probability keys never meet uninitialised shared memory in a product).
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* s, int ld,
                                                const __nv_bfloat16* g, long long sl,
                                                int row0, int L) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < L;
    const __nv_bfloat16* src = g + (long long)(ok ? row0 + r : 0) * sl + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(s + r * ld + c * 8)),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// In-place RoPE on the rows of the shared q tile (rows of `ld` elements)
// that exist.
template <int D>
__device__ __forceinline__ void rope_tile(__nv_bfloat16* s, int ld, const float* sin,
                                          const float* cos, int row0, int L) {
  constexpr int HALF = D / 2;
  for (int i = threadIdx.x; i < BQ * HALF; i += NTHREADS) {
    const int r = i / HALF, d = i % HALF;
    const int pos = row0 + r;
    if (pos >= L) continue;
    __nv_bfloat16* row = s + r * ld;
    const float* sr = sin + (long long)pos * D;
    const float* cr = cos + (long long)pos * D;
    rope_pair(__bfloat162float(row[d]), __bfloat162float(row[d + HALF]), sr[d],
              sr[d + HALF], cr[d], cr[d + HALF], row[d], row[d + HALF]);
  }
}

// Un-rotate a [16 x D] fp32 accumulator (the transpose of rotate-half RoPE,
// tables rounded to bf16 as the forward used them) and store it as bf16.
// acc[dn][e] holds row g (e < 2) or g + 8 (e >= 2), column dn*8 + 2t + (e&1);
// the rotate-half partner of column d is d + D/2: tile dn + D/16, same thread.
template <int D>
__device__ __forceinline__ void store_rows(float (&acc)[D / 8][4], __nv_bfloat16* base,
                                           long long sl, int row_a, int L,
                                           const float* sin, const float* cos, int t) {
  constexpr int NO = D / 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= L) continue;
    if (sin != nullptr) {
      const float* sr = sin + (long long)row * D;
      const float* cr = cos + (long long)row * D;
#pragma unroll
      for (int dn = 0; dn < NO / 2; ++dn) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = dn * 8 + 2 * t + c, d2 = d + D / 2;
          const float g1 = acc[dn][2 * r + c], g2 = acc[dn + NO / 2][2 * r + c];
          acc[dn][2 * r + c] = g1 * bf16_round(cr[d]) + g2 * bf16_round(sr[d2]);
          acc[dn + NO / 2][2 * r + c] = g2 * bf16_round(cr[d2]) - g1 * bf16_round(sr[d]);
        }
      }
    }
    __nv_bfloat16* orow = base + (long long)row * sl;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * r], acc[dn][2 * r + 1]);
    }
  }
}

// Attention of one 64-row q tile of one (batch, head) over all its keys, on
// mma.sync: the body of the ring step kernel at Dh 64 (ring_attention.cu
// `ring_step_kernel`). The whole block calls it.
// `qg`, `kg`, `vg` point at the head's first row (k rotated already when
// RoPE is on). Keys stream in tiles of BKT rows; Qs is 64 shared rows of
// `q_ld` elements, Ks and Vs two padded tiles of BKT rows each. On return
// this thread holds, for its rows g and g + 8 of the warp's 16, the
// un-normalised output `acc` (column dn*8 + 2t + (e&1), row g for e < 2),
// the row maxima `m_r` (log2 units, scale folded in) and the row sums
// `l_r` (>= 1, reduced over the row), and every warp is done with the
// shared tiles. With FRESH (the default) the state starts empty; without,
// it goes on from the state the caller put in `acc`, `m_r` and `l_r` (a
// row sum carried whole by one thread of the row's four and 0 in the
// others, so that the reduction at the end counts it once): the ring
// kernel (ring_attention.cu) folds one K/V chunk after another in.
template <int D, int BKT, bool FRESH = true>
__device__ __forceinline__ void attend_head(
    __nv_bfloat16* Qs, int q_ld, __nv_bfloat16* Ks, __nv_bfloat16* Vs,
    const __nv_bfloat16* qg, long long q_sl, const __nv_bfloat16* kg, long long k_sl,
    const __nv_bfloat16* vg, long long v_sl, const float* sin, const float* cos,
    const uint8_t* mrow, int q0, int Lq, int Lk, float scale_log2, int causal,
    float (&acc)[D / 8][4], float (&m_r)[2], float (&l_r)[2]) {
  constexpr int TILE = BKT * (D + PAD);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int ntiles = (Lk + BKT - 1) / BKT;

  load_rows_async<D, BQ>(Qs, q_ld, qg, q_sl, q0, Lq);
  load_rows_async<D, BKT>(Ks, D + PAD, kg, k_sl, 0, Lk);
  load_rows_async<D, BKT>(Vs, D + PAD, vg, v_sl, 0, Lk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (sin) {
    rope_tile<D>(Qs, q_ld, sin, cos, q0, Lq);
    __syncthreads();
  }

  // this warp's 16 q rows as mma A fragments, kept for the whole key loop
  constexpr int KS = D / 16;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * q_ld + ks * 16 + (lane >> 4) * 8);
  }

  constexpr int NO = D / 8;  // n8 tiles of the output
  if constexpr (FRESH) {
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    m_r[0] = m_r[1] = -INFINITY;  // rows g and g + 8
    l_r[0] = l_r[1] = 0.f;        // this thread's partial row sums
  }
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  // ldmatrix lane offsets: K (x4: n-tiles nt, nt+1 x k-halves), V (x4.trans:
  // k-halves x d-tiles dn, dn+1)
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  for (int j = 0; j < ntiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < ntiles) {  // prefetch the next tile into the other buffer
      load_rows_async<D, BKT>(Ks + (cur ^ 1) * TILE, D + PAD, kg, k_sl, (j + 1) * BKT, Lk);
      load_rows_async<D, BKT>(Vs + (cur ^ 1) * TILE, D + PAD, vg, v_sl, (j + 1) * BKT, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + cur * TILE;
    const __nv_bfloat16* Vt = Vs + cur * TILE;
    const int kv0 = j * BKT;

    // S = Q K^T for 16 rows x BKT keys
    float s[BKT / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKT / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int np = 0; np < BKT / 16; ++np) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (np * 16 + k_row) * (D + PAD) + ks * 16 + k_col);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // scale, mask, and the tile's row maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BKT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        float x;
        if (key >= Lk) {
          x = -INFINITY;  // does not exist: probability exactly 0
        } else {
          x = s[nt][e] * scale_log2;
          if ((mrow != nullptr && mrow[key] == 0) || (causal && key > row)) x = -FLT_MAX;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key kv0 < Lk scores finite, so the new max is finite
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // P = exp2(S - m), re-packed as A fragments of the P V product:
    // n8 tiles 2kk and 2kk+1 of S are the k16 slice kk of P
    uint32_t pf[BKT / 16][4];
#pragma unroll
    for (int nt = 0; nt < BKT / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_r[0]);
      const float p1 = exp2f(s[nt][1] - m_r[0]);
      const float p2 = exp2f(s[nt][2] - m_r[1]);
      const float p3 = exp2f(s[nt][3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      const int kk = nt >> 1, hi = nt & 1;
      pf[kk][hi * 2 + 0] = pack_bf16(p0, p1);  // row g
      pf[kk][hi * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (kk * 16 + v_row) * (D + PAD) + dp * 16 + v_col);
        mma_bf16(acc[2 * dp], pf[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
}

// RoPE pre-pass: x [B, H, L, D] (strided) -> out [B, H, L, D] contiguous,
// rotated once. One thread per row and 8 rotate-half pairs: two 16-byte
// loads of x, eight of the tables, two 16-byte stores. Grid:
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
  const float4* s4 = reinterpret_cast<const float4*>(sin + (long long)row * D + c);
  const float4* c4 = reinterpret_cast<const float4*>(cos + (long long)row * D + c);
  float4 t[4][2];  // sin d, sin d + HALF, cos d, cos d + HALF; 4 columns each
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    t[0][j] = __ldg(s4 + j);
    t[1][j] = __ldg(s4 + HALF / 4 + j);
    t[2][j] = __ldg(c4 + j);
    t[3][j] = __ldg(c4 + HALF / 4 + j);
  }
  const float* s1 = reinterpret_cast<const float*>(t[0]);
  const float* s2 = reinterpret_cast<const float*>(t[1]);
  const float* c1 = reinterpret_cast<const float*>(t[2]);
  const float* c2 = reinterpret_cast<const float*>(t[3]);
  uint4 o1, o2;
  __nv_bfloat16* y1 = reinterpret_cast<__nv_bfloat16*>(&o1);
  __nv_bfloat16* y2 = reinterpret_cast<__nv_bfloat16*>(&o2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rope_pair(__bfloat162float(x1[i]), __bfloat162float(x2[i]), s1[i], s2[i], c1[i], c2[i],
              y1[i], y2[i]);
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

// ---- SIMT kernels: fp32 operands, and bf16 at Dh 256 to 512 ---------------
// The SIMT kernels (flash_fwd.cu, flash_bwd.cu, flash_fwd_proj.cu,
// ring_attention.cu) serve what the tensor-core kernels do not take: the
// fp32 calls past the short kernels of flash_short.cu (every attention of a
// model built with `precision: fp32` but its aggregator's) and the bf16
// calls at head dims of 256 to 512; the fp32 forward at head dims 64 and
// 128 (K1, K3, K5) runs the register-tiled body of fwd_f32_regtile.cuh
// instead.
// They use no tensor cores: a warp owns 4 rows, a lane owns the columns
// lane, lane + 32, ... of each, and every product is an fp32 FMA. Operands of
// type T (float or bf16) are read into fp32; in bf16 the values are rounded
// where the plain version rounds them (P before P V, dS before its
// products, the RoPE tables and products), in fp32 nothing is rounded below
// fp32. The head dims are 64 to 512: D / 32 columns a lane.

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, as a float: the identity for fp32.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// One element of rotate-half RoPE, x * cos + partner * sin (the partner of
// column d < D/2 is -x[d + D/2], of the others x[d - D/2]): in fp32 as it
// is; in bf16 with the tables rounded to bf16 and each product and the sum
// rounded, as rope_pair rounds (the plain version's elementwise bf16 ops).
template <typename T>
__device__ __forceinline__ float rope_elem(float x, float partner, float s, float c) {
  if constexpr (sizeof(T) == 4) {
    return x * c + partner * s;
  } else {
    return round_to<T>(round_to<T>(x * round_to<T>(c)) + round_to<T>(partner * round_to<T>(s)));
  }
}

// ---- tiled SIMT attention ---------------------------------------------------
// The forward of K1 / K3 / K5 (fp32 above Dh 128, bf16 at 256 to 512) and
// the ring step (K6) on the CUDA cores, a block
// of NW warps over one (batch, head): a warp owns SR = 4 query rows, so a
// block owns BQ = 4 NW rows, and the keys stream through shared memory in
// tiles of SBK = 32, one key a lane. Each K and V tile is read from device
// memory once a block (coalesced, a row a warp-wide load) for its 4 NW
// rows; a lane scores its key against the warp's 4 rows with one shared K
// value and one float4 of the transposed Q tile an FMA quad, the warp
// reduces each row's maximum and sum, and every lane adds the tile's
// weighted value rows into its own columns. NW is 8 up to D 256 and 4
// above, so that the
// tiles fit (FwdTiles). Rows past the operand's end are zero in Q and never
// stored; keys past Lk are zero in K and V and have probability exactly 0.

constexpr int SR = 4;    // rows (the dK/dV kernel: keys) a warp owns
constexpr int SBK = 32;  // keys (the dK/dV kernel: q rows) a streamed tile: one a lane

template <int D>
constexpr int SIMT_WARPS = D <= 256 ? 8 : 4;

// Shared memory of the tiled forward, in floats: Q^T [D][BQ + 4] (the rows
// of a column 16-byte aligned for the float4 reads, and fewer bank conflicts
// on the transposing store), K [SBK][D + 1] (a lane reads its key's row:
// conflict-free), V [SBK][D].
template <int D, int NW>
struct FwdTiles {
  static constexpr int BQ = NW * SR;
  static constexpr int QLD = BQ + 4;
  static constexpr int KLD = D + 1;
  static constexpr int Q = 0;
  static constexpr int K = Q + D * QLD;
  static constexpr int V = K + SBK * KLD;
  static constexpr int BYTES = (V + SBK * D) * 4;
};

// Rows [r0, r0 + n) of a [L, D] operand of type T (rows `sl` apart) into
// shared fp32 rows dst[r * ld + d], a row a warp-wide coalesced load; rows
// at or past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile_rows(float* dst, int ld, const T* g, long long sl,
                                               int r0, int n, int L) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = r0 + r < L ? to_f(g[(long long)(r0 + r) * sl + d]) : 0.f;
  }
}

// The same rows transposed, dst[d * ld + r], rotated by RoPE (the operand
// type's rounding, rope_elem) when `sin` is given.
template <typename T, int D>
__device__ __forceinline__ void load_tile_cols(float* dst, int ld, const T* g, long long sl,
                                               int r0, int n, int L, const float* sin,
                                               const float* cos) {
  constexpr int HALF = D / 2;
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, d = i % D, row = r0 + r;
    float x = 0.f;
    if (row < L) {
      const T* gr = g + (long long)row * sl;
      x = to_f(gr[d]);
      if (sin != nullptr) {
        const float xp = d < HALF ? -to_f(gr[d + HALF]) : to_f(gr[d - HALF]);
        x = rope_elem<T>(x, xp, sin[(long long)row * D + d], cos[(long long)row * D + d]);
      }
    }
    dst[d * ld + r] = x;
  }
}

// The online softmax of the block's BQ query rows q0 .. (warp w: rows q0 +
// SR w + r) over the keys [0, Lk) of one head, continuing the state (m in
// log2 units with the scale folded in, l, acc; m = -inf, l = 0, acc = 0 is
// the empty state). Masked keys (mask byte 0, or key > row under causal
// masking) score -FLT_MAX; in bf16, P is rounded to bf16 before P V and l
// sums the fp32 P. Every thread of the block calls it (it synchronises the
// block).
template <typename T, int D, int NW>
__device__ __forceinline__ void simt_attend_tiles(
    float* smem, const T* qg, long long q_sl, int q0, int Lq, const float* sin,
    const float* cos, const T* kg, long long k_sl, const T* vg, long long v_sl,
    const uint8_t* mrow, int Lk, int causal, float scale_log2, float (&acc)[SR][D / 32],
    float (&m)[SR], float (&l)[SR]) {
  static_assert(SR == 4, "a warp's rows are one float4 of the transposed Q tile");
  using S = FwdTiles<D, NW>;
  constexpr int PER = D / 32;
  float* qs = smem + S::Q;
  float* ks = smem + S::K;
  float* vs = smem + S::V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + SR * warp;
  load_tile_cols<T, D>(qs, S::QLD, qg, q_sl, q0, S::BQ, Lq, sin, cos);
  for (int j0 = 0; j0 < Lk; j0 += SBK) {
    __syncthreads();  // Q is written; the last tile's readers are done
    load_tile_rows<T, D>(ks, S::KLD, kg, k_sl, j0, SBK, Lk);
    load_tile_rows<T, D>(vs, D, vg, v_sl, j0, SBK, Lk);
    __syncthreads();
    const int key = j0 + lane;
    float s[SR] = {0.f, 0.f, 0.f, 0.f};
    const float* krow = ks + lane * S::KLD;
    const float* qcol = qs + SR * warp;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d];
      const float4 q4 = *reinterpret_cast<const float4*>(qcol + d * S::QLD);
      s[0] = fmaf(q4.x, kv, s[0]);
      s[1] = fmaf(q4.y, kv, s[1]);
      s[2] = fmaf(q4.z, kv, s[2]);
      s[3] = fmaf(q4.w, kv, s[3]);
    }
    const bool live = key < Lk;
    const bool kmasked = live && mrow != nullptr && mrow[key] == 0;
    float pj[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      float x = -INFINITY;  // a key that does not exist: probability exactly 0
      if (live) x = (kmasked || (causal && key > row0 + r)) ? -FLT_MAX : s[r] * scale_log2;
      const float m_new = fmaxf(m[r], warp_max(x));  // key j0 exists: finite
      const float alpha = exp2f(m[r] - m_new);
      pj[r] = exp2f(x - m_new);
      l[r] = l[r] * alpha + warp_sum(pj[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[r][i] *= alpha;
    }
    const int n = min(SBK, Lk - j0);
    for (int jj = 0; jj < n; ++jj) {
      float pv[SR];
#pragma unroll
      for (int r = 0; r < SR; ++r) pv[r] = round_to<T>(__shfl_sync(FULL, pj[r], jj));
      const float* vrow = vs + jj * D + lane;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float vv = vrow[32 * i];
#pragma unroll
        for (int r = 0; r < SR; ++r) acc[r][i] = fmaf(pv[r], vv, acc[r][i]);
      }
    }
  }
}

// fp32 RoPE pre-pass: x [B, H, L, D] (strided) -> out [B, H, L, D]
// contiguous, rotate-half with fp32 tables. One thread per pair (d, d + D/2).
template <int D>
__global__ void __launch_bounds__(256) rope_rows_f32_kernel(
    const float* x, long long sb, long long sh, long long sl, int H, int L,
    const float* sin, const float* cos, float* out) {
  constexpr int HALF = D / 2;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = idx / HALF, d = idx % HALF;
  if (row >= L) return;
  const float* src = x + b * sb + h * sh + row * sl;
  float* dst = out + ((long long)bh * L + row) * D;
  const float* sr = sin + (long long)row * D;
  const float* cr = cos + (long long)row * D;
  const float x1 = src[d], x2 = src[d + HALF];
  dst[d] = x1 * cr[d] - x2 * sr[d];
  dst[d + HALF] = x2 * cr[d + HALF] + x1 * sr[d + HALF];
}

template <int D>
cudaError_t launch_rope_rows_f32(const float* x, long long sb, long long sh, long long sl,
                                 int B, int H, int L, const float* sin, const float* cos,
                                 float* out, cudaStream_t stream) {
  const dim3 grid((L * (D / 2) + 255) / 256, B * H);
  rope_rows_f32_kernel<D><<<grid, 256, 0, stream>>>(x, sb, sh, sl, H, L, sin, cos, out);
  return cudaGetLastError();
}

// The RoPE pre-pass of the operand type: the fp32 one, or the bf16 one with
// the forward's rounding (rope_rows_kernel).
template <int D>
cudaError_t launch_rope_rows_t(const float* x, long long sb, long long sh, long long sl, int B,
                               int H, int L, const float* sin, const float* cos, float* out,
                               cudaStream_t stream) {
  return launch_rope_rows_f32<D>(x, sb, sh, sl, B, H, L, sin, cos, out, stream);
}

template <int D>
cudaError_t launch_rope_rows_t(const __nv_bfloat16* x, long long sb, long long sh,
                               long long sl, int B, int H, int L, const float* sin,
                               const float* cos, __nv_bfloat16* out, cudaStream_t stream) {
  return launch_rope_rows<D>(x, sb, sh, sl, B, H, L, sin, cos, out, stream);
}

// Transpose of rotate-half RoPE on a row held as columns lane + 32 i (the
// partner of column d < D/2 is d + D/2: index i + PER/2 of the same lane),
// in fp32 with the tables rounded to T as the forward used them, then the
// store in T.
template <typename T, int D>
__device__ __forceinline__ void store_row(float (&acc)[D / 32], T* out, const float* sin,
                                          const float* cos, int row, int lane) {
  constexpr int PER = D / 32;
  if (sin != nullptr) {
    const float* sr = sin + (long long)row * D;
    const float* cr = cos + (long long)row * D;
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      const int d = lane + 32 * i, d2 = d + D / 2;
      const float g1 = acc[i], g2 = acc[i + PER / 2];
      acc[i] = g1 * round_to<T>(cr[d]) + g2 * round_to<T>(sr[d2]);
      acc[i + PER / 2] = g2 * round_to<T>(cr[d2]) - g1 * round_to<T>(sr[d]);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) out[lane + 32 * i] = from_f<T>(acc[i]);
}

}  // namespace
