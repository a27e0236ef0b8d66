// The fp32 attention backward on Hopper's CUDA cores at head dims 64 and
// 128, register-tiled: the bodies of the dK/dV and dQ kernels of K2 and K4
// in fp32 (flash_bwd.cu, `flash_bwd_dkv_f32_regtile_kernel<D>` and
// `flash_bwd_dq_f32_regtile_kernel<D>`). Wider heads and the wide-bf16
// routes keep `bwd_dkv_simt` / `bwd_dq_simt` (flash_bwd.cu).
//
// What bounds it: 10*Lq*Lk*D FLOP a head on the CUDA cores (67 TFLOP/s fp32
// on an H100; no TF32, no tensor core). It is done as five products a tile
// pair, the bound's count: the dK/dV kernel computes S^T, dP^T, dV and dK
// and writes dS^T (fp32, [B*H, Lk, Lq_pad], 4*Lq*Lk bytes a head) to a
// scratch buffer, and the dQ kernel is the product dQ = dS K read back from
// it; no atomics, and every sum in a fixed order. (Seven products, S and dP
// computed again in a dQ kernel, ran slower: PERF.md has both forms'
// times.) What holds a CUDA-core
// product short of the FMA pipe is the shared-memory pipe: a 16-byte warp
// read takes 4 of its cycles, a shuffle 1, against 4 FMA warp instructions
// a cycle. So the design feeds the FMAs from registers:
//   - a thread owns an outer-product micro-tile: its 8 "own" rows og + 8 r
//     (og = its 16-lane group, 0..7, of a 128-thread warpgroup) against 4
//     "partner" rows px + 16 i (px = its lane in the group, 0..15) of a
//     64 x 64 tile; a product takes 12 float4 reads of shared memory for
//     128 FMAs (`rb_product`);
//   - a product's result reaches the accumulation by shuffles inside the
//     group (8 a partner row), the partner row's columns by float4 reads:
//     8 own rows x 8 columns, 64 FMAs a partner row for 8 shuffles and 2
//     reads at D 128 (`rb_accumulate`); the accumulators stay in
//     registers for the whole loop and are written once;
//   - the dK/dV kernel's block owns 64 keys and is two warpgroups: the
//     first holds K resident and streams Q (S^T = K Q^T, then dK += dS^T
//     Q), the second V and dO (dP^T = V dO^T, then dV += P^T dO), two
//     products each; P^T goes from the first to the second and dS^T back
//     through a 16 KB exchange tile in shared memory (each element read by
//     the thread of the other warpgroup that holds the same position), so
//     each warpgroup reads only its own streamed operand, double-buffered
//     by cp.async: the next tile loads under this tile's two products. The
//     second warpgroup also stores dS^T (16 lanes a key, 64 bytes a store);
//   - the dQ kernel's block of 128 threads owns 64 query rows and streams
//     dS^T and K in 64-key tiles, double-buffered by cp.async: a thread
//     holds rows 8 og + r against the float4 columns px + 16 j, and a key
//     takes 4 float4 reads for 64 FMAs at D 128.
// Shared memory at D 128: 214 KB (dK/dV: one block of 8 warps an SM) and
// 100 KB (dQ: two blocks of 4 warps); at D 64 118 KB and 68 KB.
// Numbers: P is rebuilt as exp2(s * scale_log2 - m) * (1/l) from the
// forward's statistics; a masked score (mask byte 0, or key > row under
// causal masking) scores -FLT_MAX and gives dS = 0, so a row with no real
// key still feeds dV with P = 1/Lk; keys at or past Lk and rows at or past
// Lq add nothing (zero-filled tiles, P = 0). Tiles and the order of every
// sum are fixed, whatever B is, and nothing is atomic: reruns are bit-equal
// and a row's gradient does not depend on the batch around it.

#pragma once

#include "fwd_f32_regtile.cuh"

namespace {

constexpr int RB_KEYS = 64;      // keys a dK/dV block; keys a streamed dQ tile
constexpr int RB_ROWS = 64;      // q rows a streamed dK/dV tile; q rows a dQ warpgroup
constexpr int RB_WG = 128;       // threads a warpgroup
constexpr int RB_THREADS = 256;  // two warpgroups a block
constexpr int RB_OWN = 8;        // own rows a thread: og + 8 r
constexpr int RB_PART = 4;       // partner rows a thread: px + 16 i
constexpr int RB_PAD = 4;        // floats of padding a row

// Shared memory of the dK/dV kernel, in floats: K and V [64][D + 4]
// (resident), Q and dO [2][64][D + 4] (double-buffered), the exchange
// tile [8][128] float4 (P^T, then dS^T, at each thread's positions).
template <int D>
struct RbDkvTiles {
  static constexpr int LD = D + RB_PAD;
  static constexpr int K = 0;
  static constexpr int V = K + RB_KEYS * LD;
  static constexpr int Q = V + RB_KEYS * LD;
  static constexpr int G = Q + 2 * RB_ROWS * LD;
  static constexpr int E = G + 2 * RB_ROWS * LD;
  static constexpr int END = E + RB_OWN * RB_PART * RB_WG;
  static constexpr int BYTES = END * 4;
};

// Shared memory of the dQ kernel, in floats: dS^T [2][64 keys][64 + 4]
// (the block's rows of each key) and K [2][64][D + 4], double-buffered.
template <int D>
struct RbDqTiles {
  static constexpr int LD = D + RB_PAD;
  static constexpr int DLD = RB_ROWS + RB_PAD;
  static constexpr int DS = 0;
  static constexpr int K = DS + 2 * RB_KEYS * DLD;
  static constexpr int END = K + 2 * RB_KEYS * LD;
  static constexpr int BYTES = END * 4;
};

// The 128 threads of warpgroup `wg` (0 or 1) meet: named barrier 1 + wg.
__device__ __forceinline__ void rb_wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(RB_WG) : "memory");
}

// Rows [r0, r0 + ROWS) of a strided [L, W] fp32 operand into shared rows of
// `ld` floats by cp.async, NT threads (this one is `t`): 16 bytes a copy
// with `vec`, else 4; rows at or past L are zero-filled (a zero-filled copy
// reads nothing, but its address is row 0's).
template <int W, int ROWS, int NT>
__device__ __forceinline__ void rb_load(float* s, int ld, const float* g, long long sl, int r0,
                                        int L, bool vec, int t) {
  if (vec) {
    constexpr int CH = W / 4;
    for (int i = t; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = r0 + r < L;
      const float* src = g + (ok ? (long long)(r0 + r) * sl + c : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(s + r * ld + c)),
                   "l"(src), "r"(ok ? 16 : 0));
    }
  } else {
    for (int i = t; i < ROWS * W; i += NT) {
      const int r = i / W, c = i % W;
      const bool ok = r0 + r < L;
      const float* src = g + (ok ? (long long)(r0 + r) * sl + c : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_u32(s + r * ld + c)),
                   "l"(src), "r"(ok ? 4 : 0));
    }
  }
}

// acc[r][i] += sum over d of own[og + 8 r][d] * part[px + 16 i][d]: the
// micro-tile of a product of two row-major [64][D + 4] shared tiles. The 16
// lanes of a group read one own row (a broadcast) and 16 consecutive
// partner rows (the padding puts them on distinct banks).
template <int D>
__device__ __forceinline__ void rb_product(float (&acc)[RB_OWN][RB_PART], const float* own,
                                           const float* part, int og, int px) {
  constexpr int LD = D + RB_PAD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RB_OWN], b[RB_PART];
#pragma unroll
    for (int r = 0; r < RB_OWN; ++r) {
      a[r] = *reinterpret_cast<const float4*>(own + (og + 8 * r) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < RB_PART; ++i) {
      b[i] = *reinterpret_cast<const float4*>(part + (px + 16 * i) * LD + d);
    }
#pragma unroll
    for (int r = 0; r < RB_OWN; ++r) {
#pragma unroll
      for (int i = 0; i < RB_PART; ++i) {
        acc[r][i] = fmaf(a[r].x, b[i].x, acc[r][i]);
        acc[r][i] = fmaf(a[r].y, b[i].y, acc[r][i]);
        acc[r][i] = fmaf(a[r].z, b[i].z, acc[r][i]);
        acc[r][i] = fmaf(a[r].w, b[i].w, acc[r][i]);
      }
    }
  }
}

// acc[r][j] (the float4 of columns 4 px + 64 j of own row og + 8 r) += the
// sum over the 64 partner rows rho, in order, of w[og + 8 r][rho] *
// rows[rho][those columns]; w[.][rho] is held by lane rho % 16 of the
// group as its w[r][rho / 16] and reaches the others by a shuffle.
template <int D>
__device__ __forceinline__ void rb_accumulate(float (&acc)[RB_OWN][D / 64][4],
                                              const float (&w)[RB_OWN][RB_PART],
                                              const float* rows, int px) {
  constexpr int LD = D + RB_PAD, NJ = D / 64;
#pragma unroll
  for (int i = 0; i < RB_PART; ++i) {
#pragma unroll
    for (int src = 0; src < 16; ++src) {
      const float* row = rows + (src + 16 * i) * LD + 4 * px;
      float4 v[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) v[j] = *reinterpret_cast<const float4*>(row + 64 * j);
      float c[RB_OWN];
#pragma unroll
      for (int r = 0; r < RB_OWN; ++r) c[r] = __shfl_sync(FULL, w[r][i], src, 16);
#pragma unroll
      for (int r = 0; r < RB_OWN; ++r) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[r][j][0] = fmaf(c[r], v[j].x, acc[r][j][0]);
          acc[r][j][1] = fmaf(c[r], v[j].y, acc[r][j][1]);
          acc[r][j][2] = fmaf(c[r], v[j].z, acc[r][j][2]);
          acc[r][j][3] = fmaf(c[r], v[j].w, acc[r][j][3]);
        }
      }
    }
  }
}

// Rows first + step * r (r < 8; those below L) of a gradient, this thread's
// float4 columns 4 px + 64 j of each, into `out` (rows `sl` floats apart),
// float4 stores with `vec`: with `sin`, first the transpose of rotate-half
// RoPE at each row's position, in fp32 (column c's partner c +- D/2 is
// this thread's other float4 at D 128, the lane 8 away at D 64).
template <int D>
__device__ __forceinline__ void rb_store(float (&acc)[RB_OWN][D / 64][4], float* out,
                                         long long sl, int first, int step, int L,
                                         const float* sin, const float* cos, int px, bool vec) {
  constexpr int NJ = D / 64, HALF = D / 2;
#pragma unroll
  for (int r = 0; r < RB_OWN; ++r) {
    const int row = first + step * r;
    float v[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = acc[r][j][e];
    }
    if (sin != nullptr) {
      float pv[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (NJ == 2) {
            pv[j][e] = acc[r][1 - j][e];
          } else {
            pv[j][e] = __shfl_xor_sync(FULL, acc[r][j][e], 8, 16);
          }
        }
      }
      if (row < L) {
        const float* sr = sin + (long long)row * D;
        const float* cr = cos + (long long)row * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * px + 64 * j + e;
            v[j][e] = c < HALF ? v[j][e] * cr[c] + pv[j][e] * sr[c + HALF]
                               : v[j][e] * cr[c] - pv[j][e] * sr[c - HALF];
          }
        }
      }
    }
    if (row >= L) continue;
    float* orow = out + (long long)row * sl + 4 * px;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (vec) {
        *reinterpret_cast<float4*>(orow + 64 * j) = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[64 * j + e] = v[j][e];
      }
    }
  }
}

}  // namespace
