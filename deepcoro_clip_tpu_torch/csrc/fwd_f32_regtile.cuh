// The fp32 attention forward on Hopper's CUDA cores at head dims 64 and 128,
// register-tiled: the body of K1 and K3 in fp32 (flash_fwd.cu,
// `flash_fwd_f32_regtile_kernel<D>`) and of K5 in fp32 (flash_fwd_proj.cu,
// `flash_fwd_proj_f32_regtile_kernel`). Wider heads, the wide-bf16 routes
// and the ring step keep `simt_attend_tiles` (flash_common.cuh).
//
// What bounds it: 4*Lq*Lk*D FLOP a head on the CUDA cores (67 TFLOP/s fp32
// on an H100; no TF32, no tensor core: the fp32 route exists to give the
// JAX package's fp32 numbers). So the design keeps the FMA pipe fed and
// takes loads, shuffles and barriers off it:
//   - a block of 4 warps owns RT_BQ = 64 query rows of one (batch, head);
//     the keys stream through shared memory in tiles of BK keys (RT_BK = 64
//     for K1 and K3, RT_PROJ_BK = 32 for K5), K and V in buffers of their
//     own filled by cp.async (16 bytes a copy where the operands allow it,
//     else 4): the next K tile loads under this tile's softmax and P V, the
//     next V tile under the next S, two __syncthreads a tile. 98 KB of
//     shared memory at D 128 and 64 keys a tile (Q, K, V): two blocks an
//     SM;
//   - a thread owns an outer-product micro-tile: the rows rg + 16 r (r < 4,
//     rg its row group, 0..15) against the keys kx + 8 i (kx its key
//     group, 0..7; i < 8 at 64 keys a tile) for S = Q K^T, and the same
//     rows against the float4 columns kx + 8 j (j < D / 32) for O += P V.
//     At 64 keys S takes 12 float4 reads of shared Q and K for 128 FMAs,
//     P V one float4 of V for 16 FMAs
//     (shared memory serves a 16-byte read a quarter warp a cycle, so the
//     FMAs a read feeds set the ceiling). Q and K rows are padded by 4
//     floats, so the 8 lanes of a key group read 8 consecutive 16-byte
//     bank groups;
//   - a row's keys of a tile lie in the 8 lanes of one quarter warp: its maximum
//     takes 3 xor-shuffles a tile, its sum 3 at the end (each thread sums
//     its own keys); P stays in registers and reaches P V by one shuffle a
//     row and key inside those 8 lanes, so no warp waits on another for
//     it. P V fetches the next key's P and V row before this key's FMAs,
//     and runs every key of a tile (no branch a key to hold the fetches
//     back).
// Numbers: rows past Lq are zero in Q and never stored; keys past Lk are
// zero in K and V and score -inf (probability exactly 0); a masked key
// (mask byte 0, or key > row under causal masking) scores -FLT_MAX, so a
// row with no real key is the uniform mean over the Lk keys, as the plain
// version gives. The row statistics are those of the other kernels: m in
// log2 units with the scale folded in, l the sum of exp2(s - m). Tiles and
// the order of every sum are fixed, whatever B is, and nothing is atomic:
// reruns are bit-equal and a row does not depend on the batch around it.

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int RT_BQ = 64;           // query rows a block
constexpr int RT_BK = 64;           // keys a streamed tile (K1, K3)
constexpr int RT_PROJ_BK = 32;      // keys a streamed tile (K5)
constexpr int RT_THREADS = 128;     // 4 warps
constexpr int RT_RPT = 4;           // rows a thread: rg + 16 r
constexpr int RT_PAD = 4;           // floats of padding a Q and K row

// Shared memory of the body at BK keys a tile, in floats: Q [RT_BQ][D + 4],
// K [BK][D + 4], V [BK][D].
template <int D, int BK>
struct RtTiles {
  static constexpr int LD = D + RT_PAD;
  static constexpr int Q = 0;
  static constexpr int K = Q + RT_BQ * LD;
  static constexpr int V = K + BK * LD;
  static constexpr int END = V + BK * D;
  static constexpr int BYTES = END * 4;
};

// Host side: whether an fp32 operand allows 16-byte copies (its base and
// its batch, head and row strides, in floats).
inline bool aligned16(const void* p, long long sb, long long sh, long long sl) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 && sl % 4 == 0;
}

// Rows [r0, r0 + ROWS) of a strided [L, W] fp32 operand (rows `sl` floats
// apart) into shared rows of `ld` floats by cp.async, 16 bytes a copy with
// `vec`, else 4; rows at or past L, and columns at or past `w` (<= W), are
// zero-filled. A zero-filled copy reads nothing, but its address is row 0's.
template <int W, int ROWS>
__device__ __forceinline__ void rt_load(float* s, int ld, const float* g, long long sl, int r0,
                                        int L, int w, bool vec) {
  if (vec) {
    constexpr int CH = W / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += RT_THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = r0 + r < L && c < w;
      const float* src = g + (ok ? (long long)(r0 + r) * sl + c : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(s + r * ld + c)),
                   "l"(src), "r"(ok ? 16 : 0));
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += RT_THREADS) {
      const int r = i / W, c = i % W;
      const bool ok = r0 + r < L && c < w;
      const float* src = g + (ok ? (long long)(r0 + r) * sl + c : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_u32(s + r * ld + c)),
                   "l"(src), "r"(ok ? 4 : 0));
    }
  }
}

// This thread's row group (rows rg + 16 r) and key / column group (keys
// kx + 8 i of a tile, float4 columns kx + 8 j): a row group is the 8 lanes
// of one quarter warp.
__device__ __forceinline__ int rt_rg() {
  return (threadIdx.x >> 5) * 4 + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int rt_kx() { return threadIdx.x & 7; }

// The online softmax of the block's RT_BQ query rows q0 .. over the keys
// [0, Lk) of one head, BK keys a tile (a thread's keys of a tile: kx + 8 i,
// i < BK / 8). `qg`, `kg`, `vg` point at the head's row 0 (K
// rotated already when RoPE is on: the pre-pass); with `sin`, Q is rotated
// in shared memory (rotate-half, fp32 tables). On return this thread holds,
// for its rows rg + 16 r, the un-normalised output `o` (float4 columns
// kx + 8 j), the row maxima `m` and the row sums `l` (reduced over the
// row's lanes); no copy is in flight and every warp is done with the
// shared tiles (it returns after a barrier). Every thread of the block
// calls it.
template <int D, int BK>
__device__ __forceinline__ void rt_attend(float* smem, const float* qg, long long q_sl, int q0,
                                          int Lq, const float* sin, const float* cos,
                                          const float* kg, long long k_sl, const float* vg,
                                          long long v_sl, const uint8_t* mrow, int Lk, int causal,
                                          float scale_log2, bool vec,
                                          float (&o)[RT_RPT][D / 32][4], float (&m)[RT_RPT],
                                          float (&l)[RT_RPT]) {
  using S = RtTiles<D, BK>;
  constexpr int NJ = D / 32;
  constexpr int HALF = D / 2;
  constexpr int KPT = BK / 8;
  float* qs = smem + S::Q;
  float* ks = smem + S::K;
  float* vs = smem + S::V;
  const int rg = rt_rg(), kx = rt_kx();
  const int ntiles = (Lk + BK - 1) / BK;

  rt_load<D, RT_BQ>(qs, S::LD, qg, q_sl, q0, Lq, D, vec);
  rt_load<D, BK>(ks, S::LD, kg, k_sl, 0, Lk, D, vec);
  cp_async_commit();
  rt_load<D, BK>(vs, D, vg, v_sl, 0, Lk, D, vec);
  cp_async_commit();
#pragma unroll
  for (int r = 0; r < RT_RPT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[r][j][0] = o[r][j][1] = o[r][j][2] = o[r][j][3] = 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();  // Q and the first K tile are in
  if (sin != nullptr) {  // RoPE of the Q tile, in place, 8 pairs' tables in flight
    constexpr int PER = RT_BQ * HALF / RT_THREADS;
    static_assert(PER % 8 == 0, "pairs a thread come in eights");
    for (int n0 = 0; n0 < PER; n0 += 8) {
      float t[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = threadIdx.x + (n0 + u) * RT_THREADS, d = i % HALF;
        // a row past Lq is zero and stays zero: any row's table will do
        const long long pos = min(q0 + i / HALF, Lq - 1);
        t[u][0] = __ldg(sin + pos * D + d);
        t[u][1] = __ldg(sin + pos * D + d + HALF);
        t[u][2] = __ldg(cos + pos * D + d);
        t[u][3] = __ldg(cos + pos * D + d + HALF);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = threadIdx.x + (n0 + u) * RT_THREADS, d = i % HALF;
        float* row = qs + (i / HALF) * S::LD;
        const float x1 = row[d], x2 = row[d + HALF];
        row[d] = x1 * t[u][2] - x2 * t[u][0];
        row[d + HALF] = x2 * t[u][3] + x1 * t[u][1];
      }
    }
    __syncthreads();
  }

  for (int jt = 0; jt < ntiles; ++jt) {
    const int kv0 = jt * BK;
    const bool more = jt + 1 < ntiles;

    // S = Q K^T: 4 rows x 8 keys, a float4 of the head dim at a time
    float s[RT_RPT][KPT];
#pragma unroll
    for (int r = 0; r < RT_RPT; ++r) {
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[r][i] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RT_RPT], kv[KPT];
#pragma unroll
      for (int r = 0; r < RT_RPT; ++r) {
        qv[r] = *reinterpret_cast<const float4*>(qs + (rg + 16 * r) * S::LD + d);
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(ks + (kx + 8 * i) * S::LD + d);
      }
#pragma unroll
      for (int r = 0; r < RT_RPT; ++r) {
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          s[r][i] = fmaf(qv[r].x, kv[i].x, s[r][i]);
          s[r][i] = fmaf(qv[r].y, kv[i].y, s[r][i]);
          s[r][i] = fmaf(qv[r].z, kv[i].z, s[r][i]);
          s[r][i] = fmaf(qv[r].w, kv[i].w, s[r][i]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V tile jt is in; every warp is done with K tile jt
    if (more) {  // the next K tile, under this tile's softmax and P V
      rt_load<D, BK>(ks, S::LD, kg, k_sl, kv0 + BK, Lk, D, vec);
      cp_async_commit();
    }

    // scale, mask, the rows' maxima over the tile, the rescale, P
    bool masked[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int key = kv0 + kx + 8 * i;
      masked[i] = key < Lk && mrow != nullptr && __ldg(mrow + key) == 0;
    }
#pragma unroll
    for (int r = 0; r < RT_RPT; ++r) {
      const int row = q0 + rg + 16 * r;
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int key = kv0 + kx + 8 * i;
        float x = -INFINITY;  // a key that does not exist: probability exactly 0
        if (key < Lk) x = (masked[i] || (causal && key > row)) ? -FLT_MAX : s[r][i] * scale_log2;
        s[r][i] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 4));
      const float m_new = fmaxf(m[r], mt);  // key kv0 exists: finite
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        o[r][j][0] *= alpha;
        o[r][j][1] *= alpha;
        o[r][j][2] *= alpha;
        o[r][j][3] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        s[r][i] = exp2f(s[r][i] - m_new);
        l[r] += s[r][i];
      }
    }

    // O += P V, key after key: key src + 8 i's P comes from lane src of the
    // row group; the next key's P and V row are fetched before this key's
    // FMAs. Keys past Lk have P 0 and V 0: every tile runs all BK keys.
    float pn[RT_RPT];
    float4 vn[NJ];
#pragma unroll
    for (int r = 0; r < RT_RPT; ++r) pn[r] = __shfl_sync(FULL, s[r][0], 0, 8);
#pragma unroll
    for (int j = 0; j < NJ; ++j) vn[j] = *reinterpret_cast<const float4*>(vs + 4 * kx + 32 * j);
#pragma unroll
    for (int key = 0; key < BK; ++key) {
      float p[RT_RPT];
      float4 vc[NJ];
#pragma unroll
      for (int r = 0; r < RT_RPT; ++r) p[r] = pn[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vc[j] = vn[j];
      if (key + 1 < BK) {
        const int i = (key + 1) / 8, src = (key + 1) % 8;
        const float* vrow = vs + (key + 1) * D + 4 * kx;
#pragma unroll
        for (int r = 0; r < RT_RPT; ++r) pn[r] = __shfl_sync(FULL, s[r][i], src, 8);
#pragma unroll
        for (int j = 0; j < NJ; ++j) vn[j] = *reinterpret_cast<const float4*>(vrow + 32 * j);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int r = 0; r < RT_RPT; ++r) {
          o[r][j][0] = fmaf(p[r], vc[j].x, o[r][j][0]);
          o[r][j][1] = fmaf(p[r], vc[j].y, o[r][j][1]);
          o[r][j][2] = fmaf(p[r], vc[j].z, o[r][j][2]);
          o[r][j][3] = fmaf(p[r], vc[j].w, o[r][j][3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // K tile jt + 1 is in; every warp is done with V tile jt
    if (more) {  // the next V tile, under the next tile's S
      rt_load<D, BK>(vs, D, vg, v_sl, kv0 + BK, Lk, D, vec);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int r = 0; r < RT_RPT; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    l[r] += __shfl_xor_sync(FULL, l[r], 4);
  }
}

}  // namespace
