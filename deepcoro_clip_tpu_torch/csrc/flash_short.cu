// Short-sequence flash attention for Hopper (sm_90a): the [B, H, L, Dh]
// forward and the whole backward in one launch each, for Lq <= 64 and
// Lk <= 64, in bf16 (tensor cores) and fp32 (FMA units).
//
// Replaces, for short sequences, two Pallas TPU kernels of deepcoro_clip_tpu:
//   - ops/flash_attention.py:84  `_fwd_kernel`;
//   - ops/flash_attention.py:179 `_bwd_kernel`.
// Longer calls keep the 64-row tile kernels of flash_fwd.cu and flash_bwd.cu.
//
// What bounds it on an H100. The main paths send this entry a few tokens
// per head: the multi-video aggregator [4,8,10,64] and [8,8,4,64] bf16 with
// a key mask, the probing head's CLS block [8,8,11,64] fp32 with a key mask.
// A call moves tens of kilobytes and does a few MFLOP: its roofline bound is
// well under a microsecond, so the launch (a few microseconds) and the
// host's work around it set the time, not bytes or FLOPs. The tile kernels
// pad such a head to 64-row tiles (80 to 94% padding), and their backward
// is three launches (a row pre-pass, dK/dV, dQ) after two mask-conversion
// kernels on the host's side.
//
// Design: the Pallas kernel folds all H heads of a batch row into one
// program and keeps K/V resident, because per-step overhead and not FLOPs
// sets its time at these lengths. Here:
//   - one warp owns one (batch, head); a block holds a fixed number of
//     heads that depends on Dh, dtype and direction only (never on B), and
//     the warps of a block share nothing, so a head's result is the same
//     bits whatever the batch size;
//   - the head's q, k, v (and dO, and in bf16 o, in the backward) arrive in
//     shared memory whole, rows padded to 16 (bf16) or 8 (fp32), by 16-byte
//     cp.async copies straight from the caller's strided views; no TMA
//     tensor map is encoded (that is host time per call); the key mask is
//     read once, one byte per key, from the caller's own bool/uint8 mask,
//     into a 64-bit word by two warp votes;
//   - bf16 runs mma.sync m16n8k16 (bf16 x bf16 -> fp32). wgmma needs 64
//     rows per warpgroup: at L = 10 it would pad 84% of the work away, so at
//     these lengths the warp-level instruction is the one that fits. S sits
//     in registers; one exact softmax per row over all its keys (no online
//     rescale), with the rounding points of the tile kernels and of the
//     plain version: exp2 with log2(e) folded into the scale, P rounded to
//     bf16 before P V, l summing the fp32 P (the Hopper tile kernel
//     flash_long_fwd_kernel sums in wgmma's order, so the two agree to
//     rounding, not bit for bit: chip_smoke.py phase 20 counts the cases);
//   - fp32 runs on the FMA units in fp32 (no TF32: the probing head
//     computes in fp32): a group of lanes owns a query row (a key in the
//     backward's second pass), 32 / Lq rounded to a power of two of them,
//     splitting its keys and columns, so the row's softmax needs at most a
//     few xor shuffles and short heads keep the warp busy; a lane scores
//     eight keys at a time for independent FMA chains;
//   - the backward is one launch: each warp rebuilds S and the row
//     statistics itself (the whole row is resident, so nothing is saved by
//     the forward), forms delta = rowsum(dO * O), dV = bf16(P)^T dO,
//     dP = dO V^T, dS = bf16(P (dP - delta) scale) (0 where the score was
//     masked), dQ = dS K and dK = dS^T Q, and applies the transpose of RoPE
//     in fp32 before the rounding. P and dS go through shared memory once
//     (bf16 or fp32) to be read by keys. Every output element is summed
//     by one thread in a fixed order, without atomics: two launches agree
//     bit for bit.
//
// Semantics kept from the plain version (ops/attention.py,
// flash_bwd_plain): keys at index >= Lk do not exist (P = 0); masked keys
// (kv_mask == 0, or causal key > query) score -FLT_MAX, so a row with no
// valid key is the uniform mean of v over the Lk keys (that P feeds dV,
// while dS = 0); rows at index >= Lq add nothing; RoPE (self-attention) is
// rotate-half with the plain version's rounding points, applied to q and k
// in shared memory.
//
// The host passes one block of 64-bit arguments (ShortArg below) and the
// scale: two ctypes arguments instead of the tile kernels' 44.

#include "flash_common.cuh"

namespace {

constexpr int SHORT_MAX = 64;  // Lq and Lk this file takes

// Slots of the argument block the host fills (ops/_flash_cuda.py mirrors
// them): pointers, the stream, (batch, head, row) strides in elements of
// q, k, v and dO, the mask's batch stride, sizes and the causal flag. o,
// dq, dk, dv are contiguous [B, H, L, Dh] tensors the wrapper allocated.
enum ShortArg : int {
  A_Q, A_K, A_V, A_O, A_DO, A_DQ, A_DK, A_DV, A_MASK, A_SIN, A_COS, A_STREAM,
  A_QS, A_KS = A_QS + 3, A_VS = A_KS + 3, A_DOS = A_VS + 3, A_MASK_SB = A_DOS + 3,
  A_B, A_H, A_LQ, A_LK, A_DH, A_CAUSAL, A_COUNT
};

template <typename T>
struct ShortParams {
  const T* q;
  const T* k;
  const T* v;
  T* o;             // the forward's output (read by the backward)
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  const uint8_t* mask;  // [B, Lk] with batch stride mask_sb, nonzero = attend, or null
  const float* sin;     // [L, Dh] fp32 or null
  const float* cos;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long do_sb, do_sh, do_sl;
  long long mask_sb;
  int BH, H, Lq, Lk;
  float scale, scale_log2;
  int causal;
};

// Heads a block holds (the buffers are sized by the call's own lengths;
// these fit at Lq = Lk = 64). The count moved no kernel's time by more
// than a few percent on the H100; fp32 blocks of one warp kept ptxas from
// spilling.
template <typename T, int D, bool BWD>
__host__ __device__ constexpr int heads_per_block() {
  return sizeof(T) == 2 ? (BWD ? 2 : 4) : 1;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared row pitch in elements: rows an odd number of 16-byte units long,
// so that eight rows read at once (ldmatrix, or the fp32 lanes' float4
// reads of different rows) fall in eight different bank groups.
template <typename T, int D>
__host__ __device__ constexpr int pitch() { return sizeof(T) == 2 ? D + PAD : D + 4; }

// fp32 rows are padded to this many (the keys scored at once, KG below)
constexpr int RG = 8;

// Shared memory one warp takes: bf16 rows padded to 16, fp32 rows to RG.
template <typename T, int D, bool BWD>
__host__ __device__ constexpr int warp_smem_bytes(int Lq, int Lk) {
  const int m = sizeof(T) == 2 ? 16 : RG;
  const int lq = round_up(Lq, m), lk = round_up(Lk, m);
  const int ld = pitch<T, D>();
  // q; k, v (and, in fp32, every lane's scores [32][lk + 1])
  if (!BWD) return (lq + 2 * lk) * ld * static_cast<int>(sizeof(T)) +
                   (sizeof(T) == 2 ? 0 : 32 * (lk + 1) * 4);
  if (sizeof(T) == 2) {
    // q, dO, o; k, v; P and dS [lq][lk + PAD] bf16; delta [lq] fp32
    return ((3 * lq + 2 * lk) * ld + 2 * lq * (lk + PAD)) * 2 + lq * 4;
  }
  // q, dO; k, v; P and dS [Lq rounded up to 32][lk + 1] fp32 (o is read
  // from device memory)
  return ((2 * lq + 2 * lk) * ld + 2 * round_up(Lq, 32) * (lk + 1)) * 4;
}

// Rows [0, rows) of a strided [L, D] operand into shared rows of `ld`
// elements by the warp's 16-byte cp.async copies; rows at or past L are
// zero-filled, so padding never meets uninitialised memory in a product.
template <typename T, int D>
__device__ __forceinline__ void warp_load_rows(T* s, int ld, const T* g, long long sl,
                                               int rows, int L) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements per copy
  constexpr int CH = D / EPC;                             // copies per row
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < rows * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < L;
    const T* src = g + (long long)(ok ? r : 0) * sl + c * EPC;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(s + r * ld + c * EPC)),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// Bit j set: key j exists (j < Lk) and the key mask lets it be attended.
// One byte a key, read once, by two warp votes.
__device__ __forceinline__ unsigned long long key_bits(const uint8_t* m, int Lk) {
  const int lane = threadIdx.x % 32;
  const bool a = lane < Lk && (m == nullptr || m[lane] != 0);
  const bool b = lane + 32 < Lk && (m == nullptr || m[lane + 32] != 0);
  const unsigned lo = __ballot_sync(FULL, a), hi = __ballot_sync(FULL, b);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// The score of (row, key) in log2 units: -inf for a key that does not
// exist, -FLT_MAX for a masked one.
__device__ __forceinline__ float log2_score(float s, int key, int row, int Lk,
                                            unsigned long long bits, int causal,
                                            float scale_log2) {
  if (key >= Lk) return -INFINITY;
  if (!((bits >> key) & 1ull) || (causal && key > row)) return -FLT_MAX;
  return s * scale_log2;
}

// In-place rotate-half RoPE of rows [0, L) of a shared bf16 head, with the
// plain version's rounding points (rope_pair), by one warp.
template <int D>
__device__ __forceinline__ void warp_rope(__nv_bfloat16* s, int ld, const float* sin,
                                          const float* cos, int L) {
  constexpr int HALF = D / 2;
  for (int i = threadIdx.x % 32; i < L * HALF; i += 32) {
    const int r = i / HALF, d = i % HALF;
    __nv_bfloat16* row = s + r * ld;
    const float* sr = sin + (long long)r * D;
    const float* cr = cos + (long long)r * D;
    rope_pair(__bfloat162float(row[d]), __bfloat162float(row[d + HALF]), sr[d],
              sr[d + HALF], cr[d], cr[d + HALF], row[d], row[d + HALF]);
  }
}

// The same in fp32 with fp32 tables.
template <int D>
__device__ __forceinline__ void warp_rope_f32(float* s, int ld, const float* sin,
                                              const float* cos, int L) {
  constexpr int HALF = D / 2;
  for (int i = threadIdx.x % 32; i < L * HALF; i += 32) {
    const int r = i / HALF, d = i % HALF;
    float* row = s + r * ld;
    const float* sr = sin + (long long)r * D;
    const float* cr = cos + (long long)r * D;
    const float x1 = row[d], x2 = row[d + HALF];
    row[d] = x1 * cr[d] - x2 * sr[d];
    row[d + HALF] = x2 * cr[d + HALF] + x1 * sr[d + HALF];
  }
}

// ldmatrix lane offsets. ROW/COL_N: a [n][k] tile read as the B operand of
// one k16 x two n8 tiles (x4), or a [k][m] tile read transposed as an A
// operand (x4.trans). ROW/COL_K: a [k][n] tile read transposed as the B
// operand of one k16 x two n8 tiles.
__device__ __forceinline__ int row_n(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int col_n(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int row_k(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int col_k(int lane) { return (lane >> 4) * 8; }

// ---- bf16 -------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(32 * heads_per_block<__nv_bfloat16, D, false>())
flash_short_fwd_bf16_kernel(const ShortParams<__nv_bfloat16> p) {
  using bf16 = __nv_bfloat16;
  constexpr int HEADS = heads_per_block<bf16, D, false>();
  constexpr int LD = pitch<bf16, D>(), KS = D / 16, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x * HEADS + warp;
  if (bh >= p.BH) return;  // the warps of a block share nothing: no barrier follows
  const int b = bh / p.H, h = bh % p.H;
  const int g = lane >> 2, t = lane & 3;
  const int lq16 = round_up(p.Lq, 16), lk16 = round_up(p.Lk, 16), nk = lk16 / 16;

  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + warp * warp_smem_bytes<bf16, D, false>(p.Lq, p.Lk));
  bf16* Ks = Qs + lq16 * LD;
  bf16* Vs = Ks + lk16 * LD;
  warp_load_rows<bf16, D>(Qs, LD, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, lq16, p.Lq);
  warp_load_rows<bf16, D>(Ks, LD, p.k + b * p.k_sb + h * p.k_sh, p.k_sl, lk16, p.Lk);
  warp_load_rows<bf16, D>(Vs, LD, p.v + b * p.v_sb + h * p.v_sh, p.v_sl, lk16, p.Lk);
  cp_async_commit();
  const unsigned long long bits =
      key_bits(p.mask ? p.mask + b * p.mask_sb : nullptr, p.Lk);
  cp_async_wait<0>();
  __syncwarp();
  if (p.sin != nullptr) {
    warp_rope<D>(Qs, LD, p.sin, p.cos, p.Lq);
    warp_rope<D>(Ks, LD, p.sin, p.cos, p.Lk);
    __syncwarp();
  }
  bf16* og = p.o + (long long)bh * p.Lq * D;

  for (int qb = 0; qb < lq16 / 16; ++qb) {
    // S = Q K^T for 16 rows x all keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      ldsm_x4(qa, Qs + (qb * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < nk) {
          uint32_t kb[4];
          ldsm_x4(kb, Ks + (np * 16 + row_n(lane)) * LD + ks * 16 + col_n(lane));
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
    }
    // one exact softmax per row: scale, mask, row maxima
    const int row_a = qb * 16 + g, row_b = row_a + 8;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * nk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = log2_score(s[nt][e], nt * 8 + 2 * t + (e & 1),
                                     e < 2 ? row_a : row_b, p.Lk, bits, p.causal,
                                     p.scale_log2);
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // key 0 exists: the maxima are finite
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    }
    // P = exp2(S - m), re-packed as the A fragments of P V: n8 tiles 2kk
    // and 2kk+1 of S are the k16 slice kk of P
    float l_r[2] = {0.f, 0.f};
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * nk) {
        const float p0 = exp2f(s[nt][0] - mx[0]);
        const float p1 = exp2f(s[nt][1] - mx[0]);
        const float p2 = exp2f(s[nt][2] - mx[1]);
        const float p3 = exp2f(s[nt][3] - mx[1]);
        l_r[0] += p0 + p1;
        l_r[1] += p2 + p3;
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);  // row g
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
      }
    }
    // O = P V
    float acc[NO][4];
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < nk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, Vs + (kk * 16 + row_k(lane)) * LD + dp * 16 + col_k(lane));
          mma_bf16(acc[2 * dp], pf[kk], vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pf[kk], vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      if (row >= p.Lq) continue;
      const float inv = 1.f / l_r[r];  // l >= 1: the row maximum contributes exp2(0)
      bf16* orow = og + (long long)row * D;
#pragma unroll
      for (int dn = 0; dn < NO; ++dn) {
        *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
            pack_bf16(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * heads_per_block<__nv_bfloat16, D, true>())
flash_short_bwd_bf16_kernel(const ShortParams<__nv_bfloat16> p) {
  using bf16 = __nv_bfloat16;
  constexpr int HEADS = heads_per_block<bf16, D, true>();
  constexpr int LD = pitch<bf16, D>(), KS = D / 16, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x * HEADS + warp;
  if (bh >= p.BH) return;
  const int b = bh / p.H, h = bh % p.H;
  const int g = lane >> 2, t = lane & 3;
  const int lq16 = round_up(p.Lq, 16), lk16 = round_up(p.Lk, 16);
  const int nq = lq16 / 16, nk = lk16 / 16, LDP = lk16 + PAD;

  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + warp * warp_smem_bytes<bf16, D, true>(p.Lq, p.Lk));
  bf16* Gs = Qs + lq16 * LD;  // dO
  bf16* Os = Gs + lq16 * LD;
  bf16* Ks = Os + lq16 * LD;
  bf16* Vs = Ks + lk16 * LD;
  bf16* Ps = Vs + lk16 * LD;  // P  [lq16][LDP], bf16 as it enters dV
  bf16* Ss = Ps + lq16 * LDP; // dS [lq16][LDP]
  float* Dl = reinterpret_cast<float*>(Ss + lq16 * LDP);  // delta [lq16]
  const long long oq = (long long)bh * p.Lq * D, ok = (long long)bh * p.Lk * D;
  warp_load_rows<bf16, D>(Qs, LD, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, lq16, p.Lq);
  warp_load_rows<bf16, D>(Gs, LD, p.dout + b * p.do_sb + h * p.do_sh, p.do_sl, lq16, p.Lq);
  warp_load_rows<bf16, D>(Os, LD, p.o + oq, D, lq16, p.Lq);
  warp_load_rows<bf16, D>(Ks, LD, p.k + b * p.k_sb + h * p.k_sh, p.k_sl, lk16, p.Lk);
  warp_load_rows<bf16, D>(Vs, LD, p.v + b * p.v_sb + h * p.v_sh, p.v_sl, lk16, p.Lk);
  cp_async_commit();
  const unsigned long long bits =
      key_bits(p.mask ? p.mask + b * p.mask_sb : nullptr, p.Lk);
  cp_async_wait<0>();
  __syncwarp();
  // delta = rowsum(dO * O) in fp32 from the bf16 O, one lane a row; padded
  // rows get 0
  for (int r = lane; r < lq16; r += 32) {
    float acc = 0.f;
    for (int c = 0; c < D; c += 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(Os + r * LD + c);
      const uint4 d = *reinterpret_cast<const uint4*>(Gs + r * LD + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(d2[i]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
    Dl[r] = acc;
  }
  if (p.sin != nullptr) {
    warp_rope<D>(Qs, LD, p.sin, p.cos, p.Lq);
    warp_rope<D>(Ks, LD, p.sin, p.cos, p.Lk);
  }
  __syncwarp();

  // pass 1, per 16 q rows: S, dP, P, dS; dQ = dS K; P and dS to shared memory
  for (int qb = 0; qb < nq; ++qb) {
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], ga[4];
      ldsm_x4(qa, Qs + (qb * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      ldsm_x4(ga, Gs + (qb * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < nk) {
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, Ks + (np * 16 + row_n(lane)) * LD + ks * 16 + col_n(lane));
          ldsm_x4(vb, Vs + (np * 16 + row_n(lane)) * LD + ks * 16 + col_n(lane));
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
        }
      }
    }
    const int row_a = qb * 16 + g, row_b = row_a + 8;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * nk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = log2_score(s[nt][e], nt * 8 + 2 * t + (e & 1),
                                     e < 2 ? row_a : row_b, p.Lk, bits, p.causal,
                                     p.scale_log2);
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    }
    float l_r[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    }
    // the forward's row sums, summed in its order
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * nk) {
        const float p0 = exp2f(s[nt][0] - mx[0]);
        const float p1 = exp2f(s[nt][1] - mx[0]);
        const float p2 = exp2f(s[nt][2] - mx[1]);
        const float p3 = exp2f(s[nt][3] - mx[1]);
        l_r[0] += p0 + p1;
        l_r[1] += p2 + p3;
        s[nt][0] = p0; s[nt][1] = p1; s[nt][2] = p2; s[nt][3] = p3;
      }
    }
    float il[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
      const int row = r ? row_b : row_a;
      // rows past Lq add nothing: P = 0 there
      il[r] = row < p.Lq ? 1.f / l_r[r] : 0.f;
      dl[r] = Dl[row];
    }
    uint32_t sf[4][4];  // dS as the A fragments of dQ = dS K
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * nk) {
        float pv[4], sv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = nt * 8 + 2 * t + (e & 1);
          const int row = r ? row_b : row_a;
          const float prob = s[nt][e] * il[r];
          const bool live = key < p.Lk && ((bits >> key) & 1ull) && !(p.causal && key > row);
          pv[e] = prob;
          sv[e] = live ? prob * (dp[nt][e] - dl[r]) * p.scale : 0.f;
        }
        const uint32_t pa = pack_bf16(pv[0], pv[1]), pb = pack_bf16(pv[2], pv[3]);
        const uint32_t sa = pack_bf16(sv[0], sv[1]), sb = pack_bf16(sv[2], sv[3]);
        sf[nt >> 1][(nt & 1) * 2 + 0] = sa;
        sf[nt >> 1][(nt & 1) * 2 + 1] = sb;
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(Ps + row_a * LDP + col) = pa;
        *reinterpret_cast<uint32_t*>(Ps + row_b * LDP + col) = pb;
        *reinterpret_cast<uint32_t*>(Ss + row_a * LDP + col) = sa;
        *reinterpret_cast<uint32_t*>(Ss + row_b * LDP + col) = sb;
      }
    }
    // dQ = dS K (k dim: the keys)
    float dq[NO][4];
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < nk) {
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, Ks + (kk * 16 + row_k(lane)) * LD + dd * 16 + col_k(lane));
          mma_bf16(dq[2 * dd], sf[kk], kb[0], kb[1]);
          mma_bf16(dq[2 * dd + 1], sf[kk], kb[2], kb[3]);
        }
      }
    }
    store_rows<D>(dq, p.dq + oq, D, row_a, p.Lq, p.sin, p.cos, t);
  }
  __syncwarp();  // P and dS of every row are in shared memory

  // pass 2, per 16 keys: dV = P^T dO, dK = dS^T Q (k dim: the q rows)
  for (int kb = 0; kb < nk; ++kb) {
    float dv[NO][4], dk[NO][4];
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
      dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    }
    for (int qk = 0; qk < nq; ++qk) {
      uint32_t pa[4], sa[4];  // P^T and dS^T: the [q][key] tiles read transposed
      ldsm_x4_trans(pa, Ps + (qk * 16 + row_n(lane)) * LDP + kb * 16 + col_n(lane));
      ldsm_x4_trans(sa, Ss + (qk * 16 + row_n(lane)) * LDP + kb * 16 + col_n(lane));
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t gb[4], qb[4];
        ldsm_x4_trans(gb, Gs + (qk * 16 + row_k(lane)) * LD + dp * 16 + col_k(lane));
        ldsm_x4_trans(qb, Qs + (qk * 16 + row_k(lane)) * LD + dp * 16 + col_k(lane));
        mma_bf16(dv[2 * dp], pa, gb[0], gb[1]);
        mma_bf16(dv[2 * dp + 1], pa, gb[2], gb[3]);
        mma_bf16(dk[2 * dp], sa, qb[0], qb[1]);
        mma_bf16(dk[2 * dp + 1], sa, qb[2], qb[3]);
      }
    }
    const int key_a = kb * 16 + g;
    store_rows<D>(dv, p.dv + ok, D, key_a, p.Lk, nullptr, nullptr, t);
    store_rows<D>(dk, p.dk + ok, D, key_a, p.Lk, p.sin, p.cos, t);
  }
}

// ---- fp32 -------------------------------------------------------------------
// A group of lanes owns a query row (in the backward's second pass, a
// key): as many lanes a row as 32 / (Lq rounded up to a power of two), so
// that short heads keep the whole warp busy. The group's lanes split the
// keys (lane `sub` of the group scores keys sub, sub + lpr, ...) and the
// output columns; the row's maximum, sum and delta are reduced over the
// group by xor shuffles in a fixed order. K, V, Q and dO rows that the
// group reads at once are shared-memory broadcasts; rows are an odd number
// of 16-byte units apart, and the score rows an odd number of floats, so
// lanes reading different rows meet no bank conflict.

constexpr int KG = RG;  // keys a lane scores at once: independent FMA chains
constexpr int CW = 16;  // output columns a lane sums at once, with their rotate-half partners

__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

// Lanes a row (or key) when n of them share a warp: 32 / (n rounded up to
// a power of two), at least 1.
__device__ __forceinline__ int lanes_per(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p >= 32 ? 1 : 32 / p;
}

__device__ __forceinline__ float group_max(float x, int lpr) {
  for (int off = 1; off < lpr; off <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int lpr) {
  for (int off = 1; off < lpr; off <<= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Dot products, summed in d order, of the row `x` with the keys j0, j0 +
// step, ... (KG of them; 0 for keys at or past Lk) of `rows` (pitch ld).
template <int D>
__device__ __forceinline__ void dot_keys(const float* x, const float* rows, int ld, int j0,
                                         int step, int Lk, float (&s)[KG]) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < KG; ++r) s[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 a = ld4(x + d);
#pragma unroll
    for (int r = 0; r < KG; ++r) {
      const int j = j0 + r * step;
      const float4 b = j < Lk ? ld4(rows + j * ld + d) : zero;
      s[r] = fmaf(a.x, b.x, s[r]); s[r] = fmaf(a.y, b.y, s[r]);
      s[r] = fmaf(a.z, b.z, s[r]); s[r] = fmaf(a.w, b.w, s[r]);
    }
  }
}

// acc1/acc2 += w * row[c0, c0 + CW) / row[D/2 + c0, ...) (a broadcast row).
template <int D>
__device__ __forceinline__ void axpy_pair(float w, const float* row, int c0,
                                          float (&acc1)[CW], float (&acc2)[CW]) {
#pragma unroll
  for (int c = 0; c < CW; c += 4) {
    const float4 a = ld4(row + c0 + c), b = ld4(row + D / 2 + c0 + c);
    acc1[c] = fmaf(w, a.x, acc1[c]); acc1[c + 1] = fmaf(w, a.y, acc1[c + 1]);
    acc1[c + 2] = fmaf(w, a.z, acc1[c + 2]); acc1[c + 3] = fmaf(w, a.w, acc1[c + 3]);
    acc2[c] = fmaf(w, b.x, acc2[c]); acc2[c + 1] = fmaf(w, b.y, acc2[c + 1]);
    acc2[c + 2] = fmaf(w, b.z, acc2[c + 2]); acc2[c + 3] = fmaf(w, b.w, acc2[c + 3]);
  }
}

// Columns [c0, c0 + CW) and their partners [D/2 + c0, ...) of the row
// `pos` into `out`, scaled by `scale`, through the transpose of
// rotate-half RoPE (fp32 tables) when `sin` is set.
template <int D>
__device__ __forceinline__ void store_pair(float (&acc1)[CW], float (&acc2)[CW], float* out,
                                           int c0, float scale, const float* sin,
                                           const float* cos, int pos) {
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    acc1[c] *= scale;
    acc2[c] *= scale;
  }
  if (sin != nullptr) {
    const float* sr = sin + (long long)pos * D;
    const float* cr = cos + (long long)pos * D;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int d = c0 + c, d2 = d + D / 2;
      const float g1 = acc1[c], g2 = acc2[c];
      acc1[c] = g1 * cr[d] + g2 * sr[d2];
      acc2[c] = g2 * cr[d2] - g1 * sr[d];
    }
  }
#pragma unroll
  for (int c = 0; c < CW; c += 4) {
    *reinterpret_cast<float4*>(out + c0 + c) =
        make_float4(acc1[c], acc1[c + 1], acc1[c + 2], acc1[c + 3]);
    *reinterpret_cast<float4*>(out + D / 2 + c0 + c) =
        make_float4(acc2[c], acc2[c + 1], acc2[c + 2], acc2[c + 3]);
  }
}

// The scores of query row `qi` (position `row`) against this lane's keys
// (sub, sub + lpr, ...), in log2 units with the mask applied, into `prow`;
// returns their maximum (-inf for a lane without keys).
template <int D>
__device__ __forceinline__ float score_row(const float* qi, const float* Ks, int ld,
                                           float* prow, int row, int Lk, int sub, int lpr,
                                           unsigned long long bits, int causal,
                                           float scale_log2) {
  float m = -INFINITY;
  for (int j0 = sub; j0 < Lk; j0 += KG * lpr) {
    float s[KG];
    dot_keys<D>(qi, Ks, ld, j0, lpr, Lk, s);
#pragma unroll
    for (int r = 0; r < KG; ++r) {
      const int j = j0 + r * lpr;
      if (j < Lk) {
        const float x = log2_score(s[r], j, row, Lk, bits, causal, scale_log2);
        prow[j] = x;
        m = fmaxf(m, x);
      }
    }
  }
  return m;
}

// exp2(score - m) over this lane's keys, in place; returns their sum.
__device__ __forceinline__ float exp_row(float* prow, float m, int Lk, int sub, int lpr) {
  float l = 0.f;
  for (int j = sub; j < Lk; j += lpr) {
    const float e = exp2f(prow[j] - m);
    prow[j] = e;
    l += e;
  }
  return l;
}

template <int D>
__global__ void __launch_bounds__(32 * heads_per_block<float, D, false>())
flash_short_fwd_f32_kernel(const ShortParams<float> p) {
  constexpr int HEADS = heads_per_block<float, D, false>();
  constexpr int LD = pitch<float, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x * HEADS + warp;
  if (bh >= p.BH) return;
  const int b = bh / p.H, h = bh % p.H;
  const int lq = round_up(p.Lq, RG), lk = round_up(p.Lk, RG), lkp = lk + 1;
  const int lpr = lanes_per(p.Lq), sub = lane % lpr;

  float* Qs = reinterpret_cast<float*>(
      smem_raw + warp * warp_smem_bytes<float, D, false>(p.Lq, p.Lk));
  float* Ks = Qs + lq * LD;
  float* Vs = Ks + lk * LD;
  float* prow = Vs + lk * LD + (lane / lpr) * lkp;  // the group's scores, then P
  warp_load_rows<float, D>(Qs, LD, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, lq, p.Lq);
  warp_load_rows<float, D>(Ks, LD, p.k + b * p.k_sb + h * p.k_sh, p.k_sl, lk, p.Lk);
  warp_load_rows<float, D>(Vs, LD, p.v + b * p.v_sb + h * p.v_sh, p.v_sl, lk, p.Lk);
  cp_async_commit();
  const unsigned long long bits =
      key_bits(p.mask ? p.mask + b * p.mask_sb : nullptr, p.Lk);
  cp_async_wait<0>();
  __syncwarp();
  if (p.sin != nullptr) {
    warp_rope_f32<D>(Qs, LD, p.sin, p.cos, p.Lq);
    warp_rope_f32<D>(Ks, LD, p.sin, p.cos, p.Lk);
    __syncwarp();
  }

  // every lane runs every pass (the group reductions need the whole warp);
  // a group past Lq works on the last row and writes nothing
  for (int i0 = 0; i0 < p.Lq; i0 += 32 / lpr) {
    const int i = i0 + lane / lpr, ir = min(i, p.Lq - 1);
    const float m = group_max(score_row<D>(Qs + ir * LD, Ks, LD, prow, ir, p.Lk, sub, lpr,
                                           bits, p.causal, p.scale_log2), lpr);
    const float il = 1.f / group_sum(exp_row(prow, m, p.Lk, sub, lpr), lpr);  // l >= 1
    __syncwarp();  // the group's P is in shared memory
    for (int c0 = sub * CW; c0 < D / 2; c0 += lpr * CW) {  // O = P V, keys in order
      float a1[CW], a2[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) a1[c] = a2[c] = 0.f;
      for (int j = 0; j < p.Lk; ++j) axpy_pair<D>(prow[j], Vs + j * LD, c0, a1, a2);
      if (i < p.Lq) {
        store_pair<D>(a1, a2, p.o + ((long long)bh * p.Lq + i) * D, c0, il, nullptr,
                      nullptr, i);
      }
    }
    __syncwarp();  // before the next pass writes its scores
  }
}

template <int D>
__global__ void __launch_bounds__(32 * heads_per_block<float, D, true>())
flash_short_bwd_f32_kernel(const ShortParams<float> p) {
  constexpr int HEADS = heads_per_block<float, D, true>();
  constexpr int LD = pitch<float, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x * HEADS + warp;
  if (bh >= p.BH) return;
  const int b = bh / p.H, h = bh % p.H;
  const int lq = round_up(p.Lq, RG), lk = round_up(p.Lk, RG), lkp = lk + 1;
  const int lpr = lanes_per(p.Lq), sub = lane % lpr;

  float* Qs = reinterpret_cast<float*>(
      smem_raw + warp * warp_smem_bytes<float, D, true>(p.Lq, p.Lk));
  float* Gs = Qs + lq * LD;  // dO
  float* Ks = Gs + lq * LD;
  float* Vs = Ks + lk * LD;
  float* Ps = Vs + lk * LD;                   // P  [Lq rounded up to 32][lkp]
  float* Ss = Ps + round_up(p.Lq, 32) * lkp;  // dS, the same
  const long long oq = (long long)bh * p.Lq * D, okv = (long long)bh * p.Lk * D;
  warp_load_rows<float, D>(Qs, LD, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, lq, p.Lq);
  warp_load_rows<float, D>(Gs, LD, p.dout + b * p.do_sb + h * p.do_sh, p.do_sl, lq, p.Lq);
  warp_load_rows<float, D>(Ks, LD, p.k + b * p.k_sb + h * p.k_sh, p.k_sl, lk, p.Lk);
  warp_load_rows<float, D>(Vs, LD, p.v + b * p.v_sb + h * p.v_sh, p.v_sl, lk, p.Lk);
  cp_async_commit();
  const unsigned long long bits =
      key_bits(p.mask ? p.mask + b * p.mask_sb : nullptr, p.Lk);
  cp_async_wait<0>();
  __syncwarp();
  if (p.sin != nullptr) {
    warp_rope_f32<D>(Qs, LD, p.sin, p.cos, p.Lq);
    warp_rope_f32<D>(Ks, LD, p.sin, p.cos, p.Lk);
    __syncwarp();
  }

  // pass 1, a group a query row: P and dS to shared memory, dQ = dS K; a
  // group past Lq works on the last row into rows of its own, writes nothing
  for (int i0 = 0; i0 < p.Lq; i0 += 32 / lpr) {
    const int i = i0 + lane / lpr, ir = min(i, p.Lq - 1);
    const float* qi = Qs + ir * LD;
    const float* gi = Gs + ir * LD;
    float* prow = Ps + i * lkp;
    float* srow = Ss + i * lkp;
    const float m = group_max(score_row<D>(qi, Ks, LD, prow, ir, p.Lk, sub, lpr, bits,
                                           p.causal, p.scale_log2), lpr);
    const float il = 1.f / group_sum(exp_row(prow, m, p.Lk, sub, lpr), lpr);
    float delta = 0.f;  // rowsum(dO * O), O from device memory; the group splits d
    const float* orow = p.o + oq + (long long)ir * D;
    for (int d = sub * 4; d < D; d += 4 * lpr) {
      const float4 a = ld4(gi + d), o = ld4(orow + d);
      delta = fmaf(a.x, o.x, delta); delta = fmaf(a.y, o.y, delta);
      delta = fmaf(a.z, o.z, delta); delta = fmaf(a.w, o.w, delta);
    }
    delta = group_sum(delta, lpr);
    for (int j0 = sub; j0 < p.Lk; j0 += KG * lpr) {
      float dp[KG];
      dot_keys<D>(gi, Vs, LD, j0, lpr, p.Lk, dp);  // dP = dO V^T
#pragma unroll
      for (int r = 0; r < KG; ++r) {
        const int j = j0 + r * lpr;
        if (j < p.Lk) {
          const bool live = ((bits >> j) & 1ull) && !(p.causal && j > ir);
          const float prob = prow[j] * il;
          prow[j] = prob;
          srow[j] = live ? prob * (dp[r] - delta) * p.scale : 0.f;
        }
      }
    }
    __syncwarp();  // the group's dS is in shared memory
    for (int c0 = sub * CW; c0 < D / 2; c0 += lpr * CW) {
      float a1[CW], a2[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) a1[c] = a2[c] = 0.f;
      for (int j = 0; j < p.Lk; ++j) axpy_pair<D>(srow[j], Ks + j * LD, c0, a1, a2);
      if (i < p.Lq) store_pair<D>(a1, a2, p.dq + oq + (long long)i * D, c0, 1.f, p.sin, p.cos, i);
    }
  }
  __syncwarp();  // P and dS of every row are in shared memory

  // pass 2, a group a key: dV = P^T dO, dK = dS^T Q, q rows in order; the
  // group splits the columns
  const int lpk = lanes_per(p.Lk), subk = lane % lpk;
  for (int j = lane / lpk; j < p.Lk; j += 32 / lpk) {
    for (int c0 = subk * CW; c0 < D / 2; c0 += lpk * CW) {
      float v1[CW], v2[CW], k1[CW], k2[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) v1[c] = v2[c] = k1[c] = k2[c] = 0.f;
      for (int i = 0; i < p.Lq; ++i) {
        axpy_pair<D>(Ps[i * lkp + j], Gs + i * LD, c0, v1, v2);
        axpy_pair<D>(Ss[i * lkp + j], Qs + i * LD, c0, k1, k2);
      }
      store_pair<D>(v1, v2, p.dv + okv + (long long)j * D, c0, 1.f, nullptr, nullptr, j);
      store_pair<D>(k1, k2, p.dk + okv + (long long)j * D, c0, 1.f, p.sin, p.cos, j);
    }
  }
}

// ---- host side ----------------------------------------------------------------

template <typename T>
ShortParams<T> unpack(const long long* a, float scale) {
  ShortParams<T> p;
  p.q = reinterpret_cast<const T*>(a[A_Q]);
  p.k = reinterpret_cast<const T*>(a[A_K]);
  p.v = reinterpret_cast<const T*>(a[A_V]);
  p.o = reinterpret_cast<T*>(a[A_O]);
  p.dout = reinterpret_cast<const T*>(a[A_DO]);
  p.dq = reinterpret_cast<T*>(a[A_DQ]);
  p.dk = reinterpret_cast<T*>(a[A_DK]);
  p.dv = reinterpret_cast<T*>(a[A_DV]);
  p.mask = reinterpret_cast<const uint8_t*>(a[A_MASK]);
  p.sin = reinterpret_cast<const float*>(a[A_SIN]);
  p.cos = reinterpret_cast<const float*>(a[A_COS]);
  p.q_sb = a[A_QS]; p.q_sh = a[A_QS + 1]; p.q_sl = a[A_QS + 2];
  p.k_sb = a[A_KS]; p.k_sh = a[A_KS + 1]; p.k_sl = a[A_KS + 2];
  p.v_sb = a[A_VS]; p.v_sh = a[A_VS + 1]; p.v_sl = a[A_VS + 2];
  p.do_sb = a[A_DOS]; p.do_sh = a[A_DOS + 1]; p.do_sl = a[A_DOS + 2];
  p.mask_sb = a[A_MASK_SB];
  p.H = static_cast<int>(a[A_H]);
  p.BH = static_cast<int>(a[A_B] * a[A_H]);
  p.Lq = static_cast<int>(a[A_LQ]);
  p.Lk = static_cast<int>(a[A_LK]);
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = static_cast<int>(a[A_CAUSAL]);
  return p;
}

template <typename T, int D, bool BWD>
cudaError_t launch_short(const ShortParams<T>& p, cudaStream_t stream) {
  constexpr int HEADS = heads_per_block<T, D, BWD>();
  void (*kernel)(ShortParams<T>);
  if constexpr (sizeof(T) == 2) {
    kernel = BWD ? flash_short_bwd_bf16_kernel<D> : flash_short_fwd_bf16_kernel<D>;
  } else {
    kernel = BWD ? flash_short_bwd_f32_kernel<D> : flash_short_fwd_f32_kernel<D>;
  }
  // the attribute is set once, to what the longest call takes
  static bool ready[MAX_DEVICES] = {};
  cudaError_t err = allow_smem_once(reinterpret_cast<const void*>(kernel),
                                    HEADS * warp_smem_bytes<T, D, BWD>(SHORT_MAX, SHORT_MAX),
                                    ready);
  if (err != cudaSuccess) return err;
  const int blocks = (p.BH + HEADS - 1) / HEADS;
  kernel<<<blocks, 32 * HEADS, HEADS * warp_smem_bytes<T, D, BWD>(p.Lq, p.Lk), stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool BWD>
int run(const long long* a, float scale) {
  const ShortParams<T> p = unpack<T>(a, scale);
  if (p.Lq < 1 || p.Lq > SHORT_MAX || p.Lk < 1 || p.Lk > SHORT_MAX || p.BH < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[A_STREAM]);
  switch (a[A_DH]) {
    case 64: return static_cast<int>(launch_short<T, 64, BWD>(p, stream));
    case 128: return static_cast<int>(launch_short<T, 128, BWD>(p, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The length of the argument block the entries below read.
int deepcoro_flash_short_arg_count() { return A_COUNT; }

// Forward: writes attention of q over k/v into o. `args` holds A_COUNT
// 64-bit values in ShortArg order (dout, dq, dk, dv unused). Returns 0 on
// success, else the CUDA error code of the launch (cudaErrorInvalidValue
// for a length outside [1, 64] or a head dim other than 64 and 128).
int deepcoro_flash_short_fwd_bf16(const long long* args, float scale) {
  return run<__nv_bfloat16, false>(args, scale);
}
int deepcoro_flash_short_fwd_f32(const long long* args, float scale) {
  return run<float, false>(args, scale);
}

// Backward: writes dq, dk, dv (contiguous [B, H, L, Dh]) from dout and the
// forward's output o, in one launch.
int deepcoro_flash_short_bwd_bf16(const long long* args, float scale) {
  return run<__nv_bfloat16, true>(args, scale);
}
int deepcoro_flash_short_bwd_f32(const long long* args, float scale) {
  return run<float, true>(args, scale);
}

}  // extern "C"
