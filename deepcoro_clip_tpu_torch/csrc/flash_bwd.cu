// Flash-attention backward for Hopper (sm_90a): bf16 in/out with fp32 sums on
// the tensor cores, and plain fp32 kernels for fp32 operands (below).
//
// Replaces two Pallas TPU kernels of deepcoro_clip_tpu:
//   - ops/flash_attention_packed.py `_bwd_kernel` (packed [B, L, H*Dh]; in
//     fused mode dq, dk, dv are written through strided views straight into
//     one [B, L, 3D] gradient of the fused QKV tensor);
//   - ops/flash_attention.py `_bwd_kernel` ([B, H, L, Dh]).
// As in flash_fwd.cu, one set of kernels serves both: every operand is a
// base pointer plus (batch, head, row) strides in elements.
//
// What it computes (Dao's backward, with the Pallas kernel's rounding
// points), per (batch, head):
//   P  = softmax(scale * rot(Q) rot(K)^T + mask)          fp32, rebuilt
//   dV = bf16(P)^T dO                                     fp32 sum
//   dP = dO V^T
//   delta = rowsum(dO * O)                                fp32, from bf16 O
//   dS = bf16(P * (dP - delta) * scale), 0 where masked
//   dQ = unrot(dS rot(K)),  dK = unrot(dS^T rot(Q))       unrot in fp32,
//                                                         then bf16
//
// What bounds it on an H100: 10*L*L*Dh FLOP per head against 8*L*Dh*2 bytes
// (q, k, v, do, o read; dq, dk, dv written), 5L/8 FLOP per byte: above the
// card's ~295 FLOP/byte ridge at the video tower's L = 1569 (operations
// bound it), at it for the text tower's L = 512, below it at L = 393 and in
// the aggregator (bytes, then launch latency).
//
// Design. The Pallas kernel walks the q-blocks of one head in order, holds
// all of K/V in VMEM, rebuilds one exact softmax per q-block and carries
// dK/dV in fp32 scratch from one grid step to the next. Here blocks run in
// parallel and K/V do not fit in shared memory, so:
//   - the forward kernel writes each row's softmax maximum and sum (fp32,
//     when a gradient is wanted); a pre-pass turns them into (m, 1/l,
//     delta) per row, padded to whole 64-row tiles, so P = exp2(s - m) / l
//     is rebuilt tile by tile exactly as the forward defined it;
//   - with RoPE, q and k are rotated once by a pre-pass into scratch copies
//     (the forward's rotation, bit for bit), so the main kernels read plain
//     tiles;
//   - dK/dV: one kernel whose blocks each own a key tile and loop over the
//     q tiles, dK and dV in registers for the whole loop, written once. It
//     works on the transposed tile S^T = K Q^T so that P^T and dS^T come out
//     of the accumulators already laid out as the A operand of the two
//     products that follow;
//   - dQ: a second kernel whose blocks each own a q tile and loop over the
//     key tiles, dQ in registers.
//   Seven products per tile pair instead of five (S and dP are computed in
//   both kernels), in exchange for no atomics: every output element is
//   summed by one thread in a fixed order, so two launches on the same
//   inputs agree bit for bit and a training run is reproducible.
// Two implementations of that design:
//   - K2, every bf16 call of the packed and fused layouts (Dh 128): the
//     Hopper kernels `flash_bwd_dkv_sm90_kernel` and
//     `flash_bwd_dq_sm90_kernel` (below, after the mma.sync ones): wgmma on
//     128-key (dK/dV) and 128-row (dQ) blocks of the two consumer
//     warpgroups alone (256 threads, no setmaxnreg), one thread of which
//     issues every TMA and bulk copy into an mbarrier ring, because with a
//     producer warp in the block ptxas held every thread to 168 registers
//     and the dK/dV consumers spilled; causal tiles skipped where nothing
//     can reach them;
//   - K4, the [B, H, L, Dh] entry (Dh 64 or 128) where Lq or Lk exceeds 64
//     (shorter calls run flash_short.cu in one launch):
//     `flash_bwd_dkv_kernel` and `flash_bwd_dq_kernel`, 64-row tiles of 4
//     warps, mma.sync m16n8k16
//     with fragments out of padded shared tiles by ldmatrix, the streamed
//     tiles by cp.async into a double buffer.
// The fp32 kernels at the end serve fp32 operands of that entry.
//
// Semantics kept from the plain version (ops/attention.py and
// flash_bwd_plain): keys at index >= Lk do not exist (P = 0); masked keys
// inside Lk score -FLT_MAX, so a row with no valid key has P = 1/Lk on
// every key: it feeds dV, while dS is 0 wherever the score was masked (no
// gradient flows through a masked score); rows at index >= Lq add nothing.

#include "sm90_common.cuh"

namespace {

struct BwdParams {
  const __nv_bfloat16* q;   // rotated already when RoPE is on
  const __nv_bfloat16* k;   // rotated already when RoPE is on
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* rows;        // [3, B*H, Lq_pad]: m, 1/l, delta
  const float* sin;         // [L, Dh] fp32 or null (for the un-rotation)
  const float* cos;
  const uint8_t* mask;      // [B, Lk], nonzero = attend, or null
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  int H, Lq, Lk, Lq_pad;
  float scale, scale_log2;
  int causal;
};

// Pre-pass: per (batch, head, row) the softmax maximum, the reciprocal of
// the softmax sum, and delta = rowsum(dO * O) in fp32. One warp per row;
// rows in [Lq, Lq_pad) get zeros, so a padded row has P = 0 everywhere.
template <int D>
__global__ void __launch_bounds__(256) bwd_rows_kernel(
    const __nv_bfloat16* o, long long o_sb, long long o_sh, long long o_sl,
    const __nv_bfloat16* dout, long long do_sb, long long do_sh, long long do_sl,
    const float* stats, float* rows, int H, int Lq, int Lq_pad) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= Lq_pad) return;
  const long long plane = (long long)gridDim.y * Lq_pad;
  float* out = rows + (long long)bh * Lq_pad + row;
  if (row >= Lq) {
    if (lane == 0) { out[0] = 0.f; out[plane] = 0.f; out[2 * plane] = 0.f; }
    return;
  }
  constexpr int PER = D / 32;  // bf16 values per lane: 2 or 4
  const __nv_bfloat16* orow = o + b * o_sb + h * o_sh + row * o_sl + lane * PER;
  const __nv_bfloat16* drow = dout + b * do_sb + h * do_sh + row * do_sl + lane * PER;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + i));
    const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + i));
    acc += a.x * g.x + a.y * g.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float* sm = stats + (long long)bh * Lq;
    const float* sl = sm + (long long)gridDim.y * Lq;
    out[0] = sm[row];
    out[plane] = 1.f / sl[row];  // l >= 1
    out[2 * plane] = acc;
  }
}

// The (m, 1/l, delta) values of 64 rows into shared memory [3][64].
__device__ __forceinline__ void load_rows_async(float* s, const float* rows,
                                                long long plane, int row0) {
  if (threadIdx.x < 48) {
    const int pl = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(s + pl * BQ + c)),
                 "l"(rows + pl * plane + row0 + c));
  }
}

// dK and dV of one 64-key tile. Shared memory: K tile, V tile, two Q tiles,
// two dO tiles, two [3][64] row-value blocks.
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = BK * (D + PAD);
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int HQ = 32;  // q columns of S^T worked on at a time (registers)
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + TILE;
  __nv_bfloat16* Qs = Vs + TILE;       // two tiles
  __nv_bfloat16* Gs = Qs + 2 * TILE;   // two dO tiles
  float* Rs = reinterpret_cast<float*>(Gs + 2 * TILE);  // [2][3][64]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gg = p.dout + b * p.do_sb + h * p.do_sh;
  const long long plane = (long long)gridDim.y * p.Lq_pad;
  const float* rows = p.rows + (long long)bh * p.Lq_pad;
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
  const int ntiles = p.Lq_pad / BQ;

  load_tile_async<D>(Ks, kg, p.k_sl, k0, p.Lk);
  load_tile_async<D>(Vs, vg, p.v_sl, k0, p.Lk);
  load_tile_async<D>(Qs, qg, p.q_sl, 0, p.Lq);
  load_tile_async<D>(Gs, gg, p.do_sl, 0, p.Lq);
  load_rows_async(Rs, rows, plane, 0);
  cp_async_commit();

  // this warp's 16 keys are the rows of S^T; keys g and g + 8 of them
  const int key_a = k0 + warp * 16 + g;
  const int key_b = key_a + 8;
  const bool exists[2] = {key_a < p.Lk, key_b < p.Lk};
  const bool kmasked[2] = {mrow != nullptr && exists[0] && mrow[key_a] == 0,
                           mrow != nullptr && exists[1] && mrow[key_b] == 0};

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) {
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
  }
  // ldmatrix lane offsets: A operand rows, B operand from a [n, k] tile
  // (x4: n-tiles nt, nt+1 x k-halves), B from a [k, n] tile (x4.trans)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int n_row = (lane & 7) + ((lane >> 4) << 3), n_col = ((lane >> 3) & 1) * 8;
  const int k_row = (lane & 7) + (((lane >> 3) & 1) << 3), k_col = (lane >> 4) * 8;

  for (int j = 0; j < ntiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < ntiles) {  // prefetch the next q tile into the other buffer
      load_tile_async<D>(Qs + (cur ^ 1) * TILE, qg, p.q_sl, (j + 1) * BQ, p.Lq);
      load_tile_async<D>(Gs + (cur ^ 1) * TILE, gg, p.do_sl, (j + 1) * BQ, p.Lq);
      load_rows_async(Rs + (cur ^ 1) * 3 * BQ, rows, plane, (j + 1) * BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qt = Qs + cur * TILE;
    const __nv_bfloat16* Gt = Gs + cur * TILE;
    const float* Rt = Rs + cur * 3 * BQ;
    const int q0 = j * BQ;

#pragma unroll 1
    for (int hq = 0; hq < BQ / HQ; ++hq) {
      const int c0 = hq * HQ;  // first q row of this half, within the tile
      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 q rows
      float st[HQ / 8][4], dpt[HQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < HQ / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, Ks + (warp * 16 + a_row) * (D + PAD) + ks * 16 + a_col);
        ldsm_x4(va, Vs + (warp * 16 + a_row) * (D + PAD) + ks * 16 + a_col);
#pragma unroll
        for (int np = 0; np < HQ / 16; ++np) {
          uint32_t qb[4], gb[4];
          ldsm_x4(qb, Qt + (c0 + np * 16 + n_row) * (D + PAD) + ks * 16 + n_col);
          ldsm_x4(gb, Gt + (c0 + np * 16 + n_row) * (D + PAD) + ks * 16 + n_col);
          mma_bf16(st[2 * np], ka, qb[0], qb[1]);
          mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dpt[2 * np], va, gb[0], gb[1]);
          mma_bf16(dpt[2 * np + 1], va, gb[2], gb[3]);
        }
      }

      // P^T and dS^T, re-packed as A fragments: n8 tiles 2kk and 2kk+1 of
      // the accumulator are the k16 slice kk of the operand
      uint32_t pf[HQ / 16][4], sf[HQ / 16][4];
#pragma unroll
      for (int nt = 0; nt < HQ / 8; ++nt) {
        float pv[4], sv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = c0 + nt * 8 + 2 * t + (e & 1);
          const int qrow = q0 + col;
          const bool masked = kmasked[r] || (p.causal && (r ? key_b : key_a) > qrow);
          const float x = masked ? -FLT_MAX : st[nt][e] * p.scale_log2;
          const float prob = exists[r] ? exp2f(x - Rt[col]) * Rt[BQ + col] : 0.f;
          pv[e] = prob;
          sv[e] = masked ? 0.f : prob * (dpt[nt][e] - Rt[2 * BQ + col]) * p.scale;
        }
        const int kk = nt >> 1, hi = nt & 1;
        pf[kk][hi * 2 + 0] = pack_bf16(pv[0], pv[1]);
        pf[kk][hi * 2 + 1] = pack_bf16(pv[2], pv[3]);
        sf[kk][hi * 2 + 0] = pack_bf16(sv[0], sv[1]);
        sf[kk][hi * 2 + 1] = pack_bf16(sv[2], sv[3]);
      }

      // dV += P^T dO, dK += dS^T Q (k dim: the 32 q rows)
#pragma unroll
      for (int kk = 0; kk < HQ / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t gb[4], qb[4];
          ldsm_x4_trans(gb, Gt + (c0 + kk * 16 + k_row) * (D + PAD) + dp * 16 + k_col);
          ldsm_x4_trans(qb, Qt + (c0 + kk * 16 + k_row) * (D + PAD) + dp * 16 + k_col);
          mma_bf16(dv[2 * dp], pf[kk], gb[0], gb[1]);
          mma_bf16(dv[2 * dp + 1], pf[kk], gb[2], gb[3]);
          mma_bf16(dk[2 * dp], sf[kk], qb[0], qb[1]);
          mma_bf16(dk[2 * dp + 1], sf[kk], qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  store_rows<D>(dv, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl, key_a, p.Lk,
                nullptr, nullptr, t);
  store_rows<D>(dk, p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl, key_a, p.Lk,
                p.sin, p.cos, t);
}

// dQ of one 64-row q tile. Shared memory: Q tile, dO tile, two K tiles,
// two V tiles.
template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 1)
flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = BK * (D + PAD);
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int HK = 32;  // keys of S worked on at a time (registers)
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + TILE;
  __nv_bfloat16* Ks = Gs + TILE;      // two tiles
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // two tiles

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gg = p.dout + b * p.do_sb + h * p.do_sh;
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
  const int ntiles = (p.Lk + BK - 1) / BK;

  load_tile_async<D>(Qs, qg, p.q_sl, q0, p.Lq);
  load_tile_async<D>(Gs, gg, p.do_sl, q0, p.Lq);
  load_tile_async<D>(Ks, kg, p.k_sl, 0, p.Lk);
  load_tile_async<D>(Vs, vg, p.v_sl, 0, p.Lk);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  // (m, 1/l, delta) of rows g and g + 8; the buffer is padded to whole tiles
  const long long plane = (long long)gridDim.y * p.Lq_pad;
  const float* rows = p.rows + (long long)bh * p.Lq_pad;
  const float m_r[2] = {rows[row_a], rows[row_b]};
  const float il_r[2] = {rows[plane + row_a], rows[plane + row_b]};
  const float dl_r[2] = {rows[2 * plane + row_a], rows[2 * plane + row_b]};

  float dq[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int n_row = (lane & 7) + ((lane >> 4) << 3), n_col = ((lane >> 3) & 1) * 8;
  const int k_row = (lane & 7) + (((lane >> 3) & 1) << 3), k_col = (lane >> 4) * 8;

  for (int j = 0; j < ntiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < ntiles) {  // prefetch the next K/V tile into the other buffer
      load_tile_async<D>(Ks + (cur ^ 1) * TILE, kg, p.k_sl, (j + 1) * BK, p.Lk);
      load_tile_async<D>(Vs + (cur ^ 1) * TILE, vg, p.v_sl, (j + 1) * BK, p.Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + cur * TILE;
    const __nv_bfloat16* Vt = Vs + cur * TILE;
    const int kv0 = j * BK;

#pragma unroll 1
    for (int hk = 0; hk < BK / HK; ++hk) {
      const int c0 = hk * HK;  // first key of this half, within the tile
      // S = Q K^T and dP = dO V^T for 16 rows x 32 keys
      float s[HK / 8][4], dp[HK / 8][4];
#pragma unroll
      for (int nt = 0; nt < HK / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4], ga[4];
        ldsm_x4(qa, Qs + (warp * 16 + a_row) * (D + PAD) + ks * 16 + a_col);
        ldsm_x4(ga, Gs + (warp * 16 + a_row) * (D + PAD) + ks * 16 + a_col);
#pragma unroll
        for (int np = 0; np < HK / 16; ++np) {
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, Kt + (c0 + np * 16 + n_row) * (D + PAD) + ks * 16 + n_col);
          ldsm_x4(vb, Vt + (c0 + np * 16 + n_row) * (D + PAD) + ks * 16 + n_col);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
        }
      }

      uint32_t sf[HK / 16][4];  // dS as A fragments
#pragma unroll
      for (int nt = 0; nt < HK / 8; ++nt) {
        float sv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = kv0 + c0 + nt * 8 + 2 * t + (e & 1);
          float out = 0.f;
          if (key < p.Lk) {
            const bool masked = (mrow != nullptr && mrow[key] == 0) ||
                                (p.causal && key > (r ? row_b : row_a));
            if (!masked) {
              const float prob = exp2f(s[nt][e] * p.scale_log2 - m_r[r]) * il_r[r];
              out = prob * (dp[nt][e] - dl_r[r]) * p.scale;
            }
          }
          sv[e] = out;
        }
        const int kk = nt >> 1, hi = nt & 1;
        sf[kk][hi * 2 + 0] = pack_bf16(sv[0], sv[1]);
        sf[kk][hi * 2 + 1] = pack_bf16(sv[2], sv[3]);
      }

      // dQ += dS K (k dim: the 32 keys)
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk) {
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, Kt + (c0 + kk * 16 + k_row) * (D + PAD) + dd * 16 + k_col);
          mma_bf16(dq[2 * dd], sf[kk], kb[0], kb[1]);
          mma_bf16(dq[2 * dd + 1], sf[kk], kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  store_rows<D>(dq, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sl, row_a, p.Lq,
                p.sin, p.cos, t);
}

// The pre-passes of both designs: with RoPE, q and k rotated once into the
// scratch copies (and `p` pointed at them), then the row values.
template <int D>
cudaError_t prepare(BwdParams& p, int B, const __nv_bfloat16* o, long long o_sb,
                    long long o_sh, long long o_sl, const float* stats, float* rows,
                    __nv_bfloat16* q_rot, __nv_bfloat16* k_rot, cudaStream_t stream) {
  cudaError_t err;
  if (p.sin != nullptr) {
    err = launch_rope_rows<D>(p.q, p.q_sb, p.q_sh, p.q_sl, B, p.H, p.Lq, p.sin, p.cos,
                              q_rot, stream);
    if (err != cudaSuccess) return err;
    err = launch_rope_rows<D>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk, p.sin, p.cos,
                              k_rot, stream);
    if (err != cudaSuccess) return err;
    p.q = q_rot;
    p.q_sb = (long long)p.H * p.Lq * D; p.q_sh = (long long)p.Lq * D; p.q_sl = D;
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D; p.k_sh = (long long)p.Lk * D; p.k_sl = D;
  }
  const dim3 grid((p.Lq_pad + 7) / 8, B * p.H);
  bwd_rows_kernel<D><<<grid, 256, 0, stream>>>(o, o_sb, o_sh, o_sl, p.dout, p.do_sb,
                                               p.do_sh, p.do_sl, stats, rows, p.H, p.Lq,
                                               p.Lq_pad);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(BwdParams p, int B, const __nv_bfloat16* o, long long o_sb,
                   long long o_sh, long long o_sl, const float* stats, float* rows,
                   __nv_bfloat16* q_rot, __nv_bfloat16* k_rot, cudaStream_t stream) {
  cudaError_t err = prepare<D>(p, B, o, o_sb, o_sh, o_sl, stats, rows, q_rot, k_rot, stream);
  if (err != cudaSuccess) return err;
  const int tile_bytes = BK * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16));
  {
    const int smem = 6 * tile_bytes + 2 * 3 * BQ * static_cast<int>(sizeof(float));
    static bool ready[MAX_DEVICES] = {};  // one per head dim: launch<D> is a template
    err = allow_smem_once(reinterpret_cast<const void*>(&flash_bwd_dkv_kernel<D>), smem,
                          ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Lk + BK - 1) / BK, B * p.H);
    flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  {
    const int smem = 6 * tile_bytes;
    static bool ready[MAX_DEVICES] = {};
    err = allow_smem_once(reinterpret_cast<const void*>(&flash_bwd_dq_kernel<D>), smem,
                          ready);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.Lq_pad / BQ, B * p.H);
    flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

// ---- the packed layouts on Hopper's own tools (K2) -----------------------------
// Every bf16 call of the packed [B, L, H*128] and fused [B, L, 3D] layouts
// (flash_attention_packed, and the backward of its fused projection) runs
// these two kernels; the [B, H, L, Dh] entry (K4) keeps the mma.sync
// kernels above. The pre-passes are the same (`prepare`); tiles are fixed
// (never dependent on B) and nothing is summed with atomics, so results are
// batch-size invariant and two launches agree bit for bit.
//
// flash_bwd_dkv_sm90_kernel: one block per (128-key tile, batch*head), two
// warpgroups of 64 keys each. K and V of the block's keys are loaded once
// by TMA; the 64-row Q and dO tiles, with their rows' (m, 1/l, delta),
// stream through a ring of four mbarrier stages (TMA for the tiles, a plain
// bulk copy for the row values). Per q tile a warpgroup computes S^T = K Q^T
// and dP^T = V dO^T (wgmma m64n64 from shared memory, both operands
// K-major), P^T and dS^T in registers (the row values index columns here,
// read from the stage), and then dV += P^T dO and dK += dS^T Q with the
// bf16 fragments of P^T and dS^T as the register A operand and dO and Q read
// MN-major (the accumulator layout of a 64-row wgmma is its A-fragment
// layout). dK and dV stay in registers for the whole q loop and are written
// once, dK un-rotated in fp32.
//
// flash_bwd_dq_sm90_kernel: one block per (128-row q tile, batch*head), two
// warpgroups of 64 rows. Q and dO are loaded once; K and V stream in 64-key
// tiles through four stages (KVRing<64>). Per key tile: S = Q K^T and dP =
// dO V^T from shared memory, dS in registers (the key mask read from device
// memory, one byte a lane, and shared through a warp vote), dQ += dS K with
// K read MN-major; dQ is un-rotated in fp32 and written once.
//
// Registers and the loads. The dK/dV warpgroup holds dK and dV (128 fp32)
// and, per q tile, S^T and dP^T (64), then the bf16 fragments of P^T and
// dS^T (32): more than the 168 registers a thread of a 384-thread block
// (the forwards' two consumer warpgroups and a producer warpgroup) starts
// with, and ptxas fitted such consumers into those 168 whatever setmaxnreg
// later granted: they spilled. So a block is the two warpgroups alone (256
// threads, up to 255 registers each), and one thread of warpgroup 1 issues
// every copy: the first stages before the loop, then, at the top of each
// iteration, the refill of the stage that the tile before was read from,
// once both warpgroups have released it. Warpgroup 0 therefore runs up to a
// tile ahead of warpgroup 1, so the softmax of one overlaps the products of
// the other on the SM's tensor cores. Inside a warpgroup the products and
// the softmax run one after the other: dK and dV leave no registers for a
// second S^T and dP^T, and in the dQ kernel issuing the next S and dP with
// dQ += dS K, as sm90_attend does, was slower on the card.
//
// Causal without a key mask: tiles that the mask removes entirely (every key
// after every row) are skipped; every row keeps key 0, so they add exactly
// nothing. With a key mask a row may have no valid key, and then its
// uniform P reaches every key: nothing is skipped.

constexpr int B9_KT = 128;  // keys per dK/dV block: two warpgroups of 64
constexpr int B9_QT = 64;   // q rows per streamed tile of the dK/dV kernel
constexpr int B9_QB = 128;  // q rows per dQ block: two warpgroups of 64
constexpr int B9_KB = 64;   // keys per streamed tile of the dQ kernel
constexpr int B9_NST = 4;   // ring stages of both kernels
constexpr int B9_THREADS = 2 * 128;
constexpr int B9_ISSUER = 128;  // the thread that issues the copies: warpgroup 1's first

struct Bwd9Params {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* rows;    // [3, B*H, Lq_pad]: m, 1/l, delta
  const float* sin;     // [L, 128] fp32 or null (for the un-rotation)
  const float* cos;
  const uint8_t* mask;  // [B, Lk], nonzero = attend, or null
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  int B, H, Lq, Lk, Lq_pad;
  float scale, scale_log2;
  int causal;
  int q_hi, k_hi, v_hi, do_hi;  // coordinate order of each operand's tensor maps
};

// Un-rotate (the transpose of rotate-half RoPE, tables rounded to bf16 as the
// forward used them; nothing with `sin` null) and store one warpgroup's
// [64 x 128] fp32 accumulator as bf16: this thread's rows row_a and row_a + 8
// (those < L), columns 8 j + 2 t + c in acc[4 j + 2 r + c]. The rotate-half
// partner of column d is d + 64: fragment j + 8 of the same thread.
__device__ __forceinline__ void store_acc_rows(float (&acc)[64], __nv_bfloat16* base,
                                               long long sl, int row_a, int L,
                                               const float* sin, const float* cos, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= L) continue;
    if (sin != nullptr) {
      const float* sr = sin + (long long)row * 128;
      const float* cr = cos + (long long)row * 128;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 8 * j + 2 * t + c, d2 = d + 64;
          const int i1 = 4 * j + 2 * r + c, i2 = i1 + 32;
          const float g1 = acc[i1], g2 = acc[i2];
          acc[i1] = g1 * bf16_round(cr[d]) + g2 * bf16_round(sr[d2]);
          acc[i2] = g2 * bf16_round(cr[d2]) - g1 * bf16_round(sr[d]);
        }
      }
    }
    __nv_bfloat16* orow = base + (long long)row * sl + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// A [64 x 64] fp32 accumulator rounded to bf16 as the A fragments of four
// k16 slices: its n8 column blocks 2 kk and 2 kk + 1 are slice kk.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int kk = nt >> 1, hi = nt & 1;
    f[kk][hi * 2 + 0] = pack_bf16(x[4 * nt + 0], x[4 * nt + 1]);  // row a
    f[kk][hi * 2 + 1] = pack_bf16(x[4 * nt + 2], x[4 * nt + 3]);  // row a + 8
  }
}

// D[64 x 64] = A[64 x 128] B[64 x 128]^T, both K-major in shared memory, each
// as two boxes (columns 0-63 at a0 / b0, 64-127 at a0 + a_box / b0 + b_box);
// issued, not committed.
__device__ __forceinline__ void wgmma_nt_64x64x128(float (&d)[32], uint32_t a0, int a_box,
                                                   uint32_t b0, int b_box) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {  // 16 columns of Dh a step: 32 bytes
    const uint64_t da = make_desc(a0 + (ks / 4) * a_box, 16, 1024) + (ks % 4) * 2;
    const uint64_t db = make_desc(b0 + (ks / 4) * b_box, 16, 1024) + (ks % 4) * 2;
    wgmma_ss_n64(d, da, db, ks > 0);
  }
}

// The stage before `pp`'s, and the parity of the phase in which it held the
// tile before the current one.
__device__ __forceinline__ Pipe prev_stage(const Pipe& pp) {
  Pipe q;
  q.stage = pp.stage == 0 ? B9_NST - 1 : pp.stage - 1;
  q.phase = pp.stage == 0 ? pp.phase ^ 1 : pp.phase;
  return q;
}

struct DkvSmem {  // byte offsets from the 1024-aligned base
  static constexpr int KBOX = B9_KT * BOX_ROW_BYTES;  // one box of the key tile
  static constexpr int QBOX = B9_QT * BOX_ROW_BYTES;  // one box of a q tile
  static constexpr int K = 0;                         // K's two boxes, V's two
  static constexpr int V = K + 2 * KBOX;
  static constexpr int RING = V + 2 * KBOX;           // a stage: Q's two boxes, dO's two
  static constexpr int STAGE = 4 * QBOX;
  static constexpr int ROWS = RING + B9_NST * STAGE;  // a stage's m, 1/l, delta [3][64]
  static constexpr int ROWS_STAGE = 3 * B9_QT * 4;
  // full[NST], empty[NST], K/V loaded
  static constexpr int BARS = ROWS + B9_NST * ROWS_STAGE;
  static constexpr int END = BARS + (2 * B9_NST + 1) * 8;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

// The issuing thread: q tile j (rows j * 64 ..) of Q, dO and the row values
// into stage `stage` of the dK/dV kernel's ring, completing `full[stage]`.
__device__ __forceinline__ void load_q_tile(const CUtensorMap* tq, const CUtensorMap* tdo,
                                            const Bwd9Params& p, const float* rows,
                                            long long plane, uint32_t base, uint64_t* full,
                                            int stage, int j, int h, int b) {
  uint64_t* bar = &full[stage];
  const uint32_t st = base + DkvSmem::RING + stage * DkvSmem::STAGE;
  const uint32_t rs = base + DkvSmem::ROWS + stage * DkvSmem::ROWS_STAGE;
  const int q0 = j * B9_QT;
  mbar_arrive_expect_tx(bar, DkvSmem::STAGE + DkvSmem::ROWS_STAGE);
  tma_load_head(tq, st, bar, 0, q0, h, b, p.q_hi);
  tma_load_head(tq, st + DkvSmem::QBOX, bar, 64, q0, h, b, p.q_hi);
  tma_load_head(tdo, st + 2 * DkvSmem::QBOX, bar, 0, q0, h, b, p.do_hi);
  tma_load_head(tdo, st + 3 * DkvSmem::QBOX, bar, 64, q0, h, b, p.do_hi);
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    bulk_load(rs + pl * B9_QT * 4, rows + pl * plane + q0, B9_QT * 4, bar);
  }
}

__global__ void __launch_bounds__(B9_THREADS, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo, const Bwd9Params p) {
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  unsigned char* smem = dkv_smem + ((1024 - (smem_u32(dkv_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DkvSmem::BARS);
  uint64_t* empty = full + B9_NST;
  uint64_t* kv_loaded = empty + B9_NST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * B9_KT;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int ntq = p.Lq_pad / B9_QT;
  // causal without a mask: q tiles wholly before the first key add nothing
  const int j0 = p.causal && p.mask == nullptr ? min(k0 / B9_QT, ntq) : 0;
  const bool issuer = threadIdx.x == B9_ISSUER;
  const long long plane = (long long)p.B * p.H * p.Lq_pad;
  const float* rows = p.rows + (long long)bh * p.Lq_pad;
  if (threadIdx.x == 0) {
    for (int s = 0; s < B9_NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], B9_THREADS);
    }
    mbar_init(kv_loaded, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (issuer) {
    mbar_arrive_expect_tx(kv_loaded, 4 * DkvSmem::KBOX);
    tma_load_head(&tk, base + DkvSmem::K, kv_loaded, 0, k0, h, b, p.k_hi);
    tma_load_head(&tk, base + DkvSmem::K + DkvSmem::KBOX, kv_loaded, 64, k0, h, b, p.k_hi);
    tma_load_head(&tv, base + DkvSmem::V, kv_loaded, 0, k0, h, b, p.v_hi);
    tma_load_head(&tv, base + DkvSmem::V + DkvSmem::KBOX, kv_loaded, 64, k0, h, b, p.v_hi);
    for (int i = 0; i < B9_NST && j0 + i < ntq; ++i) {
      load_q_tile(&tq, &tdo, p, rows, plane, base, full, i, j0 + i, h, b);
    }
  }

  // this thread's keys are rows key_a and key_a + 8 of S^T
  const int key_a = k0 + wg * 64 + warp * 16 + lane / 4;
  bool exists[2], kmasked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    exists[r] = key < p.Lk;
    kmasked[r] = p.mask != nullptr && exists[r] && p.mask[(long long)b * p.Lk + key] == 0;
  }
  const uint32_t krows = base + DkvSmem::K + wg * 64 * BOX_ROW_BYTES;
  const uint32_t vrows = base + DkvSmem::V + wg * 64 * BOX_ROW_BYTES;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_loaded, 0);
  Pipe pp;
  for (int j = j0; j < ntq; ++j) {
    if (issuer && j > j0 && j - 1 + B9_NST < ntq) {
      // the stage of tile j - 1 takes tile j - 1 + NST once both warpgroups are done with it
      const Pipe pv = prev_stage(pp);
      mbar_wait(&empty[pv.stage], pv.phase);
      load_q_tile(&tq, &tdo, p, rows, plane, base, full, pv.stage, j - 1 + B9_NST, h, b);
    }
    mbar_wait(&full[pp.stage], pp.phase);
    const uint32_t st = base + DkvSmem::RING + pp.stage * DkvSmem::STAGE;
    const float* rs =
        reinterpret_cast<const float*>(smem + DkvSmem::ROWS + pp.stage * DkvSmem::ROWS_STAGE);
    float s[32], dp[32];
    wgmma_fence();
    wgmma_nt_64x64x128(s, krows, DkvSmem::KBOX, st, DkvSmem::QBOX);  // S^T = K Q^T
    wgmma_nt_64x64x128(dp, vrows, DkvSmem::KBOX, st + 2 * DkvSmem::QBOX,
                       DkvSmem::QBOX);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // P^T and dS^T in place; column c of the tile is q row q0 + c, whose
    // (m, 1/l, delta) are rs[c], rs[64 + c], rs[128 + c]
    const int q0 = j * B9_QT;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float2 mv = *reinterpret_cast<const float2*>(rs + c);
      const float2 iv = *reinterpret_cast<const float2*>(rs + B9_QT + c);
      const float2 dl = *reinterpret_cast<const float2*>(rs + 2 * B9_QT + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, hi = e & 1;
        const bool masked = kmasked[r] || (p.causal && key_a + 8 * r > q0 + c + hi);
        const float x = masked ? -FLT_MAX : s[4 * nt + e] * p.scale_log2;
        // a row with no valid key has m = -FLT_MAX: P = 1/Lk on every key
        const float prob =
            exists[r] ? fast_exp2(x - (hi ? mv.y : mv.x)) * (hi ? iv.y : iv.x) : 0.f;
        dp[4 * nt + e] = masked ? 0.f : prob * (dp[4 * nt + e] - (hi ? dl.y : dl.x)) * p.scale;
        s[4 * nt + e] = prob;
      }
    }
    uint32_t pf[4][4], sf[4][4];  // P^T and dS^T, bf16, as A fragments
    pack_a(s, pf);
    pack_a(dp, sf);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    // dV += P^T dO and dK += dS^T Q over the tile's 64 q rows, 16 a step
    const uint64_t bq = make_desc(st, DkvSmem::QBOX, 1024);
    const uint64_t bg = make_desc(st + 2 * DkvSmem::QBOX, DkvSmem::QBOX, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n128_tb(dv, pf[kk], bg + kk * (16 * BOX_ROW_BYTES / 16));
      wgmma_rs_n128_tb(dk, sf[kk], bq + kk * (16 * BOX_ROW_BYTES / 16));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(sf);
    mbar_arrive(&empty[pp.stage]);
    pp.advance<B9_NST>();
  }
  store_acc_rows(dv, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl, key_a, p.Lk, nullptr, nullptr,
                 t);
  store_acc_rows(dk, p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl, key_a, p.Lk, p.sin, p.cos, t);
}

struct DqSmem {  // byte offsets from the 1024-aligned base
  static constexpr int QBOX = B9_QB * BOX_ROW_BYTES;  // one box of the q tile
  static constexpr int Q = 0;                         // Q's two boxes, dO's two
  static constexpr int DO = Q + 2 * QBOX;
  static constexpr int RING = DO + 2 * QBOX;          // K/V stages, KVRing<B9_KB>
  // full[NST], empty[NST], Q/dO loaded
  static constexpr int BARS = RING + B9_NST * KVRing<B9_KB>::STAGE;
  static constexpr int END = BARS + (2 * B9_NST + 1) * 8;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

// The issuing thread: key tile j of K and V into stage `stage` of the dQ
// kernel's ring, completing `full[stage]`.
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* tk, const CUtensorMap* tv,
                                             const Bwd9Params& p, uint32_t base,
                                             uint64_t* full, int stage, int j, int h, int b) {
  using R = KVRing<B9_KB>;
  uint64_t* bar = &full[stage];
  const uint32_t st = base + DqSmem::RING + stage * R::STAGE;
  mbar_arrive_expect_tx(bar, R::STAGE);
  tma_load_head(tk, st, bar, 0, j * B9_KB, h, b, p.k_hi);
  tma_load_head(tk, st + R::BOX, bar, 64, j * B9_KB, h, b, p.k_hi);
  tma_load_head(tv, st + 2 * R::BOX, bar, 0, j * B9_KB, h, b, p.v_hi);
  tma_load_head(tv, st + 3 * R::BOX, bar, 64, j * B9_KB, h, b, p.v_hi);
}

__global__ void __launch_bounds__(B9_THREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Bwd9Params p) {
  using R = KVRing<B9_KB>;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  unsigned char* smem = dq_smem + ((1024 - (smem_u32(dq_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DqSmem::BARS);
  uint64_t* empty = full + B9_NST;
  uint64_t* qd_loaded = empty + B9_NST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * B9_QB;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  // causal without a mask: key tiles wholly after the last row add nothing
  const int Lk = p.causal && p.mask == nullptr ? min(p.Lk, q0 + B9_QB) : p.Lk;
  const int ntiles = (Lk + B9_KB - 1) / B9_KB;
  const bool issuer = threadIdx.x == B9_ISSUER;
  if (threadIdx.x == 0) {
    for (int s = 0; s < B9_NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], B9_THREADS);
    }
    mbar_init(qd_loaded, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (issuer) {
    mbar_arrive_expect_tx(qd_loaded, 4 * DqSmem::QBOX);
    tma_load_head(&tq, base + DqSmem::Q, qd_loaded, 0, q0, h, b, p.q_hi);
    tma_load_head(&tq, base + DqSmem::Q + DqSmem::QBOX, qd_loaded, 64, q0, h, b, p.q_hi);
    tma_load_head(&tdo, base + DqSmem::DO, qd_loaded, 0, q0, h, b, p.do_hi);
    tma_load_head(&tdo, base + DqSmem::DO + DqSmem::QBOX, qd_loaded, 64, q0, h, b, p.do_hi);
    for (int i = 0; i < B9_NST && i < ntiles; ++i) {
      load_kv_tile(&tk, &tv, p, base, full, i, i, h, b);
    }
  }

  const int row_a = q0 + wg * 64 + warp * 16 + lane / 4;
  // (m, 1/l, delta) of rows row_a and row_a + 8; rows past Lq add nothing
  const long long plane = (long long)p.B * p.H * p.Lq_pad;
  const float* rows = p.rows + (long long)bh * p.Lq_pad;
  float m_r[2], il_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool ok = row < p.Lq;
    m_r[r] = ok ? rows[row] : 0.f;
    il_r[r] = ok ? rows[plane + row] : 0.f;
    dl_r[r] = ok ? rows[2 * plane + row] : 0.f;
  }
  const uint8_t* mrow = p.mask != nullptr ? p.mask + (long long)b * p.Lk : nullptr;
  const uint32_t qrows = base + DqSmem::Q + wg * 64 * BOX_ROW_BYTES;
  const uint32_t grows = base + DqSmem::DO + wg * 64 * BOX_ROW_BYTES;
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  mbar_wait(qd_loaded, 0);
  Pipe pp;
  for (int j = 0; j < ntiles; ++j) {
    if (issuer && j > 0 && j - 1 + B9_NST < ntiles) {
      // the stage of tile j - 1 takes tile j - 1 + NST once both warpgroups are done with it
      const Pipe pv = prev_stage(pp);
      mbar_wait(&empty[pv.stage], pv.phase);
      load_kv_tile(&tk, &tv, p, base, full, pv.stage, j - 1 + B9_NST, h, b);
    }
    mbar_wait(&full[pp.stage], pp.phase);
    const uint32_t st = base + DqSmem::RING + pp.stage * R::STAGE;
    float s[32], dp[32];
    wgmma_fence();
    wgmma_nt_64x64x128(s, qrows, DqSmem::QBOX, st, R::BOX);                // S = Q K^T
    wgmma_nt_64x64x128(dp, grows, DqSmem::QBOX, st + 2 * R::BOX, R::BOX);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // dS in place of dP: 0 where the score was masked or the key does not exist
    const int kv0 = j * B9_KB;
    if (mrow == nullptr && !p.causal && kv0 + B9_KB <= p.Lk) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float prob = fast_exp2(s[i] * p.scale_log2 - m_r[r]) * il_r[r];
        dp[i] = prob * (dp[i] - dl_r[r]) * p.scale;
      }
    } else {
      // which of the tile's 64 keys exist and are not masked: bit k of
      // word k / 32, one key a lane, gathered by a warp vote
      uint32_t valid[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int key = kv0 + 32 * w + lane;
        valid[w] = __ballot_sync(0xffffffffu,
                                 key < p.Lk && (mrow == nullptr || mrow[key] != 0));
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kl = nt * 8 + 2 * t + (e & 1);
          float ds = 0.f;
          if (((valid[kl >> 5] >> (kl & 31)) & 1u) && !(p.causal && kv0 + kl > row_a + 8 * r)) {
            const float prob = fast_exp2(s[4 * nt + e] * p.scale_log2 - m_r[r]) * il_r[r];
            ds = prob * (dp[4 * nt + e] - dl_r[r]) * p.scale;
          }
          dp[4 * nt + e] = ds;
        }
      }
    }
    uint32_t sf[4][4];  // dS, bf16, as A fragments
    pack_a(dp, sf);
    fence_regs(dq);
    wgmma_fence();
    // dQ += dS K over the tile's 64 keys, 16 a step
    const uint64_t bk = make_desc(st, R::BOX, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n128_tb(dq, sf[kk], bk + kk * (16 * BOX_ROW_BYTES / 16));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(sf);
    mbar_arrive(&empty[pp.stage]);
    pp.advance<B9_NST>();
  }
  store_acc_rows(dq, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sl, row_a, p.Lq, p.sin, p.cos, t);
}

int launch_sm90(BwdParams p, int B, const __nv_bfloat16* o, long long o_sb, long long o_sh,
                long long o_sl, const float* stats, float* rows, __nv_bfloat16* q_rot,
                __nv_bfloat16* k_rot, cudaStream_t stream) {
  cudaError_t cerr =
      prepare<128>(p, B, o, o_sb, o_sh, o_sl, stats, rows, q_rot, k_rot, stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  Bwd9Params s;
  s.dq = p.dq; s.dk = p.dk; s.dv = p.dv;
  s.rows = rows; s.sin = p.sin; s.cos = p.cos; s.mask = p.mask;
  s.dq_sb = p.dq_sb; s.dq_sh = p.dq_sh; s.dq_sl = p.dq_sl;
  s.dk_sb = p.dk_sb; s.dk_sh = p.dk_sh; s.dk_sl = p.dk_sl;
  s.dv_sb = p.dv_sb; s.dv_sh = p.dv_sh; s.dv_sl = p.dv_sl;
  s.B = B; s.H = p.H; s.Lq = p.Lq; s.Lk = p.Lk; s.Lq_pad = p.Lq_pad;
  s.scale = p.scale; s.scale_log2 = p.scale_log2;
  s.causal = p.causal;
  // each operand twice: in the dK/dV kernel's boxes and in the dQ kernel's
  CUtensorMap k_kv, v_kv, q_kv, do_kv, q_q, do_q, k_q, v_q;
  int hi = 0;
  int err = encode_head_map(&k_kv, p.k, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, B9_KT, &s.k_hi);
  if (err == 0)
    err = encode_head_map(&v_kv, p.v, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, B9_KT, &s.v_hi);
  if (err == 0)
    err = encode_head_map(&q_kv, p.q, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, B9_QT, &s.q_hi);
  if (err == 0)
    err = encode_head_map(&do_kv, p.dout, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, B9_QT,
                          &s.do_hi);
  if (err == 0)
    err = encode_head_map(&q_q, p.q, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, B9_QB, &hi);
  if (err == 0)
    err = encode_head_map(&do_q, p.dout, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, B9_QB, &hi);
  if (err == 0)
    err = encode_head_map(&k_q, p.k, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, B9_KB, &hi);
  if (err == 0)
    err = encode_head_map(&v_q, p.v, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, B9_KB, &hi);
  if (err != 0) return err;
  static bool ready_kv[MAX_DEVICES] = {}, ready_q[MAX_DEVICES] = {};
  cerr = allow_smem_once(reinterpret_cast<const void*>(&flash_bwd_dkv_sm90_kernel),
                         DkvSmem::BYTES, ready_kv);
  if (cerr == cudaSuccess) {
    cerr = allow_smem_once(reinterpret_cast<const void*>(&flash_bwd_dq_sm90_kernel),
                           DqSmem::BYTES, ready_q);
  }
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  flash_bwd_dkv_sm90_kernel<<<dim3((p.Lk + B9_KT - 1) / B9_KT, B * p.H), B9_THREADS,
                              DkvSmem::BYTES, stream>>>(k_kv, v_kv, q_kv, do_kv, s);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  flash_bwd_dq_sm90_kernel<<<dim3((p.Lq + B9_QB - 1) / B9_QB, B * p.H), B9_THREADS,
                             DqSmem::BYTES, stream>>>(q_q, do_q, k_q, v_q, s);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 operands ----------------------------------------------------------
// The same gradients with nothing rounded below fp32, without tensor cores:
// one warp per row (a q row for dQ, a key for dK and dV), a lane per
// partner row of a 32-row chunk for the two dot products, then every lane
// adds the chunk's weighted rows into its own columns. No atomics: each
// output row is summed by one warp in a fixed order.

struct BwdParamsF32 {
  const float* q;   // rotated already when RoPE is on
  const float* k;   // rotated already when RoPE is on
  const float* v;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  const float* rows;  // [3, B*H, Lq_pad]: m, 1/l, delta
  const float* sin;
  const float* cos;
  const uint8_t* mask;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  int H, Lq, Lk, Lq_pad;
  float scale, scale_log2;
  int causal;
};

// Pre-pass: (m, 1/l, delta = rowsum(dO * O)) per row, one warp per row.
template <int D>
__global__ void __launch_bounds__(256) bwd_rows_f32_kernel(
    const float* o, long long o_sb, long long o_sh, long long o_sl,
    const float* dout, long long do_sb, long long do_sh, long long do_sl,
    const float* stats, float* rows, int H, int Lq, int Lq_pad) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= Lq) return;
  const float* orow = o + b * o_sb + h * o_sh + row * o_sl;
  const float* drow = dout + b * do_sb + h * do_sh + row * do_sl;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc = fmaf(orow[lane + 32 * i], drow[lane + 32 * i], acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long plane = (long long)gridDim.y * Lq_pad;
    float* out = rows + (long long)bh * Lq_pad + row;
    const float* sm = stats + (long long)bh * Lq;
    out[0] = sm[row];
    out[plane] = 1.f / sm[(long long)gridDim.y * Lq + row];  // l >= 1
    out[2 * plane] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32) flash_bwd_dq_f32_kernel(
    const BwdParamsF32 p) {
  constexpr int PER = D / 32;
  __shared__ float qs[F32_WARPS][D], gs[F32_WARPS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * F32_WARPS + warp;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  if (row >= p.Lq) return;
  const float* qrow = p.q + b * p.q_sb + h * p.q_sh + row * p.q_sl;
  const float* grow = p.dout + b * p.do_sb + h * p.do_sh + row * p.do_sl;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qs[warp][lane + 32 * i] = qrow[lane + 32 * i];
    gs[warp][lane + 32 * i] = grow[lane + 32 * i];
  }
  __syncwarp();
  const long long plane = (long long)gridDim.y * p.Lq_pad;
  const float* rv = p.rows + (long long)bh * p.Lq_pad + row;
  const float m = rv[0], il = rv[plane], delta = rv[2 * plane];

  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < p.Lk; j0 += 32) {
    const int key = j0 + lane;
    float ds = 0.f;  // no gradient through a masked score
    if (key < p.Lk && !((mrow != nullptr && mrow[key] == 0) || (p.causal && key > row))) {
      const float s = dot_row<D>(qs[warp], kg + key * p.k_sl);
      const float dp = dot_row<D>(gs[warp], vg + key * p.v_sl);
      ds = exp2f(s * p.scale_log2 - m) * il * (dp - delta) * p.scale;
    }
    const int n = min(32, p.Lk - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float dsv = __shfl_sync(FULL, ds, jj);
      const float* krow = kg + (j0 + jj) * p.k_sl;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(dsv, krow[lane + 32 * i], acc[i]);
    }
  }
  store_row_f32<D>(acc, p.dq + b * p.dq_sb + h * p.dq_sh + row * p.dq_sl, p.sin, p.cos,
                   row, lane);
}

template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32) flash_bwd_dkv_f32_kernel(
    const BwdParamsF32 p) {
  constexpr int PER = D / 32;
  __shared__ float ks[F32_WARPS][D], vs[F32_WARPS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = blockIdx.x * F32_WARPS + warp;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  if (key >= p.Lk) return;
  const float* krow = p.k + b * p.k_sb + h * p.k_sh + key * p.k_sl;
  const float* vrow = p.v + b * p.v_sb + h * p.v_sh + key * p.v_sl;
  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* gg = p.dout + b * p.do_sb + h * p.do_sh;
  const bool kmasked = p.mask != nullptr && p.mask[(long long)b * p.Lk + key] == 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    ks[warp][lane + 32 * i] = krow[lane + 32 * i];
    vs[warp][lane + 32 * i] = vrow[lane + 32 * i];
  }
  __syncwarp();
  const long long plane = (long long)gridDim.y * p.Lq_pad;
  const float* rv = p.rows + (long long)bh * p.Lq_pad;

  float dk[PER], dv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) dk[i] = dv[i] = 0.f;
  for (int i0 = 0; i0 < p.Lq; i0 += 32) {
    const int qi = i0 + lane;
    float prob = 0.f, ds = 0.f;
    if (qi < p.Lq) {
      const bool masked = kmasked || (p.causal && key > qi);
      const float s = dot_row<D>(ks[warp], qg + qi * p.q_sl);
      const float x = masked ? -FLT_MAX : s * p.scale_log2;
      // a row with no valid key has m = -FLT_MAX: P = 1/Lk on every key
      prob = exp2f(x - rv[qi]) * rv[plane + qi];
      if (!masked) {
        const float dp = dot_row<D>(vs[warp], gg + qi * p.do_sl);
        ds = prob * (dp - rv[2 * plane + qi]) * p.scale;
      }
    }
    const int n = min(32, p.Lq - i0);
    for (int ii = 0; ii < n; ++ii) {
      const float pv = __shfl_sync(FULL, prob, ii);
      const float dsv = __shfl_sync(FULL, ds, ii);
      const float* grow = gg + (i0 + ii) * p.do_sl;
      const float* qrow = qg + (i0 + ii) * p.q_sl;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        dv[i] = fmaf(pv, grow[lane + 32 * i], dv[i]);
        dk[i] = fmaf(dsv, qrow[lane + 32 * i], dk[i]);
      }
    }
  }
  store_row_f32<D>(dv, p.dv + b * p.dv_sb + h * p.dv_sh + key * p.dv_sl, nullptr, nullptr,
                   key, lane);
  store_row_f32<D>(dk, p.dk + b * p.dk_sb + h * p.dk_sh + key * p.dk_sl, p.sin, p.cos,
                   key, lane);
}

template <int D>
cudaError_t launch_f32(BwdParamsF32 p, int B, const float* o, long long o_sb, long long o_sh,
                       long long o_sl, const float* stats, float* rows, float* q_rot,
                       float* k_rot, cudaStream_t stream) {
  cudaError_t err;
  if (p.sin != nullptr) {  // rotate q and k once into the scratch copies
    err = launch_rope_rows_f32<D>(p.q, p.q_sb, p.q_sh, p.q_sl, B, p.H, p.Lq, p.sin, p.cos,
                                  q_rot, stream);
    if (err != cudaSuccess) return err;
    err = launch_rope_rows_f32<D>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk, p.sin, p.cos,
                                  k_rot, stream);
    if (err != cudaSuccess) return err;
    p.q = q_rot;
    p.q_sb = (long long)p.H * p.Lq * D; p.q_sh = (long long)p.Lq * D; p.q_sl = D;
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D; p.k_sh = (long long)p.Lk * D; p.k_sl = D;
  }
  bwd_rows_f32_kernel<D><<<dim3((p.Lq + 7) / 8, B * p.H), 256, 0, stream>>>(
      o, o_sb, o_sh, o_sl, p.dout, p.do_sb, p.do_sh, p.do_sl, stats, rows, p.H, p.Lq,
      p.Lq_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_f32_kernel<D>
      <<<dim3((p.Lk + F32_WARPS - 1) / F32_WARPS, B * p.H), F32_WARPS * 32, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<D>
      <<<dim3((p.Lq + F32_WARPS - 1) / F32_WARPS, B * p.H), F32_WARPS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

// The arguments of the C entries below, and their names.
#define BWD_ARGS                                                                      \
  const void *q, const void *k, const void *v, const void *o, const void *dout,       \
      const void *stats, const void *sin, const void *cos, const void *mask, void *dq, \
      void *dk, void *dv, void *rows, void *q_rot, void *k_rot, int B, int H, int Lq,  \
      int Lk, int Dh, long long q_sb, long long q_sh, long long q_sl, long long k_sb,  \
      long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,  \
      long long o_sb, long long o_sh, long long o_sl, long long do_sb, long long do_sh, \
      long long do_sl, long long dq_sb, long long dq_sh, long long dq_sl,              \
      long long dk_sb, long long dk_sh, long long dk_sl, long long dv_sb,              \
      long long dv_sh, long long dv_sl, float scale, int causal, void *stream
#define BWD_NAMES                                                                      \
  q, k, v, o, dout, stats, sin, cos, mask, dq, dk, dv, rows, q_rot, k_rot, B, H, Lq, Lk, \
      Dh, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, do_sb, \
      do_sh, do_sl, dq_sb, dq_sh, dq_sl, dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl, scale, \
      causal, stream

// `hopper`: the Hopper kernels (Dh 128 only), else the mma.sync ones.
int bwd_bf16(bool hopper, BWD_ARGS) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.rows = static_cast<const float*>(rows);
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.mask = static_cast<const uint8_t*>(mask);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sl = do_sl;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_sl = dq_sl;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_sl = dk_sl;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_sl = dv_sl;
  p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.Lq_pad = (Lq + BQ - 1) / BQ * BQ;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  if (stats == nullptr || rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (sin != nullptr && (q_rot == nullptr || k_rot == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o);
  const float* st = static_cast<const float*>(stats);
  float* rw = static_cast<float*>(rows);
  __nv_bfloat16* qr = static_cast<__nv_bfloat16*>(q_rot);
  __nv_bfloat16* kr = static_cast<__nv_bfloat16*>(k_rot);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (hopper) {
    if (Dh != 128) return static_cast<int>(cudaErrorInvalidValue);
    return launch_sm90(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm);
  }
  switch (Dh) {
    case 64:
      return static_cast<int>(launch<64>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm));
    case 128:
      return static_cast<int>(launch<128>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, else the CUDA error code of a launch (or
// cudaErrorInvalidValue for a head dim the kernels were not built for, or a
// missing scratch buffer). Strides are in elements; the head dim of every
// operand is contiguous. `stats` is the [2, B, H, Lq] fp32 buffer the
// forward filled. Scratch, allocated by the caller: `rows`
// [3, B, H, Lq_pad] fp32 with Lq_pad = Lq rounded up to 64; with sin/cos,
// `q_rot` [B, H, Lq, Dh] and `k_rot` [B, H, Lk, Dh] bf16. Runs the
// mma.sync kernels (the [B, H, L, Dh] entry, K4).
int deepcoro_flash_bwd_bf16(BWD_ARGS) { return bwd_bf16(false, BWD_NAMES); }

// K2: the same arguments and results for the packed and fused layouts,
// bf16, Dh 128 only (cudaErrorInvalidValue otherwise), on
// flash_bwd_dkv_sm90_kernel and flash_bwd_dq_sm90_kernel. Also returns
// TMA_ERROR_BASE + the CUresult of cuTensorMapEncodeTiled when a tensor map
// cannot be encoded (every operand, dO included, needs a 16-byte aligned
// base and strides).
int deepcoro_flash_bwd_sm90_bf16(BWD_ARGS) { return bwd_bf16(true, BWD_NAMES); }

// Registers per thread and dynamic shared memory per block of the dK/dV
// (`which` 0) or the dQ (`which` 1) Hopper kernel.
int deepcoro_flash_bwd_sm90_attrs(int which, int* regs, int* smem) {
  const void* fn = which == 0 ? reinterpret_cast<const void*>(&flash_bwd_dkv_sm90_kernel)
                              : reinterpret_cast<const void*>(&flash_bwd_dq_sm90_kernel);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = which == 0 ? DkvSmem::BYTES : DqSmem::BYTES;
  return 0;
}

// The same for fp32 operands (the scratch copies `q_rot` and `k_rot` then
// are fp32 too); the arguments mean what they mean above.
int deepcoro_flash_bwd_f32(BWD_ARGS) {
  BwdParamsF32 p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.rows = static_cast<const float*>(rows);
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.mask = static_cast<const uint8_t*>(mask);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sl = do_sl;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_sl = dq_sl;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_sl = dk_sl;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_sl = dv_sl;
  p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.Lq_pad = (Lq + BQ - 1) / BQ * BQ;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  if (stats == nullptr || rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (sin != nullptr && (q_rot == nullptr || k_rot == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ob = static_cast<const float*>(o);
  const float* st = static_cast<const float*>(stats);
  float* rw = static_cast<float*>(rows);
  float* qr = static_cast<float*>(q_rot);
  float* kr = static_cast<float*>(k_rot);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return static_cast<int>(launch_f32<64>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm));
    case 128:
      return static_cast<int>(launch_f32<128>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
