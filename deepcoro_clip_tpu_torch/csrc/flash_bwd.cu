// Flash-attention backward for Hopper (sm_90a): bf16 in/out with fp32 sums on
// the tensor cores (wgmma, TMA, mbarriers) at every head dim, register-tiled
// CUDA-core kernels for fp32 at head dims 64 and 128 (bwd_f32_regtile.cuh),
// and SIMT kernels for fp32 at head dims 256 to 512 (below).
//
// Replaces two Pallas TPU kernels of deepcoro_clip_tpu:
//   - ops/flash_attention_packed.py `_bwd_kernel` (K2: packed [B, L, H*Dh];
//     in fused mode dq, dk, dv are written through strided views straight
//     into one [B, L, 3D] gradient of the fused QKV tensor), bf16 at Dh 128
//     on `flash_bwd_dkv_sm90_kernel` and `flash_bwd_dq_sm90_kernel`, bf16 at
//     Dh 256 to 512 on `flash_bwd_dkv_wide_sm90_kernel<Dh>` and
//     `flash_bwd_dq_wide_sm90_kernel<Dh>`, fp32 at Dh 128 on
//     `flash_bwd_dkv_f32_regtile_kernel<128>` and
//     `flash_bwd_dq_f32_regtile_kernel<128>`, fp32 at Dh 256 to 512 on the
//     SIMT kernels below;
//   - ops/flash_attention.py `_bwd_kernel` (K4: [B, H, L, Dh]) where Lq or
//     Lk exceeds 64 (or Dh exceeds 128), bf16 at Dh 64 or 128 on
//     `flash_long_bwd_dkv_kernel<D>` and `flash_long_bwd_dq_kernel<D>`, bf16
//     at the padded widths 256 to 512 on the wide kernels, fp32 at Dh 64 or
//     128 on the register-tiled kernels, fp32 at the padded widths 256 to
//     512 on the SIMT kernels (shorter calls at Dh <= 128 run flash_short.cu
//     in one launch).
// K2's and K4's long pairs are one body (`bwd_dkv_sm90<D>`, `bwd_dq_sm90<D>`
// below) under two names, the wide pair the same design cut to the wider
// rows (`bwd_dkv_wide<D>`, `bwd_dq_wide<D>`, `BwdWideCfg<D>`); every operand
// is a base pointer plus (batch, head, row) strides in elements.
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
// What bounds it on an H100: 10*Lq*Lk'*D FLOP per head (Lk' the keys the
// rows may attend) against about (4*Lq + 4*Lk')*D*2 bytes (q, do, o read,
// dq written; k, v read, dk, dv written). At the video tower's L = 1569
// without a mask (K2) ~980 FLOP a byte: operations. The text tower at L 512
// and 128 with the reports' padding (K4, Dh 64): the bytes. The SigLIP bank
// [280, 12, 512, 64], 2 to 21 real keys of 512 a row: q, dO and o read and
// dq, dk, dv written whole (dk and dv are 0 past the real keys) bound it
// near 0.4 ms; every key visited, as the mma.sync kernels this pair
// replaced did, cost 14x that.
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
// Both kernels skip, exactly, the (q tile, key tile) pairs past the q
// tile's key extent (visit_keys in sm90_common.cuh: past every row's last
// real key, and past the last row under causal masking, when every row of
// the q tile has a real key): a dK/dV block whose keys no q tile reaches
// writes zeros without looping, and the dQ loop stops at its tile's extent.
// The CUDA-core kernels at the end serve fp32 operands of every layout (K2
// and K4: register-tiled at Dh 64 and 128, SIMT at 256 to 512).
//
// Semantics kept from the plain version (ops/attention.py and
// flash_bwd_plain): keys at index >= Lk do not exist (P = 0); masked keys
// inside Lk score -FLT_MAX, so a row with no valid key has P = 1/Lk on
// every key: it feeds dV, while dS is 0 wherever the score was masked (no
// gradient flows through a masked score); rows at index >= Lq add nothing.

#include "bwd_f32_regtile.cuh"
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
// the softmax sum, and delta = rowsum(dO * O) in fp32. LPR lanes a row, each
// summing its D / LPR products in column order before the lanes' xor tree:
// K2 keeps one warp a row (LPR 32: its delta, and so its bits, stay as they
// were); the long K4 calls take 16 bytes a lane (LPR = D / 8), four times the
// loads in flight a thread, for the SigLIP bank's o and dO at Dh 64.
// Rows in [Lq, Lq_pad) get zeros, so a padded row has P = 0 everywhere.
template <int D, int LPR>
__global__ void __launch_bounds__(256) bwd_rows_kernel(
    const __nv_bfloat16* o, long long o_sb, long long o_sh, long long o_sl,
    const __nv_bfloat16* dout, long long do_sb, long long do_sh, long long do_sl,
    const float* stats, float* rows, int H, int Lq, int Lq_pad) {
  constexpr int RPB = 256 / LPR;  // rows a block
  constexpr int PER = D / LPR;    // bf16 values a lane: 2, 4 or 8
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.x * RPB + threadIdx.x / LPR;
  const int lane = threadIdx.x % LPR;
  float acc = 0.f;
  if (row < Lq) {
    const __nv_bfloat16* orow = o + b * o_sb + h * o_sh + row * o_sl + lane * PER;
    const __nv_bfloat16* drow = dout + b * do_sb + h * do_sh + row * do_sl + lane * PER;
    __nv_bfloat162 ov[PER / 2], dv[PER / 2];
    if constexpr (PER == 8) {  // one 16-byte load of each
      *reinterpret_cast<uint4*>(ov) = *reinterpret_cast<const uint4*>(orow);
      *reinterpret_cast<uint4*>(dv) = *reinterpret_cast<const uint4*>(drow);
    } else {
#pragma unroll
      for (int i = 0; i < PER / 2; ++i) {
        ov[i] = reinterpret_cast<const __nv_bfloat162*>(orow)[i];
        dv[i] = reinterpret_cast<const __nv_bfloat162*>(drow)[i];
      }
    }
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      const float2 a = __bfloat1622float2(ov[i]);
      const float2 g = __bfloat1622float2(dv[i]);
      acc += a.x * g.x + a.y * g.y;
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0 && row < Lq_pad) {
    const long long plane = (long long)gridDim.y * Lq_pad;
    float* out = rows + (long long)bh * Lq_pad + row;
    if (row >= Lq) {
      out[0] = out[plane] = out[2 * plane] = 0.f;
    } else {
      const float* sm = stats + (long long)bh * Lq;
      const float* sl = sm + (long long)gridDim.y * Lq;
      out[0] = sm[row];
      out[plane] = 1.f / sl[row];  // l >= 1
      out[2 * plane] = acc;
    }
  }
}

// The pre-passes: with RoPE, q and k rotated once into the scratch copies
// (and `p` pointed at them), then the row values (LPR lanes a row).
template <int D, int LPR>
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
  constexpr int RPB = 256 / LPR;
  const dim3 grid((p.Lq_pad + RPB - 1) / RPB, B * p.H);
  bwd_rows_kernel<D, LPR><<<grid, 256, 0, stream>>>(o, o_sb, o_sh, o_sl, p.dout, p.do_sb,
                                                    p.do_sh, p.do_sl, stats, rows, p.H,
                                                    p.Lq, p.Lq_pad);
  return cudaGetLastError();
}

// ---- the Hopper kernels (K2, and K4 above 64 tokens) ---------------------------
// Every bf16 call of the packed [B, L, H*128] and fused [B, L, 3D] layouts
// (flash_attention_packed, and the backward of its fused projection) runs
// flash_bwd_{dkv,dq}_sm90_kernel, every bf16 call of the [B, H, L, Dh] entry
// above 64 tokens flash_long_bwd_{dkv,dq}_kernel<Dh>: the same bodies at D =
// Dh. The pre-passes are the same (`prepare`); tiles are fixed (never
// dependent on B) and nothing is summed with atomics, so results are
// batch-size invariant and two launches agree bit for bit.
//
// dK/dV: one block per (128-key tile, batch*head), two warpgroups of 64
// keys each (in the long kernels at Dh 64 one block per 64-key tile, one
// warpgroup: see below). K and V of the block's keys are loaded once by
// TMA; the 64-row
// Q and dO tiles, with their rows' (m, 1/l, delta), stream through a ring of
// four mbarrier stages (TMA for the tiles, a plain bulk copy for the row
// values). Per q tile a warpgroup computes S^T = K Q^T and dP^T = V dO^T
// (wgmma m64n64 from shared memory, both operands K-major), P^T and dS^T in
// registers (the row values index columns here, read from the stage), and
// then dV += P^T dO and dK += dS^T Q with the bf16 fragments of P^T and dS^T
// as the register A operand and dO and Q read MN-major (the accumulator
// layout of a 64-row wgmma is its A-fragment layout). dK and dV stay in
// registers for the whole q loop and are written once, dK un-rotated in
// fp32. The block visits only the q tiles whose key extent reaches its keys
// (in order: the tiles that hold a row with no real key, and under causal
// masking the rows at or after its first key); with none, it writes zeros.
// A warpgroup whose 64 keys a visited tile does not reach releases the
// stage unread (the SigLIP bank: 21 real keys at most, all in warpgroup 0's).
//
// dQ: one block per (128-row q tile, batch*head), two warpgroups of 64 rows.
// Q and dO are loaded once; K and V stream in 64-key tiles through four
// stages (KVRing<64, D>), up to the q tile's key extent. Per key tile: S = Q
// K^T and dP = dO V^T from shared memory, dS in registers (the key mask read
// from device memory, one byte a lane, and shared through a warp vote), dQ
// += dS K with K read MN-major; dQ is un-rotated in fp32 and written once.
//
// Registers and the loads. The dK/dV warpgroup holds dK and dV (2 x D/2
// fp32) and, per q tile, S^T and dP^T (64), then the bf16 fragments of P^T
// and dS^T (32): at D = 128 more than the 168 registers a thread of a
// 384-thread block (the forwards' two consumer warpgroups and a producer
// warpgroup) starts with, and ptxas fitted such consumers into those 168
// whatever setmaxnreg later granted: they spilled. So a block is the two
// warpgroups alone (256 threads, up to 255 registers each), and one thread
// of warpgroup 1 issues every copy: the first stages before the loop, then,
// at the top of each iteration, the refill of the stage that the tile before
// was read from, once both warpgroups have released it. Warpgroup 0
// therefore runs up to a tile ahead of warpgroup 1, so the softmax of one
// overlaps the products of the other on the SM's tensor cores. Inside a
// warpgroup the products and the softmax run one after the other: dK and dV
// leave no registers for a second S^T and dP^T, and in the dQ kernel issuing
// the next S and dP with dQ += dS K, as sm90_attend does, was slower on the
// card. At D = 64 a stage and the K/V tiles are half as large; the dQ block
// keeps its 128 rows and fits two an SM (at most 128 registers a thread,
// ~97 KB of shared memory), and the long dK/dV kernel takes blocks of one
// warpgroup and 64 keys (174 registers a thread, ~82 KB), two an SM, the
// issuing thread its own first: at the SigLIP bank most dK/dV blocks lie
// past every row's extent and only write zeros, and the few real ones (the
// first 64 keys) keep one warpgroup busy, so two blocks an SM overlap one
// block's loads and zeros with another's products.

// keys per dK/dV block: 64 a warpgroup, two warpgroups (one at Dh 64 in the
// long kernels: dkv_wgs)
constexpr int B9_QT = 64;   // q rows per streamed tile of the dK/dV kernel
constexpr int B9_QB = 128;  // q rows per dQ block: two warpgroups of 64
constexpr int B9_KB = 64;   // keys per streamed tile of the dQ kernel
constexpr int B9_NST = 4;   // ring stages of both kernels
constexpr int B9_THREADS = 2 * 128;
constexpr int B9_ISSUER = 128;  // the thread that issues the copies: warpgroup 1's first

// Warpgroups of a dK/dV block: K2's and the long kernels' at Dh 128 two, the
// long kernels' at Dh 64 one, so that two blocks share an SM.
__host__ __device__ constexpr int dkv_wgs(int D, bool LONG) { return LONG && D == 64 ? 1 : 2; }

struct Bwd9Params {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* rows;    // [3, B*H, Lq_pad]: m, 1/l, delta
  const float* sin;     // [L, D] fp32 or null (for the un-rotation)
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
// [64 x D] fp32 accumulator as bf16: this thread's rows row_a and row_a + 8
// (those < L), columns 8 j + 2 t + c in acc[4 j + 2 r + c]. The rotate-half
// partner of column d is d + D/2: fragment j + D/16 of the same thread.
template <int D>
__device__ __forceinline__ void store_acc_rows(float (&acc)[D / 2], __nv_bfloat16* base,
                                               long long sl, int row_a, int L,
                                               const float* sin, const float* cos, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= L) continue;
    if (sin != nullptr) {
      const float* sr = sin + (long long)row * D;
      const float* cr = cos + (long long)row * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 8 * j + 2 * t + c, d2 = d + D / 2;
          const int i1 = 4 * j + 2 * r + c, i2 = i1 + D / 4;
          const float g1 = acc[i1], g2 = acc[i2];
          acc[i1] = g1 * bf16_round(cr[d]) + g2 * bf16_round(sr[d2]);
          acc[i2] = g2 * bf16_round(cr[d2]) - g1 * bf16_round(sr[d]);
        }
      }
    }
    __nv_bfloat16* orow = base + (long long)row * sl + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// A [64 x N] fp32 accumulator (NS = N / 2 registers a thread) rounded to
// bf16 as the A fragments of N / 16 k16 slices: its n8 column blocks 2 kk
// and 2 kk + 1 are slice kk.
template <int NS>
__device__ __forceinline__ void pack_a(const float (&x)[NS], uint32_t (&f)[NS / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < NS / 4; ++nt) {
    const int kk = nt >> 1, hi = nt & 1;
    f[kk][hi * 2 + 0] = pack_bf16(x[4 * nt + 0], x[4 * nt + 1]);  // row a
    f[kk][hi * 2 + 1] = pack_bf16(x[4 * nt + 2], x[4 * nt + 3]);  // row a + 8
  }
}

// D[64 x N] = A[64 x D] B[N x D]^T, both K-major in shared memory, each as
// D/64 boxes (columns 64 c .. at a0 + c a_box / b0 + c b_box); N 16 to 128;
// issued, not committed.
template <int D, int N = 64>
__device__ __forceinline__ void wgmma_nt(float (&d)[N / 2], uint32_t a0, int a_box, uint32_t b0,
                                         int b_box) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {  // 16 columns of Dh a step: 32 bytes
    const uint64_t da = make_desc(a0 + (ks / 4) * a_box, 16, 1024) + (ks % 4) * 2;
    const uint64_t db = make_desc(b0 + (ks / 4) * b_box, 16, 1024) + (ks % 4) * 2;
    wgmma_ss_keys<N>(d, da, db, ks > 0);
  }
}

// The stage before `pp`'s in a ring of NST, and the parity of the phase in
// which it held the tile before the current one.
template <int NST = B9_NST>
__device__ __forceinline__ Pipe prev_stage(const Pipe& pp) {
  Pipe q;
  q.stage = pp.stage == 0 ? NST - 1 : pp.stage - 1;
  q.phase = pp.stage == 0 ? pp.phase ^ 1 : pp.phase;
  return q;
}

template <int D, int NWG>
struct DkvSmem {  // byte offsets from the 1024-aligned base
  static constexpr int NB = D / 64;                    // boxes of a row
  static constexpr int KT = 64 * NWG;                  // keys of the block
  static constexpr int KBOX = KT * BOX_ROW_BYTES;      // one box of the key tile
  static constexpr int QBOX = B9_QT * BOX_ROW_BYTES;  // one box of a q tile
  static constexpr int K = 0;                         // K's boxes, V's
  static constexpr int V = K + NB * KBOX;
  static constexpr int RING = V + NB * KBOX;          // a stage: Q's boxes, dO's
  static constexpr int STAGE = 2 * NB * QBOX;
  static constexpr int ROWS = RING + B9_NST * STAGE;  // a stage's m, 1/l, delta [3][64]
  static constexpr int ROWS_STAGE = 3 * B9_QT * 4;
  // full[NST], empty[NST], K/V loaded
  static constexpr int BARS = ROWS + B9_NST * ROWS_STAGE;
  static constexpr int END = BARS + (2 * B9_NST + 1) * 8;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

// The issuing thread: q tile j (rows j * 64 ..) of Q, dO and the row values
// into stage `stage` of the dK/dV kernel's ring, completing `full[stage]`.
template <int D, int NWG>
__device__ __forceinline__ void load_q_tile(const CUtensorMap* tq, const CUtensorMap* tdo,
                                            const Bwd9Params& p, const float* rows,
                                            long long plane, uint32_t base, uint64_t* full,
                                            int stage, int j, int h, int b) {
  using S = DkvSmem<D, NWG>;
  uint64_t* bar = &full[stage];
  const uint32_t st = base + S::RING + stage * S::STAGE;
  const uint32_t rs = base + S::ROWS + stage * S::ROWS_STAGE;
  const int q0 = j * B9_QT;
  mbar_arrive_expect_tx(bar, S::STAGE + S::ROWS_STAGE);
#pragma unroll
  for (int c = 0; c < S::NB; ++c) {
    tma_load_head(tq, st + c * S::QBOX, bar, 64 * c, q0, h, b, p.q_hi);
    tma_load_head(tdo, st + (S::NB + c) * S::QBOX, bar, 64 * c, q0, h, b, p.do_hi);
  }
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    bulk_load(rs + pl * B9_QT * 4, rows + pl * plane + q0, B9_QT * 4, bar);
  }
}

template <int D, int NWG>
__device__ __forceinline__ void bwd_dkv_sm90(const CUtensorMap* tk, const CUtensorMap* tv,
                                             const CUtensorMap* tq, const CUtensorMap* tdo,
                                             const Bwd9Params& p) {
  using S = DkvSmem<D, NWG>;
  constexpr int THREADS = 128 * NWG;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  unsigned char* smem = dkv_smem + ((1024 - (smem_u32(dkv_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + B9_NST;
  uint64_t* kv_loaded = empty + B9_NST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * S::KT;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int ntq = p.Lq_pad / B9_QT;
  const uint8_t* mrow = p.mask != nullptr ? p.mask + (long long)b * p.Lk : nullptr;
  // The q tiles whose key extent (visit_keys) reaches this block's keys:
  // the tiles [0, pre) that hold a row with no real key (every key reaches
  // them), then the tiles from `post` on whose rows reach key k0 (under
  // causal masking those ending at or after it), when k0 is before the last
  // real key. Worked out once here, not a tile at a time.
  int e, f;
  key_extent(mrow, p.Lk, lane, e, f);
  const int reach = min(p.Lk, e);  // the extent of a tile whose every row has a key
  int pre = 0, post = k0 < reach ? 0 : ntq;
  if (e == 0) {
    pre = ntq;
  } else if (p.causal) {
    pre = min(ntq, (f + B9_QT - 1) / B9_QT);  // the tiles with a row before f
    if (post == 0) post = max(pre, k0 / B9_QT);
    // only the last tile can end (at row Lq - 1) before key k0
    if (post < ntq && min(post * B9_QT + B9_QT, p.Lq) <= k0) post = ntq;
  }
  auto next_tile = [&](int j) { return j < pre ? j : max(j, post); };  // ntq: none
  // this thread's keys are rows key_a and key_a + 8 of S^T
  const int key_a = k0 + wg * 64 + warp * 16 + lane / 4;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const int jfirst = next_tile(0);
  if (jfirst == ntq) {  // no q tile reaches these keys: dK = dV = 0
    store_acc_rows<D>(dv, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl, key_a, p.Lk, nullptr,
                      nullptr, t);
    store_acc_rows<D>(dk, p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl, key_a, p.Lk, p.sin,
                      p.cos, t);
    return;
  }
  const bool issuer = threadIdx.x == (NWG == 2 ? B9_ISSUER : 0);
  const long long plane = (long long)p.B * p.H * p.Lq_pad;
  const float* rows = p.rows + (long long)bh * p.Lq_pad;
  if (threadIdx.x == 0) {
    for (int s = 0; s < B9_NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    mbar_init(kv_loaded, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int jload = jfirst;  // the issuer's next q tile to load
  if (issuer) {
    mbar_arrive_expect_tx(kv_loaded, 2 * S::NB * S::KBOX);
#pragma unroll
    for (int c = 0; c < S::NB; ++c) {
      tma_load_head(tk, base + S::K + c * S::KBOX, kv_loaded, 64 * c, k0, h, b, p.k_hi);
      tma_load_head(tv, base + S::V + c * S::KBOX, kv_loaded, 64 * c, k0, h, b, p.v_hi);
    }
    for (int i = 0; i < B9_NST && jload < ntq; ++i) {
      load_q_tile<D, NWG>(tq, tdo, p, rows, plane, base, full, i, jload, h, b);
      jload = next_tile(jload + 1);
    }
  }

  bool exists[2], kmasked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    exists[r] = key < p.Lk;
    kmasked[r] = mrow != nullptr && exists[r] && mrow[key] == 0;
  }
  const uint32_t krows = base + S::K + wg * 64 * BOX_ROW_BYTES;
  const uint32_t vrows = base + S::V + wg * 64 * BOX_ROW_BYTES;
  mbar_wait(kv_loaded, 0);
  Pipe pp;
  for (int j = jfirst, i = 0; j < ntq; j = next_tile(j + 1), ++i) {
    if (issuer && i > 0 && jload < ntq) {
      // the stage of the tile before takes the next tile to load once both
      // warpgroups are done with it
      const Pipe pv = prev_stage(pp);
      mbar_wait(&empty[pv.stage], pv.phase);
      load_q_tile<D, NWG>(tq, tdo, p, rows, plane, base, full, pv.stage, jload, h, b);
      jload = next_tile(jload + 1);
    }
    mbar_wait(&full[pp.stage], pp.phase);
    // a warpgroup whose 64 keys lie past the q tile's extent adds exactly
    // nothing: it releases the stage unread (having waited for it, so that
    // it never runs more than the ring ahead of the other)
    if (j >= pre && (k0 + wg * 64 >= reach ||
                     (p.causal && min(j * B9_QT + B9_QT, p.Lq) <= k0 + wg * 64))) {
      mbar_arrive(&empty[pp.stage]);
      pp.advance<B9_NST>();
      continue;
    }
    const uint32_t st = base + S::RING + pp.stage * S::STAGE;
    const float* rs =
        reinterpret_cast<const float*>(smem + S::ROWS + pp.stage * S::ROWS_STAGE);
    float s[32], dp[32];
    wgmma_fence();
    wgmma_nt<D>(s, krows, S::KBOX, st, S::QBOX);  // S^T = K Q^T
    wgmma_nt<D>(dp, vrows, S::KBOX, st + S::NB * S::QBOX, S::QBOX);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // P^T and dS^T in place; column c of the tile is q row q0 + c, whose
    // (m, 1/l, delta) are rs[c], rs[64 + c], rs[128 + c]. Selects, no
    // branches. Under causal masking key k is masked for the rows before it:
    // column nt * 8 + hi (less 2 t) < after[r]
    const int q0 = j * B9_QT;
    const int after[2] = {p.causal ? key_a - q0 - 2 * t : INT_MIN,
                          p.causal ? key_a + 8 - q0 - 2 * t : INT_MIN};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float2 mv = *reinterpret_cast<const float2*>(rs + c);
      const float2 iv = *reinterpret_cast<const float2*>(rs + B9_QT + c);
      const float2 dl = *reinterpret_cast<const float2*>(rs + 2 * B9_QT + c);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int r = e4 >> 1, hi = e4 & 1;
        const bool masked = kmasked[r] | (nt * 8 + hi < after[r]);
        const float x = masked ? -FLT_MAX : s[4 * nt + e4] * p.scale_log2;
        // a row with no valid key has m = -FLT_MAX: P = 1/Lk on every key
        const float prob =
            exists[r] ? fast_exp2(x - (hi ? mv.y : mv.x)) * (hi ? iv.y : iv.x) : 0.f;
        dp[4 * nt + e4] =
            masked ? 0.f : prob * (dp[4 * nt + e4] - (hi ? dl.y : dl.x)) * p.scale;
        s[4 * nt + e4] = prob;
      }
    }
    uint32_t pf[4][4], sf[4][4];  // P^T and dS^T, bf16, as A fragments
    pack_a(s, pf);
    pack_a(dp, sf);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    // dV += P^T dO and dK += dS^T Q over the tile's 64 q rows, 16 a step
    const uint64_t bq = make_desc(st, S::QBOX, 1024);
    const uint64_t bg = make_desc(st + S::NB * S::QBOX, S::QBOX, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb<D>(dv, pf[kk], bg + kk * (16 * BOX_ROW_BYTES / 16));
      wgmma_rs_tb<D>(dk, sf[kk], bq + kk * (16 * BOX_ROW_BYTES / 16));
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
  store_acc_rows<D>(dv, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl, key_a, p.Lk, nullptr,
                    nullptr, t);
  store_acc_rows<D>(dk, p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl, key_a, p.Lk, p.sin, p.cos,
                    t);
}

template <int D>
struct DqSmem {  // byte offsets from the 1024-aligned base
  static constexpr int NB = D / 64;                   // boxes of a row
  static constexpr int QBOX = B9_QB * BOX_ROW_BYTES;  // one box of the q tile
  static constexpr int Q = 0;                         // Q's boxes, dO's
  static constexpr int DO = Q + NB * QBOX;
  static constexpr int RING = DO + NB * QBOX;         // K/V stages, KVRing<B9_KB, D>
  // full[NST], empty[NST], Q/dO loaded
  static constexpr int BARS = RING + B9_NST * KVRing<B9_KB, D>::STAGE;
  static constexpr int END = BARS + (2 * B9_NST + 1) * 8;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

// The issuing thread: key tile j of K and V into stage `stage` of the dQ
// kernel's ring, completing `full[stage]`.
template <int D>
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* tk, const CUtensorMap* tv,
                                             const Bwd9Params& p, uint32_t base,
                                             uint64_t* full, int stage, int j, int h, int b) {
  using R = KVRing<B9_KB, D>;
  uint64_t* bar = &full[stage];
  const uint32_t st = base + DqSmem<D>::RING + stage * R::STAGE;
  mbar_arrive_expect_tx(bar, R::STAGE);
#pragma unroll
  for (int c = 0; c < R::BOXES; ++c) {
    tma_load_head(tk, st + c * R::BOX, bar, 64 * c, j * B9_KB, h, b, p.k_hi);
    tma_load_head(tv, st + (R::BOXES + c) * R::BOX, bar, 64 * c, j * B9_KB, h, b, p.v_hi);
  }
}

template <int D>
__device__ __forceinline__ void bwd_dq_sm90(const CUtensorMap* tq, const CUtensorMap* tdo,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const Bwd9Params& p) {
  using S = DqSmem<D>;
  using R = KVRing<B9_KB, D>;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  unsigned char* smem = dq_smem + ((1024 - (smem_u32(dq_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + B9_NST;
  uint64_t* qd_loaded = empty + B9_NST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * B9_QB;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const uint8_t* mrow = p.mask != nullptr ? p.mask + (long long)b * p.Lk : nullptr;
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
    mbar_arrive_expect_tx(qd_loaded, 2 * S::NB * S::QBOX);
#pragma unroll
    for (int c = 0; c < S::NB; ++c) {
      tma_load_head(tq, base + S::Q + c * S::QBOX, qd_loaded, 64 * c, q0, h, b, p.q_hi);
      tma_load_head(tdo, base + S::DO + c * S::QBOX, qd_loaded, 64 * c, q0, h, b, p.do_hi);
    }
  }
  // key tiles past the q tile's key extent add exactly nothing (read while
  // Q and dO are in flight)
  int e, f;
  key_extent(mrow, p.Lk, lane, e, f);
  const int ntiles =
      (visit_keys(e, f, p.Lq, p.Lk, q0, B9_QB, p.causal) + B9_KB - 1) / B9_KB;
  if (issuer) {
    for (int i = 0; i < B9_NST && i < ntiles; ++i) {
      load_kv_tile<D>(tk, tv, p, base, full, i, i, h, b);
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
  const uint32_t qrows = base + S::Q + wg * 64 * BOX_ROW_BYTES;
  const uint32_t grows = base + S::DO + wg * 64 * BOX_ROW_BYTES;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(qd_loaded, 0);
  Pipe pp;
  for (int j = 0; j < ntiles; ++j) {
    if (issuer && j > 0 && j - 1 + B9_NST < ntiles) {
      // the stage of tile j - 1 takes tile j - 1 + NST once both warpgroups are done with it
      const Pipe pv = prev_stage(pp);
      mbar_wait(&empty[pv.stage], pv.phase);
      load_kv_tile<D>(tk, tv, p, base, full, pv.stage, j - 1 + B9_NST, h, b);
    }
    mbar_wait(&full[pp.stage], pp.phase);
    const uint32_t st = base + S::RING + pp.stage * R::STAGE;
    float s[32], dp[32];
    wgmma_fence();
    wgmma_nt<D>(s, qrows, S::QBOX, st, R::BOX);                        // S = Q K^T
    wgmma_nt<D>(dp, grows, S::QBOX, st + R::BOXES * R::BOX, R::BOX);  // dP = dO V^T
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
      // word k / 32, one key a lane, gathered by a warp vote; this thread's
      // keys nt * 8 + 2 t + c are bit 8 (nt % 4) + c of word nt / 4 shifted
      // down by 2 t. Under causal masking the row's keys after it (key kl,
      // less 2 t, past upto[r]) are masked. Selects, no branches.
      uint32_t valid[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int key = kv0 + 32 * w + lane;
        valid[w] = __ballot_sync(0xffffffffu,
                                 key < p.Lk && (mrow == nullptr || mrow[key] != 0)) >>
                   (2 * t);
      }
      const int upto[2] = {p.causal ? row_a - kv0 - 2 * t : INT_MAX,
                           p.causal ? row_a + 8 - kv0 - 2 * t : INT_MAX};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int r = e4 >> 1;
          const bool keep = ((valid[nt >> 2] >> (8 * (nt & 3) + (e4 & 1))) & 1u) &&
                            nt * 8 + (e4 & 1) <= upto[r];
          const float prob = fast_exp2(s[4 * nt + e4] * p.scale_log2 - m_r[r]) * il_r[r];
          const float ds = prob * (dp[4 * nt + e4] - dl_r[r]) * p.scale;
          dp[4 * nt + e4] = keep ? ds : 0.f;
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
      wgmma_rs_tb<D>(dq, sf[kk], bk + kk * (16 * BOX_ROW_BYTES / 16));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(sf);
    mbar_arrive(&empty[pp.stage]);
    pp.advance<B9_NST>();
  }
  store_acc_rows<D>(dq, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sl, row_a, p.Lq, p.sin, p.cos,
                    t);
}

// K2: the packed and fused layouts, Dh 128.
__global__ void __launch_bounds__(B9_THREADS, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo, const Bwd9Params p) {
  bwd_dkv_sm90<128, 2>(&tk, &tv, &tq, &tdo, p);
}

__global__ void __launch_bounds__(B9_THREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Bwd9Params p) {
  bwd_dq_sm90<128>(&tq, &tdo, &tk, &tv, p);
}

// K4: the [B, H, L, Dh] entry above 64 tokens, Dh 64 or 128.
template <int D>
__global__ void __launch_bounds__(128 * dkv_wgs(D, true), dkv_wgs(D, true) == 1 ? 2 : 1)
    flash_long_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo, const Bwd9Params p) {
  bwd_dkv_sm90<D, dkv_wgs(D, true)>(&tk, &tv, &tq, &tdo, p);
}

// At Dh 64 two blocks an SM (at most 128 registers a thread): the SigLIP
// bank's 13440 short dQ blocks overlap one another's loads.
template <int D>
__global__ void __launch_bounds__(B9_THREADS, D == 64 ? 2 : 1)
    flash_long_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Bwd9Params p) {
  bwd_dq_sm90<D>(&tq, &tdo, &tk, &tv, p);
}

// The two kernels of an entry: K2's, or K4's long ones at D.
template <int D, bool LONG>
const void* dkv_kernel() {
  if constexpr (LONG) {
    return reinterpret_cast<const void*>(&flash_long_bwd_dkv_kernel<D>);
  } else {
    static_assert(D == 128, "K2 takes Dh 128");
    return reinterpret_cast<const void*>(&flash_bwd_dkv_sm90_kernel);
  }
}

template <int D, bool LONG>
const void* dq_kernel() {
  if constexpr (LONG) {
    return reinterpret_cast<const void*>(&flash_long_bwd_dq_kernel<D>);
  } else {
    static_assert(D == 128, "K2 takes Dh 128");
    return reinterpret_cast<const void*>(&flash_bwd_dq_sm90_kernel);
  }
}

// The main kernels' arguments, once `prepare` has pointed `p` at the rotated
// copies (the tensor maps' coordinate orders are set as they are encoded).
inline Bwd9Params bwd9_params(const BwdParams& p, int B, const float* rows) {
  Bwd9Params s;
  s.dq = p.dq; s.dk = p.dk; s.dv = p.dv;
  s.rows = rows; s.sin = p.sin; s.cos = p.cos; s.mask = p.mask;
  s.dq_sb = p.dq_sb; s.dq_sh = p.dq_sh; s.dq_sl = p.dq_sl;
  s.dk_sb = p.dk_sb; s.dk_sh = p.dk_sh; s.dk_sl = p.dk_sl;
  s.dv_sb = p.dv_sb; s.dv_sh = p.dv_sh; s.dv_sl = p.dv_sl;
  s.B = B; s.H = p.H; s.Lq = p.Lq; s.Lk = p.Lk; s.Lq_pad = p.Lq_pad;
  s.scale = p.scale; s.scale_log2 = p.scale_log2;
  s.causal = p.causal;
  return s;
}

template <int D, bool LONG>
int launch_sm90(BwdParams p, int B, const __nv_bfloat16* o, long long o_sb, long long o_sh,
                long long o_sl, const float* stats, float* rows, __nv_bfloat16* q_rot,
                __nv_bfloat16* k_rot, cudaStream_t stream) {
  cudaError_t cerr = prepare<D, LONG ? D / 8 : 32>(p, B, o, o_sb, o_sh, o_sl, stats, rows,
                                                   q_rot, k_rot, stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  Bwd9Params s = bwd9_params(p, B, rows);
  // each operand twice: in the dK/dV kernel's boxes and in the dQ kernel's
  CUtensorMap k_kv, v_kv, q_kv, do_kv, q_q, do_q, k_q, v_q;
  int hi = 0;
  using SK = DkvSmem<D, dkv_wgs(D, LONG)>;
  int err = encode_head_map(&k_kv, p.k, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, SK::KT, &s.k_hi,
                            D);
  if (err == 0)
    err = encode_head_map(&v_kv, p.v, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, SK::KT, &s.v_hi, D);
  if (err == 0)
    err = encode_head_map(&q_kv, p.q, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, B9_QT, &s.q_hi, D);
  if (err == 0)
    err = encode_head_map(&do_kv, p.dout, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, B9_QT,
                          &s.do_hi, D);
  if (err == 0)
    err = encode_head_map(&q_q, p.q, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, B9_QB, &hi, D);
  if (err == 0)
    err = encode_head_map(&do_q, p.dout, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, B9_QB, &hi,
                          D);
  if (err == 0)
    err = encode_head_map(&k_q, p.k, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, B9_KB, &hi, D);
  if (err == 0)
    err = encode_head_map(&v_q, p.v, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, B9_KB, &hi, D);
  if (err != 0) return err;
  const void* kdkv = dkv_kernel<D, LONG>();
  const void* kdq = dq_kernel<D, LONG>();
  static bool ready_kv[MAX_DEVICES] = {}, ready_q[MAX_DEVICES] = {};  // one per instance
  cerr = allow_smem_once(kdkv, SK::BYTES, ready_kv);
  if (cerr == cudaSuccess) cerr = allow_smem_once(kdq, DqSmem<D>::BYTES, ready_q);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  void* args_kv[] = {&k_kv, &v_kv, &q_kv, &do_kv, &s};
  cerr = cudaLaunchKernel(kdkv, dim3((p.Lk + SK::KT - 1) / SK::KT, B * p.H),
                          dim3(128 * dkv_wgs(D, LONG)), args_kv, SK::BYTES, stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  void* args_q[] = {&q_q, &do_q, &k_q, &v_q, &s};
  cerr = cudaLaunchKernel(kdq, dim3((p.Lq + B9_QB - 1) / B9_QB, B * p.H), dim3(B9_THREADS),
                          args_q, DqSmem<D>::BYTES, stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}


// ---- the wide Hopper kernels: bf16 at Dh 256 to 512 ---------------------------
// K2 at head dims 256, 384 and 512 (packed and fused layouts, and the
// backward of the wide K5) and K4 at the widths pad_head_dim reaches above
// 128, at every length: the Hopper design above (the same pre-passes, the
// same key-tile skip, no atomics, tiles fixed whatever B: two launches agree
// bit for bit and a row's gradients do not depend on the batch), cut to rows
// of D / 64 TMA boxes. What changes with D:
//   - Registers. A 64-row accumulator of D fp32 columns is D / 2 registers a
//     thread: dK and dV of one warpgroup's 64 keys are D at 256 (K2 at 128
//     holds both in 128). So the two warpgroups of a block SHARE 64 keys (64
//     q rows in the dQ kernel) and split the work by role, each with one
//     accumulator of at most 128 registers: in the dK/dV kernel warpgroup 0
//     computes S^T = K Q^T, P^T and dV += bf16(P^T) dO, warpgroup 1 dP^T = V
//     dO^T, dS^T = P^T (dP^T - delta) scale (P^T read in fp32 from an
//     exchange tile that warpgroup 0 wrote, two tiles' worth so that one
//     pair barrier a tile serves) and dK += bf16(dS^T) Q; in the dQ kernel
//     warpgroup 0 computes S and P, warpgroup 1 dP and dS (P read from the
//     exchange, bf16(dS) written back as A fragments, two pair barriers a
//     tile), and each adds dS K into its own columns of dQ. (Decoupling the
//     two warpgroups with written / read mbarriers instead, warpgroup 0 a
//     tile ahead, read no faster on the card, and slower in the dQ kernel,
//     whose lookahead ran it at the register limit.)
//   - Columns. A head's columns are held as rotate-half pairs of boxes (box
//     i with box i + D / 128: column d with d + D / 2), so that dK and dQ are
//     un-rotated in registers by the thread that holds both columns. The dQ
//     warpgroups split the D / 128 pairs (1 + 1 at 256, 2 + 1 at 384, 2 + 2
//     at 512); a dK/dV block holds at most two pairs of dK and dV (a "slab"),
//     so at 384 and 512 a grid axis repeats each 64-key block for its two
//     slabs, and each repeats S^T and dP^T: 1.5x the dK/dV kernel's products
//     there (~1.4x the backward's).
//   - Shared memory. The resident 64 rows of K and V (Q and dO in the dQ
//     kernel) take 16 KB a box pair, 128 KB at 512; the streamed tile is what
//     the 227 KB leave: 64 rows (keys) at 256, 32 at 384, 16 at 512, in two
//     stages (`BwdWideCfg`; `wide_bwd_smem_bytes` in ops/_flash_cuda.py
//     mirrors the layouts).
// What bounds them: the operations, as K2 at 128 (10*Lq*Lk'*D FLOP a head:
// at one H*Dh the same at every D), with the slab repeat on top at 384 /
// 512; the 32- and 16-row tiles there give the score products n32 / n16
// shapes, whose A operand is read from shared memory for few columns.
template <int D>
struct BwdWideCfg;
template <>
struct BwdWideCfg<256> { static constexpr int T = 64, NST = 2; };
template <>
struct BwdWideCfg<384> { static constexpr int T = 32, NST = 2; };
template <>
struct BwdWideCfg<512> { static constexpr int T = 16, NST = 2; };
// rows of the resident tile (keys of a dK/dV block, q rows of a dQ block),
// and the box pairs a dK/dV slab holds
constexpr int WB_ROWS = 64;
constexpr int WB_SLAB = 2;

template <int D>
struct DkvWideSmem {  // byte offsets from the 1024-aligned base
  using C = BwdWideCfg<D>;
  static constexpr int NB = D / 64;                      // boxes of a row
  static constexpr int KBOX = WB_ROWS * BOX_ROW_BYTES;   // one box of the 64 keys
  static constexpr int TBOX = C::T * BOX_ROW_BYTES;      // one box of a streamed q tile
  static constexpr int K = 0;                            // K's boxes, V's
  static constexpr int V = K + NB * KBOX;
  static constexpr int RING = V + NB * KBOX;             // a stage: Q's boxes, dO's
  static constexpr int STAGE = 2 * NB * TBOX;
  static constexpr int ROWS = RING + C::NST * STAGE;     // a stage's m, 1/l, delta [3][T]
  static constexpr int ROWS_STAGE = 3 * C::T * 4;
  static constexpr int XP = ROWS + C::NST * ROWS_STAGE;  // P^T of two tiles, fp32
  static constexpr int XP_TILE = WB_ROWS * C::T * 4;
  // full[NST], empty[NST], K/V loaded
  static constexpr int BARS = XP + 2 * XP_TILE;
  static constexpr int END = BARS + (2 * C::NST + 1) * 8;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

template <int D>
struct DqWideSmem {  // byte offsets from the 1024-aligned base
  using C = BwdWideCfg<D>;
  using R = KVRing<C::T, D>;
  static constexpr int NB = D / 64;
  static constexpr int QBOX = WB_ROWS * BOX_ROW_BYTES;  // one box of the 64 q rows
  static constexpr int Q = 0;                           // Q's boxes, dO's
  static constexpr int DO = Q + NB * QBOX;
  static constexpr int RING = DO + NB * QBOX;           // K/V stages, KVRing<T, D>
  static constexpr int XP = RING + C::NST * R::STAGE;   // P, fp32
  static constexpr int XS = XP + WB_ROWS * C::T * 4;    // dS, bf16 A fragments
  // full[NST], empty[NST], Q/dO loaded
  static constexpr int BARS = XS + WB_ROWS * C::T * 2;
  static constexpr int END = BARS + (2 * C::NST + 1) * 8;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

// acc[64 * NP] += A B over the box pairs [p0, p0 + np) (np <= NP): A the
// bf16 fragments of a [64 x T] tile (T / 16 k16 slices), B a tile of T rows
// read MN-major, its D / 64 boxes `box` bytes apart from b0. Pair lp's box
// p0 + lp accumulates into acc_cols64(acc, 2 lp), its rotate-half partner
// box p0 + lp + D / 128 into acc_cols64(acc, 2 lp + 1). Issued, not
// committed.
template <int D, int T, int NP>
__device__ __forceinline__ void wgmma_pairs(float (&acc)[64 * NP], const uint32_t (&a)[T / 16][4],
                                            uint32_t b0, int box, int p0, int np) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {  // 16 rows of B a step
#pragma unroll
    for (int lp = 0; lp < NP; ++lp) {
      if (lp >= np) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int bi = p0 + lp + hh * (D / 128);
        wgmma_rs_n64_tb(acc_cols64(acc, 2 * lp + hh), a[kk],
                        make_desc(b0 + bi * box, box, 1024) + kk * (16 * BOX_ROW_BYTES / 16));
      }
    }
  }
}

// Un-rotate (as store_acc_rows) and store as bf16 the box pairs [p0, p0 +
// np) of a warpgroup's [64 x D] accumulator held as wgmma_pairs leaves it:
// this thread's rows row_a and row_a + 8 (those < L), in each box the
// columns 8 j + 2 t + c at [4 j + 2 r + c]; the rotate-half partner of a
// column is the same place of the pair's other box.
template <int D, int NP>
__device__ __forceinline__ void store_pairs(float (&acc)[64 * NP], __nv_bfloat16* base,
                                            long long sl, int row_a, int L, const float* sin,
                                            const float* cos, int t, int p0, int np) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int lp = 0; lp < NP; ++lp) {
      if (lp >= np) continue;
      float(&x1)[32] = acc_cols64(acc, 2 * lp);
      float(&x2)[32] = acc_cols64(acc, 2 * lp + 1);
      const int c1 = 64 * (p0 + lp), c2 = c1 + D / 2;
      if (sin != nullptr) {
        const float* sr = sin + (long long)row * D;
        const float* cr = cos + (long long)row * D;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = c1 + 8 * j + 2 * t + c, d2 = d + D / 2;
            const int i = 4 * j + 2 * r + c;
            const float g1 = x1[i], g2 = x2[i];
            x1[i] = g1 * bf16_round(cr[d]) + g2 * bf16_round(sr[d2]);
            x2[i] = g2 * bf16_round(cr[d2]) - g1 * bf16_round(sr[d]);
          }
        }
      }
      __nv_bfloat16* orow = base + (long long)row * sl + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + c1 + 8 * j) =
            pack_bf16(x1[4 * j + 2 * r], x1[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(orow + c2 + 8 * j) =
            pack_bf16(x2[4 * j + 2 * r], x2[4 * j + 2 * r + 1]);
      }
    }
  }
}

// The issuing thread: q tile j (rows j * T ..) of Q, dO and the row values
// into stage `stage` of the wide dK/dV kernel's ring, completing `full[stage]`.
template <int D>
__device__ __forceinline__ void load_q_tile_wide(const CUtensorMap* tq, const CUtensorMap* tdo,
                                                 const Bwd9Params& p, const float* rows,
                                                 long long plane, uint32_t base, uint64_t* full,
                                                 int stage, int j, int h, int b) {
  using S = DkvWideSmem<D>;
  constexpr int T = BwdWideCfg<D>::T;
  uint64_t* bar = &full[stage];
  const uint32_t st = base + S::RING + stage * S::STAGE;
  const uint32_t rs = base + S::ROWS + stage * S::ROWS_STAGE;
  const int q0 = j * T;
  mbar_arrive_expect_tx(bar, S::STAGE + S::ROWS_STAGE);
#pragma unroll
  for (int c = 0; c < S::NB; ++c) {
    tma_load_head(tq, st + c * S::TBOX, bar, 64 * c, q0, h, b, p.q_hi);
    tma_load_head(tdo, st + (S::NB + c) * S::TBOX, bar, 64 * c, q0, h, b, p.do_hi);
  }
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) bulk_load(rs + pl * T * 4, rows + pl * plane + q0, T * 4, bar);
}

// dK/dV: one block per (64-key block, slab, batch*head); blockIdx.x = key
// block * slabs + slab. K and V of the keys are loaded once by TMA; the
// T-row Q and dO tiles, with their rows' (m, 1/l, delta), stream through
// NST stages, refilled by one thread of warpgroup 1 as in bwd_dkv_sm90. The
// q tiles visited are bwd_dkv_sm90's (the same rule at T rows a tile).
template <int D>
__device__ __forceinline__ void bwd_dkv_wide(const CUtensorMap* tk, const CUtensorMap* tv,
                                             const CUtensorMap* tq, const CUtensorMap* tdo,
                                             const Bwd9Params& p) {
  using S = DkvWideSmem<D>;
  constexpr int T = BwdWideCfg<D>::T, NST = BwdWideCfg<D>::NST, NS = T / 2;
  constexpr int HB = D / 128, NSLAB = (HB + WB_SLAB - 1) / WB_SLAB;
  extern __shared__ __align__(16) unsigned char dkvw_smem[];
  unsigned char* smem = dkvw_smem + ((1024 - (smem_u32(dkvw_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + NST;
  uint64_t* kv_loaded = empty + NST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int slab = blockIdx.x % NSLAB;
  const int k0 = blockIdx.x / NSLAB * WB_ROWS;
  const int p0 = slab * WB_SLAB, np = min(WB_SLAB, HB - p0);  // the slab's box pairs
  const int wg = threadIdx.x / 128;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int ntq = p.Lq_pad / T;
  const uint8_t* mrow = p.mask != nullptr ? p.mask + (long long)b * p.Lk : nullptr;
  // the q tiles whose key extent reaches this block's keys, as bwd_dkv_sm90
  int e, f;
  key_extent(mrow, p.Lk, lane, e, f);
  const int reach = min(p.Lk, e);
  int pre = 0, post = k0 < reach ? 0 : ntq;
  if (e == 0) {
    pre = ntq;
  } else if (p.causal) {
    pre = min(ntq, (f + T - 1) / T);
    if (post == 0) post = max(pre, k0 / T);
    if (post < ntq && min(post * T + T, p.Lq) <= k0) post = ntq;
  }
  auto next_tile = [&](int j) { return j < pre ? j : max(j, post); };  // ntq: none
  // this thread's keys are rows key_a and key_a + 8 of S^T (both warpgroups)
  const int key_a = k0 + warp * 16 + lane / 4;
  // warpgroup 0: dV, warpgroup 1: dK, over the slab's box pairs
  __nv_bfloat16* out = wg == 0 ? p.dv + b * p.dv_sb + h * p.dv_sh
                               : p.dk + b * p.dk_sb + h * p.dk_sh;
  const long long out_sl = wg == 0 ? p.dv_sl : p.dk_sl;
  const float* out_sin = wg == 0 ? nullptr : p.sin;
  float acc[64 * WB_SLAB];
#pragma unroll
  for (int i = 0; i < 64 * WB_SLAB; ++i) acc[i] = 0.f;
  const int jfirst = next_tile(0);
  if (jfirst == ntq) {  // no q tile reaches these keys: dK = dV = 0
    store_pairs<D, WB_SLAB>(acc, out, out_sl, key_a, p.Lk, nullptr, nullptr, t, p0, np);
    return;
  }
  const bool issuer = threadIdx.x == B9_ISSUER;
  const long long plane = (long long)p.B * p.H * p.Lq_pad;
  const float* rows = p.rows + (long long)bh * p.Lq_pad;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], B9_THREADS);
    }
    mbar_init(kv_loaded, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int jload = jfirst;  // the issuer's next q tile to load
  if (issuer) {
    mbar_arrive_expect_tx(kv_loaded, 2 * S::NB * S::KBOX);
#pragma unroll
    for (int c = 0; c < S::NB; ++c) {
      tma_load_head(tk, base + S::K + c * S::KBOX, kv_loaded, 64 * c, k0, h, b, p.k_hi);
      tma_load_head(tv, base + S::V + c * S::KBOX, kv_loaded, 64 * c, k0, h, b, p.v_hi);
    }
    for (int i = 0; i < NST && jload < ntq; ++i) {
      load_q_tile_wide<D>(tq, tdo, p, rows, plane, base, full, i, jload, h, b);
      jload = next_tile(jload + 1);
    }
  }

  bool exists[2], kmasked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    exists[r] = key < p.Lk;
    kmasked[r] = mrow != nullptr && exists[r] && mrow[key] == 0;
  }
  // the score product's A (K or V, resident) and B (Q or dO, in the stage),
  // and the accumulation's B (dO for dV, Q for dK)
  const uint32_t own = base + (wg == 0 ? S::K : S::V);
  const int score_b = wg == 0 ? 0 : S::NB * S::TBOX;
  const int acc_b = wg == 0 ? S::NB * S::TBOX : 0;
  float4* xp = reinterpret_cast<float4*>(smem + S::XP) + threadIdx.x % 128;
  mbar_wait(kv_loaded, 0);
  Pipe pp;
  for (int j = jfirst, i = 0; j < ntq; j = next_tile(j + 1), ++i) {
    if (issuer && i > 0 && jload < ntq) {
      // the stage of the tile before takes the next tile to load once both
      // warpgroups are done with it
      const Pipe pv = prev_stage<NST>(pp);
      mbar_wait(&empty[pv.stage], pv.phase);
      load_q_tile_wide<D>(tq, tdo, p, rows, plane, base, full, pv.stage, jload, h, b);
      jload = next_tile(jload + 1);
    }
    mbar_wait(&full[pp.stage], pp.phase);
    const uint32_t st = base + S::RING + pp.stage * S::STAGE;
    const float* rs = reinterpret_cast<const float*>(smem + S::ROWS + pp.stage * S::ROWS_STAGE);
    float s[NS];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
    wgmma_fence();
    wgmma_nt<D, T>(s, own, S::KBOX, st + score_b, S::TBOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    // column c of the tile is q row q0 + c, whose (m, 1/l, delta) are
    // rs[c], rs[T + c], rs[2 T + c]; under causal masking key k is masked
    // for the rows before it: column nt * 8 + hi (less 2 t) < after[r]
    const int q0 = j * T;
    const int after[2] = {p.causal ? key_a - q0 - 2 * t : INT_MIN,
                          p.causal ? key_a + 8 - q0 - 2 * t : INT_MIN};
    float4* xb = xp + (i & 1) * (NS / 4) * 128;
    uint32_t fr[T / 16][4];  // bf16(P^T) or bf16(dS^T), as A fragments
    if (wg == 0) {  // P^T in place, and to the exchange in fp32
#pragma unroll
      for (int nt = 0; nt < T / 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        const float2 mv = *reinterpret_cast<const float2*>(rs + c);
        const float2 iv = *reinterpret_cast<const float2*>(rs + T + c);
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int r = e4 >> 1, hi = e4 & 1;
          const bool masked = kmasked[r] | (nt * 8 + hi < after[r]);
          const float x = masked ? -FLT_MAX : s[4 * nt + e4] * p.scale_log2;
          // a row with no valid key has m = -FLT_MAX: P = 1/Lk on every key
          s[4 * nt + e4] =
              exists[r] ? fast_exp2(x - (hi ? mv.y : mv.x)) * (hi ? iv.y : iv.x) : 0.f;
        }
      }
#pragma unroll
      for (int i4 = 0; i4 < NS / 4; ++i4) {
        xb[i4 * 128] = make_float4(s[4 * i4], s[4 * i4 + 1], s[4 * i4 + 2], s[4 * i4 + 3]);
      }
      pack_a(s, fr);
    }
    pair_sync();  // P^T is in the exchange
    if (wg == 1) {  // dS^T = P^T (dP^T - delta) scale, 0 where the score was masked
#pragma unroll
      for (int nt = 0; nt < T / 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        const float2 dl = *reinterpret_cast<const float2*>(rs + 2 * T + c);
        const float4 pr = xb[nt * 128];  // P^T's entries 4 nt .. 4 nt + 3 of this thread
        const float prob[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int r = e4 >> 1, hi = e4 & 1;
          const bool masked = kmasked[r] | (nt * 8 + hi < after[r]);
          s[4 * nt + e4] =
              masked ? 0.f : prob[e4] * (s[4 * nt + e4] - (hi ? dl.y : dl.x)) * p.scale;
        }
      }
      pack_a(s, fr);
    }
    fence_regs(acc);
    wgmma_fence();
    // dV += P^T dO or dK += dS^T Q over the tile's T q rows, the slab's columns
    wgmma_pairs<D, T, WB_SLAB>(acc, fr, st + acc_b, S::TBOX, p0, np);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fr);
    mbar_arrive(&empty[pp.stage]);
    pp.advance<NST>();
  }
  store_pairs<D, WB_SLAB>(acc, out, out_sl, key_a, p.Lk, out_sin, p.cos, t, p0, np);
}

// dQ: one block per (64-row q tile, batch*head). Q and dO are loaded once;
// K and V stream in T-key tiles through NST stages (KVRing<T, D>) up to the
// q tile's key extent, refilled by one thread of warpgroup 1 as in
// bwd_dq_sm90. Warpgroup 0 holds dQ's box pairs [0, NP), warpgroup 1 the rest.
template <int D>
__device__ __forceinline__ void bwd_dq_wide(const CUtensorMap* tq, const CUtensorMap* tdo,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const Bwd9Params& p) {
  using S = DqWideSmem<D>;
  constexpr int T = BwdWideCfg<D>::T, NST = BwdWideCfg<D>::NST, NS = T / 2;
  using R = KVRing<T, D>;
  constexpr int HB = D / 128, NP = (HB + 1) / 2;
  extern __shared__ __align__(16) unsigned char dqw_smem[];
  unsigned char* smem = dqw_smem + ((1024 - (smem_u32(dqw_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + NST;
  uint64_t* qd_loaded = empty + NST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * WB_ROWS;
  const int wg = threadIdx.x / 128;  // 0: S, P; 1: dP, dS
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const uint8_t* mrow = p.mask != nullptr ? p.mask + (long long)b * p.Lk : nullptr;
  const bool issuer = threadIdx.x == B9_ISSUER;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], B9_THREADS);
    }
    mbar_init(qd_loaded, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // key tile j of K and V into stage `stage`, completing `full[stage]`
  auto load_kv = [&](int stage, int j) {
    uint64_t* bar = &full[stage];
    const uint32_t st = base + S::RING + stage * R::STAGE;
    mbar_arrive_expect_tx(bar, R::STAGE);
#pragma unroll
    for (int c = 0; c < R::BOXES; ++c) {
      tma_load_head(tk, st + c * R::BOX, bar, 64 * c, j * T, h, b, p.k_hi);
      tma_load_head(tv, st + (R::BOXES + c) * R::BOX, bar, 64 * c, j * T, h, b, p.v_hi);
    }
  };
  if (issuer) {
    mbar_arrive_expect_tx(qd_loaded, 2 * S::NB * S::QBOX);
#pragma unroll
    for (int c = 0; c < S::NB; ++c) {
      tma_load_head(tq, base + S::Q + c * S::QBOX, qd_loaded, 64 * c, q0, h, b, p.q_hi);
      tma_load_head(tdo, base + S::DO + c * S::QBOX, qd_loaded, 64 * c, q0, h, b, p.do_hi);
    }
  }
  // key tiles past the q tile's key extent add exactly nothing
  int e, f;
  key_extent(mrow, p.Lk, lane, e, f);
  const int ntiles = (visit_keys(e, f, p.Lq, p.Lk, q0, WB_ROWS, p.causal) + T - 1) / T;
  if (issuer) {
    for (int i = 0; i < NST && i < ntiles; ++i) load_kv(i, i);
  }

  const int row_a = q0 + warp * 16 + lane / 4;  // both warpgroups: rows row_a, row_a + 8
  const long long plane = (long long)p.B * p.H * p.Lq_pad;
  const float* rows = p.rows + (long long)bh * p.Lq_pad;
  float m_r[2], il_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool ok = row < p.Lq;  // rows past Lq add nothing
    m_r[r] = ok ? rows[row] : 0.f;
    il_r[r] = ok ? rows[plane + row] : 0.f;
    dl_r[r] = ok ? rows[2 * plane + row] : 0.f;
  }
  const int p0 = wg == 0 ? 0 : NP, np = wg == 0 ? NP : HB - NP;  // this warpgroup's pairs of dQ
  float dq[64 * NP];
#pragma unroll
  for (int i = 0; i < 64 * NP; ++i) dq[i] = 0.f;
  // the score product: S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1)
  const uint32_t own = base + (wg == 0 ? S::Q : S::DO);
  const int score_b = wg == 0 ? 0 : R::BOXES * R::BOX;
  float4* xp = reinterpret_cast<float4*>(smem + S::XP) + threadIdx.x % 128;
  uint4* xs = reinterpret_cast<uint4*>(smem + S::XS) + threadIdx.x % 128;
  mbar_wait(qd_loaded, 0);
  Pipe pp;
  for (int j = 0; j < ntiles; ++j) {
    if (issuer && j > 0 && j - 1 + NST < ntiles) {
      // the stage of tile j - 1 takes tile j - 1 + NST once both warpgroups are done with it
      const Pipe pv = prev_stage<NST>(pp);
      mbar_wait(&empty[pv.stage], pv.phase);
      load_kv(pv.stage, j - 1 + NST);
    }
    mbar_wait(&full[pp.stage], pp.phase);
    const uint32_t st = base + S::RING + pp.stage * R::STAGE;
    float s[NS];
    wgmma_fence();
    wgmma_nt<D, T>(s, own, S::QBOX, st + score_b, R::BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    uint32_t fr[T / 16][4];  // bf16(dS), as A fragments
    if (wg == 0) {
      // P, 0 where the score was masked or the key does not exist (so dS is
      // 0 there): which of the tile's keys exist and are not masked, bit k of
      // word k / 32, one key a lane, gathered by a warp vote; this thread's
      // keys nt * 8 + 2 t + c are bit 8 (nt % 4) + c of word nt / 4 shifted
      // down by 2 t. Under causal masking the row's keys after it (key kl,
      // less 2 t, past upto[r]) are masked. Selects, no branches.
      const int kv0 = j * T;
      if (mrow == nullptr && !p.causal && kv0 + T <= p.Lk) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = fast_exp2(s[i] * p.scale_log2 - m_r[r]) * il_r[r];
        }
      } else {
        constexpr int MW = (T + 31) / 32;
        uint32_t valid[MW];
#pragma unroll
        for (int w = 0; w < MW; ++w) {
          const int kl = 32 * w + lane, key = kv0 + kl;
          valid[w] = __ballot_sync(0xffffffffu, kl < T && key < p.Lk &&
                                                    (mrow == nullptr || mrow[key] != 0)) >>
                     (2 * t);
        }
        const int upto[2] = {p.causal ? row_a - kv0 - 2 * t : INT_MAX,
                             p.causal ? row_a + 8 - kv0 - 2 * t : INT_MAX};
#pragma unroll
        for (int nt = 0; nt < T / 8; ++nt) {
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int r = e4 >> 1;
            const bool keep = ((valid[nt >> 2] >> (8 * (nt & 3) + (e4 & 1))) & 1u) &&
                              nt * 8 + (e4 & 1) <= upto[r];
            const float prob = fast_exp2(s[4 * nt + e4] * p.scale_log2 - m_r[r]) * il_r[r];
            s[4 * nt + e4] = keep ? prob : 0.f;
          }
        }
      }
#pragma unroll
      for (int i4 = 0; i4 < NS / 4; ++i4) {
        xp[i4 * 128] = make_float4(s[4 * i4], s[4 * i4 + 1], s[4 * i4 + 2], s[4 * i4 + 3]);
      }
    }
    pair_sync();  // P is in the exchange
    if (wg == 1) {  // dS = P (dP - delta) scale, to the exchange as bf16 fragments
#pragma unroll
      for (int i4 = 0; i4 < NS / 4; ++i4) {
        const float4 pr = xp[i4 * 128];
        const float prob[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int r = e4 >> 1;
          s[4 * i4 + e4] = prob[e4] * (s[4 * i4 + e4] - dl_r[r]) * p.scale;
        }
      }
      pack_a(s, fr);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        xs[kk * 128] = make_uint4(fr[kk][0], fr[kk][1], fr[kk][2], fr[kk][3]);
      }
    }
    pair_sync();  // dS is in the exchange
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        const uint4 v = xs[kk * 128];
        fr[kk][0] = v.x;
        fr[kk][1] = v.y;
        fr[kk][2] = v.z;
        fr[kk][3] = v.w;
      }
    }
    fence_regs(dq);
    wgmma_fence();
    // dQ += dS K over the tile's T keys, this warpgroup's columns
    wgmma_pairs<D, T, NP>(dq, fr, st, R::BOX, p0, np);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(fr);
    mbar_arrive(&empty[pp.stage]);
    pp.advance<NST>();
  }
  store_pairs<D, NP>(dq, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sl, row_a, p.Lq, p.sin, p.cos, t,
                     p0, np);
}

// K2 at Dh 256, 384 and 512, and K4 at the padded widths.
template <int D>
__global__ void __launch_bounds__(B9_THREADS, 1)
    flash_bwd_dkv_wide_sm90_kernel(const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tdo, const Bwd9Params p) {
  bwd_dkv_wide<D>(&tk, &tv, &tq, &tdo, p);
}

template <int D>
__global__ void __launch_bounds__(B9_THREADS, 1)
    flash_bwd_dq_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv, const Bwd9Params p) {
  bwd_dq_wide<D>(&tq, &tdo, &tk, &tv, p);
}

template <int D>
int launch_wide(BwdParams p, int B, const __nv_bfloat16* o, long long o_sb, long long o_sh,
                long long o_sl, const float* stats, float* rows, __nv_bfloat16* q_rot,
                __nv_bfloat16* k_rot, cudaStream_t stream) {
  constexpr int T = BwdWideCfg<D>::T, NSLAB = (D / 128 + WB_SLAB - 1) / WB_SLAB;
  cudaError_t cerr = prepare<D, 32>(p, B, o, o_sb, o_sh, o_sl, stats, rows, q_rot, k_rot,
                                    stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  Bwd9Params s = bwd9_params(p, B, rows);
  // each operand twice: resident (64 rows a box) and streamed (T rows a box)
  CUtensorMap k_res, v_res, q_str, do_str, q_res, do_res, k_str, v_str;
  int hi = 0;
  int err = encode_head_map(&k_res, p.k, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, WB_ROWS, &s.k_hi,
                            D);
  if (err == 0)
    err = encode_head_map(&v_res, p.v, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, WB_ROWS, &s.v_hi, D);
  if (err == 0)
    err = encode_head_map(&q_str, p.q, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, T, &s.q_hi, D);
  if (err == 0)
    err = encode_head_map(&do_str, p.dout, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, T, &s.do_hi,
                          D);
  if (err == 0)
    err = encode_head_map(&q_res, p.q, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, WB_ROWS, &hi, D);
  if (err == 0)
    err = encode_head_map(&do_res, p.dout, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, WB_ROWS, &hi,
                          D);
  if (err == 0)
    err = encode_head_map(&k_str, p.k, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, T, &hi, D);
  if (err == 0)
    err = encode_head_map(&v_str, p.v, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, T, &hi, D);
  if (err != 0) return err;
  const void* kdkv = reinterpret_cast<const void*>(&flash_bwd_dkv_wide_sm90_kernel<D>);
  const void* kdq = reinterpret_cast<const void*>(&flash_bwd_dq_wide_sm90_kernel<D>);
  static bool ready_kv[MAX_DEVICES] = {}, ready_q[MAX_DEVICES] = {};  // one per instance
  cerr = allow_smem_once(kdkv, DkvWideSmem<D>::BYTES, ready_kv);
  if (cerr == cudaSuccess) cerr = allow_smem_once(kdq, DqWideSmem<D>::BYTES, ready_q);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  void* args_kv[] = {&k_res, &v_res, &q_str, &do_str, &s};
  cerr = cudaLaunchKernel(kdkv, dim3((p.Lk + WB_ROWS - 1) / WB_ROWS * NSLAB, B * p.H),
                          dim3(B9_THREADS), args_kv, DkvWideSmem<D>::BYTES, stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  void* args_q[] = {&q_res, &do_res, &k_str, &v_str, &s};
  cerr = cudaLaunchKernel(kdq, dim3((p.Lq + WB_ROWS - 1) / WB_ROWS, B * p.H), dim3(B9_THREADS),
                          args_q, DqWideSmem<D>::BYTES, stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

// ---- SIMT kernels: fp32 at Dh 256 to 512 -------------------------------------
// The same gradients without tensor cores, tiled as the SIMT forward
// (flash_common.cuh, simt_attend_tiles): a block of 4 or 8 warps owns 16 or
// 32 rows (q rows for dQ, keys for dK and dV), 4 a warp, held transposed in
// shared memory; the partner rows (keys for dQ, q rows for dK and dV)
// stream through shared memory 32 at a time, one a lane for the two dot
// products, then every lane adds the tile's weighted rows into its own
// columns. No atomics: each output row is summed by one warp in a fixed
// order. fp32 operands (K2 and K4, every layout, D 256 to 512; D 64 and
// 128 run the register-tiled kernels further down) round nothing below
// fp32. In the fused layout dq, dk and dv are column blocks of one [B, L,
// 3D] gradient: the dK/dV kernel writes the dk and dv rows of its keys and
// the dQ kernel the dq rows of its queries, each only its own columns,
// nothing is zeroed, so no kernel touches another's block (as every kernel
// of this file). What bounds them, as the forward: 10*Lq*Lk*D FLOP on the
// CUDA cores, paced by the shared-memory pipe (PERF.md has their times).

template <typename T>
struct BwdParamsSimt {
  const T* q;   // rotated already when RoPE is on
  const T* k;   // rotated already when RoPE is on
  const T* v;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  const float* rows;  // [3, B*H, Lq_pad]: m, 1/l, delta
  float* dst;         // fp32 [B*H, Lk, Lq_pad]: dS^T (the register-tiled kernels)
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
template <typename T, int D>
__device__ __forceinline__ void bwd_rows_simt(
    const T* o, long long o_sb, long long o_sh, long long o_sl,
    const T* dout, long long do_sb, long long do_sh, long long do_sl,
    const float* stats, float* rows, int H, int Lq, int Lq_pad) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= Lq) return;
  const T* orow = o + b * o_sb + h * o_sh + row * o_sl;
  const T* drow = dout + b * do_sb + h * do_sh + row * do_sl;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    acc = fmaf(to_f(orow[lane + 32 * i]), to_f(drow[lane + 32 * i]), acc);
  }
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
__global__ void __launch_bounds__(256) bwd_rows_f32_kernel(
    const float* o, long long o_sb, long long o_sh, long long o_sl, const float* dout,
    long long do_sb, long long do_sh, long long do_sl, const float* stats, float* rows, int H,
    int Lq, int Lq_pad) {
  bwd_rows_simt<float, D>(o, o_sb, o_sh, o_sl, dout, do_sb, do_sh, do_sl, stats, rows, H, Lq,
                          Lq_pad);
}

// Shared memory of the tiled dQ kernel, in floats: Q^T and dO^T [D][BQ + 4]
// (a warp's 4 rows one float4), K and V [SBK][D + 1] (a lane reads its key's
// row); of the dK/dV kernel: K^T and V^T [D][BK + 4] (a warp's 4 keys one
// float4), the streamed Q and dO tiles [SBK][D + 1] (a lane reads its row).
template <int D, int NW>
struct BwdTiles {
  static constexpr int B4 = NW * SR;  // the block's rows (dQ) or keys (dK/dV)
  static constexpr int TLD = B4 + 4;
  static constexpr int RLD = D + 1;
  static constexpr int T1 = 0;
  static constexpr int T2 = T1 + D * TLD;
  static constexpr int R1 = T2 + D * TLD;
  static constexpr int R2 = R1 + SBK * RLD;
  static constexpr int BYTES = (R2 + SBK * RLD) * 4;
};

// dQ: a block owns B4 q rows (4 a warp) and streams the head's K and V in
// tiles of 32 keys, a lane scoring one key against the warp's 4 rows (S and
// dP from float4s of the transposed Q and dO tiles), then dQ += dS K with
// the warp's dS shuffled key by key, in the order of the one-warp-a-row
// version.
template <typename T, int D>
__device__ __forceinline__ void bwd_dq_simt(const BwdParamsSimt<T>& p) {
  constexpr int NW = SIMT_WARPS<D>, PER = D / 32;
  using S = BwdTiles<D, NW>;
  extern __shared__ __align__(16) float simt_smem[];
  float* qs = simt_smem + S::T1;
  float* gs = simt_smem + S::T2;
  float* ks = simt_smem + S::R1;
  float* vs = simt_smem + S::R2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * S::B4, row0 = q0 + SR * warp;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const T* kg = p.k + b * p.k_sb + h * p.k_sh;
  const T* vg = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
  load_tile_cols<T, D>(qs, S::TLD, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, S::B4, p.Lq,
                       nullptr, nullptr);
  load_tile_cols<T, D>(gs, S::TLD, p.dout + b * p.do_sb + h * p.do_sh, p.do_sl, q0, S::B4,
                       p.Lq, nullptr, nullptr);
  const long long plane = (long long)gridDim.y * p.Lq_pad;
  const float* rv = p.rows + (long long)bh * p.Lq_pad;
  float m[SR], il[SR], delta[SR], acc[SR][PER];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int row = row0 + r;  // a row past Lq: P = 0, so dS = 0 (never stored)
    m[r] = row < p.Lq ? rv[row] : 0.f;
    il[r] = row < p.Lq ? rv[plane + row] : 0.f;
    delta[r] = row < p.Lq ? rv[2 * plane + row] : 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[r][i] = 0.f;
  }
  for (int j0 = 0; j0 < p.Lk; j0 += SBK) {
    __syncthreads();
    load_tile_rows<T, D>(ks, S::RLD, kg, p.k_sl, j0, SBK, p.Lk);
    load_tile_rows<T, D>(vs, S::RLD, vg, p.v_sl, j0, SBK, p.Lk);
    __syncthreads();
    const int key = j0 + lane;
    float sc[SR] = {0.f, 0.f, 0.f, 0.f}, dp[SR] = {0.f, 0.f, 0.f, 0.f};
    const float* krow = ks + lane * S::RLD;
    const float* vrow = vs + lane * S::RLD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d], vv = vrow[d];
      const float4 q4 = *reinterpret_cast<const float4*>(qs + d * S::TLD + SR * warp);
      const float4 g4 = *reinterpret_cast<const float4*>(gs + d * S::TLD + SR * warp);
      sc[0] = fmaf(q4.x, kv, sc[0]); sc[1] = fmaf(q4.y, kv, sc[1]);
      sc[2] = fmaf(q4.z, kv, sc[2]); sc[3] = fmaf(q4.w, kv, sc[3]);
      dp[0] = fmaf(g4.x, vv, dp[0]); dp[1] = fmaf(g4.y, vv, dp[1]);
      dp[2] = fmaf(g4.z, vv, dp[2]); dp[3] = fmaf(g4.w, vv, dp[3]);
    }
    const bool open = key < p.Lk && !(mrow != nullptr && mrow[key] == 0);
    float ds[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) {  // no gradient through a masked score
      ds[r] = (open && !(p.causal && key > row0 + r))
                  ? round_to<T>(exp2f(sc[r] * p.scale_log2 - m[r]) * il[r] * (dp[r] - delta[r]) *
                                p.scale)
                  : 0.f;
    }
    const int n = min(SBK, p.Lk - j0);
    for (int jj = 0; jj < n; ++jj) {
      float dv_[SR];
#pragma unroll
      for (int r = 0; r < SR; ++r) dv_[r] = __shfl_sync(FULL, ds[r], jj);
      const float* kr = ks + jj * S::RLD + lane;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float kv = kr[32 * i];
#pragma unroll
        for (int r = 0; r < SR; ++r) acc[r][i] = fmaf(dv_[r], kv, acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int row = row0 + r;
    if (row < p.Lq) {
      store_row<T, D>(acc[r], p.dq + b * p.dq_sb + h * p.dq_sh + row * p.dq_sl, p.sin, p.cos,
                      row, lane);
    }
  }
}

// dK and dV: a block owns B4 keys (4 a warp) and streams the head's q rows
// and dO in tiles of 32, a lane taking one q row against the warp's 4 keys
// (S^T and dP^T from float4s of the transposed K and V tiles), then dV +=
// P^T dO and dK += dS^T Q with the warp's P and dS shuffled row by row.
template <typename T, int D>
__device__ __forceinline__ void bwd_dkv_simt(const BwdParamsSimt<T>& p) {
  constexpr int NW = SIMT_WARPS<D>, PER = D / 32;
  using S = BwdTiles<D, NW>;
  extern __shared__ __align__(16) float simt_smem[];
  float* kt = simt_smem + S::T1;
  float* vt = simt_smem + S::T2;
  float* qs = simt_smem + S::R1;
  float* gs = simt_smem + S::R2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * S::B4, key0 = k0 + SR * warp;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const T* qg = p.q + b * p.q_sb + h * p.q_sh;
  const T* gg = p.dout + b * p.do_sb + h * p.do_sh;
  load_tile_cols<T, D>(kt, S::TLD, p.k + b * p.k_sb + h * p.k_sh, p.k_sl, k0, S::B4, p.Lk,
                       nullptr, nullptr);
  load_tile_cols<T, D>(vt, S::TLD, p.v + b * p.v_sb + h * p.v_sh, p.v_sl, k0, S::B4, p.Lk,
                       nullptr, nullptr);
  bool kmasked[SR];
  float dk[SR][PER], dv[SR][PER];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int key = key0 + r;
    kmasked[r] = key < p.Lk && p.mask != nullptr && p.mask[(long long)b * p.Lk + key] == 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) dk[r][i] = dv[r][i] = 0.f;
  }
  const long long plane = (long long)gridDim.y * p.Lq_pad;
  const float* rv = p.rows + (long long)bh * p.Lq_pad;
  for (int i0 = 0; i0 < p.Lq; i0 += SBK) {
    __syncthreads();
    load_tile_rows<T, D>(qs, S::RLD, qg, p.q_sl, i0, SBK, p.Lq);
    load_tile_rows<T, D>(gs, S::RLD, gg, p.do_sl, i0, SBK, p.Lq);
    __syncthreads();
    const int qi = i0 + lane;
    float sc[SR] = {0.f, 0.f, 0.f, 0.f}, dp[SR] = {0.f, 0.f, 0.f, 0.f};
    const float* qrow = qs + lane * S::RLD;
    const float* grow = gs + lane * S::RLD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d], gv = grow[d];
      const float4 k4 = *reinterpret_cast<const float4*>(kt + d * S::TLD + SR * warp);
      const float4 v4 = *reinterpret_cast<const float4*>(vt + d * S::TLD + SR * warp);
      sc[0] = fmaf(k4.x, qv, sc[0]); sc[1] = fmaf(k4.y, qv, sc[1]);
      sc[2] = fmaf(k4.z, qv, sc[2]); sc[3] = fmaf(k4.w, qv, sc[3]);
      dp[0] = fmaf(v4.x, gv, dp[0]); dp[1] = fmaf(v4.y, gv, dp[1]);
      dp[2] = fmaf(v4.z, gv, dp[2]); dp[3] = fmaf(v4.w, gv, dp[3]);
    }
    float prob[SR] = {0.f, 0.f, 0.f, 0.f}, ds[SR] = {0.f, 0.f, 0.f, 0.f};
    if (qi < p.Lq) {
      const float mq = rv[qi], ilq = rv[plane + qi], dlt = rv[2 * plane + qi];
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        const bool masked = kmasked[r] || (p.causal && key0 + r > qi);
        const float x = masked ? -FLT_MAX : sc[r] * p.scale_log2;
        // a row with no valid key has m = -FLT_MAX: P = 1/Lk on every key
        const float pr = exp2f(x - mq) * ilq;
        if (!masked) ds[r] = round_to<T>(pr * (dp[r] - dlt) * p.scale);
        prob[r] = round_to<T>(pr);
      }
    }
    const int n = min(SBK, p.Lq - i0);
    for (int ii = 0; ii < n; ++ii) {
      float pv[SR], dsv[SR];
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        pv[r] = __shfl_sync(FULL, prob[r], ii);
        dsv[r] = __shfl_sync(FULL, ds[r], ii);
      }
      const float* gr = gs + ii * S::RLD + lane;
      const float* qr = qs + ii * S::RLD + lane;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float gv = gr[32 * i], qv = qr[32 * i];
#pragma unroll
        for (int r = 0; r < SR; ++r) {
          dv[r][i] = fmaf(pv[r], gv, dv[r][i]);
          dk[r][i] = fmaf(dsv[r], qv, dk[r][i]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int key = key0 + r;
    if (key >= p.Lk) continue;
    store_row<T, D>(dv[r], p.dv + b * p.dv_sb + h * p.dv_sh + key * p.dv_sl, nullptr, nullptr,
                    key, lane);
    store_row<T, D>(dk[r], p.dk + b * p.dk_sb + h * p.dk_sh + key * p.dk_sl, p.sin, p.cos, key,
                    lane);
  }
}

// fp32 operands, every layout, D 256 to 512: K2 and K4.
template <int D>
__global__ void __launch_bounds__(SIMT_WARPS<D> * 32) flash_bwd_dq_f32_kernel(
    const BwdParamsSimt<float> p) {
  bwd_dq_simt<float, D>(p);
}

template <int D>
__global__ void __launch_bounds__(SIMT_WARPS<D> * 32) flash_bwd_dkv_f32_kernel(
    const BwdParamsSimt<float> p) {
  bwd_dkv_simt<float, D>(p);
}

// The pre-passes of the SIMT and register-tiled kernels: q and k rotated
// once into the scratch copies (then `p` points at those), and the rows'
// (m, 1/l, delta).
template <int D>
cudaError_t simt_prepass(BwdParamsSimt<float>& p, int B, const float* o, long long o_sb,
                         long long o_sh, long long o_sl, const float* stats, float* rows,
                         float* q_rot, float* k_rot, cudaStream_t stream) {
  cudaError_t err;
  if (p.sin != nullptr) {  // rotate q and k once into the scratch copies
    err = launch_rope_rows_t<D>(p.q, p.q_sb, p.q_sh, p.q_sl, B, p.H, p.Lq, p.sin, p.cos,
                                q_rot, stream);
    if (err != cudaSuccess) return err;
    err = launch_rope_rows_t<D>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk, p.sin, p.cos,
                                k_rot, stream);
    if (err != cudaSuccess) return err;
    p.q = q_rot;
    p.q_sb = (long long)p.H * p.Lq * D; p.q_sh = (long long)p.Lq * D; p.q_sl = D;
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D; p.k_sh = (long long)p.Lk * D; p.k_sl = D;
  }
  const dim3 grows((p.Lq + 7) / 8, B * p.H);
  bwd_rows_f32_kernel<D><<<grows, 256, 0, stream>>>(o, o_sb, o_sh, o_sl, p.dout, p.do_sb,
                                                    p.do_sh, p.do_sl, stats, rows, p.H, p.Lq,
                                                    p.Lq_pad);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_simt(BwdParamsSimt<float> p, int B, const float* o, long long o_sb,
                        long long o_sh, long long o_sl, const float* stats, float* rows,
                        float* q_rot, float* k_rot, cudaStream_t stream) {
  cudaError_t err = simt_prepass<D>(p, B, o, o_sb, o_sh, o_sl, stats, rows, q_rot, k_rot,
                                    stream);
  if (err != cudaSuccess) return err;
  using S = BwdTiles<D, SIMT_WARPS<D>>;
  const void* kdkv = reinterpret_cast<const void*>(&flash_bwd_dkv_f32_kernel<D>);
  const void* kdq = reinterpret_cast<const void*>(&flash_bwd_dq_f32_kernel<D>);
  static bool ready_kv[MAX_DEVICES] = {}, ready_q[MAX_DEVICES] = {};
  err = allow_smem_once(kdkv, S::BYTES, ready_kv);
  if (err == cudaSuccess) err = allow_smem_once(kdq, S::BYTES, ready_q);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  const dim3 block(SIMT_WARPS<D> * 32);
  err = cudaLaunchKernel(kdkv, dim3((p.Lk + S::B4 - 1) / S::B4, B * p.H), block, args,
                         S::BYTES, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(kdq, dim3((p.Lq + S::B4 - 1) / S::B4, B * p.H), block, args,
                         S::BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- fp32 at Dh 64 and 128: the register-tiled kernels ---------------------
// K2 and K4 for fp32 operands at Dh 64 and 128, every layout, on
// bwd_f32_regtile.cuh (8 x 4 micro-tiles of the products, 8 own rows x D / 16
// columns of the accumulators a thread, the streamed tiles by cp.async).
// The pre-passes are the SIMT kernels' (simt_prepass).

// dK and dV: a block owns 64 keys; warpgroup 0 holds K and streams Q (S^T,
// P^T, then dK += dS^T Q), warpgroup 1 holds V and streams dO (dP^T, dS^T
// from P^T, then dV += P^T dO). `vec`: the inputs allow 16-byte copies;
// `o_vec`: dK and dV allow float4 stores.
template <int D>
__global__ void __launch_bounds__(RB_THREADS, 1) flash_bwd_dkv_f32_regtile_kernel(
    const BwdParamsSimt<float> p, int vec, int o_vec) {
  using S = RbDkvTiles<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) float rb_smem[];
  const int wg = threadIdx.x / RB_WG, t = threadIdx.x % RB_WG;
  const int og = t >> 4, px = t & 15;
  const int k0 = blockIdx.x * RB_KEYS;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const float* own_g = wg == 0 ? p.k + b * p.k_sb + h * p.k_sh : p.v + b * p.v_sb + h * p.v_sh;
  const long long own_sl = wg == 0 ? p.k_sl : p.v_sl;
  const float* str_g = wg == 0 ? p.q + b * p.q_sb + h * p.q_sh
                               : p.dout + b * p.do_sb + h * p.do_sh;
  const long long str_sl = wg == 0 ? p.q_sl : p.do_sl;
  float* own_s = rb_smem + (wg == 0 ? S::K : S::V);
  float* str_s = rb_smem + (wg == 0 ? S::Q : S::G);
  float4* ex = reinterpret_cast<float4*>(rb_smem + S::E);
  rb_load<D, RB_KEYS, RB_WG>(own_s, LD, own_g, own_sl, k0, p.Lk, vec != 0, t);
  rb_load<D, RB_ROWS, RB_WG>(str_s, LD, str_g, str_sl, 0, p.Lq, vec != 0, t);
  cp_async_commit();
  bool kmasked[RB_OWN];
  float acc[RB_OWN][D / 64][4];
#pragma unroll
  for (int r = 0; r < RB_OWN; ++r) {
    const int key = k0 + og + 8 * r;
    kmasked[r] = key < p.Lk && p.mask != nullptr && p.mask[(long long)b * p.Lk + key] == 0;
#pragma unroll
    for (int j = 0; j < D / 64; ++j) acc[r][j][0] = acc[r][j][1] = acc[r][j][2] = acc[r][j][3] = 0.f;
  }
  const long long plane = (long long)gridDim.y * p.Lq_pad;
  const float* rv = p.rows + (long long)bh * p.Lq_pad;
  float* dst = p.dst + (long long)bh * p.Lk * p.Lq_pad;
  const int ntiles = (p.Lq + RB_ROWS - 1) / RB_ROWS;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int r0 = jt * RB_ROWS;
    const float* cur = str_s + (jt & 1) * RB_ROWS * LD;
    cp_async_wait<0>();
    rb_wg_sync(wg);  // tile jt is in; the warpgroup is done with the other buffer
    if (jt + 1 < ntiles) {  // the next tile, under this tile's two products
      rb_load<D, RB_ROWS, RB_WG>(str_s + ((jt + 1) & 1) * RB_ROWS * LD, LD, str_g, str_sl,
                                 r0 + RB_ROWS, p.Lq, vec != 0, t);
      cp_async_commit();
    }
    // the partner rows' statistics: (m, 1/l) for P, delta for dS
    float sa[RB_PART], sb[RB_PART];
#pragma unroll
    for (int i = 0; i < RB_PART; ++i) {
      const int row = r0 + px + 16 * i;
      const bool in = row < p.Lq;  // the pre-pass leaves rows past Lq unwritten
      sa[i] = in ? rv[(wg == 0 ? 0 : 2 * plane) + row] : 0.f;
      sb[i] = in && wg == 0 ? rv[plane + row] : 0.f;
    }
    float s[RB_OWN][RB_PART];
#pragma unroll
    for (int r = 0; r < RB_OWN; ++r) {
#pragma unroll
      for (int i = 0; i < RB_PART; ++i) s[r][i] = 0.f;
    }
    rb_product<D>(s, own_s, cur, og, px);  // S^T = K Q^T, or dP^T = V dO^T
    if (wg == 0) {  // P^T, to the exchange tile
#pragma unroll
      for (int r = 0; r < RB_OWN; ++r) {
        const int key = k0 + og + 8 * r;
#pragma unroll
        for (int i = 0; i < RB_PART; ++i) {
          const int row = r0 + px + 16 * i;
          const bool masked = kmasked[r] || (p.causal && key > row);
          // a row with no valid key has m = -FLT_MAX: P = 1/Lk on every key
          const float x = masked ? -FLT_MAX : s[r][i] * p.scale_log2;
          s[r][i] = key < p.Lk && row < p.Lq ? exp2f(x - sa[i]) * sb[i] : 0.f;
        }
        ex[r * RB_WG + t] = make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
      }
    }
    __syncthreads();  // P^T is in the exchange tile
    if (wg == 1) {  // dS^T = P^T (dP^T - delta) scale, 0 where masked: back, and to
                    // the scratch for the dQ kernel (rows past Lq: 0); keep P^T
#pragma unroll
      for (int r = 0; r < RB_OWN; ++r) {
        const int key = k0 + og + 8 * r;
        const float4 p4 = ex[r * RB_WG + t];
        const float pr[RB_PART] = {p4.x, p4.y, p4.z, p4.w};
        float ds[RB_PART];
#pragma unroll
        for (int i = 0; i < RB_PART; ++i) {
          const int row = r0 + px + 16 * i;
          const bool masked = kmasked[r] || (p.causal && key > row);
          ds[i] = masked ? 0.f : pr[i] * (s[r][i] - sa[i]) * p.scale;
          s[r][i] = pr[i];
        }
        ex[r * RB_WG + t] = make_float4(ds[0], ds[1], ds[2], ds[3]);
        if (key < p.Lk) {
          float* drow = dst + (long long)key * p.Lq_pad + r0 + px;
#pragma unroll
          for (int i = 0; i < RB_PART; ++i) drow[16 * i] = ds[i];
        }
      }
    }
    __syncthreads();  // dS^T is in the exchange tile
    if (wg == 0) {
#pragma unroll
      for (int r = 0; r < RB_OWN; ++r) {
        const float4 d4 = ex[r * RB_WG + t];
        s[r][0] = d4.x;
        s[r][1] = d4.y;
        s[r][2] = d4.z;
        s[r][3] = d4.w;
      }
    }
    rb_accumulate<D>(acc, s, cur, px);  // dK += dS^T Q, or dV += P^T dO
  }
  if (wg == 0) {
    rb_store<D>(acc, p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl, k0 + og, 8, p.Lk, p.sin, p.cos,
                px, o_vec != 0);
  } else {
    rb_store<D>(acc, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl, k0 + og, 8, p.Lk, nullptr,
                nullptr, px, o_vec != 0);
  }
}

// dQ = dS K, from the dS^T the dK/dV kernel wrote: a block of 128 threads
// owns 64 query rows; dS^T (the rows' columns of 64 keys) and K stream in
// 64-key tiles, double-buffered by cp.async; a thread holds rows 8 og + r
// (r < 8) x the float4 columns px + 16 j, a key's two float4s of dS^T read
// by its 16-lane group at once.
template <int D>
__global__ void __launch_bounds__(RB_WG) flash_bwd_dq_f32_regtile_kernel(
    const BwdParamsSimt<float> p, int vec, int o_vec) {
  using S = RbDqTiles<D>;
  constexpr int LD = S::LD, DLD = S::DLD, NJ = D / 64;
  extern __shared__ __align__(16) float rb_smem[];
  const int t = threadIdx.x, og = t >> 4, px = t & 15;
  const int q0 = blockIdx.x * RB_ROWS;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* dg = p.dst + (long long)bh * p.Lk * p.Lq_pad + q0;  // 16-byte aligned rows
  float* ds_s = rb_smem + S::DS;
  float* k_s = rb_smem + S::K;
  rb_load<RB_ROWS, RB_KEYS, RB_WG>(ds_s, DLD, dg, p.Lq_pad, 0, p.Lk, true, t);
  rb_load<D, RB_KEYS, RB_WG>(k_s, LD, kg, p.k_sl, 0, p.Lk, vec != 0, t);
  cp_async_commit();
  float acc[RB_OWN][NJ][4];
#pragma unroll
  for (int r = 0; r < RB_OWN; ++r) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j][0] = acc[r][j][1] = acc[r][j][2] = acc[r][j][3] = 0.f;
  }
  const int ntiles = (p.Lk + RB_KEYS - 1) / RB_KEYS;
  for (int jt = 0; jt < ntiles; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt is in; every warp is done with the other buffers
    if (jt + 1 < ntiles) {  // the next tile, under this one's FMAs
      const int nb = (jt + 1) & 1, kv1 = (jt + 1) * RB_KEYS;
      rb_load<RB_ROWS, RB_KEYS, RB_WG>(ds_s + nb * RB_KEYS * DLD, DLD, dg, p.Lq_pad, kv1, p.Lk,
                                       true, t);
      rb_load<D, RB_KEYS, RB_WG>(k_s + nb * RB_KEYS * LD, LD, kg, p.k_sl, kv1, p.Lk, vec != 0,
                                 t);
      cp_async_commit();
    }
    const float* dcur = ds_s + (jt & 1) * RB_KEYS * DLD + 8 * og;
    const float* kcur = k_s + (jt & 1) * RB_KEYS * LD + 4 * px;
#pragma unroll 8
    for (int key = 0; key < RB_KEYS; ++key) {  // keys past Lk: dS^T and K zero-filled
      const float4 d0 = *reinterpret_cast<const float4*>(dcur + key * DLD);
      const float4 d1 = *reinterpret_cast<const float4*>(dcur + key * DLD + 4);
      const float w[RB_OWN] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      float4 kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = *reinterpret_cast<const float4*>(kcur + key * LD + 64 * j);
#pragma unroll
      for (int r = 0; r < RB_OWN; ++r) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[r][j][0] = fmaf(w[r], kv[j].x, acc[r][j][0]);
          acc[r][j][1] = fmaf(w[r], kv[j].y, acc[r][j][1]);
          acc[r][j][2] = fmaf(w[r], kv[j].z, acc[r][j][2]);
          acc[r][j][3] = fmaf(w[r], kv[j].w, acc[r][j][3]);
        }
      }
    }
  }
  rb_store<D>(acc, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sl, q0 + 8 * og, 1, p.Lq, p.sin, p.cos,
              px, o_vec != 0);
}

template <int D>
cudaError_t launch_regtile(BwdParamsSimt<float> p, int B, const float* o, long long o_sb,
                           long long o_sh, long long o_sl, const float* stats, float* rows,
                           float* q_rot, float* k_rot, cudaStream_t stream) {
  if (p.dst == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = simt_prepass<D>(p, B, o, o_sb, o_sh, o_sl, stats, rows, q_rot, k_rot,
                                    stream);
  if (err != cudaSuccess) return err;
  int vec = aligned16(p.q, p.q_sb, p.q_sh, p.q_sl) && aligned16(p.k, p.k_sb, p.k_sh, p.k_sl) &&
            aligned16(p.v, p.v_sb, p.v_sh, p.v_sl) &&
            aligned16(p.dout, p.do_sb, p.do_sh, p.do_sl);
  int kv_vec = aligned16(p.dk, p.dk_sb, p.dk_sh, p.dk_sl) &&
               aligned16(p.dv, p.dv_sb, p.dv_sh, p.dv_sl);
  int q_vec = aligned16(p.dq, p.dq_sb, p.dq_sh, p.dq_sl);
  const void* kdkv = reinterpret_cast<const void*>(&flash_bwd_dkv_f32_regtile_kernel<D>);
  const void* kdq = reinterpret_cast<const void*>(&flash_bwd_dq_f32_regtile_kernel<D>);
  static bool ready_kv[MAX_DEVICES] = {}, ready_q[MAX_DEVICES] = {};  // one per instance
  err = allow_smem_once(kdkv, RbDkvTiles<D>::BYTES, ready_kv);
  if (err == cudaSuccess) err = allow_smem_once(kdq, RbDqTiles<D>::BYTES, ready_q);
  if (err != cudaSuccess) return err;
  void* args_kv[] = {&p, &vec, &kv_vec};
  err = cudaLaunchKernel(kdkv, dim3((p.Lk + RB_KEYS - 1) / RB_KEYS, B * p.H), dim3(RB_THREADS),
                         args_kv, RbDkvTiles<D>::BYTES, stream);
  if (err != cudaSuccess) return err;
  void* args_q[] = {&p, &vec, &q_vec};
  err = cudaLaunchKernel(kdq, dim3(p.Lq_pad / RB_ROWS, B * p.H), dim3(RB_WG), args_q,
                         RbDqTiles<D>::BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The arguments of the C entries below, and their names.
#define BWD_ARGS                                                                      \
  const void *q, const void *k, const void *v, const void *o, const void *dout,       \
      const void *stats, const void *sin, const void *cos, const void *mask, void *dq, \
      void *dk, void *dv, void *rows, void *q_rot, void *k_rot, void *ds, int B, int H, \
      int Lq, int Lk, int Dh, long long q_sb, long long q_sh, long long q_sl,         \
      long long k_sb,                                                                  \
      long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,  \
      long long o_sb, long long o_sh, long long o_sl, long long do_sb, long long do_sh, \
      long long do_sl, long long dq_sb, long long dq_sh, long long dq_sl,              \
      long long dk_sb, long long dk_sh, long long dk_sl, long long dv_sb,              \
      long long dv_sh, long long dv_sl, float scale, int causal, void *stream
#define BWD_NAMES                                                                      \
  q, k, v, o, dout, stats, sin, cos, mask, dq, dk, dv, rows, q_rot, k_rot, ds, B, H, Lq, Lk, \
      Dh, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, do_sb, \
      do_sh, do_sl, dq_sb, dq_sh, dq_sl, dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl, scale, \
      causal, stream

// The bf16 entries' kernels: K2's (Dh 128), K4's long ones (Dh 64 or 128),
// or the wide ones (Dh 256, 384 or 512, both layouts).
enum class Bf16Entry { K2, LONG, WIDE };

int bwd_bf16(Bf16Entry entry, BWD_ARGS) {
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
  if (entry == Bf16Entry::K2) {
    if (Dh != 128) return static_cast<int>(cudaErrorInvalidValue);
    return launch_sm90<128, false>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm);
  }
  if (entry == Bf16Entry::LONG) {
    switch (Dh) {
      case 64: return launch_sm90<64, true>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm);
      case 128: return launch_sm90<128, true>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (Dh) {
    case 256: return launch_wide<256>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm);
    case 384: return launch_wide<384>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm);
    case 512: return launch_wide<512>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The CUDA-core entry: fp32 at Dh 64 to 512 (register-tiled at 64 and 128).
int bwd_f32(BWD_ARGS) {
  using T = float;
  BwdParamsSimt<T> p;
  p.dst = static_cast<float*>(ds);
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
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
  const T* ob = static_cast<const T*>(o);
  const float* st = static_cast<const float*>(stats);
  float* rw = static_cast<float*>(rows);
  T* qr = static_cast<T*>(q_rot);
  T* kr = static_cast<T*>(k_rot);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 64: err = launch_regtile<64>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm); break;
    case 128: err = launch_regtile<128>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm); break;
    case 256: err = launch_simt<256>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm); break;
    case 384: err = launch_simt<384>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm); break;
    case 512: err = launch_simt<512>(p, B, ob, o_sb, o_sh, o_sl, st, rw, qr, kr, sm); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The entries below share their arguments. They return 0 on success, else
// the CUDA error code of a launch (or cudaErrorInvalidValue for a head dim
// the kernels were not built for, or a missing scratch buffer), or
// TMA_ERROR_BASE + the CUresult of cuTensorMapEncodeTiled when a tensor map
// cannot be encoded (the bf16 entries: every operand, dO included, needs a
// 16-byte aligned base and strides). Strides are in elements; the head dim
// of every operand is contiguous. `stats` is the [2, B, H, Lq] fp32 buffer
// the forward filled. Scratch, allocated by the caller: `rows`
// [3, B, H, Lq_pad] fp32 with Lq_pad = Lq rounded up to 64; with sin/cos,
// `q_rot` [B, H, Lq, Dh] and `k_rot` [B, H, Lk, Dh] of the operands' type;
// for fp32 at Dh 64 and 128 `ds` [B, H, Lk, Lq_pad] fp32 (dS^T, from the
// dK/dV kernel to the dQ kernel), else unread (may be null).

// K2: the packed and fused layouts, bf16, Dh 128 only, on
// flash_bwd_dkv_sm90_kernel and flash_bwd_dq_sm90_kernel.
int deepcoro_flash_bwd_sm90_bf16(BWD_ARGS) { return bwd_bf16(Bf16Entry::K2, BWD_NAMES); }

// K4: the [B, H, L, Dh] entry's long calls (Lq or Lk above 64), bf16, Dh 64
// or 128, on flash_long_bwd_dkv_kernel<Dh> and flash_long_bwd_dq_kernel<Dh>.
int deepcoro_flash_long_bwd_bf16(BWD_ARGS) { return bwd_bf16(Bf16Entry::LONG, BWD_NAMES); }

// Registers per thread and dynamic shared memory per block of the dK/dV
// (`which` 0) or the dQ (`which` 1) kernel: K2's at Dh 0, K4's long ones at
// Dh 64 or 128.
int deepcoro_flash_bwd_sm90_attrs(int which, int Dh, int* regs, int* smem) {
  const void* fn;
  int bytes;
  switch (Dh) {
    case 0:
      fn = which == 0 ? dkv_kernel<128, false>() : dq_kernel<128, false>();
      bytes = which == 0 ? DkvSmem<128, 2>::BYTES : DqSmem<128>::BYTES;
      break;
    case 64:
      fn = which == 0 ? dkv_kernel<64, true>() : dq_kernel<64, true>();
      bytes = which == 0 ? DkvSmem<64, 1>::BYTES : DqSmem<64>::BYTES;
      break;
    case 128:
      fn = which == 0 ? dkv_kernel<128, true>() : dq_kernel<128, true>();
      bytes = which == 0 ? DkvSmem<128, 2>::BYTES : DqSmem<128>::BYTES;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = bytes;
  return 0;
}

// fp32 operands of every layout, Dh 64, 128, 256, 384 or 512: on
// flash_bwd_dkv_f32_regtile_kernel<Dh> and flash_bwd_dq_f32_regtile_kernel<Dh>
// at 64 and 128, on the SIMT kernels above.
int deepcoro_flash_bwd_f32(BWD_ARGS) { return bwd_f32(BWD_NAMES); }

// Registers per thread and dynamic shared memory per block of
// flash_bwd_dkv_f32_regtile_kernel<Dh> (`which` 0) or
// flash_bwd_dq_f32_regtile_kernel<Dh> (`which` 1), Dh 64 or 128.
int deepcoro_flash_bwd_f32_regtile_attrs(int which, int Dh, int* regs, int* smem) {
  if (Dh != 64 && Dh != 128) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn;
  if (which == 0) {
    fn = Dh == 64 ? reinterpret_cast<const void*>(&flash_bwd_dkv_f32_regtile_kernel<64>)
                  : reinterpret_cast<const void*>(&flash_bwd_dkv_f32_regtile_kernel<128>);
    *smem = Dh == 64 ? RbDkvTiles<64>::BYTES : RbDkvTiles<128>::BYTES;
  } else {
    fn = Dh == 64 ? reinterpret_cast<const void*>(&flash_bwd_dq_f32_regtile_kernel<64>)
                  : reinterpret_cast<const void*>(&flash_bwd_dq_f32_regtile_kernel<128>);
    *smem = Dh == 64 ? RbDqTiles<64>::BYTES : RbDqTiles<128>::BYTES;
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  return 0;
}

// bf16 of every layout (K2's packed and fused views, K4's [B, H, L, Dh] and
// its transposed views) at Dh 256, 384 or 512, on
// flash_bwd_dkv_wide_sm90_kernel<Dh> and flash_bwd_dq_wide_sm90_kernel<Dh>.
int deepcoro_flash_wide_bwd_bf16(BWD_ARGS) { return bwd_bf16(Bf16Entry::WIDE, BWD_NAMES); }

// Registers and local memory (spilled) bytes per thread of
// flash_bwd_dkv_wide_sm90_kernel<Dh> (`which` 0) or
// flash_bwd_dq_wide_sm90_kernel<Dh> (`which` 1), Dh 256, 384 or 512, as the
// runtime reads them, and the dynamic shared memory a block takes.
int deepcoro_flash_wide_bwd_attrs(int which, int Dh, int* regs, int* local, int* smem) {
  const void* fn;
  switch (Dh) {
    case 256:
      fn = which == 0 ? reinterpret_cast<const void*>(&flash_bwd_dkv_wide_sm90_kernel<256>)
                      : reinterpret_cast<const void*>(&flash_bwd_dq_wide_sm90_kernel<256>);
      *smem = which == 0 ? DkvWideSmem<256>::BYTES : DqWideSmem<256>::BYTES;
      break;
    case 384:
      fn = which == 0 ? reinterpret_cast<const void*>(&flash_bwd_dkv_wide_sm90_kernel<384>)
                      : reinterpret_cast<const void*>(&flash_bwd_dq_wide_sm90_kernel<384>);
      *smem = which == 0 ? DkvWideSmem<384>::BYTES : DqWideSmem<384>::BYTES;
      break;
    case 512:
      fn = which == 0 ? reinterpret_cast<const void*>(&flash_bwd_dkv_wide_sm90_kernel<512>)
                      : reinterpret_cast<const void*>(&flash_bwd_dq_wide_sm90_kernel<512>);
      *smem = which == 0 ? DkvWideSmem<512>::BYTES : DqWideSmem<512>::BYTES;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // extern "C"
