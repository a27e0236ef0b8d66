// Flash-attention forward for Hopper (sm_90a): bf16 in/out with fp32 softmax
// on the tensor cores (wgmma, TMA, mbarriers) at every head dim, and CUDA-core
// kernels for fp32 operands (below).
//
// Replaces two Pallas TPU kernels of deepcoro_clip_tpu:
//   - ops/flash_attention_packed.py `_fwd_kernel` (K1: packed [B, L, H*Dh],
//     with q/k/v read as strided views of one fused [B, L, 3D] QKV tensor),
//     bf16 at Dh 128 on `flash_fwd_sm90_kernel`, at Dh 256 to 512 on
//     `flash_fwd_wide_sm90_kernel<D>`; fp32 at Dh 128 on
//     `flash_fwd_f32_regtile_kernel<128>`, at Dh 256 to 512 on
//     `flash_fwd_f32_kernel<D>`;
//   - ops/flash_attention.py `_fwd_kernel` (K3: [B, H, L, Dh]) where Lq or
//     Lk exceeds 64 (or Dh exceeds 128), bf16 at Dh 64 or 128 on
//     `flash_long_fwd_kernel<D>`, at the padded widths 256 to 512 on
//     `flash_fwd_wide_sm90_kernel<D>`, fp32 on
//     `flash_fwd_f32_regtile_kernel<D>` (Dh 64, 128) or
//     `flash_fwd_f32_kernel<D>` (above)
//     (shorter calls at Dh <= 128 run flash_short.cu in one launch).
// The three bf16 kernels are the one body `fwd_sm90<D>` below: it takes every operand
// as a base pointer plus (batch, head, row) strides in elements, with the
// head dim contiguous, so no layout is copied or transposed on the way in or
// out (the text tower hands K3 transposed views of [B, L, 768], heads inside
// a row). The two names keep the calls apart in a profile.
//
// Semantics kept from the plain version (ops/attention.py):
//   - keys at index >= Lk do not exist: their probability is exactly 0;
//   - masked keys inside Lk (kv_mask == 0, or causal key > query) score
//     -FLT_MAX, the finite finfo(float32).min of the plain version, so a
//     row with no valid key comes out as the uniform mean of v over the Lk
//     real keys (never NaN);
//   - RoPE is rotate-half over the whole head, tables rounded to bf16 first
//     and each product and sum rounded to bf16, as the plain version's ops;
//   - P is rounded to bf16 before the P V product; l sums the fp32 P.
// exp2 with log2(e) folded into the score scale computes the same softmax.
//
// What bounds it on an H100. Per head the work is 4*Lq*Lk'*D FLOP, Lk' the
// keys the rows may attend, against (2*Lq + 2*Lk')*D*2 bytes (q read, o
// written, k and v read). Video tower (K1, L 1569, no mask): ~780 FLOP a
// byte, above the card's ~295 bf16 ridge: the tensor cores. Text tower at L
// 512 and 128 with the reports' padding (K3, Dh 64): Lk' a few hundred or
// less, ~100 to 200 FLOP a byte: the bytes. The SigLIP bank [280, 12, 512,
// 64], 2 to 21 real keys a row of 512: Lk' <= 21, ~10 FLOP a byte, so q and o
// alone (0.44 GB, 0.13 ms) bound it; visiting all 512 keys of every row, as
// the mma.sync kernel this one replaced did, cost 19x that bound.
//
// Design (FA3's forward shape), tiles fixed (never dependent on B, so
// results stay batch-size invariant bit for bit; no atomics, so two
// launches agree bit for bit):
//   - a persistent grid (one block per SM) walks the work items, BQ = 128
//     q rows of one (batch, head) each, q tiles of a head next to each
//     other so its K/V stay in L2;
//   - a block has three warpgroups: two consumers of 64 rows each and a
//     producer; setmaxnreg gives the consumers 232 registers and the
//     producer 40;
//   - one warp of the producer loads the item's q tile by TMA (once the
//     consumers are done with the products of the q tile that slot held),
//     hands the consumers the item's key tile count beside it (read from the
//     item's mask row while the consumers work on the item before:
//     key_extent, visit_keys in sm90_common.cuh; the key tiles past every
//     row's last real key, and past the last row under causal masking, are
//     skipped, exactly, see there), and then loads the item's K and V tiles
//     of 128 keys (cp.async.bulk.tensor over 4-D tensor maps of the strided
//     operands) into a ring of stages guarded by `full`/`empty` mbarriers,
//     with each tile's 128 mask bytes beside it; so the next item's tiles
//     arrive while the consumers finish this one;
//   - each consumer warpgroup rotates its 64 rows of the q tile (RoPE, in
//     place, rope_q_rows) and runs sm90_attend (sm90_common.cuh): S = Q K^T
//     on wgmma from shared memory, the softmax in registers while the
//     tensor cores run the previous tile's P V, P rounded to bf16 as the
//     register A operand of O += P V on wgmma; then the epilogue straight
//     from registers;
//   - RoPE of K: a pre-pass (launch_rope_rows) into a contiguous scratch.
// The q-tile height costs padded rows on ragged lengths: 1569 rows take 13
// tiles (1664 rows, 6% idle), 393 take 4 (512, 23%), 512 take 4 (none).
//
// Head dims 256 to 512 (flash_fwd_wide_sm90_kernel<D>; FwdCfg). A consumer
// warpgroup keeps its 64 rows x D of O in fp32 registers: D / 2 a thread,
// 128 at D 256 (beside S and P: about 200 of the 232 setmaxnreg gives), 192
// and 256 at 384 and 512, which do not fit. So at 384 and 512 the two
// consumer warpgroups share one 64-row q tile and split O's columns, each
// P V for its D / 2 columns, and the depth of Q K^T: each sums S over its
// half of the head dim, the two partial S meet in shared memory (a pair
// barrier a key tile), and each adds the other's to its own: the same S bit
// for bit in both (s0 + s1 == s1 + s0), so their P agree. (Each computing
// the whole S instead costs 1.5x the FLOPs; the fused K5 still does.)
// Shared memory sets the key tile: one stage of K and V is 4 * BK * D bytes,
// so at 384 and 512 a tile takes 32 keys (48 and 64 KB), three and two stages
// beside the 48 and 64 KB q tile and the 32 KB of partial S; at 256 a 128-row
// q tile (64 KB) and two stages of 64 keys (64 KB each). 192 KB of tiles in
// each case (the `wide_smem_bytes` mirror in ops/_flash_cuda.py).
// Stages and shared memory: at Dh 128 a stage of 128 keys is 64 KB, so one q
// tile of 32 KB + 3 stages + mask bytes fill 225 KB of the 227 KB a block
// may have. At Dh 64 a stage is 32 KB and a q tile 16 KB: the ring has 4
// stages and there are 2 q slots (161 KB in all), so the next item's q tile
// loads while the consumers work on this one. That is what the SigLIP bank
// needs: its items visit one key tile each, and with one q slot every item
// waited for its q tile's load after the last one's products. Either way
// one block per SM: the 384 threads take the SM's 64K registers
// (setmaxnreg), and the q-tile height stays 128 rows at both head dims, 64 a
// consumer warpgroup, the height wgmma's m64 products take.

#include "fwd_f32_regtile.cuh"
#include "sm90_common.cuh"

namespace {

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* sin;      // [Lq, Dh] fp32 or null
  const float* cos;      // [Lq, Dh] fp32 or null
  const uint8_t* mask;   // [B, Lk], nonzero = attend, or null
  float* stats;          // [2, B*H, Lq] fp32 row max and row sum, or null
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int H, Lq, Lk;
  float scale_log2;
  int causal;
};

constexpr int SM90_THREADS = 3 * 128;

// Tiles of the Hopper forward by head dim: q rows an item (BQ), keys a K/V
// tile (BK), stages of the K/V ring (NST), q tiles in flight (QST), and the
// consumer warpgroups that share each 64 rows of the item, splitting O's
// columns (SPLIT: 2 where one warpgroup cannot hold 64 x D of O).
template <int D>
struct FwdCfg;
template <>
struct FwdCfg<64> { static constexpr int BQ = 128, BK = 128, NST = 4, QST = 2, SPLIT = 1; };
template <>
struct FwdCfg<128> { static constexpr int BQ = 128, BK = 128, NST = 3, QST = 1, SPLIT = 1; };
template <>
struct FwdCfg<256> { static constexpr int BQ = 128, BK = 64, NST = 2, QST = 1, SPLIT = 1; };
template <>
struct FwdCfg<384> { static constexpr int BQ = 64, BK = 32, NST = 3, QST = 1, SPLIT = 2; };
template <>
struct FwdCfg<512> { static constexpr int BQ = 64, BK = 32, NST = 2, QST = 1, SPLIT = 2; };

struct Sm90Params {
  __nv_bfloat16* o;
  const float* sin;     // [Lq, D] fp32 or null
  const float* cos;
  const uint8_t* mask;  // [B, Lk], nonzero = attend, or null
  float* stats;         // [2, B*H, Lq] fp32 row max and row sum, or null
  long long o_sb, o_sh, o_sl;
  int B, H, Lq, Lk;
  float scale_log2;
  int causal;
  int q_hi, k_hi, v_hi;  // coordinate order of each tensor map
};

template <int D>
struct Sm90Smem {  // byte offsets from the 1024-aligned base
  using C = FwdCfg<D>;
  static constexpr int NST = C::NST;  // K/V stages
  static constexpr int QST = C::QST;  // q tiles: the next item's loads early
  static constexpr int QBOX = C::BQ * BOX_ROW_BYTES;  // one box of a q tile
  static constexpr int QTILE = (D / 64) * QBOX;
  static constexpr int Q = 0;
  static constexpr int RING = Q + QST * QTILE;
  // SPLIT 2: the two warpgroups' partial S of a tile, two tiles' worth
  // (sm90_attend's depth split): [2][2][BK / 8][128] float4
  static constexpr int X = RING + NST * KVRing<C::BK, D>::STAGE;
  static constexpr int MASK = X + (C::SPLIT == 2 ? 2 * 2 * 128 * (C::BK / 2) * 4 : 0);
  // full[NST], empty[NST], q loaded[QST], q free[QST]
  static constexpr int BARS = MASK + NST * C::BK;
  static constexpr int TILES = BARS + (2 * NST + 2 * QST) * 8;  // each q tile's key tiles
  static constexpr int END = TILES + 16;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

template <int D>
__device__ __forceinline__ void fwd_sm90(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const Sm90Params& p) {
  using S = Sm90Smem<D>;
  using C = FwdCfg<D>;
  constexpr int NST = S::NST, QST = S::QST;
  constexpr int SM90_BQ = C::BQ, SM90_BK = C::BK, SPLIT = C::SPLIT, DO = D / SPLIT;
  extern __shared__ __align__(16) unsigned char sm90_smem[];
  unsigned char* smem = sm90_smem + ((1024 - (smem_u32(sm90_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint8_t* mask_s = smem + S::MASK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + NST;
  uint64_t* q_loaded = empty + NST;
  uint64_t* q_free = q_loaded + QST;
  int* tiles_s = reinterpret_cast<int*>(smem + S::TILES);

  const int nqt = (p.Lq + SM90_BQ - 1) / SM90_BQ;
  const int items = nqt * p.B * p.H;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    for (int s = 0; s < QST; ++s) {
      mbar_init(&q_loaded[s], 1);
      mbar_init(&q_free[s], 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one warp loads, the other three leave
    setmaxnreg_dec<40>();
    if ((threadIdx.x / 32) % 4 != 0) return;
    // the key tiles of an item, read from its mask row
    auto item_tiles = [&](int item) {
      const int qt = item % nqt, b = item / nqt / p.H;
      int e, f;
      key_extent(p.mask ? p.mask + (long long)b * p.Lk : nullptr, p.Lk, lane, e, f);
      return (visit_keys(e, f, p.Lq, p.Lk, qt * SM90_BQ, SM90_BQ, p.causal) + SM90_BK - 1) /
             SM90_BK;
    };
    uint32_t n = 0;
    Pipe pp;
    int nt = -1;  // the item's key tiles, once read
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int qt = item % nqt, bh = item / nqt;
      const int b = bh / p.H, h = bh % p.H;
      const int qs = n % QST;
      const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
      // the consumers are done with the q tile this slot held
      mbar_wait(&q_free[qs], ((n / QST) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&q_loaded[qs], S::QTILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_head(tq, base + S::Q + qs * S::QTILE + c * S::QBOX, &q_loaded[qs], 64 * c,
                        qt * SM90_BQ, h, b, p.q_hi);
        }
      }
      if (nt < 0) nt = item_tiles(item);  // the first item's, while its q is in flight
      if (lane == 0) {
        tiles_s[qs] = nt;  // released to the consumers by this arrival
        mbar_arrive(&q_loaded[qs]);
      }
      produce_kv<SM90_BK, NST, D>(tk, p.k_hi, tv, p.v_hi, h, b, p.Lk, nt, mrow,
                                  base + S::RING, mask_s, full, empty, pp, lane);
      // the next item's, while the consumers work on this one
      nt = item + gridDim.x < items ? item_tiles(item + gridDim.x) : -1;
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64 wg .. of each item
            // (SPLIT 2: both own rows q0 .., wg the columns DO wg ..)
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32;
    const int rw = SPLIT == 1 ? wg : 0;       // the warpgroup's 64 rows of the item
    const int c0 = SPLIT == 1 ? 0 : wg * DO;  // its columns of O
    uint32_t n = 0;
    Pipe pp;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int qt = item % nqt, bh = item / nqt;
      const int b = bh / p.H, h = bh % p.H;
      const int row_a = qt * SM90_BQ + rw * 64 + warp * 16 + lane / 4;
      const int qs = n % QST;
      const uint32_t qrows = S::Q + qs * S::QTILE + rw * 64 * BOX_ROW_BYTES;
      mbar_wait(&q_loaded[qs], (n / QST) & 1);
      const int nt = tiles_s[qs];
      if (p.sin != nullptr) {  // RoPE of this warpgroup's q rows, in place
        if constexpr (D <= 128) {
          rope_q_rows<D>(smem + qrows, smem + qrows + S::QBOX, p.sin, p.cos,
                         qt * SM90_BQ + wg * 64, p.Lq, threadIdx.x % 128);
        } else {  // SPLIT 2: the two warpgroups rotate their shared rows together
          rope_q_rows_wide<D>(smem + qrows, S::QBOX, p.sin, p.cos, qt * SM90_BQ + rw * 64,
                              p.Lq, threadIdx.x % (128 * SPLIT), 128 * SPLIT);
        }
        fence_async_smem();
        if constexpr (SPLIT == 1) {
          warpgroup_sync(1 + wg);
        } else {
          pair_sync();
        }
      }
      float o[DO / 2], m_r[2], l_r[2];
      sm90_attend<SM90_BK, NST, true, D, DO, SPLIT == 2>(
          base + qrows, S::QBOX, base + S::RING, mask_s, p.mask != nullptr, full, empty, pp,
          &q_free[qs], row_a, p.Lk, nt, p.scale_log2, p.causal, o, m_r, l_r, c0,
          reinterpret_cast<float*>(smem + S::X));
      if (c0 == 0) write_stats(p.stats, bh, (long long)p.B * p.H, p.Lq, row_a, m_r, l_r);
      // l >= 1: the row maximum contributes exp2(0)
      const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
      __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh + c0 + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= p.Lq) continue;
        __nv_bfloat16* orow = og + (long long)row * p.o_sl;
#pragma unroll
        for (int jn = 0; jn < DO / 8; ++jn) {
          *reinterpret_cast<uint32_t*>(orow + jn * 8) =
              pack_bf16(o[4 * jn + 2 * r] * inv[r], o[4 * jn + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

// K1: the packed and fused layouts, Dh 128.
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Sm90Params p) {
  fwd_sm90<128>(&tq, &tk, &tv, p);
}

// K3: the [B, H, L, Dh] entry above 64 tokens, Dh 64 or 128.
template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_long_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Sm90Params p) {
  fwd_sm90<D>(&tq, &tk, &tv, p);
}

// K1 and K3 in bf16 at Dh 256, 384 or 512 (K3 at the widths a head dim is
// padded to above 128).
template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const Sm90Params p) {
  fwd_sm90<D>(&tq, &tk, &tv, p);
}

// The kernel of an entry: K1's, K3's long one at D, or the wide one (both
// entries) at D above 128.
template <int D, bool LONG>
const void* fwd_kernel() {
  if constexpr (D > 128) {
    return reinterpret_cast<const void*>(&flash_fwd_wide_sm90_kernel<D>);
  } else if constexpr (LONG) {
    return reinterpret_cast<const void*>(&flash_long_fwd_kernel<D>);
  } else {
    static_assert(D == 128, "K1 takes Dh 128");
    return reinterpret_cast<const void*>(&flash_fwd_sm90_kernel);
  }
}

template <int D, bool LONG>
int launch_sm90(Params p, int B, __nv_bfloat16* k_rot, cudaStream_t stream) {
  if (p.sin != nullptr) {  // rotate K once into the scratch, then read it there
    cudaError_t err = launch_rope_rows<D>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk, p.sin,
                                          p.cos, k_rot, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D;
    p.k_sh = (long long)p.Lk * D;
    p.k_sl = D;
  }
  Sm90Params s;
  s.o = p.o; s.sin = p.sin; s.cos = p.cos; s.mask = p.mask; s.stats = p.stats;
  s.o_sb = p.o_sb; s.o_sh = p.o_sh; s.o_sl = p.o_sl;
  s.B = B; s.H = p.H; s.Lq = p.Lq; s.Lk = p.Lk;
  s.scale_log2 = p.scale_log2;
  s.causal = p.causal;
  using C = FwdCfg<D>;
  CUtensorMap tq, tk, tv;
  int err = encode_head_map(&tq, p.q, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, C::BQ, &s.q_hi, D);
  if (err == 0) {
    err = encode_head_map(&tk, p.k, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, C::BK, &s.k_hi, D);
  }
  if (err == 0) {
    err = encode_head_map(&tv, p.v, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, C::BK, &s.v_hi, D);
  }
  if (err != 0) return err;
  const void* kernel = fwd_kernel<D, LONG>();
  static bool ready[MAX_DEVICES] = {};  // one per instance: one per kernel
  cudaError_t cerr = allow_smem_once(kernel, Sm90Smem<D>::BYTES, ready);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int sms = 0;
  cerr = num_sms(&sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long items = (long long)((p.Lq + C::BQ - 1) / C::BQ) * B * p.H;
  const int grid = static_cast<int>(items < sms ? items : sms);
  void* args[] = {&tq, &tk, &tv, &s};
  cerr = cudaLaunchKernel(kernel, dim3(grid), dim3(SM90_THREADS), args, Sm90Smem<D>::BYTES,
                          stream);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

// ---- SIMT kernel: fp32 operands at Dh 256 to 512 ---------------------------
// The tiled SIMT attention of flash_common.cuh (simt_attend_tiles): a block
// of 4 or 8 warps owns 16 or 32 query rows of one (batch, head), 4 a warp,
// and streams the head's K and V through shared memory in tiles of 32 keys,
// one key a lane. Same masking rules and the same row statistics as the
// Hopper kernels. fp32 at D 256 to 512 (flash_fwd_f32_kernel<D>; at D 64 and
// 128 the register-tiled kernel below) serves K1 and
// K3 for fp32 operands in every layout: the packed [B, L, H*Dh] and fused
// [B, L, 3D] views are strides like any other (in a fused view the head
// stride Dh is smaller than the row stride 3D; nothing here assumes
// otherwise). K, when RoPE is on, was rotated by the fp32 pre-pass; q is
// rotated while it is copied into shared memory.
//
// What bounds it: the same 4*Lq*Lk*D FLOP as the Hopper kernels, here on the
// CUDA cores (67 TFLOP/s fp32 on an H100, no TF32 for fp32 operands), and
// it stays well short of that: a score takes a shared-memory K value and a
// broadcast float4 of Q for 4 FMAs, a P V step 4 shuffles and D / 32 shared
// loads for 4 D / 32 FMAs, so the shared-memory pipe, not the FMA units,
// sets its pace. PERF.md has its times.

template <typename T>
struct SimtParams {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  const float* sin;
  const float* cos;
  const uint8_t* mask;
  float* stats;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int H, Lq, Lk;
  float scale_log2;
  int causal;
};

template <typename T, int D>
__device__ __forceinline__ void fwd_simt(const SimtParams<T>& p) {
  constexpr int NW = SIMT_WARPS<D>, PER = D / 32;
  extern __shared__ __align__(16) float simt_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * FwdTiles<D, NW>::BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  float acc[SR][PER], m[SR], l[SR];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[r][i] = 0.f;
  }
  simt_attend_tiles<T, D, NW>(simt_smem, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.Lq,
                              p.sin, p.cos, p.k + b * p.k_sb + h * p.k_sh, p.k_sl,
                              p.v + b * p.v_sb + h * p.v_sh, p.v_sl,
                              p.mask ? p.mask + (long long)b * p.Lk : nullptr, p.Lk, p.causal,
                              p.scale_log2, acc, m, l);
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int row = q0 + SR * warp + r;
    if (row >= p.Lq) continue;
    if (p.stats != nullptr && lane == 0) {
      float* sm = p.stats + (long long)bh * p.Lq;
      sm[row] = m[r];
      sm[(long long)gridDim.y * p.Lq + row] = l[r];
    }
    T* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sl;
    const float inv = 1.f / l[r];  // l >= 1: the row maximum contributes exp2(0)
#pragma unroll
    for (int i = 0; i < PER; ++i) orow[lane + 32 * i] = from_f<T>(acc[r][i] * inv);
  }
}

// fp32 operands, every layout: K1 and K3.
template <int D>
__global__ void __launch_bounds__(SIMT_WARPS<D> * 32) flash_fwd_f32_kernel(
    const SimtParams<float> p) {
  fwd_simt<float, D>(p);
}

template <typename T, int D>
cudaError_t launch_simt(SimtParams<T> p, int B, T* k_rot, cudaStream_t stream) {
  if (p.sin != nullptr) {  // rotate K once into the scratch, then read it there
    cudaError_t err = launch_rope_rows_t<D>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk, p.sin,
                                            p.cos, k_rot, stream);
    if (err != cudaSuccess) return err;
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D;
    p.k_sh = (long long)p.Lk * D;
    p.k_sl = D;
  }
  using S = FwdTiles<D, SIMT_WARPS<D>>;
  const void* kernel = reinterpret_cast<const void*>(&flash_fwd_f32_kernel<D>);
  static bool ready[MAX_DEVICES] = {};  // one per instance: one per kernel
  cudaError_t err = allow_smem_once(kernel, S::BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + S::BQ - 1) / S::BQ, B * p.H);
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, grid, dim3(SIMT_WARPS<D> * 32), args, S::BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- fp32 at Dh 64 and 128: the register-tiled body ------------------------
// K1 and K3 for fp32 operands at Dh 64 and 128, every layout, on
// fwd_f32_regtile.cuh (rt_attend: a block of 4 warps over 64 rows of one
// (batch, head), a 4 x 8 register tile of S and 4 x D / 8 of O a thread,
// K and V through shared memory 64 keys a tile by cp.async). Two blocks an
// SM at D 128 (98 KB of shared memory each), more at 64 (50 KB).

template <int D>
__global__ void __launch_bounds__(RT_THREADS) flash_fwd_f32_regtile_kernel(
    const SimtParams<float> p, int vec, int o_vec) {
  extern __shared__ __align__(16) float rt_smem[];
  const int q0 = blockIdx.x * RT_BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  float o[RT_RPT][D / 32][4], m[RT_RPT], l[RT_RPT];
  rt_attend<D, RT_BK>(rt_smem, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.Lq, p.sin,
                      p.cos, p.k + b * p.k_sb + h * p.k_sh, p.k_sl,
                      p.v + b * p.v_sb + h * p.v_sh, p.v_sl,
                      p.mask ? p.mask + (long long)b * p.Lk : nullptr, p.Lk, p.causal,
                      p.scale_log2, vec != 0, o, m, l);
  const int rg = rt_rg(), kx = rt_kx();
#pragma unroll
  for (int r = 0; r < RT_RPT; ++r) {
    const int row = q0 + rg + 16 * r;
    if (row >= p.Lq) continue;
    if (p.stats != nullptr && kx == 0) {
      float* sm = p.stats + (long long)bh * p.Lq;
      sm[row] = m[r];
      sm[(long long)gridDim.y * p.Lq + row] = l[r];
    }
    const float inv = 1.f / l[r];  // l >= 1: the row maximum contributes exp2(0)
    float* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_sl + 4 * kx;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const float4 val = make_float4(o[r][j][0] * inv, o[r][j][1] * inv, o[r][j][2] * inv,
                                     o[r][j][3] * inv);
      if (o_vec) {
        *reinterpret_cast<float4*>(orow + 32 * j) = val;
      } else {
        orow[32 * j] = val.x;
        orow[32 * j + 1] = val.y;
        orow[32 * j + 2] = val.z;
        orow[32 * j + 3] = val.w;
      }
    }
  }
}

template <int D>
cudaError_t launch_regtile(SimtParams<float> p, int B, float* k_rot, cudaStream_t stream) {
  if (p.sin != nullptr) {  // rotate K once into the scratch, then read it there
    cudaError_t err = launch_rope_rows_f32<D>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk, p.sin,
                                              p.cos, k_rot, stream);
    if (err != cudaSuccess) return err;
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D;
    p.k_sh = (long long)p.Lk * D;
    p.k_sl = D;
  }
  int vec = aligned16(p.q, p.q_sb, p.q_sh, p.q_sl) && aligned16(p.k, p.k_sb, p.k_sh, p.k_sl) &&
            aligned16(p.v, p.v_sb, p.v_sh, p.v_sl);
  int o_vec = aligned16(p.o, p.o_sb, p.o_sh, p.o_sl);
  const void* kernel = reinterpret_cast<const void*>(&flash_fwd_f32_regtile_kernel<D>);
  static bool ready[MAX_DEVICES] = {};  // one per instance: one per kernel
  cudaError_t err = allow_smem_once(kernel, RtTiles<D, RT_BK>::BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + RT_BQ - 1) / RT_BQ, B * p.H);
  void* args[] = {&p, &vec, &o_vec};
  err = cudaLaunchKernel(kernel, grid, dim3(RT_THREADS), args, RtTiles<D, RT_BK>::BYTES,
                         stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The C entries below share their arguments. They return 0 on success,
// else the CUDA error code of a launch (or cudaErrorInvalidValue for a head
// dim the kernel was not built for, or RoPE without its scratch), or
// TMA_ERROR_BASE + the CUresult of cuTensorMapEncodeTiled when a tensor map
// cannot be encoded (the bf16 entries: every operand needs a 16-byte aligned
// base and strides). Strides are in elements; the head dim of every operand
// is contiguous. With sin/cos, `k_rot` is a [B, H, Lk, Dh] scratch buffer
// of the operands' type that receives the rotated K. `stats`, when not
// null, is a [2, B, H, Lq] fp32 buffer that receives each row's maximum (of
// the scores in log2 units, scale folded in) and the row's sum of
// exp2(score - maximum): what the backward needs to rebuild P.
#define FWD_ARGS                                                                        \
  const void *q, const void *k, const void *v, void *o, const void *sin, const void *cos, \
      const void *mask, void *k_rot, void *stats, int B, int H, int Lq, int Lk, int Dh,   \
      long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,     \
      long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long o_sb,     \
      long long o_sh, long long o_sl, float scale, int causal, void *stream
#define FWD_NAMES                                                                          \
  q, k, v, o, sin, cos, mask, k_rot, stats, B, H, Lq, Lk, Dh, q_sb, q_sh, q_sl, k_sb, k_sh, \
      k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, scale, causal, stream

// The bf16 entries' arguments as the kernels' Params.
Params fwd_params(FWD_ARGS) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.mask = static_cast<const uint8_t*>(mask);
  p.stats = static_cast<float*>(stats);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  return p;
}

// The SIMT kernels' arguments as their Params.
template <typename T>
SimtParams<T> simt_params(FWD_ARGS) {
  SimtParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.mask = static_cast<const uint8_t*>(mask);
  p.stats = static_cast<float*>(stats);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  return p;
}

}  // namespace

extern "C" {

// K1: the packed and fused layouts (q/k/v strided views with the heads
// inside a row), bf16, Dh 128 only, on flash_fwd_sm90_kernel.
int deepcoro_flash_fwd_sm90_bf16(FWD_ARGS) {
  if (Dh != 128 || (sin != nullptr && k_rot == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = fwd_params(FWD_NAMES);
  return launch_sm90<128, false>(p, B, static_cast<__nv_bfloat16*>(k_rot),
                                 static_cast<cudaStream_t>(stream));
}

// K3: the [B, H, L, Dh] entry's long calls (Lq or Lk above 64), bf16, Dh 64
// or 128, on flash_long_fwd_kernel<Dh>.
int deepcoro_flash_long_fwd_bf16(FWD_ARGS) {
  if (sin != nullptr && k_rot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = fwd_params(FWD_NAMES);
  __nv_bfloat16* kr = static_cast<__nv_bfloat16*>(k_rot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return launch_sm90<64, true>(p, B, kr, st);
    case 128: return launch_sm90<128, true>(p, B, kr, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread (at entry; setmaxnreg moves them between the
// warpgroups) and dynamic shared memory per block of flash_fwd_sm90_kernel.
int deepcoro_flash_fwd_sm90_attrs(int* regs, int* smem) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(&flash_fwd_sm90_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = Sm90Smem<128>::BYTES;
  return 0;
}

// The same for flash_long_fwd_kernel<Dh>, Dh 64 or 128.
int deepcoro_flash_long_fwd_attrs(int Dh, int* regs, int* smem) {
  if (Dh != 64 && Dh != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(
      &a, Dh == 64 ? fwd_kernel<64, true>() : fwd_kernel<128, true>());
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = Dh == 64 ? Sm90Smem<64>::BYTES : Sm90Smem<128>::BYTES;
  return 0;
}

// fp32 operands of every layout (`k_rot` then is an fp32 scratch), Dh 64,
// 128, 256, 384 or 512: on flash_fwd_f32_regtile_kernel<Dh> at 64 and 128,
// on flash_fwd_f32_kernel<Dh> above; the arguments mean what they mean
// above.
int deepcoro_flash_fwd_f32(FWD_ARGS) {
  if (sin != nullptr && k_rot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const SimtParams<float> p = simt_params<float>(FWD_NAMES);
  float* kr = static_cast<float*>(k_rot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return static_cast<int>(launch_regtile<64>(p, B, kr, st));
    case 128: return static_cast<int>(launch_regtile<128>(p, B, kr, st));
    case 256: return static_cast<int>(launch_simt<float, 256>(p, B, kr, st));
    case 384: return static_cast<int>(launch_simt<float, 384>(p, B, kr, st));
    case 512: return static_cast<int>(launch_simt<float, 512>(p, B, kr, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread and dynamic shared memory per block of
// flash_fwd_f32_regtile_kernel<Dh>, Dh 64 or 128.
int deepcoro_flash_fwd_f32_regtile_attrs(int Dh, int* regs, int* smem) {
  if (Dh != 64 && Dh != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(
      &a, Dh == 64 ? reinterpret_cast<const void*>(&flash_fwd_f32_regtile_kernel<64>)
                   : reinterpret_cast<const void*>(&flash_fwd_f32_regtile_kernel<128>));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = Dh == 64 ? RtTiles<64, RT_BK>::BYTES : RtTiles<128, RT_BK>::BYTES;
  return 0;
}

// bf16 of every layout (K1's packed and fused views, K3's [B, H, L, Dh] and
// its transposed views) at Dh 256, 384 or 512, on
// flash_fwd_wide_sm90_kernel<Dh>.
int deepcoro_flash_wide_fwd_bf16(FWD_ARGS) {
  if (sin != nullptr && k_rot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = fwd_params(FWD_NAMES);
  __nv_bfloat16* kr = static_cast<__nv_bfloat16*>(k_rot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 256: return launch_sm90<256, false>(p, B, kr, st);
    case 384: return launch_sm90<384, false>(p, B, kr, st);
    case 512: return launch_sm90<512, false>(p, B, kr, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers and local memory (spilled) bytes per thread of
// flash_fwd_wide_sm90_kernel<Dh>, Dh 256, 384 or 512, as the runtime reads
// them.
int deepcoro_flash_wide_fwd_attrs(int Dh, int* regs, int* local) {
  const void* kernel;
  switch (Dh) {
    case 256: kernel = fwd_kernel<256, false>(); break;
    case 384: kernel = fwd_kernel<384, false>(); break;
    case 512: kernel = fwd_kernel<512, false>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // extern "C"
