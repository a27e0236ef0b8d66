// Flash-attention forward with the output projection fused in, for Hopper
// (sm_90a), bf16 in/out on the tensor cores: y = concat_h(attention_h(q, k,
// v)) @ wo, at Dh 128 (flash_fwd_proj_kernel<NWG>) and at 256 to 512
// (flash_fwd_proj_wide_sm90_kernel<D>); fp32 at Dh 128 on a
// register-tiled CUDA-core kernel, at 256 to 512 on a SIMT kernel (both at
// the end).
//
// Replaces the Pallas TPU kernel of deepcoro_clip_tpu:
//   ops/flash_attention_packed.py `_fwd_proj_kernel` (packed [B, L, H*Dh],
//   q/k/v optionally strided views of one fused [B, L, 3D] tensor).
// It returns the projected y [B, Lq, Dout] and, when a gradient is wanted,
// the attention output [B, Lq, D] and the row statistics that the backward
// kernels (flash_bwd.cu) start from.
//
// What bounds it on an H100: per (batch, q row) 4*Lk*D FLOP of attention
// plus 2*D*Dout of projection against 2*(3D + Dout) bytes (each operand
// once). At the video tower's shapes (D = Dout = 512, L = 1569 / 393) that is
// ~910 / ~325 FLOP per byte, above the card's ~295 bf16 ridge: operations
// bound it at L = 1569 and it sits at the ridge at L = 393. What the fusion
// saves is the [B, L, D] attention output's round trip through device
// memory and one launch per layer, not operations.
//
// Design. The Pallas kernel gives every (head block, q block) its own grid
// step and sums the heads' partial products through an fp32 [Lq, Dout]
// scratch that one grid step hands to the next; here blocks run in
// parallel and nothing carries over between them, so one block owns a tile
// of BQ rows of y outright. It is K1's Hopper kernel (flash_fwd.cu,
// flash_fwd_sm90_kernel) with a second phase:
//   - warpgroups: one or two consumers of 64 rows each (BQ = 128 for
//     H * 128 <= 512, else 64, so that the output tile fits) and a
//     producer, of which one warp works (setmaxnreg: 232 and 40 registers
//     with two consumers);
//   - the producer loads every head's q tile by TMA at once, each into the
//     columns of the shared [BQ, H * 128] output tile that the head's
//     output will fill, then streams each head's K and V in tiles of 64
//     keys through a ring of three 32 KB stages (mbarriers), then wo
//     ([H * 128, Dout], L2-resident) in [128, 128] tiles through the same
//     ring;
//   - each consumer warpgroup rotates its rows of a head's q tile (RoPE,
//     in place; K was rotated once by a pre-pass) and runs sm90_attend
//     (sm90_common.cuh: wgmma for S = Q K^T and O += P V, the softmax in
//     registers while the tensor cores run the previous tile's P V) head
//     after head; a
//     head's normalised output, rounded to bf16 as the Pallas kernel rounds
//     it before its product, overwrites the head's q columns of the output
//     tile (in the swizzled layout wgmma reads as an A operand) and, when a
//     gradient is wanted, goes to device memory with the row statistics;
//   - then y = tile @ wo on wgmma, [64, 128] fp32 accumulators a
//     warpgroup, one column chunk at a time over all D, rounded once to
//     bf16 and stored.
// No atomics and no second pass: every y element is summed by one
// warpgroup in a fixed order, so two launches agree bit for bit, and the
// tiles never depend on B.
//
// Shared memory per block: the output tile (2 H boxes of BQ x 128 bytes:
// 128 KB at H 4 with BQ 128, 96 KB at H 6 with BQ 64, 128 KB at H 8 with
// BQ 64), the ring (96 KB), 192 mask bytes and the barriers: 225 KB at
// H = 4, one block per SM.
//
// Head dims 256 to 512 (the wide kernel, the same body fwd_proj_sm90): a
// head's q tile is D / 64 boxes of the output tile, and its K and V stream
// through the ring in tiles of ProjCfg<D>::BK keys. O of 64 rows x D does
// not fit one warpgroup's registers at 384 and 512 (see flash_fwd.cu); at
// 256 a warpgroup of 64 rows of its own spilled and ran no faster over the
// probing step (PERF.md). So at every wide D the two consumer warpgroups
// share 64 rows (kSplit): each computes the same S and its half of O's
// columns (1.5x the attention's FLOPs: the depth split of flash_fwd.cu's
// partial S needs 16 to 32 KB that the output tile and the ring leave at 256
// and 512 only with fewer stages), and of each 128-column chunk of y its 64
// columns. The output tile [64, H * Dh] is at most 128 KB;
// `wide_proj_smem_bytes` in
// ops/_flash_cuda.py mirrors the layout. Any Dout: wo's columns past the
// last whole 64 are read as zeros by TMA, a box wholly past them is not
// read, and y's columns past Dout are not stored; wo's rows are 16-byte
// aligned only at a multiple of 8 columns, so the caller pads wo to that
// width (`wo_cols`).

#include "fwd_f32_regtile.cuh"
#include "sm90_common.cuh"

#include <type_traits>

namespace {

constexpr int PBK = 64;  // keys per streamed tile at Dh 128
constexpr int PNST = 3;  // stages of the ring at Dh 128
constexpr int MAX_HEADS = 8;  // H * 128 <= 1024
constexpr int WO_TILE = 128 * 128 * 2;  // bytes of a [128, 128] tile of wo

// Tiles by head dim: keys a K/V tile (BK) and stages of the ring (NST). A
// stage holds one [128, 128] tile of wo too. The output tile [BQ, H * D]
// takes up to 128 KB, so the ring has what is left: at 256 three stages of 32
// keys (32 KB each), at 384 two of 32 (48 KB), at 512 three of 16 (32 KB).
template <int D>
struct ProjCfg;
template <>
struct ProjCfg<128> { static constexpr int BK = PBK, NST = PNST; };
template <>
struct ProjCfg<256> { static constexpr int BK = 32, NST = 3; };
template <>
struct ProjCfg<384> { static constexpr int BK = 32, NST = 2; };
template <>
struct ProjCfg<512> { static constexpr int BK = 16, NST = 3; };

struct ProjParams {
  __nv_bfloat16* y;         // [B, Lq, Dout] contiguous
  __nv_bfloat16* o;         // attention output (strided) or null
  const float* sin;         // [Lq, Dh] fp32 or null
  const float* cos;
  const uint8_t* mask;      // [B, Lk], nonzero = attend, or null
  float* stats;             // [2, B*H, Lq] fp32 row max and row sum, or null
  long long o_sb, o_sh, o_sl;
  int B, H, Lq, Lk, Dout;
  int wo_cols;              // columns of wo in device memory (Dout, or more)
  float scale_log2;
  int causal;
  int q_hi, k_hi, v_hi;  // coordinate order of each head map
};

// Byte offsets from the 1024-aligned base for H heads of D columns and BQ
// rows a block.
template <int D>
struct ProjSmem {
  int obox, ring, mask, bars, bytes;
  __host__ __device__ ProjSmem(int H, int bq) {
    using C = ProjCfg<D>;
    obox = bq * BOX_ROW_BYTES;  // one box of the output tile: BQ rows
    ring = H * (D / 64) * obox;
    mask = ring + C::NST * KVRing<C::BK, D>::STAGE;
    bars = mask + C::NST * C::BK;
    bytes = bars + (2 * C::NST + H) * 8 + 1024;  // slack to align the base
  }
};

// Consumer warpgroups that share a row of y: one at Dh 128, two at 256 to
// 512 (each with half of O's columns and half of each 128-column chunk of y).
template <int D>
constexpr int kSplit = D == 128 ? 1 : 2;

// The body of both kernels: NWG consumer warpgroups, kSplit<D> to a row.
template <int D, int NWG>
__device__ __forceinline__ void fwd_proj_sm90(const CUtensorMap* tq, const CUtensorMap* tk,
                                              const CUtensorMap* tv, const CUtensorMap* two,
                                              const ProjParams& p) {
  using C = ProjCfg<D>;
  constexpr int BK = C::BK, NST = C::NST;
  using R = KVRing<BK, D>;
  static_assert(R::STAGE >= WO_TILE, "a stage holds one [128, 128] tile of wo");
  constexpr int SPLIT = kSplit<D>;
  static_assert(SPLIT == 1 || NWG == 2, "two warpgroups share rows");
  constexpr int BQ = NWG * 64 / SPLIT;
  constexpr int DO = D / SPLIT;   // columns of O a warpgroup computes
  constexpr int NB = D / 64;      // boxes of a head's columns
  constexpr int YN = 128 / SPLIT; // columns of a chunk of y a warpgroup sums
  constexpr int OBOX = BQ * BOX_ROW_BYTES;  // one box of the output tile: BQ rows
  extern __shared__ __align__(16) unsigned char sm90_smem[];
  unsigned char* smem = sm90_smem + ((1024 - (smem_u32(sm90_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const ProjSmem<D> lay(p.H, BQ);
  uint8_t* mask_s = smem + lay.mask;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + NST;
  uint64_t* q_loaded = empty + NST;  // one per head

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int nchunks = (p.Dout + 127) / 128;
  const int kts = p.H * D / 128;  // [128, 128] tiles of wo down a chunk
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], NWG * 128);
    }
    for (int h = 0; h < p.H; ++h) mbar_init(&q_loaded[h], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {  // producer: one warp loads, the other three leave
    if constexpr (NWG == 2) setmaxnreg_dec<40>();
    if ((threadIdx.x / 32) % 4 != 0) return;
    if (lane == 0) {
      for (int h = 0; h < p.H; ++h) {
        mbar_arrive_expect_tx(&q_loaded[h], NB * OBOX);
        for (int c = 0; c < NB; ++c) {
          tma_load_head(tq, base + (h * NB + c) * OBOX, &q_loaded[h], 64 * c, q0, h, b,
                        p.q_hi);
        }
      }
    }
    Pipe pp;
    const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
    for (int h = 0; h < p.H; ++h) {
      produce_kv<BK, NST, D>(tk, p.k_hi, tv, p.v_hi, h, b, p.Lk, (p.Lk + BK - 1) / BK, mrow,
                             base + lay.ring, mask_s, full, empty, pp, lane);
    }
    // wo tile (c, kt): rows kt*128.. (the output tile's columns kt*128..),
    // columns c*128..; four boxes, [K half][N half]; a box wholly past wo's
    // columns is not loaded (its columns of y are not stored)
    for (int c = 0; c < nchunks; ++c) {
      const int nh_live = p.wo_cols - c * 128 > 64 ? 2 : 1;
      for (int kt = 0; kt < kts; ++kt) {
        mbar_wait(&empty[pp.stage], pp.phase ^ 1);
        if (lane == 0) {
          const uint32_t st = base + lay.ring + pp.stage * R::STAGE;
          mbar_arrive_expect_tx(&full[pp.stage], 2 * nh_live * 64 * BOX_ROW_BYTES);
          for (int kh = 0; kh < 2; ++kh) {
            for (int nh = 0; nh < nh_live; ++nh) {
              tma_load_matrix(two, st + (2 * kh + nh) * 64 * BOX_ROW_BYTES, &full[pp.stage],
                              c * 128 + nh * 64, kt * 128 + kh * 64);
            }
          }
        } else {
          mbar_arrive(&full[pp.stage]);
        }
        pp.advance<NST>();
      }
    }
  } else {  // consumers: warpgroup wg owns rows q0 + 64 wg .. of y (SPLIT 2:
            // both rows q0 .., wg the columns DO wg .. of O and 64 wg .. of a chunk)
    if constexpr (NWG == 2) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int t = lane & 3;
    const int rw = SPLIT == 1 ? wg : 0;
    const int cw = SPLIT == 1 ? 0 : wg;
    const int c0 = cw * DO;
    const int rl = rw * 64 + warp * 16 + lane / 4;  // this thread's first row in the tile
    const int row_a = q0 + rl;
    auto sync_rows = [&]() {  // the warpgroups that share these rows
      if constexpr (SPLIT == 1) {
        warpgroup_sync(1 + wg);
      } else {
        pair_sync();
      }
    };
    Pipe pp;
    for (int h = 0; h < p.H; ++h) {
      const uint32_t box0 = h * NB * OBOX + rw * 64 * BOX_ROW_BYTES;
      mbar_wait(&q_loaded[h], 0);
      if (p.sin != nullptr) {  // RoPE of this warpgroup's q rows, in place
        if constexpr (D == 128) {
          rope_q_rows(smem + box0, smem + box0 + OBOX, p.sin, p.cos, q0 + rw * 64, p.Lq,
                      tid);
        } else {
          rope_q_rows_wide<D>(smem + box0, OBOX, p.sin, p.cos, q0 + rw * 64, p.Lq,
                              threadIdx.x % (128 * SPLIT), 128 * SPLIT);
        }
        fence_async_smem();
        sync_rows();
      }
      float o[DO / 2], m_r[2], l_r[2];
      sm90_attend<BK, NST, true, D, DO>(base + box0, OBOX, base + lay.ring, mask_s,
                                        p.mask != nullptr, full, empty, pp, nullptr, row_a,
                                        p.Lk, (p.Lk + BK - 1) / BK, p.scale_log2, p.causal, o,
                                        m_r, l_r, c0);
      if (c0 == 0) {
        write_stats(p.stats, (long long)b * p.H + h, (long long)p.B * p.H, p.Lq, row_a, m_r,
                    l_r);
      }
      sync_rows();  // every product that read this head's q is done
      // l >= 1: the row maximum contributes exp2(0)
      const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        unsigned char* srow =
            smem + (h * NB + c0 / 64) * OBOX + (rl + 8 * r) * BOX_ROW_BYTES + 4 * t;
        __nv_bfloat16* grow = (p.o != nullptr && row < p.Lq)
                                  ? p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_sl +
                                        c0 + 2 * t
                                  : nullptr;
#pragma unroll
        for (int jn = 0; jn < DO / 8; ++jn) {
          const uint32_t val =
              pack_bf16(o[4 * jn + 2 * r] * inv[r], o[4 * jn + 2 * r + 1] * inv[r]);
          // column c0 + 8 jn + 2 t: box jn / 8 from c0's, chunk jn % 8 swizzled by the row
          *reinterpret_cast<uint32_t*>(srow + (jn / 8) * OBOX +
                                       (((jn % 8) ^ ((rl + 8 * r) & 7)) * 16)) = val;
          if (grow != nullptr) *reinterpret_cast<uint32_t*>(grow + jn * 8) = val;
        }
      }
    }
    fence_async_smem();  // the output tile's rows, written above, feed wgmma
    sync_rows();

    // y[rows, Dout] = O[rows, H D] @ wo[H D, Dout], one chunk of 128 columns
    // (SPLIT 2: this warpgroup's 64 of them) at a time over the tiles of 128
    // rows of wo
    const bool pairs = (p.Dout & 1) == 0;  // two columns a 4-byte store
    for (int c = 0; c < nchunks; ++c) {
      float y[YN / 2];
      for (int kt = 0; kt < kts; ++kt) {
        const uint32_t st = base + lay.ring + pp.stage * R::STAGE;
        mbar_wait(&full[pp.stage], pp.phase);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int kh = ks / 4;
          const uint64_t da =
              make_desc(base + (2 * kt + kh) * OBOX + rw * 64 * BOX_ROW_BYTES, 16, 1024) +
              (ks % 4) * 2;
          const uint64_t db =
              make_desc(st + (2 * kh + cw) * 64 * BOX_ROW_BYTES, 64 * BOX_ROW_BYTES, 1024) +
              (ks % 4) * (16 * BOX_ROW_BYTES / 16);
          if constexpr (SPLIT == 1) {
            wgmma_ss_n128_tb(y, da, db, kt > 0 || ks > 0);
          } else {
            wgmma_ss_n64_tb(y, da, db, kt > 0 || ks > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(y);
        mbar_arrive(&empty[pp.stage]);
        pp.advance<NST>();
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= p.Lq) continue;
        const int col0 = c * 128 + cw * 64 + 2 * t;
        __nv_bfloat16* yrow = p.y + ((long long)b * p.Lq + row) * p.Dout + col0;
#pragma unroll
        for (int jn = 0; jn < YN / 8; ++jn) {
          const int col = col0 + jn * 8;
          const float lo = y[4 * jn + 2 * r], hi = y[4 * jn + 2 * r + 1];
          if (pairs) {
            if (col < p.Dout) *reinterpret_cast<uint32_t*>(yrow + jn * 8) = pack_bf16(lo, hi);
          } else {
            if (col < p.Dout) yrow[jn * 8] = __float2bfloat16_rn(lo);
            if (col + 1 < p.Dout) yrow[jn * 8 + 1] = __float2bfloat16_rn(hi);
          }
        }
      }
    }
  }
}

// K5 at Dh 128: NWG consumer warpgroups of 64 rows each.
template <int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
    flash_fwd_proj_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap two, const ProjParams p) {
  fwd_proj_sm90<128, NWG>(&tq, &tk, &tv, &two, p);
}

// K5 in bf16 at Dh 256, 384 or 512: two consumer warpgroups sharing 64 rows.
template <int D>
__global__ void __launch_bounds__(3 * 128, 1)
    flash_fwd_proj_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const __grid_constant__ CUtensorMap two,
                                    const ProjParams p) {
  fwd_proj_sm90<D, 2>(&tq, &tk, &tv, &two, p);
}

// The kernel of (D, NWG), and the most heads it takes: its shared memory
// attribute is set once, at those heads.
template <int D, int NWG>
const void* proj_kernel() {
  if constexpr (D == 128) {
    return reinterpret_cast<const void*>(&flash_fwd_proj_kernel<NWG>);
  } else {
    return reinterpret_cast<const void*>(&flash_fwd_proj_wide_sm90_kernel<D>);
  }
}

template <int D, int NWG>
constexpr int proj_max_heads() {
  return D == 128 ? (NWG == 2 ? 4 : MAX_HEADS) : 1024 / D;
}

template <int D, int NWG>
int launch(const ProjParams& p, const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const CUtensorMap& two, cudaStream_t stream) {
  constexpr int BQ = NWG * 64 / kSplit<D>;
  const ProjSmem<D> lay(p.H, BQ);
  static bool ready[MAX_DEVICES] = {};
  cudaError_t err = allow_smem_once(proj_kernel<D, NWG>(),
                                    ProjSmem<D>(proj_max_heads<D, NWG>(), BQ).bytes, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* args[] = {&tq, &tk, &tv, &two, &p};
  err = cudaLaunchKernel(proj_kernel<D, NWG>(), dim3((p.Lq + BQ - 1) / BQ, p.B),
                         dim3((NWG + 1) * 128), const_cast<void**>(args), lay.bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Consumer warpgroups for H heads at Dh 128: two while the [128, H * 128]
// output tile fits beside the ring, else one.
inline int consumers(int H) { return H * 128 <= 512 ? 2 : 1; }


// ---- SIMT kernel: fp32 at Dh 256 to 512 ------------------------------------
// K5 where the Hopper kernels above and the register-tiled one below do not
// go: fp32 at Dh 256 to 512, H * Dh <= 1024 (flash_fwd_proj_f32_kernel<D>).
// A block owns BQ rows of one batch row (8 or 16: 4 a warp) and all of y's
// columns for them: head after
// head it runs the tiled SIMT attention of flash_common.cuh
// (simt_attend_tiles, as the SIMT forward of flash_fwd.cu) and puts the
// head's normalised output (and, when a gradient is wanted, writes it to
// `o` with the row statistics) into a shared fp32 [H * Dh, BQ] tile; then
// the block computes y = tile @ wo with CUDA-core FMAs, a thread a column,
// summed in fp32 in a fixed order and rounded once: no TF32, no atomics.
// What bounds it: the attention's 4*Lq*Lk*D FLOP a head on the CUDA cores,
// as the SIMT forward; wo (L2-resident) is read once a block.

constexpr int PROJ_SIMT_MAX = 1024;  // H * Dh

template <typename T>
struct ProjSimtParams {
  const T* q;
  const T* k;
  const T* v;
  const T* wo;          // [H * Dh, Dout] contiguous
  T* y;                 // [B, Lq, Dout] contiguous
  T* o;                 // attention output (strided) or null
  const float* sin;
  const float* cos;
  const uint8_t* mask;
  float* stats;         // [2, B*H, Lq] or null
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int B, H, Lq, Lk, Dout;
  float scale_log2;
  int causal;
};

// Warps a block of the SIMT kernel at D: the attention's tiles and the
// [H * D, BQ] output tile share the block's shared memory (ProjSimtSmem).
template <int D>
constexpr int PROJ_WARPS = D <= 384 ? 4 : 2;

template <int D>
struct ProjSimtSmem {
  using A = FwdTiles<D, PROJ_WARPS<D>>;
  static constexpr int BQ = A::BQ;
  static constexpr int OLD = BQ + 4;  // the output tile transposed: a column's rows in float4s
  static constexpr int O = A::BYTES / 4;
  static constexpr int BYTES = (O + PROJ_SIMT_MAX * OLD) * 4;
};

template <typename T, int D>
__device__ __forceinline__ void fwd_proj_simt(const ProjSimtParams<T>& p) {
  constexpr int NW = PROJ_WARPS<D>, PER = D / 32;
  using S = ProjSimtSmem<D>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(16) float simt_smem[];
  float* ot = simt_smem + S::O;  // [H * D][OLD]: the attention output, transposed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ, row0 = q0 + SR * warp;
  const int b = blockIdx.y;
  const int HD = p.H * D;
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
  for (int h = 0; h < p.H; ++h) {
    __syncthreads();  // every warp is done with the last head's Q tile
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
                                p.v + b * p.v_sb + h * p.v_sh, p.v_sl, mrow, p.Lk, p.causal,
                                p.scale_log2, acc, m, l);
    const long long bh = (long long)b * p.H + h;
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int row = row0 + r;
      const bool live = row < p.Lq;
      if (live && p.stats != nullptr && lane == 0) {
        p.stats[bh * p.Lq + row] = m[r];
        p.stats[((long long)p.B * p.H + bh) * p.Lq + row] = l[r];
      }
      const float inv = 1.f / l[r];  // l >= 1: the row maximum contributes exp2(0)
      T* orow = (live && p.o != nullptr) ? p.o + b * p.o_sb + h * p.o_sh + row * p.o_sl
                                         : nullptr;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const T val = from_f<T>(acc[r][i] * inv);
        ot[(h * D + lane + 32 * i) * S::OLD + SR * warp + r] = to_f(val);
        if (orow != nullptr) orow[lane + 32 * i] = val;
      }
    }
  }
  __syncthreads();
  // y = tile @ wo: a thread a column of y at a time, the block's BQ rows of
  // it summed over H * D in order
  for (int c = threadIdx.x; c < p.Dout; c += NW * 32) {
    float y[BQ];
#pragma unroll
    for (int r = 0; r < BQ; ++r) y[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {  // (8 loads of wo in flight: HD is a multiple of 128)
      const float w = to_f(p.wo[(long long)d * p.Dout + c]);
      const float4* t4 = reinterpret_cast<const float4*>(ot + d * S::OLD);
#pragma unroll
      for (int j = 0; j < BQ / 4; ++j) {
        const float4 x = t4[j];
        y[4 * j] = fmaf(x.x, w, y[4 * j]);
        y[4 * j + 1] = fmaf(x.y, w, y[4 * j + 1]);
        y[4 * j + 2] = fmaf(x.z, w, y[4 * j + 2]);
        y[4 * j + 3] = fmaf(x.w, w, y[4 * j + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      if (q0 + r < p.Lq) p.y[((long long)b * p.Lq + q0 + r) * p.Dout + c] = from_f<T>(y[r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(PROJ_WARPS<D> * 32) flash_fwd_proj_f32_kernel(
    const ProjSimtParams<float> p) {
  fwd_proj_simt<float, D>(p);
}

template <typename T, int D>
cudaError_t launch_proj_simt(ProjSimtParams<T> p, cudaStream_t stream) {
  using S = ProjSimtSmem<D>;
  const void* kernel = reinterpret_cast<const void*>(&flash_fwd_proj_f32_kernel<D>);
  // the attribute once, at the most the kernel takes (H * D = PROJ_SIMT_MAX)
  static bool ready[MAX_DEVICES] = {};
  cudaError_t err = allow_smem_once(kernel, S::BYTES, ready);
  if (err != cudaSuccess) return err;
  const int bytes = (S::O + p.H * D * S::OLD) * 4;
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3((p.Lq + S::BQ - 1) / S::BQ, p.B),
                         dim3(PROJ_WARPS<D> * 32), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- fp32 at Dh 128: the register-tiled kernel ----------------------------
// flash_fwd_proj_f32_regtile_kernel: a block of 4 warps owns RT_BQ = 64 rows
// of one batch row and every column of y for them. Head after head in
// order: the register-tiled attention of fwd_f32_regtile.cuh (rt_attend, 32
// keys a tile); the head's normalised output goes into the Q tile's shared
// memory (and, when a gradient is wanted, to `o` with the row statistics);
// then y += O_h @ wo[h*128 : (h+1)*128, :] as a tiled GEMM from shared
// memory: wo streams through the K and V tiles' memory in [32, 128] slabs
// (rows of wo x columns of y) by cp.async, the next slab's copies under
// this one's FMAs, so a block reads wo once; a thread accumulates a 4 x 16
// register tile of y (the rows of its attention, float4 columns kx + 8 j of
// a 128-column chunk) over the head's 128 rows of wo. Between heads the
// running sum of y waits in y itself: each element is read and written by
// the one thread that owns it, summed in fp32 in a fixed order over heads
// and rows of wo, with no atomics and nothing rounded below fp32 (y is
// fp32). Kept in shared memory instead, y [64, 512] (128 KB) would leave
// room for one 4-warp block an SM, where the body's 66 KB leave room for
// two (three by shared memory; the registers hold it to two), whose warps
// hide each other's waits; at 32 keys a tile (against K1's 64) the smaller
// tiles and the tail of 393 keys cost less. Shared memory: 66 KB at any H
// and Dout. What bounds it: the attention's 4*Lq*Lk*128 FLOP a head and
// the projection's 2*Lq*H*128*Dout, on the CUDA cores.

constexpr int RT_WROWS = 32;   // rows of wo a slab
constexpr int RT_WK = 128 / RT_WROWS;  // slabs a head's 128 rows of wo take
constexpr int RT_WCOLS = 128;  // columns of y a slab, and a register tile's chunk

__global__ void __launch_bounds__(RT_THREADS, 2) flash_fwd_proj_f32_regtile_kernel(
    const ProjSimtParams<float> p, int vec, int o_vec, int w_vec, int y_vec) {
  constexpr int D = 128, NJ = D / 32;
  using S = RtTiles<D, RT_PROJ_BK>;
  static_assert(2 * RT_WROWS * RT_WCOLS <= S::END - S::K, "two wo slabs fit where K and V were");
  static_assert(RT_WROWS % 4 == 0 && 128 % RT_WROWS == 0, "slabs of whole fours of rows");
  extern __shared__ __align__(16) float rt_smem[];
  float* os = rt_smem + S::Q;  // the head's output, [RT_BQ][S::LD]: the Q tile's place
  float* ws = rt_smem + S::K;  // two wo slabs [RT_WROWS][RT_WCOLS]: the K and V tiles' place
  const int rg = rt_rg(), kx = rt_kx();
  const int q0 = blockIdx.x * RT_BQ, b = blockIdx.y;
  const int nslabs = RT_WK * ((p.Dout + RT_WCOLS - 1) / RT_WCOLS);  // (chunk, rows of wo) pairs
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
  float* y = p.y + ((long long)b * p.Lq + q0) * p.Dout + 4 * kx;  // row q0, this lane's columns
  for (int h = 0; h < p.H; ++h) {
    float o[RT_RPT][NJ][4], m[RT_RPT], l[RT_RPT];
    rt_attend<D, RT_PROJ_BK>(rt_smem, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.Lq, p.sin,
                             p.cos, p.k + b * p.k_sb + h * p.k_sh, p.k_sl,
                             p.v + b * p.v_sb + h * p.v_sh, p.v_sl, mrow, p.Lk, p.causal,
                             p.scale_log2, vec != 0, o, m, l);
    // (rt_attend returns after a barrier: every warp is done with Q, K and V)
    const long long bh = (long long)b * p.H + h;
#pragma unroll
    for (int r = 0; r < RT_RPT; ++r) {
      const int row = q0 + rg + 16 * r;
      const bool out = row < p.Lq;
      if (out && p.stats != nullptr && kx == 0) {
        p.stats[bh * p.Lq + row] = m[r];
        p.stats[((long long)p.B * p.H + bh) * p.Lq + row] = l[r];
      }
      const float inv = 1.f / l[r];  // l >= 1: the row maximum contributes exp2(0)
      float* orow = (out && p.o != nullptr)
                        ? p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_sl + 4 * kx
                        : nullptr;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 val = make_float4(o[r][j][0] * inv, o[r][j][1] * inv, o[r][j][2] * inv,
                                       o[r][j][3] * inv);
        *reinterpret_cast<float4*>(os + (rg + 16 * r) * S::LD + 4 * kx + 32 * j) = val;
        if (orow == nullptr) continue;
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
    // y += O_h @ wo[h*128 .., :]: slab t holds RT_WROWS rows of wo from
    // h*128 + RT_WROWS (t % RT_WK) and the columns 128 (t / RT_WK) .. of the
    // chunk t / RT_WK
    const float* wo_h = p.wo + (long long)h * D * p.Dout;
    auto load_slab = [&](int t) {
      const int cc = (t / RT_WK) * RT_WCOLS;
      rt_load<RT_WCOLS, RT_WROWS>(ws + (t & 1) * RT_WROWS * RT_WCOLS, RT_WCOLS,
                                  wo_h + (long long)(t % RT_WK) * RT_WROWS * p.Dout + cc,
                                  p.Dout, 0, RT_WROWS, p.Dout - cc, w_vec != 0);
      cp_async_commit();
    };
    load_slab(0);
    float acc[RT_RPT][4][4];
    for (int t = 0; t < nslabs; ++t) {
      cp_async_wait<0>();
      __syncthreads();  // slab t (and at t = 0 the head's output) is in; slab t - 1 is done
      if (t + 1 < nslabs) load_slab(t + 1);
      const int cc = (t / RT_WK) * RT_WCOLS, ks = t % RT_WK;
      if (ks == 0) {  // the chunk's running sum: 0 at the first head
#pragma unroll
        for (int r = 0; r < RT_RPT; ++r) {
          const bool live = h > 0 && q0 + rg + 16 * r < p.Lq;
          const float* yr = y + (long long)(rg + 16 * r) * p.Dout + cc;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = cc + 4 * kx + 32 * j;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
            if (!live) continue;
            if (y_vec && col + 4 <= p.Dout) {
              const float4 v = *reinterpret_cast<const float4*>(yr + 32 * j);
              acc[r][j][0] = v.x;
              acc[r][j][1] = v.y;
              acc[r][j][2] = v.z;
              acc[r][j][3] = v.w;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (col + e < p.Dout) acc[r][j][e] = yr[32 * j + e];
              }
            }
          }
        }
      }
      const float* w = ws + (t & 1) * RT_WROWS * RT_WCOLS + 4 * kx;
      const float* orows = os + ks * RT_WROWS;
#pragma unroll 2
      for (int k = 0; k < RT_WROWS; k += 4) {
        float4 ov[RT_RPT];
#pragma unroll
        for (int r = 0; r < RT_RPT; ++r) {
          ov[r] = *reinterpret_cast<const float4*>(orows + (rg + 16 * r) * S::LD + k);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 wv = *reinterpret_cast<const float4*>(w + (k + kk) * RT_WCOLS + 32 * j);
#pragma unroll
            for (int r = 0; r < RT_RPT; ++r) {
              const float a = kk == 0 ? ov[r].x : kk == 1 ? ov[r].y : kk == 2 ? ov[r].z : ov[r].w;
              acc[r][j][0] = fmaf(a, wv.x, acc[r][j][0]);
              acc[r][j][1] = fmaf(a, wv.y, acc[r][j][1]);
              acc[r][j][2] = fmaf(a, wv.z, acc[r][j][2]);
              acc[r][j][3] = fmaf(a, wv.w, acc[r][j][3]);
            }
          }
        }
      }
      if (ks + 1 < RT_WK) continue;
#pragma unroll
      for (int r = 0; r < RT_RPT; ++r) {  // the chunk's sum after this head, rows below Lq
        if (q0 + rg + 16 * r >= p.Lq) continue;
        float* yr = y + (long long)(rg + 16 * r) * p.Dout + cc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cc + 4 * kx + 32 * j;
          if (y_vec && col + 4 <= p.Dout) {
            *reinterpret_cast<float4*>(yr + 32 * j) =
                make_float4(acc[r][j][0], acc[r][j][1], acc[r][j][2], acc[r][j][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (col + e < p.Dout) yr[32 * j + e] = acc[r][j][e];
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the head's output and the slabs
  }
}

cudaError_t launch_proj_regtile(ProjSimtParams<float> p, cudaStream_t stream) {
  int vec = aligned16(p.q, p.q_sb, p.q_sh, p.q_sl) && aligned16(p.k, p.k_sb, p.k_sh, p.k_sl) &&
            aligned16(p.v, p.v_sb, p.v_sh, p.v_sl);
  int o_vec = p.o != nullptr && aligned16(p.o, p.o_sb, p.o_sh, p.o_sl);
  int w_vec = aligned16(p.wo, 0, 0, p.Dout);
  int y_vec = aligned16(p.y, 0, 0, p.Dout);
  const void* kernel = reinterpret_cast<const void*>(&flash_fwd_proj_f32_regtile_kernel);
  static bool ready[MAX_DEVICES] = {};
  constexpr int bytes = RtTiles<128, RT_PROJ_BK>::BYTES;
  cudaError_t err = allow_smem_once(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + RT_BQ - 1) / RT_BQ, p.B);
  void* args[] = {&p, &vec, &o_vec, &w_vec, &y_vec};
  err = cudaLaunchKernel(kernel, grid, dim3(RT_THREADS), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define PROJ_ARGS                                                                        \
  const void *q, const void *k, const void *v, const void *wo, void *y, void *o,          \
      const void *sin, const void *cos, const void *mask, void *k_rot, void *stats, int B, \
      int H, int Lq, int Lk, int Dh, int Dout, long long q_sb, long long q_sh,             \
      long long q_sl, long long k_sb, long long k_sh, long long k_sl, long long v_sb,      \
      long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,      \
      float scale, int causal, void *stream
#define PROJ_NAMES                                                                      \
  q, k, v, wo, y, o, sin, cos, mask, k_rot, stats, B, H, Lq, Lk, Dh, Dout, q_sb, q_sh, q_sl, \
      k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, scale, causal, stream

// The fp32 entry's launches, at Dh 128 to 512.
template <typename T>
int proj_simt(PROJ_ARGS) {
  if (H < 1 || H * Dh > PROJ_SIMT_MAX || Dout < 1 || (sin != nullptr && k_rot == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ProjSimtParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.wo = static_cast<const T*>(wo);
  p.y = static_cast<T*>(y);
  p.o = static_cast<T*>(o);
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.mask = static_cast<const uint8_t*>(mask);
  p.stats = static_cast<float*>(stats);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk; p.Dout = Dout;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  // rotate K once into the scratch, then read it there
  auto rope_k = [&](auto dim) -> cudaError_t {
    constexpr int DD = decltype(dim)::value;
    if (p.sin == nullptr) return cudaSuccess;
    cudaError_t err = launch_rope_rows_t<DD>(p.k, p.k_sb, p.k_sh, p.k_sl, B, H, Lk, p.sin,
                                             p.cos, static_cast<T*>(k_rot), st);
    p.k = static_cast<const T*>(k_rot);
    p.k_sb = (long long)H * Lk * DD;
    p.k_sh = (long long)Lk * DD;
    p.k_sl = DD;
    return err;
  };
  cudaError_t err;
  switch (Dh) {
    case 128:
      err = rope_k(std::integral_constant<int, 128>());
      if (err == cudaSuccess) err = launch_proj_regtile(p, st);
      break;
    case 256:
      err = rope_k(std::integral_constant<int, 256>());
      if (err == cudaSuccess) err = launch_proj_simt<T, 256>(p, st);
      break;
    case 384:
      err = rope_k(std::integral_constant<int, 384>());
      if (err == cudaSuccess) err = launch_proj_simt<T, 384>(p, st);
      break;
    case 512:
      err = rope_k(std::integral_constant<int, 512>());
      if (err == cudaSuccess) err = launch_proj_simt<T, 512>(p, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The bf16 entries' work at head dim D: K's RoPE pre-pass into `k_rot`,
// the tensor maps (q, k, v by head; wo [H * D, wo_cols]) and the launch of
// the kernel of (D, NWG).
template <int D, int NWG>
int proj_bf16(PROJ_ARGS, int wo_cols) {
  constexpr int BQ = NWG * 64 / kSplit<D>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sin != nullptr) {  // rotate K once into the scratch, then read it there
    cudaError_t err = launch_rope_rows<D>(
        static_cast<const __nv_bfloat16*>(k), k_sb, k_sh, k_sl, B, H, Lk,
        static_cast<const float*>(sin), static_cast<const float*>(cos),
        static_cast<__nv_bfloat16*>(k_rot), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    k = k_rot;
    k_sb = (long long)H * Lk * D;
    k_sh = (long long)Lk * D;
    k_sl = D;
  }
  ProjParams p;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.mask = static_cast<const uint8_t*>(mask);
  p.stats = static_cast<float*>(stats);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk; p.Dout = Dout;
  p.wo_cols = wo_cols;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  constexpr int BK = ProjCfg<D>::BK;
  CUtensorMap tq, tk, tv, two;
  int err = encode_head_map(&tq, q, Lq, H, B, q_sl, q_sh, q_sb, BQ, &p.q_hi, D);
  if (err == 0) err = encode_head_map(&tk, k, Lk, H, B, k_sl, k_sh, k_sb, BK, &p.k_hi, D);
  if (err == 0) err = encode_head_map(&tv, v, Lk, H, B, v_sl, v_sh, v_sb, BK, &p.v_hi, D);
  if (err == 0) err = encode_matrix_map(&two, wo, H * D, wo_cols);
  if (err != 0) return err;
  return launch<D, NWG>(p, tq, tk, tv, two, st);
}

inline int kernel_attrs(const void* kernel, int bytes, int* regs, int* smem) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = bytes;
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, else the CUDA error code of a launch (or
// cudaErrorInvalidValue for a head dim other than 128, a Dout that is not a
// multiple of 128, H * Dh above 1024, or RoPE without its scratch; or
// TMA_ERROR_BASE + the CUresult of cuTensorMapEncodeTiled when a tensor map
// cannot be encoded). Strides are in elements; the head dim of every operand is
// contiguous. `wo` is [H * Dh, Dout] and `y` [B, Lq, Dout], both
// contiguous. `o` (the attention output, strided like q) and `stats` ([2,
// B, H, Lq] fp32: row maximum in log2 units with the scale folded in, and
// row sum) are written when not null: they are what the backward starts
// from. With sin/cos, `k_rot` is a [B, H, Lk, Dh] bf16 scratch buffer that
// receives the rotated K.
int deepcoro_flash_fwd_proj_bf16(PROJ_ARGS) {
  if (Dh != 128 || Dout % 128 != 0 || H < 1 || H > MAX_HEADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sin != nullptr && k_rot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return consumers(H) == 2
             ? proj_bf16<128, 2>(PROJ_NAMES, Dout)
             : proj_bf16<128, 1>(PROJ_NAMES, Dout);
}

// Registers per thread (at entry) and dynamic shared memory per block of
// the kernel that H heads launch.
int deepcoro_flash_fwd_proj_attrs(int H, int* regs, int* smem) {
  if (H < 1 || H > MAX_HEADS) return static_cast<int>(cudaErrorInvalidValue);
  const int nwg = consumers(H);
  return kernel_attrs(nwg == 2 ? proj_kernel<128, 2>() : proj_kernel<128, 1>(),
                      ProjSmem<128>(H, nwg * 64).bytes, regs, smem);
}

// bf16 at Dh 256, 384 or 512, H * Dh <= 1024, any Dout >= 1, on
// flash_fwd_proj_wide_sm90_kernel<Dh>; the arguments mean what they mean
// above, but `wo` is [H * Dh, Dout rounded up to a multiple of 8] (its rows
// 16-byte aligned for TMA; the columns past Dout are read and not used).
int deepcoro_flash_fwd_proj_wide_bf16(PROJ_ARGS) {
  if (H < 1 || H * Dh > PROJ_SIMT_MAX || Dout < 1 || (sin != nullptr && k_rot == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wo_cols = (Dout + 7) / 8 * 8;
  switch (Dh) {
    case 256: return proj_bf16<256, 2>(PROJ_NAMES, wo_cols);
    case 384: return proj_bf16<384, 2>(PROJ_NAMES, wo_cols);
    case 512: return proj_bf16<512, 2>(PROJ_NAMES, wo_cols);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers and local memory (spilled) bytes per thread of
// flash_fwd_proj_wide_sm90_kernel<Dh>, as the runtime reads them.
int deepcoro_flash_fwd_proj_wide_attrs(int Dh, int* regs, int* local) {
  const void* kernel;
  switch (Dh) {
    case 256: kernel = proj_kernel<256, 2>(); break;
    case 384: kernel = proj_kernel<384, 2>(); break;
    case 512: kernel = proj_kernel<512, 2>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local = static_cast<int>(a.localSizeBytes);
  return 0;
}

// fp32 operands (Dh 128, 256, 384 or 512), H * Dh <= 1024, any Dout: at Dh
// 128 on flash_fwd_proj_f32_regtile_kernel, above on the SIMT kernel; the
// arguments mean what they mean above (`wo`, `y`, `o` and `k_rot` fp32).
int deepcoro_flash_fwd_proj_f32(PROJ_ARGS) {
  return proj_simt<float>(PROJ_NAMES);
}

// Registers per thread and dynamic shared memory per block of
// flash_fwd_proj_f32_regtile_kernel.
int deepcoro_flash_fwd_proj_f32_regtile_attrs(int* regs, int* smem) {
  return kernel_attrs(reinterpret_cast<const void*>(&flash_fwd_proj_f32_regtile_kernel),
                      RtTiles<128, RT_PROJ_BK>::BYTES, regs, smem);
}

}  // extern "C"
