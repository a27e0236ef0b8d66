// Flash-attention forward for Hopper (sm_90a): bf16 in/out with fp32 softmax
// on the tensor cores, and a plain fp32 kernel for fp32 operands (below).
//
// Replaces two Pallas TPU kernels of deepcoro_clip_tpu:
//   - ops/flash_attention_packed.py `_fwd_kernel` (packed [B, L, H*Dh], with
//     q/k/v read as strided views of one fused [B, L, 3D] QKV tensor);
//   - ops/flash_attention.py `_fwd_kernel` ([B, H, L, Dh]).
// One kernel serves both: it takes every operand as a base pointer plus
// (batch, head, row) strides in elements, with the head dim contiguous, so
// neither layout is copied or transposed on the way in or out.
//
// What bounds it on an H100: per head the work is 4*L*L*Dh FLOP against
// 4*L*Dh*2 bytes moved (q, k, v read, o written), L/2 FLOP per byte. At the
// video tower's L = 1569 that is ~780, above the card's ~295 bf16
// FLOP/byte ridge: the tensor cores bound it. At L = 393 (after the pool,
// ~200) and in the aggregator (L = 10) it is below the ridge, and the
// bytes, then the launch, bound it.
//
// Design. The Pallas kernels keep ALL of K/V in VMEM and take one exact
// softmax per q-block. K and V of one head at L = 1569, Dh = 128 are
// 2 x 402 KB in bf16, more than a block's 227 KB of shared memory, so here
// K/V stream through shared memory in 64-key tiles with an online softmax
// (fp32 running max m, sum l and accumulator). One block of 4 warps owns a
// 64-row q-tile of one (batch, head); each warp owns 16 rows and runs
// mma.sync m16n8k16 (bf16 x bf16 -> fp32) for S = Q K^T and O += P V, with
// the S accumulator re-packed in registers as the A operand of P V (no
// shared-memory round trip for P). Tile sizes are fixed and never depend on
// the batch, so results do not change with batch size. K/V tiles arrive by
// cp.async into a double buffer (the next tile loads while this one is
// computed); fragments come out of padded shared tiles by ldmatrix (V
// transposed on the way). RoPE of K is applied once, by a small pre-pass
// kernel into a scratch copy of K, rather than to every K tile in every
// q-block; q rows are rotated once, in shared memory. This kernel serves
// the [B, H, L, Dh] entry (K3) at Dh 64 and 128 where Lq or Lk exceeds 64
// (shorter calls run flash_short.cu in one launch); every bf16 call of the
// packed and fused layouts (K1) runs flash_fwd_sm90_kernel below, the same
// function on wgmma, TMA and an mbarrier pipeline.
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

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = BK * (D + PAD);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * (D + PAD);  // two K tiles, then two V tiles
  __nv_bfloat16* Vs = Ks + 2 * TILE;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
  constexpr int NO = D / 8;  // n8 tiles of the output
  float acc[NO][4];
  float m_r[2], l_r[2];  // rows g and g + 8
  attend_head<D, BK>(Qs, D + PAD, Ks, Vs, p.q + b * p.q_sb + h * p.q_sh, p.q_sl,
                     p.k + b * p.k_sb + h * p.k_sh, p.k_sl, p.v + b * p.v_sb + h * p.v_sh,
                     p.v_sl, p.sin, p.cos,
                     p.mask ? p.mask + (long long)b * p.Lk : nullptr, q0, p.Lq, p.Lk,
                     p.scale_log2, p.causal, acc, m_r, l_r);
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  // the backward kernels rebuild P = exp2(s - m) / l from these; written
  // only when a gradient is wanted, and never read on this path
  if (p.stats != nullptr && t == 0) {
    float* sm = p.stats + (long long)bh * p.Lq;
    float* sl = sm + (long long)gridDim.y * p.Lq;
    if (row_a < p.Lq) { sm[row_a] = m_r[0]; sl[row_a] = l_r[0]; }
    if (row_b < p.Lq) { sm[row_b] = m_r[1]; sl[row_b] = l_r[1]; }
  }
  // l >= 1: the row maximum contributes exp2(0)
  const float inv_a = 1.f / l_r[0];
  const float inv_b = 1.f / l_r[1];
  if (row_a < p.Lq) {
    __nv_bfloat16* orow = og + (long long)row_a * p.o_sl;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
    }
  }
  if (row_b < p.Lq) {
    __nv_bfloat16* orow = og + (long long)row_b * p.o_sl;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
    }
  }
}

template <int D>
cudaError_t launch(Params p, int B, __nv_bfloat16* k_rot, cudaStream_t stream) {
  if (p.sin != nullptr) {  // rotate K once into the scratch, then read it there
    cudaError_t err = launch_rope_rows<D>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk,
                                          p.sin, p.cos, k_rot, stream);
    if (err != cudaSuccess) return err;
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D;
    p.k_sh = (long long)p.Lk * D;
    p.k_sl = D;
  }
  const int smem = (BQ + 4 * BK) * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16));
  static bool ready[MAX_DEVICES] = {};  // one per head dim: launch<D> is a template
  cudaError_t err = allow_smem_once(
      reinterpret_cast<const void*>(&flash_fwd_kernel<D>), smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, B * p.H);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- the packed layouts on Hopper's own tools (K1) -----------------------------
// Every bf16 call of the packed [B, L, H*128] and fused [B, L, 3D] layouts
// (flash_attention_packed) runs this kernel; the [B, H, L, Dh] entry (K3)
// keeps flash_fwd_kernel above.
//
// What bounds it: the tensor cores at L = 1569 (~780 FLOP per byte against
// the card's ~295 ridge), the bytes at L = 393. What flash_fwd_kernel left on
// the table there: mma.sync (the older tensor-core path, at most ~2/3 of
// wgmma's rate), cp.async issued by every thread with a __syncthreads()
// before and after each key tile, so loads and math never overlap, a mask
// byte read from device memory per score, and per block a q-tile load,
// RoPE and pipeline start that short rows (25 key tiles at L = 1569, 7 at
// 393) do not amortise. Design (FA3's forward shape), tiles fixed (never
// dependent on B, so results stay batch-size invariant bit for bit; no
// atomics, so two launches agree bit for bit):
//   - a persistent grid (one block per SM) walks the work items, BQ = 128
//     q rows of one (batch, head) each, q tiles of a head next to each
//     other so its K/V stay in L2;
//   - a block has three warpgroups: two consumers of 64 rows each and a
//     producer; setmaxnreg gives the consumers 232 registers and the
//     producer 40;
//   - one warp of the producer loads each item's q tile by TMA (once the
//     consumers are done with the last one's products) and then its K and V
//     tiles of 128 keys (cp.async.bulk.tensor over 4-D tensor maps of the
//     strided operands, so fused QKV is read in place) into a ring of three
//     stages guarded by `full`/`empty` mbarriers, with each tile's 128 mask
//     bytes beside it; so the next item's tiles arrive while the consumers
//     finish this one;
//   - each consumer warpgroup rotates its 64 rows of the q tile (RoPE, in
//     place, rope_q_rows) and runs sm90_attend (sm90_common.cuh): S = Q K^T
//     on wgmma from shared memory, the softmax in registers while the
//     tensor cores run the previous tile's P V, P rounded to bf16 as the
//     register A operand of O += P V on wgmma; then the epilogue straight
//     from registers;
//   - RoPE of K: a pre-pass (launch_rope_rows) into a contiguous scratch.
// The q-tile height costs padded rows on ragged lengths: 1569 rows take 13
// tiles (1664 rows, 6% idle), 393 take 4 (512, 23%), 512 take 4 (none).
// Shared memory: q 32 KB + 3 stages x 64 KB + 384 mask bytes: 225 KB of the
// 227 KB a block may have, one block per SM.

constexpr int SM90_BQ = 128;
constexpr int SM90_BK = 128;
constexpr int SM90_NST = 3;
constexpr int SM90_THREADS = 3 * 128;

struct Sm90Params {
  __nv_bfloat16* o;
  const float* sin;     // [Lq, 128] fp32 or null
  const float* cos;
  const uint8_t* mask;  // [B, Lk], nonzero = attend, or null
  float* stats;         // [2, B*H, Lq] fp32 row max and row sum, or null
  long long o_sb, o_sh, o_sl;
  int B, H, Lq, Lk;
  float scale_log2;
  int causal;
  int q_hi, k_hi, v_hi;  // coordinate order of each tensor map
};

struct Sm90Smem {  // byte offsets from the 1024-aligned base
  static constexpr int QTILE = 2 * SM90_BQ * BOX_ROW_BYTES;  // two boxes of BQ rows
  static constexpr int Q = 0;
  static constexpr int RING = Q + QTILE;
  static constexpr int MASK = RING + SM90_NST * KVRing<SM90_BK>::STAGE;
  // full[NST], empty[NST], q loaded, q free
  static constexpr int BARS = MASK + SM90_NST * SM90_BK;
  static constexpr int END = BARS + (2 * SM90_NST + 2) * 8;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Sm90Params p) {
  extern __shared__ __align__(16) unsigned char sm90_smem[];
  unsigned char* smem = sm90_smem + ((1024 - (smem_u32(sm90_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint8_t* mask_s = smem + Sm90Smem::MASK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm90Smem::BARS);
  uint64_t* empty = full + SM90_NST;
  uint64_t* q_loaded = empty + SM90_NST;
  uint64_t* q_free = q_loaded + 1;

  const int nqt = (p.Lq + SM90_BQ - 1) / SM90_BQ;
  const int items = nqt * p.B * p.H;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SM90_NST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init(q_loaded, 1);
    mbar_init(q_free, 2 * 128);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one warp loads, the other three leave
    setmaxnreg_dec<40>();
    if ((threadIdx.x / 32) % 4 != 0) return;
    uint32_t n = 0;
    Pipe pp;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int qt = item % nqt, bh = item / nqt;
      const int b = bh / p.H, h = bh % p.H;
      mbar_wait(q_free, (n & 1) ^ 1);  // the consumers are done with the last q
      if (lane == 0) {
        mbar_arrive_expect_tx(q_loaded, Sm90Smem::QTILE);
        tma_load_head(&tq, base + Sm90Smem::Q, q_loaded, 0, qt * SM90_BQ, h, b, p.q_hi);
        tma_load_head(&tq, base + Sm90Smem::Q + SM90_BQ * BOX_ROW_BYTES, q_loaded, 64,
                      qt * SM90_BQ, h, b, p.q_hi);
      }
      produce_kv<SM90_BK, SM90_NST>(&tk, p.k_hi, &tv, p.v_hi, h, b, p.Lk,
                                    p.mask ? p.mask + (long long)b * p.Lk : nullptr,
                                    base + Sm90Smem::RING, mask_s, full, empty, pp, lane);
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64 wg .. of each item
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32;
    const uint32_t qrows = Sm90Smem::Q + wg * 64 * BOX_ROW_BYTES;
    uint32_t n = 0;
    Pipe pp;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int qt = item % nqt, bh = item / nqt;
      const int b = bh / p.H, h = bh % p.H;
      const int row_a = qt * SM90_BQ + wg * 64 + warp * 16 + lane / 4;
      mbar_wait(q_loaded, n & 1);
      if (p.sin != nullptr) {  // RoPE of this warpgroup's q rows, in place
        rope_q_rows(smem + qrows, smem + qrows + SM90_BQ * BOX_ROW_BYTES, p.sin, p.cos,
                    qt * SM90_BQ + wg * 64, p.Lq, threadIdx.x % 128);
        fence_async_smem();
        warpgroup_sync(1 + wg);
      }
      float o[64], m_r[2], l_r[2];
      sm90_attend<SM90_BK, SM90_NST>(base + qrows, SM90_BQ * BOX_ROW_BYTES,
                                     base + Sm90Smem::RING, mask_s, p.mask != nullptr, full,
                                     empty, pp, q_free, row_a, p.Lk, p.scale_log2, p.causal,
                                     o, m_r, l_r);
      write_stats(p.stats, bh, (long long)p.B * p.H, p.Lq, row_a, m_r, l_r);
      // l >= 1: the row maximum contributes exp2(0)
      const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
      __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= p.Lq) continue;
        __nv_bfloat16* orow = og + (long long)row * p.o_sl;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          *reinterpret_cast<uint32_t*>(orow + jn * 8) =
              pack_bf16(o[4 * jn + 2 * r] * inv[r], o[4 * jn + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

int launch_sm90(Params p, int B, __nv_bfloat16* k_rot, cudaStream_t stream) {
  if (p.sin != nullptr) {  // rotate K once into the scratch, then read it there
    cudaError_t err = launch_rope_rows<128>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk,
                                            p.sin, p.cos, k_rot, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * 128;
    p.k_sh = (long long)p.Lk * 128;
    p.k_sl = 128;
  }
  Sm90Params s;
  s.o = p.o; s.sin = p.sin; s.cos = p.cos; s.mask = p.mask; s.stats = p.stats;
  s.o_sb = p.o_sb; s.o_sh = p.o_sh; s.o_sl = p.o_sl;
  s.B = B; s.H = p.H; s.Lq = p.Lq; s.Lk = p.Lk;
  s.scale_log2 = p.scale_log2;
  s.causal = p.causal;
  CUtensorMap tq, tk, tv;
  int err = encode_head_map(&tq, p.q, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, SM90_BQ, &s.q_hi);
  if (err == 0) {
    err = encode_head_map(&tk, p.k, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, SM90_BK, &s.k_hi);
  }
  if (err == 0) {
    err = encode_head_map(&tv, p.v, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, SM90_BK, &s.v_hi);
  }
  if (err != 0) return err;
  static bool ready[MAX_DEVICES] = {};
  cudaError_t cerr = allow_smem_once(reinterpret_cast<const void*>(&flash_fwd_sm90_kernel),
                                     Sm90Smem::BYTES, ready);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int sms = 0;
  cerr = num_sms(&sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long items = (long long)((p.Lq + SM90_BQ - 1) / SM90_BQ) * B * p.H;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_sm90_kernel<<<grid, SM90_THREADS, Sm90Smem::BYTES, stream>>>(tq, tk, tv, s);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 operands ----------------------------------------------------------
// One warp per query row, online softmax over 32 keys at a time: each lane
// scores one key (a full fp32 dot product against the row in shared memory),
// the warp reduces maximum and sum, then every lane adds the 32 weighted
// value rows into its own columns. Same masking rules and the same row
// statistics as the bf16 kernel; P is not rounded (the plain version keeps
// it in fp32 for fp32 operands). K, when RoPE is on, was rotated by the
// pre-pass; q is rotated while it is copied into shared memory.

struct ParamsF32 {
  const float* q;
  const float* k;
  const float* v;
  float* o;
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

template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32) flash_fwd_f32_kernel(const ParamsF32 p) {
  constexpr int PER = D / 32, HALF = D / 2;
  __shared__ float qs[F32_WARPS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * F32_WARPS + warp;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  if (row >= p.Lq) return;  // a whole warp leaves; no block-wide barrier follows

  const float* qrow = p.q + b * p.q_sb + h * p.q_sh + row * p.q_sl;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    float x = qrow[d];
    if (p.sin != nullptr) {
      const float xp = d < HALF ? -qrow[d + HALF] : qrow[d - HALF];
      x = x * p.cos[(long long)row * D + d] + xp * p.sin[(long long)row * D + d];
    }
    qs[warp][d] = x;
  }
  __syncwarp();

  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < p.Lk; j0 += 32) {
    const int key = j0 + lane;
    float x = -INFINITY;  // a key that does not exist: probability exactly 0
    if (key < p.Lk) {
      x = dot_row<D>(qs[warp], kg + key * p.k_sl) * p.scale_log2;
      if ((mrow != nullptr && mrow[key] == 0) || (p.causal && key > row)) x = -FLT_MAX;
    }
    const float m_new = fmaxf(m, warp_max(x));  // key j0 exists: finite
    const float alpha = exp2f(m - m_new);
    const float pj = exp2f(x - m_new);
    l = l * alpha + warp_sum(pj);
    m = m_new;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
    const int n = min(32, p.Lk - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float pv = __shfl_sync(FULL, pj, jj);
      const float* vrow = vg + (j0 + jj) * p.v_sl;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(pv, vrow[lane + 32 * i], acc[i]);
    }
  }
  if (p.stats != nullptr && lane == 0) {
    float* sm = p.stats + (long long)bh * p.Lq;
    sm[row] = m;
    sm[(long long)gridDim.y * p.Lq + row] = l;
  }
  float* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sl;
  const float inv = 1.f / l;  // l >= 1: the row maximum contributes exp2(0)
#pragma unroll
  for (int i = 0; i < PER; ++i) orow[lane + 32 * i] = acc[i] * inv;
}

template <int D>
cudaError_t launch_f32(ParamsF32 p, int B, float* k_rot, cudaStream_t stream) {
  if (p.sin != nullptr) {  // rotate K once into the scratch, then read it there
    cudaError_t err = launch_rope_rows_f32<D>(p.k, p.k_sb, p.k_sh, p.k_sl, B, p.H, p.Lk,
                                              p.sin, p.cos, k_rot, stream);
    if (err != cudaSuccess) return err;
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D;
    p.k_sh = (long long)p.Lk * D;
    p.k_sl = D;
  }
  const dim3 grid((p.Lq + F32_WARPS - 1) / F32_WARPS, B * p.H);
  flash_fwd_f32_kernel<D><<<grid, F32_WARPS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, else the CUDA error code of a launch (or
// cudaErrorInvalidValue for a head dim the kernel was not built for, or
// RoPE without its scratch). Strides are in elements; the head dim of every
// operand is contiguous. With sin/cos, `k_rot` is a [B, H, Lk, Dh] bf16
// scratch buffer that receives the rotated K. `stats`, when not null, is
// a [2, B, H, Lq] fp32 buffer that receives each row's maximum (of the
// scores in log2 units, scale folded in) and the row's sum of
// exp2(score - maximum): what the backward needs to rebuild P.
int deepcoro_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* sin, const void* cos, const void* mask, void* k_rot, void* stats,
    int B, int H, int Lq, int Lk, int Dh,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int causal, void* stream) {
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
  if (sin != nullptr && k_rot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* kr = static_cast<__nv_bfloat16*>(k_rot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return static_cast<int>(launch<64>(p, B, kr, st));
    case 128: return static_cast<int>(launch<128>(p, B, kr, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1: the same arguments and results for the packed and fused layouts
// (q/k/v strided views with the heads inside a row), bf16, Dh 128 only
// (cudaErrorInvalidValue otherwise), on flash_fwd_sm90_kernel. Also
// returns TMA_ERROR_BASE + the CUresult of cuTensorMapEncodeTiled when a
// tensor map cannot be encoded.
int deepcoro_flash_fwd_sm90_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* sin, const void* cos, const void* mask, void* k_rot, void* stats,
    int B, int H, int Lq, int Lk, int Dh,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int causal, void* stream) {
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
  if (Dh != 128 || (sin != nullptr && k_rot == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_sm90(p, B, static_cast<__nv_bfloat16*>(k_rot),
                     static_cast<cudaStream_t>(stream));
}

// Registers per thread (at entry; setmaxnreg moves them between the
// warpgroups) and dynamic shared memory per block of flash_fwd_sm90_kernel.
int deepcoro_flash_fwd_sm90_attrs(int* regs, int* smem) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(&flash_fwd_sm90_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = Sm90Smem::BYTES;
  return 0;
}

// The same for fp32 operands (`k_rot` then is an fp32 scratch); the
// arguments mean what they mean above.
int deepcoro_flash_fwd_f32(
    const void* q, const void* k, const void* v, void* o,
    const void* sin, const void* cos, const void* mask, void* k_rot, void* stats,
    int B, int H, int Lq, int Lk, int Dh,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int causal, void* stream) {
  ParamsF32 p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
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
  if (sin != nullptr && k_rot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* kr = static_cast<float*>(k_rot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return static_cast<int>(launch_f32<64>(p, B, kr, st));
    case 128: return static_cast<int>(launch_f32<128>(p, B, kr, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
