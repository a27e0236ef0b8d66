// Ring-attention forward step for Hopper (sm_90a): K6, bf16 in/out on the
// tensor cores at Dh 64 and 128, SIMT for fp32 and for bf16 at Dh 256 to 512.
//
// Replaces the Pallas TPU kernel of deepcoro_clip_tpu:
//   parallel/ring_attention.py `_rdma_ring_kernel` (one device's whole ring
//   pass: q, its K/V chunk and two K/V slots in VMEM; an async remote copy
//   of slot `cur` into the right neighbour's slot `nxt` started before the
//   math, the online-softmax update, a barrier with both neighbours, a wait).
//
// Here the pass is split in two. This file holds the step kernel, the
// online-softmax update of one shard's queries [B, H, Lc, D] with the K/V
// chunk in one of its slots, launched once per shard per ring step, and the
// slot copy. The host side (ops/_ring_cuda.py) enqueues, at step r, the copy
// of shard i's slot `cur` into shard i+1's slot `nxt` on shard i's copy
// stream before shard i's step-r kernel on its compute stream; CUDA events
// stand in for the semaphores: the copy into a slot waits until the
// neighbour's step r-1 and its own send of that slot are done (the slot
// backpressure of the TPU kernel's barrier), and a step waits for the
// arrival of the chunk it reads.
//
// Why the slots live in device memory: one head's K/V chunk at Lc = 3920
// and D = 128 is 2 MB in bf16, far more than a block's 227 KB of shared
// memory, so the state cannot stay on chip from step to step as it stays
// in VMEM on the TPU. The row state (m, l, acc) is carried between the
// steps in fp32 device buffers, [B*H, Lc], [B*H, Lc] and [B*H, Lc, D]; the
// last step normalises and writes bf16.
//
// What bounds it on an H100: per (batch, head) the whole pass is
// 4 * L^2 * D FLOP against q, k, v and o read or written once (8 * L * D
// bytes) plus the chunks the ring moves ((n-1) * 4 * L * D bytes) and the
// state's round trips; at L = 15680, D = 128 that is thousands of FLOP per
// byte: the tensor cores bound it.
//
// Two kernels, chosen by the head dim (the host names the choice:
// ops/_ring_cuda.step_symbol):
//   - Dh 128, every path of the repository: `ring_step_sm90_kernel`, the
//     packed forward's Hopper design (flash_fwd.cu `flash_fwd_sm90_kernel`)
//     started from the carried state. Work items are (batch*head, 128-row q
//     tile); a block has two consumer warpgroups of 64 rows and a producer
//     warp that loads the q tile by TMA (a 4-D map over q's strides) and
//     streams the slot's K/V in 128-key tiles through a ring of three
//     `mbarrier`-guarded stages (KVRing<128>, produce_kv). Each consumer
//     loads its rows' state into the accumulator layout (or takes the empty
//     state at the first step), runs sm90_attend (S = Q K^T and O += P V on
//     wgmma, the softmax in registers under the other product) and either
//     writes the state back in place or, at the last step, normalises and
//     stores bf16 through o's strides. One block per item (248 at Lc =
//     3920), so the shards' launches on their own streams interleave on the
//     SMs; a persistent grid of one block per SM was slower at 1, 2 and 4
//     shards. 225 KB of shared memory: one block per SM. 168 registers a
//     thread at entry, the consumers' budget too (see the kernel).
//   - Dh 64: `ring_step_kernel`, the mma.sync design of flash_common.cuh's
//     `attend_head` from the carried state: one block of 4 warps per
//     (batch*head, 64-row q tile), K/V in 64-key tiles through a cp.async
//     double buffer.
// In both, m is kept in log2 units with log2(e) folded into the scale (exp2
// in place of exp) in every step, so the unit never changes across steps.
// P is rounded to bf16 against the running maximum of the key tiles (128
// or 64 keys), where the plain ring rounds it against the chunk's maximum:
// the two round at different points, within the tolerance the tests state.
// Rows and keys past Lc (Lc is not a multiple of the tiles at the main
// path's sizes) are zero-filled (by TMA, or by cp.async) and never stored;
// a key that does not exist has probability exactly 0. No atomics: every
// output is summed by one thread in a fixed order, so two calls agree bit
// for bit. A forward of the slot through peer pointers inside the kernel
// is left for later work.

#include "sm90_common.cuh"

namespace {

struct RingParams {
  const __nv_bfloat16* q;  // [B, H, Lc, D], strided, head dim contiguous
  const __nv_bfloat16* k;  // the slot's K: [B*H, Lc, D] contiguous
  const __nv_bfloat16* v;  // the slot's V: [B*H, Lc, D] contiguous
  __nv_bfloat16* o;        // [B, H, Lc, D], strided (written by the last step)
  float* m;                // [B*H, Lc] row maxima, log2 units (not read by the first step)
  float* l;                // [B*H, Lc] row sums
  float* acc;              // [B*H, Lc, D] un-normalised outputs
  long long q_sb, q_sh, q_sl;
  long long o_sb, o_sh, o_sl;
  int H, Lc;
  float scale_log2;
  int first, last;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) ring_step_kernel(const RingParams p) {
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
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const bool ok_a = row_a < p.Lc, ok_b = row_b < p.Lc;
  const long long rows = (long long)bh * p.Lc;  // this head's first state row

  constexpr int NO = D / 8;  // n8 tiles of the output
  float acc[NO][4];
  float m_r[2], l_r[2];  // rows g and g + 8
  if (p.first) {
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    m_r[0] = m_r[1] = -INFINITY;
    l_r[0] = l_r[1] = 0.f;
  } else {
    m_r[0] = ok_a ? p.m[rows + row_a] : -INFINITY;
    m_r[1] = ok_b ? p.m[rows + row_b] : -INFINITY;
    // the carried sum is whole: one thread of the row's four takes it
    l_r[0] = (ok_a && t == 0) ? p.l[rows + row_a] : 0.f;
    l_r[1] = (ok_b && t == 0) ? p.l[rows + row_b] : 0.f;
    const float* aa = p.acc + (rows + (ok_a ? row_a : 0)) * D + 2 * t;
    const float* ab = p.acc + (rows + (ok_b ? row_b : 0)) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const float2 xa = ok_a ? *reinterpret_cast<const float2*>(aa + dn * 8) : make_float2(0.f, 0.f);
      const float2 xb = ok_b ? *reinterpret_cast<const float2*>(ab + dn * 8) : make_float2(0.f, 0.f);
      acc[dn][0] = xa.x; acc[dn][1] = xa.y;
      acc[dn][2] = xb.x; acc[dn][3] = xb.y;
    }
  }

  attend_head<D, BK, false>(Qs, D + PAD, Ks, Vs, p.q + b * p.q_sb + h * p.q_sh, p.q_sl,
                            p.k + rows * D, D, p.v + rows * D, D, nullptr, nullptr,
                            nullptr, q0, p.Lc, p.Lc, p.scale_log2, 0, acc, m_r, l_r);

  if (p.last) {
    // l >= 1: the row maximum contributes exp2(0) at the step that set it
    const float inv_a = 1.f / l_r[0];
    const float inv_b = 1.f / l_r[1];
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
    if (ok_a) {
      __nv_bfloat16* orow = og + (long long)row_a * p.o_sl;
#pragma unroll
      for (int dn = 0; dn < NO; ++dn) {
        *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
            pack_bf16(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
      }
    }
    if (ok_b) {
      __nv_bfloat16* orow = og + (long long)row_b * p.o_sl;
#pragma unroll
      for (int dn = 0; dn < NO; ++dn) {
        *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
            pack_bf16(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
      }
    }
    return;
  }
  // carry the state to the next step; l_r is whole in every thread of the row
  if (t == 0) {
    if (ok_a) { p.m[rows + row_a] = m_r[0]; p.l[rows + row_a] = l_r[0]; }
    if (ok_b) { p.m[rows + row_b] = m_r[1]; p.l[rows + row_b] = l_r[1]; }
  }
  float* aa = p.acc + (rows + row_a) * D + 2 * t;
  float* ab = p.acc + (rows + row_b) * D + 2 * t;
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) {
    if (ok_a) *reinterpret_cast<float2*>(aa + dn * 8) = make_float2(acc[dn][0], acc[dn][1]);
    if (ok_b) *reinterpret_cast<float2*>(ab + dn * 8) = make_float2(acc[dn][2], acc[dn][3]);
  }
}

template <int D>
cudaError_t launch_step(const RingParams& p, int BH, cudaStream_t stream) {
  const int smem = (BQ + 4 * BK) * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16));
  static bool ready[MAX_DEVICES] = {};  // one per head dim: launch_step<D> is a template
  cudaError_t err = allow_smem_once(
      reinterpret_cast<const void*>(&ring_step_kernel<D>), smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lc + BQ - 1) / BQ, BH);
  ring_step_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- Dh 128 on Hopper's own tools ------------------------------------------

constexpr int RS_BQ = 128;  // q rows per item: two consumer warpgroups of 64
constexpr int RS_BK = 128;  // keys per streamed tile
constexpr int RS_NST = 3;
constexpr int RS_THREADS = 3 * 128;

struct RingSm90Params {
  __nv_bfloat16* o;  // [B, H, Lc, 128], strided (written by the last step)
  float* m;          // the carried state, as in RingParams
  float* l;
  float* acc;
  long long o_sb, o_sh, o_sl;
  int B, H, Lc;
  float scale_log2;
  int first, last;
  int q_hi, kv_hi;  // coordinate order of the q map and of the slot's maps
};

struct RingSmem {  // byte offsets from the 1024-aligned base
  static constexpr int QTILE = 2 * RS_BQ * BOX_ROW_BYTES;  // two boxes of RS_BQ rows
  static constexpr int Q = 0;
  static constexpr int RING = Q + QTILE;
  // full[NST], empty[NST], q loaded
  static constexpr int BARS = RING + RS_NST * KVRing<RS_BK>::STAGE;
  static constexpr int END = BARS + (2 * RS_NST + 1) * 8;
  static constexpr int BYTES = END + 1024;  // slack to align the base
};

// One block per work item (batch*head, 128-row q tile); the launch's grid is
// the item count. Both roles still walk "their" items in a loop, which thus
// runs once: ptxas compiles the whole kernel to the 168 registers a thread
// of a 384-thread block starts with, and only in this form did the consumer
// fit. Written straight, without the loop, it spilled in the key loop and a
// step took about 1.3x as long on an H100. With one item a block the q
// tile is loaded once, so no barrier guards its reuse.
__global__ void __launch_bounds__(RS_THREADS, 1)
    ring_step_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const RingSm90Params p) {
  extern __shared__ __align__(16) unsigned char rs_smem[];
  unsigned char* smem = rs_smem + ((1024 - (smem_u32(rs_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RingSmem::BARS);
  uint64_t* empty = full + RS_NST;
  uint64_t* q_loaded = empty + RS_NST;

  const int nqt = (p.Lc + RS_BQ - 1) / RS_BQ;
  const int items = nqt * p.B * p.H;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RS_NST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init(q_loaded, 1);
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
      if (lane == 0) {
        mbar_arrive_expect_tx(q_loaded, RingSmem::QTILE);
        tma_load_head(&tq, base + RingSmem::Q, q_loaded, 0, qt * RS_BQ, h, b, p.q_hi);
        tma_load_head(&tq, base + RingSmem::Q + RS_BQ * BOX_ROW_BYTES, q_loaded, 64,
                      qt * RS_BQ, h, b, p.q_hi);
      }
      produce_kv<RS_BK, RS_NST>(&tk, p.kv_hi, &tv, p.kv_hi, h, b, p.Lc,
                                (p.Lc + RS_BK - 1) / RS_BK, nullptr,
                                base + RingSmem::RING, smem, full, empty, pp, lane);
    }
  } else {  // consumers: warpgroup wg owns q rows 128 qt + 64 wg .. of the item
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32;
    const int t = lane & 3;
    const uint32_t qrows = RingSmem::Q + wg * 64 * BOX_ROW_BYTES;
    uint32_t n = 0;
    Pipe pp;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int qt = item % nqt, bh = item / nqt;
      const int b = bh / p.H, h = bh % p.H;
      const int row_a = qt * RS_BQ + wg * 64 + warp * 16 + lane / 4;
      const long long rows = (long long)bh * p.Lc;  // this head's first state row
      // the carried state of rows row_a and row_a + 8 (the empty state at the
      // first step and past Lc), read while the q tile arrives
      float o[64], m_r[2], l_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        const bool carried = !p.first && row < p.Lc;
        m_r[r] = carried ? p.m[rows + row] : -INFINITY;
        l_r[r] = carried && t == 0 ? p.l[rows + row] : 0.f;  // whole, in one thread
        const float* a = p.acc + (rows + (carried ? row : 0)) * 128 + 2 * t;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const float2 x = carried ? *reinterpret_cast<const float2*>(a + jn * 8)
                                   : make_float2(0.f, 0.f);
          o[4 * jn + 2 * r] = x.x;
          o[4 * jn + 2 * r + 1] = x.y;
        }
      }
      mbar_wait(q_loaded, n & 1);
      sm90_attend<RS_BK, RS_NST, false>(base + qrows, RS_BQ * BOX_ROW_BYTES,
                                        base + RingSmem::RING, smem, false, full, empty, pp,
                                        nullptr, row_a, p.Lc, (p.Lc + RS_BK - 1) / RS_BK,
                                        p.scale_log2, 0, o, m_r, l_r);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= p.Lc) continue;
        if (p.last) {  // l >= 1: the row maximum contributes exp2(0) at the step that set it
          const float inv = 1.f / l_r[r];
          __nv_bfloat16* orow =
              p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_sl + 2 * t;
#pragma unroll
          for (int jn = 0; jn < 16; ++jn) {
            *reinterpret_cast<uint32_t*>(orow + jn * 8) =
                pack_bf16(o[4 * jn + 2 * r] * inv, o[4 * jn + 2 * r + 1] * inv);
          }
        } else {  // carry the state; l_r is whole in every thread of the row
          if (t == 0) {
            p.m[rows + row] = m_r[r];
            p.l[rows + row] = l_r[r];
          }
          float* a = p.acc + (rows + row) * 128 + 2 * t;
#pragma unroll
          for (int jn = 0; jn < 16; ++jn) {
            *reinterpret_cast<float2*>(a + jn * 8) =
                make_float2(o[4 * jn + 2 * r], o[4 * jn + 2 * r + 1]);
          }
        }
      }
    }
  }
}

int launch_step_sm90(const RingParams& rp, int B, cudaStream_t stream) {
  RingSm90Params s;
  s.o = rp.o; s.m = rp.m; s.l = rp.l; s.acc = rp.acc;
  s.o_sb = rp.o_sb; s.o_sh = rp.o_sh; s.o_sl = rp.o_sl;
  s.B = B; s.H = rp.H; s.Lc = rp.Lc;
  s.scale_log2 = rp.scale_log2;
  s.first = rp.first; s.last = rp.last;
  // the slot's K and V are [B, H, Lc, 128] contiguous
  const long long sl = 128, sh = (long long)rp.Lc * 128, sb = (long long)rp.H * rp.Lc * 128;
  CUtensorMap tq, tk, tv;
  int v_hi = 0;
  int err = encode_head_map(&tq, rp.q, rp.Lc, rp.H, B, rp.q_sl, rp.q_sh, rp.q_sb, RS_BQ, &s.q_hi);
  if (err == 0) err = encode_head_map(&tk, rp.k, rp.Lc, rp.H, B, sl, sh, sb, RS_BK, &s.kv_hi);
  if (err == 0) err = encode_head_map(&tv, rp.v, rp.Lc, rp.H, B, sl, sh, sb, RS_BK, &v_hi);
  if (err != 0) return err;
  static bool ready[MAX_DEVICES] = {};
  cudaError_t cerr = allow_smem_once(reinterpret_cast<const void*>(&ring_step_sm90_kernel),
                                     RingSmem::BYTES, ready);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = ((rp.Lc + RS_BQ - 1) / RS_BQ) * B * rp.H;
  ring_step_sm90_kernel<<<grid, RS_THREADS, RingSmem::BYTES, stream>>>(tq, tk, tv, s);
  return static_cast<int>(cudaGetLastError());
}


// ---- SIMT step: fp32 operands, and bf16 at Dh 256 to 512 -------------------
// The same step where the two kernels above do not go: fp32 at Dh 64 to 512
// (ring_step_f32_kernel<D>) and bf16 at Dh 256 to 512
// (ring_step_wide_bf16_kernel<D>). The SIMT forward's tiled body
// (simt_attend_tiles, flash_common.cuh: 4 query rows a warp, the slot's K/V
// through shared memory 32 keys at a time) started from the carried state:
// m and l of each row and its D accumulators in the same [B*H, Lc] /
// [B*H, Lc, D] fp32 buffers, so the carried state means the same in every
// kernel. In bf16 P is rounded to bf16 against the running maximum of each
// 32-key tile. What bounds it: 4*Lc*Lc*D FLOP a step and head on the CUDA
// cores; the shared-memory pipe sets its pace, as in the SIMT forward of
// flash_fwd.cu.

template <typename T>
struct RingSimtParams {
  const T* q;  // [B, H, Lc, D], strided, head dim contiguous
  const T* k;  // the slot's K: [B*H, Lc, D] contiguous
  const T* v;  // the slot's V: [B*H, Lc, D] contiguous
  T* o;        // [B, H, Lc, D], strided (written by the last step)
  float* m;
  float* l;
  float* acc;
  long long q_sb, q_sh, q_sl;
  long long o_sb, o_sh, o_sl;
  int H, Lc;
  float scale_log2;
  int first, last;
};

template <typename T, int D>
__device__ __forceinline__ void ring_step_simt(const RingSimtParams<T>& p) {
  constexpr int NW = SIMT_WARPS<D>, PER = D / 32;
  extern __shared__ __align__(16) float simt_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * FwdTiles<D, NW>::BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const long long rows = (long long)bh * p.Lc;  // this head's first state row
  float acc[SR][PER], m[SR], l[SR];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int row = q0 + SR * warp + r;
    const bool fresh = p.first || row >= p.Lc;  // (a row past Lc is never stored)
    m[r] = fresh ? -INFINITY : p.m[rows + row];
    l[r] = fresh ? 0.f : p.l[rows + row];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      acc[r][i] = fresh ? 0.f : p.acc[(rows + row) * D + lane + 32 * i];
    }
  }
  const long long chunk = rows * D;
  simt_attend_tiles<T, D, NW>(simt_smem, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.Lc,
                              nullptr, nullptr, p.k + chunk, D, p.v + chunk, D, nullptr, p.Lc,
                              0, p.scale_log2, acc, m, l);
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int row = q0 + SR * warp + r;
    if (row >= p.Lc) continue;
    if (p.last) {
      const float inv = 1.f / l[r];  // l >= 1: the row maximum contributes exp2(0)
      T* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sl;
#pragma unroll
      for (int i = 0; i < PER; ++i) orow[lane + 32 * i] = from_f<T>(acc[r][i] * inv);
      continue;
    }
    if (lane == 0) {
      p.m[rows + row] = m[r];
      p.l[rows + row] = l[r];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) p.acc[(rows + row) * D + lane + 32 * i] = acc[r][i];
  }
}

template <int D>
__global__ void __launch_bounds__(SIMT_WARPS<D> * 32) ring_step_f32_kernel(
    const RingSimtParams<float> p) {
  ring_step_simt<float, D>(p);
}

template <int D>
__global__ void __launch_bounds__(SIMT_WARPS<D> * 32) ring_step_wide_bf16_kernel(
    const RingSimtParams<__nv_bfloat16> p) {
  ring_step_simt<__nv_bfloat16, D>(p);
}

template <typename T, int D>
cudaError_t launch_step_simt(RingSimtParams<T> p, int BH, cudaStream_t stream) {
  using S = FwdTiles<D, SIMT_WARPS<D>>;
  const void* kernel;
  if constexpr (sizeof(T) == 4) {
    kernel = reinterpret_cast<const void*>(&ring_step_f32_kernel<D>);
  } else {
    kernel = reinterpret_cast<const void*>(&ring_step_wide_bf16_kernel<D>);
  }
  static bool ready[MAX_DEVICES] = {};  // one per instance: one per kernel
  cudaError_t err = allow_smem_once(kernel, S::BYTES, ready);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3((p.Lc + S::BQ - 1) / S::BQ, BH),
                         dim3(SIMT_WARPS<D> * 32), args, S::BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define STEP_ARGS                                                                         \
  const void *q, const void *k, const void *v, void *o, void *m, void *l, void *acc, int B, \
      int H, int Lc, int Dh, long long q_sb, long long q_sh, long long q_sl, long long o_sb, \
      long long o_sh, long long o_sl, float scale, int first, int last, void *stream

template <typename T>
int step_simt(STEP_ARGS) {
  RingSimtParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.acc = static_cast<float*>(acc);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.H = H; p.Lc = Lc;
  p.scale_log2 = scale * LOG2E;
  p.first = first;
  p.last = last;
  if ((!first || !last) && (m == nullptr || l == nullptr || acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  switch (Dh) {
    case 64:
      if constexpr (sizeof(T) == 4) {
        return static_cast<int>(launch_step_simt<T, 64>(p, BH, st));
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    case 128:
      if constexpr (sizeof(T) == 4) {
        return static_cast<int>(launch_step_simt<T, 128>(p, BH, st));
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    case 256: return static_cast<int>(launch_step_simt<T, 256>(p, BH, st));
    case 384: return static_cast<int>(launch_step_simt<T, 384>(p, BH, st));
    case 512: return static_cast<int>(launch_step_simt<T, 512>(p, BH, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One ring step of one shard on ring_step_kernel: fold the K/V chunk of a slot (`k`, `v`, each
// [B*H, Lc, Dh] contiguous bf16) into the online softmax of the shard's
// queries `q` ([B, H, Lc, Dh], strides in elements, head dim contiguous).
// `first`: start from the empty state (m, l, acc are not read); `last`:
// normalise and write `o` (strided like q) instead of the state. With
// neither, the state is read and written back in place. Returns 0 on
// success, else the CUDA error code of the launch (cudaErrorInvalidValue for
// a head dim other than 64: Dh 128 runs the Hopper entry below). The
// current device must be the stream's.
int deepcoro_ring_step_bf16(
    const void* q, const void* k, const void* v, void* o, void* m, void* l, void* acc,
    int B, int H, int Lc, int Dh,
    long long q_sb, long long q_sh, long long q_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int first, int last, void* stream) {
  RingParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.acc = static_cast<float*>(acc);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.H = H; p.Lc = Lc;
  p.scale_log2 = scale * LOG2E;
  p.first = first;
  p.last = last;
  if ((!first || !last) && (m == nullptr || l == nullptr || acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_step<64>(p, B * H, static_cast<cudaStream_t>(stream)));
}

// The same step at Dh 128 (cudaErrorInvalidValue otherwise) on
// ring_step_sm90_kernel; the arguments mean what they mean above. Also
// returns TMA_ERROR_BASE + the CUresult of cuTensorMapEncodeTiled when a
// tensor map cannot be encoded.
int deepcoro_ring_step_sm90_bf16(
    const void* q, const void* k, const void* v, void* o, void* m, void* l, void* acc,
    int B, int H, int Lc, int Dh,
    long long q_sb, long long q_sh, long long q_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int first, int last, void* stream) {
  RingParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.acc = static_cast<float*>(acc);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.H = H; p.Lc = Lc;
  p.scale_log2 = scale * LOG2E;
  p.first = first;
  p.last = last;
  if (Dh != 128) return static_cast<int>(cudaErrorInvalidValue);
  if ((!first || !last) && (m == nullptr || l == nullptr || acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_step_sm90(p, B, static_cast<cudaStream_t>(stream));
}

// The same step for fp32 operands at Dh 64, 128, 256, 384 or 512 (`k`, `v`,
// `o` fp32), on ring_step_f32_kernel<Dh>, and for bf16 at Dh 256, 384 or 512
// on ring_step_wide_bf16_kernel<Dh>; the arguments mean what they mean above.
int deepcoro_ring_step_f32(STEP_ARGS) {
  return step_simt<float>(q, k, v, o, m, l, acc, B, H, Lc, Dh, q_sb, q_sh, q_sl, o_sb, o_sh,
                          o_sl, scale, first, last, stream);
}

int deepcoro_ring_step_wide_bf16(STEP_ARGS) {
  return step_simt<__nv_bfloat16>(q, k, v, o, m, l, acc, B, H, Lc, Dh, q_sb, q_sh, q_sl, o_sb,
                                  o_sh, o_sl, scale, first, last, stream);
}

// Registers per thread (at entry; setmaxnreg moves them between the
// warpgroups) and dynamic shared memory per block of ring_step_sm90_kernel.
int deepcoro_ring_step_sm90_attrs(int* regs, int* smem) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(&ring_step_sm90_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = RingSmem::BYTES;
  return 0;
}

// The ring's slot copy: `bytes` from `src` on device `src_dev` into `dst`
// on device `dst_dev`, on `stream` (the sender's copy stream). A copy
// inside one card is a device-to-device copy; across cards it is a peer
// copy, which goes card to card where peer access is enabled.
int deepcoro_ring_copy(void* dst, int dst_dev, const void* src, int src_dev,
                       long long bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dst_dev == src_dev
      ? cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes), cudaMemcpyDeviceToDevice, st)
      : cudaMemcpyPeerAsync(dst, dst_dev, src, src_dev, static_cast<size_t>(bytes), st);
  return static_cast<int>(err);
}

// Let `dev` reach `peer`'s memory directly. Returns 0 when access is
// enabled (now or before), else the CUDA error code. Restores the calling
// thread's current device.
int deepcoro_ring_enable_peer(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it: a later launch check must not see it
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // extern "C"
