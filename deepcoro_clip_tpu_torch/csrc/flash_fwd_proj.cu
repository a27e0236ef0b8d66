// Flash-attention forward with the output projection fused in, for Hopper
// (sm_90a), bf16 in/out: y = concat_h(attention_h(q, k, v)) @ wo.
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
// parallel and nothing carries over between them, so one block owns a
// 64-row tile of y outright:
//   1. it loops over the H heads; each head's attention is `attend_head`
//      of flash_common.cuh, the body of flash_fwd.cu's kernel (K/V streamed
//      in tiles by cp.async, online softmax, mma.sync m16n8k16); the head's
//      normalised output, rounded to bf16 as the Pallas kernel rounds it
//      before its product, goes into a shared [64, D] tile (and, when a
//      gradient is wanted, to device memory);
//   2. then y = tile @ wo: wo streams through the K/V buffers in [64, 128]
//      tiles (column chunk by column chunk, double-buffered); a warp keeps
//      its 16 x 128 fp32 slice of y in registers over the D/64 tiles of a
//      chunk and rounds it once on the way out.
// No atomics and no second pass: every y element is summed by one thread
// in a fixed order, so two launches agree bit for bit.
//
// Shared memory per block. The [64, D + 8] output tile (65 KB at D = 512,
// 97 KB at D = 768) comes on top of the streamed tiles, and with
// flash_fwd.cu's layout (q tile 17 KB, two K and two V tiles of 64 keys,
// 68 KB) a block took 150 KB: one block of 4 warps per SM, and the kernel
// ran 1.7x slower on an H100 than the unfused kernel followed by the product
// (PERF.md).
// So here keys stream in tiles of 32 (34 KB for the four tiles), and a
// head's q tile is staged in the columns of the output tile that the head's
// output will fill: 99 KB at D = 512, two blocks per SM as in flash_fwd.cu;
// 131 KB at D = 768, one block. D <= 1024 fits the 227 KB a block may take.
// Looping over the heads also divides the grid by H: the text tower's
// [8, 512] rows give 64 blocks for 132 SMs. That is the price of owning y
// without atomics; wgmma, TMA and a persistent schedule are left for later
// work.

#include "flash_common.cuh"

namespace {

constexpr int BKP = 32;  // keys per streamed tile here (flash_fwd.cu: 64)
static_assert(4 * BKP == 2 * BK, "the four K/V tiles are reused as two wo tiles");

struct ProjParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* wo;  // [D, Dout] contiguous
  __nv_bfloat16* y;         // [B, Lq, Dout] contiguous
  __nv_bfloat16* o;         // attention output (strided) or null
  const float* sin;         // [Lq, Dh] fp32 or null
  const float* cos;
  const uint8_t* mask;      // [B, Lk], nonzero = attend, or null
  float* stats;             // [2, B*H, Lq] fp32 row max and row sum, or null
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int B, H, Lq, Lk, Dout;
  float scale_log2;
  int causal;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_proj_kernel(const ProjParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = BK * (D + PAD);     // a wo tile: 64 rows
  constexpr int KTILE = BKP * (D + PAD);   // a K or V tile: BKP keys
  constexpr int NO = D / 8;
  // two K tiles then two V tiles of BKP keys; together, later, two wo tiles
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + 2 * KTILE;
  __nv_bfloat16* Os = Vs + 2 * KTILE;      // [64, H*D + PAD]: all heads' outputs
  const int DM = p.H * D;
  const int os_ld = DM + PAD;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;

  for (int h = 0; h < p.H; ++h) {
    float acc[NO][4];
    float m_r[2], l_r[2];
    // the head's q tile is staged where its output will go: the q rows are
    // in registers before the key loop's first barrier, the output is
    // written after its last
    attend_head<D, BKP>(Os + h * D, os_ld, Ks, Vs, p.q + b * p.q_sb + h * p.q_sh, p.q_sl,
                        p.k + b * p.k_sb + h * p.k_sh, p.k_sl,
                        p.v + b * p.v_sb + h * p.v_sh, p.v_sl, p.sin, p.cos, mrow, q0,
                        p.Lq, p.Lk, p.scale_log2, p.causal, acc, m_r, l_r);
    if (p.stats != nullptr && t == 0) {
      float* sm = p.stats + ((long long)b * p.H + h) * p.Lq;
      float* sl = sm + (long long)p.B * p.H * p.Lq;
      if (row_a < p.Lq) { sm[row_a] = m_r[0]; sl[row_a] = l_r[0]; }
      if (row_b < p.Lq) { sm[row_b] = m_r[1]; sl[row_b] = l_r[1]; }
    }
    // l >= 1: the row maximum contributes exp2(0)
    const float inv_a = 1.f / l_r[0];
    const float inv_b = 1.f / l_r[1];
    __nv_bfloat16* sa = Os + (warp * 16 + g) * os_ld + h * D + 2 * t;
    __nv_bfloat16* sb = sa + 8 * os_ld;
    __nv_bfloat16* ga = nullptr;
    __nv_bfloat16* gb = nullptr;
    if (p.o != nullptr) {
      __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh + 2 * t;
      if (row_a < p.Lq) ga = og + (long long)row_a * p.o_sl;
      if (row_b < p.Lq) gb = og + (long long)row_b * p.o_sl;
    }
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const uint32_t va = pack_bf16(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
      const uint32_t vb = pack_bf16(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
      *reinterpret_cast<uint32_t*>(sa + dn * 8) = va;
      *reinterpret_cast<uint32_t*>(sb + dn * 8) = vb;
      if (ga != nullptr) *reinterpret_cast<uint32_t*>(ga + dn * 8) = va;
      if (gb != nullptr) *reinterpret_cast<uint32_t*>(gb + dn * 8) = vb;
    }
  }
  __syncthreads();  // the output tile is whole, the K buffers are free

  // y[64, Dout] = Os[64, DM] @ wo[DM, Dout], a [64, D]-wide chunk of columns
  // at a time; tile i is rows (i % nkt) * 64.. of column chunk i / nkt
  const int nkt = DM / BK;
  const int total = (p.Dout / D) * nkt;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;
  load_tile_async<D>(Ks, p.wo, p.Dout, 0, DM);
  cp_async_commit();
  float y[NO][4];
  for (int i = 0; i < total; ++i) {
    const int cur = i & 1;
    if (i + 1 < total) {
      const int c = (i + 1) / nkt, kt = (i + 1) % nkt;
      load_tile_async<D>(Ks + (cur ^ 1) * TILE, p.wo + c * D, p.Dout, kt * BK, DM);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Wt = Ks + cur * TILE;
    const int c = i / nkt, kt = i % nkt;
    if (kt == 0) {
#pragma unroll
      for (int dn = 0; dn < NO; ++dn) y[dn][0] = y[dn][1] = y[dn][2] = y[dn][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Os + (warp * 16 + (lane & 15)) * os_ld + kt * BK + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t wb[4];
        ldsm_x4_trans(wb, Wt + (kk * 16 + v_row) * (D + PAD) + dp * 16 + v_col);
        mma_bf16(y[2 * dp], a, wb[0], wb[1]);
        mma_bf16(y[2 * dp + 1], a, wb[2], wb[3]);
      }
    }
    if (kt == nkt - 1) {  // the chunk is summed over all of D: round once, store
      __nv_bfloat16* yg = p.y + (long long)b * p.Lq * p.Dout + c * D + 2 * t;
      if (row_a < p.Lq) {
        __nv_bfloat16* yrow = yg + (long long)row_a * p.Dout;
#pragma unroll
        for (int dn = 0; dn < NO; ++dn) {
          *reinterpret_cast<uint32_t*>(yrow + dn * 8) = pack_bf16(y[dn][0], y[dn][1]);
        }
      }
      if (row_b < p.Lq) {
        __nv_bfloat16* yrow = yg + (long long)row_b * p.Dout;
#pragma unroll
        for (int dn = 0; dn < NO; ++dn) {
          *reinterpret_cast<uint32_t*>(yrow + dn * 8) = pack_bf16(y[dn][2], y[dn][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }
}

template <int D>
cudaError_t launch(ProjParams p, __nv_bfloat16* k_rot, cudaStream_t stream) {
  if (p.sin != nullptr) {  // rotate K once into the scratch, then read it there
    cudaError_t err = launch_rope_rows<D>(p.k, p.k_sb, p.k_sh, p.k_sl, p.B, p.H, p.Lk,
                                          p.sin, p.cos, k_rot, stream);
    if (err != cudaSuccess) return err;
    p.k = k_rot;
    p.k_sb = (long long)p.H * p.Lk * D;
    p.k_sh = (long long)p.Lk * D;
    p.k_sl = D;
  }
  const int smem = (4 * BKP * (D + PAD) + BQ * (p.H * D + PAD)) *
                   static_cast<int>(sizeof(__nv_bfloat16));
  // the attribute is the largest size asked for so far on each device
  static int allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || allowed[dev] < smem) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&flash_fwd_proj_kernel<D>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) allowed[dev] = smem;
  }
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.B);
  flash_fwd_proj_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, else the CUDA error code of a launch (or
// cudaErrorInvalidValue for a head dim other than 128, a Dout that is not a
// multiple of 128, H * Dh above 1024, or RoPE without its scratch). Strides
// are in elements; the head dim of every operand is contiguous. `wo` is
// [H * Dh, Dout] and `y` [B, Lq, Dout], both contiguous. `o` (the attention
// output, strided like q) and `stats` ([2, B, H, Lq] fp32: row maximum in
// log2 units with the scale folded in, and row sum) are written when not
// null: they are what the backward starts from. With sin/cos, `k_rot` is a
// [B, H, Lk, Dh] bf16 scratch buffer that receives the rotated K.
int deepcoro_flash_fwd_proj_bf16(
    const void* q, const void* k, const void* v, const void* wo, void* y, void* o,
    const void* sin, const void* cos, const void* mask, void* k_rot, void* stats,
    int B, int H, int Lq, int Lk, int Dh, int Dout,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int causal, void* stream) {
  ProjParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.wo = static_cast<const __nv_bfloat16*>(wo);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.o = static_cast<__nv_bfloat16*>(o);
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
  if (Dh != 128 || Dout % 128 != 0 || H * Dh > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sin != nullptr && k_rot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<128>(p, static_cast<__nv_bfloat16*>(k_rot),
                                      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
