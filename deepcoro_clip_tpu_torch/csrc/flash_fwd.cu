// Flash-attention forward for Hopper (sm_90a), bf16 in/out, fp32 softmax.
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
// q-block; q rows are rotated once, in shared memory. wgmma and TMA are
// left for later work.
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

#include "flash_common.cuh"

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

// In-place RoPE on the rows of the shared q tile that exist.
template <int D>
__device__ __forceinline__ void rope_tile(__nv_bfloat16* s, const float* sin,
                                          const float* cos, int row0, int L) {
  constexpr int HALF = D / 2;
  for (int i = threadIdx.x; i < BQ * HALF; i += NTHREADS) {
    const int r = i / HALF, d = i % HALF;
    const int pos = row0 + r;
    if (pos >= L) continue;
    __nv_bfloat16* row = s + r * (D + PAD);
    const float* sr = sin + (long long)pos * D;
    const float* cr = cos + (long long)pos * D;
    rope_pair(__bfloat162float(row[d]), __bfloat162float(row[d + HALF]), sr[d],
              sr[d + HALF], cr[d], cr[d + HALF], row[d], row[d + HALF]);
  }
}

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

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
  const uint8_t* mrow = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
  const int ntiles = (p.Lk + BK - 1) / BK;

  load_tile_async<D>(Qs, qg, p.q_sl, q0, p.Lq);
  load_tile_async<D>(Ks, kg, p.k_sl, 0, p.Lk);
  load_tile_async<D>(Vs, vg, p.v_sl, 0, p.Lk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (p.sin) {
    rope_tile<D>(Qs, p.sin, p.cos, q0, p.Lq);
    __syncthreads();
  }

  // this warp's 16 q rows as mma A fragments, kept for the whole key loop
  constexpr int KS = D / 16;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * (D + PAD) + ks * 16 + (lane >> 4) * 8);
  }

  constexpr int NO = D / 8;  // n8 tiles of the output
  float acc[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_r[2] = {0.f, 0.f};              // this thread's partial row sums
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  // ldmatrix lane offsets: K (x4: n-tiles nt, nt+1 x k-halves), V (x4.trans:
  // k-halves x d-tiles dn, dn+1)
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  for (int j = 0; j < ntiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < ntiles) {  // prefetch the next tile into the other buffer
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

    // S = Q K^T for 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (np * 16 + k_row) * (D + PAD) + ks * 16 + k_col);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // scale, mask, and the tile's row maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        float x;
        if (key >= p.Lk) {
          x = -INFINITY;  // does not exist: probability exactly 0
        } else {
          x = s[nt][e] * p.scale_log2;
          if ((mrow != nullptr && mrow[key] == 0) || (p.causal && key > row)) x = -FLT_MAX;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key kv0 < Lk scores finite, so the new max is finite
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // P = exp2(S - m), re-packed as A fragments of the P V product:
    // n8 tiles 2kk and 2kk+1 of S are the k16 slice kk of P
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_r[0]);
      const float p1 = exp2f(s[nt][1] - m_r[0]);
      const float p2 = exp2f(s[nt][2] - m_r[1]);
      const float p3 = exp2f(s[nt][3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      const int kk = nt >> 1, hi = nt & 1;
      pf[kk][hi * 2 + 0] = pack_bf16(p0, p1);  // row g
      pf[kk][hi * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (kk * 16 + v_row) * (D + PAD) + dp * 16 + v_col);
        mma_bf16(acc[2 * dp], pf[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
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

}  // extern "C"
