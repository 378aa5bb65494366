// Causal flash attention forward for Hopper (sm_90a), native GQA,
// optional sliding window.
//
// Replaces: the Pallas TPU kernel `flash_attention` / `_fa_kernel`
// (src/repro/kernels/flash_attention.py). Same function: q [B,H,S,hd],
// k [B,KV,S,hd], v [B,KV,S,hd_v] -> [B,H,S,hd_v], head h reads KV head
// h / (H/KV), mask kpos <= qpos (and kpos > qpos - window when window >
// 0), fp32 online softmax, masked scores -1e30, a row with no valid key
// returns 0. In the port it takes the role of the prefill attention that
// the JAX model computes with the jnp pair-list scan (models/attention.py),
// which takes a v head dim of its own: MLA (deepseek-v2-lite-16b) attends
// with q/k of 192 (128 + 64 rotary) and v of 128. The TPU kernel uses one
// hd for all.
//
// What bounds it on this card: operations, from S ~ 200 up. Causal
// attention does about 2*S^2*hd*H flops on (4*S*hd*H) * 2 bytes: at hd 128
// that is hundreds of flops per byte, above the ~295 flop/byte where the
// 989 TFLOP/s bf16 tensor-core rate, not the 3.35 TB/s of device memory,
// becomes the limit.
//
// What the design does about it (bf16, `flash_fwd_bf16_kernel<HD, HDV>`,
// (HD, HDV) = (16, 16), (32, 32), (64, 64), (128, 128) or (192, 128)):
// - QK^T and PV run on the tensor cores as Hopper warpgroup products
//   (`wgmma.mma_async` m64n64k16 for the scores, HD / 16 of them a tile,
//   m64nHDVk16 for the output, bf16 in, fp32 accumulate). V keeps its own
//   width: at (192, 128) it is not padded to 192, which would add a third
//   to the PV products. A block is one warpgroup and one
//   64-row query tile. Q and K are read from shared memory (K-major); P
//   goes from the score accumulators to the PV product in registers,
//   rounded to bf16 there, where the plain version (and the JAX pair-list
//   scan) rounds the probabilities; V is read transposed (MN-major) from
//   shared memory, so it is stored as it arrives.
// - Q, K and V stay bf16 in shared memory in 64-column blocks of 128-byte
//   rows with the 128-byte swizzle (16-byte chunk c of row r at c ^ (r %
//   8)), the layout the wgmma descriptors name, free of bank conflicts.
//   They arrive by 16-byte `cp.async` copies into two stages: the next K/V
//   tile is in flight while the current one is multiplied, with one
//   `__syncthreads` per tile. Rows past S are zero-filled by the copy.
//   At (192, 128) a block holds q 24 KB, k 2 x 24 KB and v 2 x 16 KB
//   (105 KB with the alignment), so two blocks still fit an SM's 227 KB.
// - The online softmax runs on the fp32 accumulators in registers (quad
//   shuffles for the row max; the row sum stays per thread until the
//   end). Masks are computed only on the diagonal tile and the sliding
//   window's edge tiles; tiles wholly outside the band are skipped. The
//   diagonal tile comes first, so every valid row has a real maximum
//   from its first tile on.
// - Query tiles launch heaviest first (the last tile of the causal band
//   has the most keys), so the tail of the grid is the light tiles.
// - The copies, the tile layout, its descriptors and the wgmma wrappers
//   are in hopper_mma.cuh, which the backward (flash_attention_bwd.cu)
//   shares.
// Not yet: TMA copies under mbarriers, a producer warp and two consumer
// warpgroups (warp specialisation), overlap of one tile's softmax with the
// next tile's products, a persistent grid.
//
// Both kernels can also write each row's natural-log log-sum-exp (lse =
// m + log l, as the reference's `_fwd_scan` forms it) through one more
// pointer: training saves it for the backward (flash_attention_bwd.cu).
// Serving passes null, and nothing more is written.
//
// fp32 inputs take `flash_fwd_kernel`, the FMA kernel on the CUDA cores
// (a 64-row query tile, an 8 x 4 score block and an 8 x hd_v/16 output
// block per thread, fp32 tiles in shared memory; hd up to 192, hd_v up to
// 128): the tests and the fp32 model check hold it to 2e-5, which bf16
// tensor-core products would not.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128; // 8 row groups x 16 column lanes
constexpr int RPT = 8;       // rows per thread
constexpr int CPT = 4;       // score columns per thread (BK / 16)
constexpr int MAX_OCOL = 8;  // output columns per thread (hd_v / 16 <= 8)
constexpr int MAX_HD = 192;  // q/k head dim

__device__ __forceinline__ float reduce16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float reduce16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (ceil(S / BQ), H, B); block THREADS; dynamic shared memory:
//   q_s [BQ][hd + 1] | k_s [BK][hd + 1] | v_s [BK][hdv] | p_s [BQ][BK + 1]
__global__ void flash_fwd_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out,
                                 float* __restrict__ lse, int H, int KV,
                                 int S, int hd, int hdv, int window,
                                 float scale) {
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // row group: rows ty*RPT .. ty*RPT+RPT-1
  const int tx = tid % 16;  // column lane: columns tx + 16*j
  const int ncol = hdv / 16;
  const int qst = hd + 1, kst = hd + 1, pst = BK + 1;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * qst;
  float* v_s = k_s + BK * kst;
  float* p_s = v_s + BK * hdv;

  const int q_lo = qt * BQ;
  const float* q_bh = q + ((size_t)b * H + h) * (size_t)S * hd;
  const float* k_bh = k + ((size_t)b * KV + kvh) * (size_t)S * hd;
  const float* v_bh = v + ((size_t)b * KV + kvh) * (size_t)S * hdv;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    const int qpos = q_lo + r;
    q_s[r * qst + d] = qpos < S ? q_bh[(size_t)qpos * hd + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][MAX_OCOL];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_OCOL; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k_lo = kt * BK;
    // tile entirely left of the sliding-window band: every key is masked
    if (window > 0 && k_lo + BK - 1 <= q_lo - window) continue;
    __syncthreads();  // previous tile consumed (first pass: q_s visible)
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int c = i / hd, d = i % hd;
      const int kpos = k_lo + c;
      k_s[c * kst + d] = kpos < S ? k_bh[(size_t)kpos * hd + d] : 0.f;
    }
    for (int i = tid; i < BK * hdv; i += THREADS) {
      const int c = i / hdv, d = i % hdv;
      const int kpos = k_lo + c;
      v_s[c * hdv + d] = kpos < S ? v_bh[(size_t)kpos * hdv + d] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kv_[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv_[j] = k_s[(tx + 16 * j) * kst + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = q_s[(ty * RPT + i) * qst + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv, kv_[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      const int qpos = q_lo + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        bool ok = kpos <= qpos && kpos < S && qpos < S;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], reduce16_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float e = expf(s[i][j] - m_new);
        p_s[r * pst + tx + 16 * j] = e;
        sum += e;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + reduce16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < MAX_OCOL; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float vv[MAX_OCOL];
#pragma unroll
      for (int j = 0; j < MAX_OCOL; ++j)
        vv[j] = j < ncol ? v_s[c * hdv + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pv = p_s[(ty * RPT + i) * pst + c];
#pragma unroll
        for (int j = 0; j < MAX_OCOL; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
  }

  float* o_bh = out + ((size_t)b * H + h) * (size_t)S * hdv;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q_lo + ty * RPT + i;
    if (qpos >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int j = 0; j < MAX_OCOL; ++j)
      if (j < ncol) o_bh[(size_t)qpos * hdv + tx + 16 * j] = acc[i][j] * inv;
    // natural-log row sum for the backward, as the reference's scan forms
    // it: m + log(l)
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + qpos] = m[i] + logf(l_safe);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int KV, int S, int hd, int hdv,
               int window, float scale, cudaStream_t stream) {
  if (hd % 16 != 0 || hd > MAX_HD || hdv % 16 != 0 || hdv == 0 ||
      hdv > 16 * MAX_OCOL)
    return (int)cudaErrorInvalidValue;
  // 148 KB at hd 192, hd_v 128
  const size_t smem = sizeof(float) * ((size_t)BQ * (hd + 1) +
                                       (size_t)BK * (hd + 1) +
                                       (size_t)BK * hdv + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, H,
      KV, S, hd, hdv, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warpgroup products (wgmma) on 128-byte swizzled tiles, cp.async
// double buffering
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 16 * TC_WARPS;     // 64 query rows per block
constexpr int TC_BK = 64;                // keys per tile
constexpr int TC_PAD = 8;                // bf16 (16 bytes) per staged out row

// One tile's scores -> bf16 P fragments against the updated running max;
// returns the factors c0, c1 that carry the rows' old accumulators over
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             uint32_t (&pf)[4][4], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& c0, float& c1,
                                             bool masked, int k_lo, int row0,
                                             int row1, int col, int window,
                                             float scale_log2) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (masked) {
        const int kpos = k_lo + j * 8 + col + (e & 1);
        const int qpos = e < 2 ? row0 : row1;
        bool ok = kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        x = ok ? x : NEG_INF;
      }
      s[4 * j + e] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  c0 = exp2f(m0 - mn0);
  c1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= c0;
  l1 *= c1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp2f(s[4 * j] - mn0), p1 = exp2f(s[4 * j + 1] - mn0);
    const float p2 = exp2f(s[4 * j + 2] - mn1), p3 = exp2f(s[4 * j + 3] - mn1);
    l0 += p0 + p1;
    l1 += p2 + p3;
    pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
    pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
}


// grid (H, B, ceil(S / 64)), the query tile reversed from blockIdx.z; one
// warpgroup (TC_THREADS); dynamic shared memory, 1024-byte aligned:
//   q [NB blocks] | k [2][NB] | v [2][NBV], NB = sw_blocks(HD),
//   NBV = sw_blocks(HDV)
template <int HD, int HDV>
__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int H, int KV, int S,
                          int window, float scale_log2) {
  constexpr int TILE = sw_blocks(HD) * SW_BLOCK;    // bytes of a q/k tile
  constexpr int VTILE = sw_blocks(HDV) * SW_BLOCK;  // bytes of a v tile
  constexpr int ONT = HDV / 8;
  constexpr int CPR = HDV / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + TILE;
  unsigned char* v_s = k_s + 2 * TILE;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tile first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q_lo = qt * TC_BQ;

  const __nv_bfloat16* q_bh = q + ((size_t)b * H + h) * (size_t)S * HD;
  const __nv_bfloat16* k_bh = k + ((size_t)b * KV + kvh) * (size_t)S * HD;
  const __nv_bfloat16* v_bh = v + ((size_t)b * KV + kvh) * (size_t)S * HDV;

  // key tiles of the band, diagonal first: kt_hi down to kt_lo
  const int kt_hi = qt;  // TC_BQ == TC_BK: the diagonal tile
  const int lowest = q_lo - window + 1;  // first key any row of the tile needs
  const int kt_lo = (window > 0 && lowest > 0) ? lowest / TC_BK : 0;
  const int n_tiles = kt_hi - kt_lo + 1;

  load_tile_sw<HD>(q_s, q_bh, q_lo, S, tid);
  load_tile_sw<HD>(k_s, k_bh, kt_hi * TC_BK, S, tid);
  load_tile_sw<HDV>(v_s, v_bh, kt_hi * TC_BK, S, tid);
  cp_async_commit();

  const int row0 = q_lo + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int col = (lane & 3) * 2;

  float o[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt_hi - it;
    const int buf = it & 1;
    cp_async_wait_all();
    // the copies were generic-proxy writes; wgmma reads through the async
    // proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile_sw<HD>(k_s + (buf ^ 1) * TILE, k_bh, (kt - 1) * TC_BK, S,
                       tid);
      load_tile_sw<HDV>(v_s + (buf ^ 1) * VTILE, v_bh, (kt - 1) * TC_BK, S,
                        tid);
      cp_async_commit();
    }
    const unsigned char* kb = k_s + buf * TILE;
    const unsigned char* vb = v_s + buf * VTILE;

    // S = Q K^T: 64 x 64, HD / 16 k-steps, 32 bytes apart in a swizzled
    // row, the next 64 columns one block further
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int off = (ks / 4) * SW_BLOCK + (ks % 4) * 32;
      wgmma_m64n64k16_ss(s, sw128_desc(q_s + off, 16, 1024),
                         sw128_desc(kb + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int k_lo = kt * TC_BK;
    const bool masked = kt == qt ||
                        (window > 0 && k_lo <= q_lo + TC_BQ - 1 - window);
    uint32_t pf[4][4];
    float c0, c1;
    softmax_tile(s, pf, m0, m1, l0, l1, c0, c1, masked, k_lo, row0, row1,
                 col, window, scale_log2);
#pragma unroll
    for (int j = 0; j < ONT; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }

    // O += P V: V read MN-major (transposed), 16 keys = 2048 bytes a step,
    // 64-column blocks SW_BLOCK apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HDV>(o, pf[kk], sw128_desc(vb + kk * 2048, SW_BLOCK, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  // the running max is in base-2 units of the scaled score: the natural
  // log-sum-exp is m * ln 2 + log(l), one quad lane writing each row
  if (lse != nullptr && (lane & 3) == 0) {
    float* lse_bh = lse + ((size_t)b * H + h) * S;
    if (row0 < S) lse_bh[row0] = m0 * LN2 + logf(l0 > 0.f ? l0 : 1.f);
    if (row1 < S) lse_bh[row1] = m1 * LN2 + logf(l1 > 0.f ? l1 : 1.f);
  }

  // stage the 64 rows in the K buffers (free once every product is done)
  // with padded rows, then write them out as 16-byte rows
  __syncthreads();
  constexpr int OST = HDV + TC_PAD;
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(k_s) + warp * 16 * OST;
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
    *reinterpret_cast<uint32_t*>(os + (lane >> 2) * OST + j * 8 + col) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(os + ((lane >> 2) + 8) * OST + j * 8 +
                                 col) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  __syncwarp();
  __nv_bfloat16* o_bh = out + ((size_t)b * H + h) * (size_t)S * HDV;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    const int qpos = q_lo + warp * 16 + r;
    if (qpos < S)
      *reinterpret_cast<uint4*>(o_bh + (size_t)qpos * HDV + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * OST + c * 8);
  }
}

template <int HD, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int H, int KV, int S, int window,
                float scale, cudaStream_t stream) {
  // q, two k stages and two v stages, and the 1024-byte alignment:
  // 107,520 bytes at (192, 128)
  const size_t smem =
      (size_t)(3 * sw_blocks(HD) + 2 * sw_blocks(HDV)) * SW_BLOCK + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + TC_BQ - 1) / TC_BQ);
  flash_fwd_bf16_kernel<HD, HDV><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, lse, H, KV, S, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k head dim hd, v and out head dim hd_v. dtype: 0 = float32 (hd a
// multiple of 16 up to 192, hd_v one up to 128), 1 = bfloat16 ((hd, hd_v)
// one of (16, 16), (32, 32), (64, 64), (128, 128), (192, 128); q, k, v
// 16-byte aligned). The wrapper checks both. lse, when not null, receives
// the natural-log log-sum-exp of each row's scaled scores, [B, H, S]
// float32, for the backward (flash_attention_bwd.cu); the serving path
// passes null and nothing more is written. Returns a cudaError_t (0 =
// success).
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int H, int KV, int S, int hd, int hd_v,
              int window, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k, v, out, (float*)lse, B, H, KV, S, hd, hd_v,
                      window, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int pair = hd * 1000 + hd_v;
  switch (pair) {
    case 16016:
      return launch_bf16<16, 16>(q, k, v, out, (float*)lse, B, H, KV,
                                 S, window, scale, st);
    case 32032:
      return launch_bf16<32, 32>(q, k, v, out, (float*)lse, B, H, KV,
                                 S, window, scale, st);
    case 64064:
      return launch_bf16<64, 64>(q, k, v, out, (float*)lse, B, H, KV,
                                 S, window, scale, st);
    case 128128:
      return launch_bf16<128, 128>(q, k, v, out, (float*)lse, B, H, KV,
                                 S, window, scale, st);
    case 192128:
      return launch_bf16<192, 128>(q, k, v, out, (float*)lse, B, H, KV,
                                 S, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
