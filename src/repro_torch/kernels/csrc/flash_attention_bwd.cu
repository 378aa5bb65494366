// Causal flash attention backward for Hopper (sm_90a), native GQA,
// optional sliding window: dq, dk, dv of B2's function (flash_attention.cu).
//
// Replaces: the jnp custom VJP `_flash_bwd` (src/repro/models/attention.py)
// that the reference model's training attention differentiates through;
// it is the backward of B2, whose forward replaces the Pallas kernel of
// src/repro/kernels/flash_attention.py (no Pallas backward exists).
// Same function: from q [B,H,S,hd], k [B,KV,S,hd], v [B,KV,S,hd_v], the
// forward's out [B,H,S,hd_v] and natural-log lse [B,H,S] (float32), and
// dout [B,H,S,hd_v]:
//   p  = exp(scale * q k^T - lse)        (masked entries 0)
//   dv = p^T dout, dp = dout v^T, delta = rowsum(dout * out),
//   ds = p * (dp - delta) * scale, dq = ds k, dk = ds^T q,
// with head h reading KV head h / (H / KV), and dk, dv summed over the
// G = H / KV query heads of each KV head. Masks as B2's: kpos <= qpos, and
// kpos > qpos - window when window > 0. Sums are fp32, written in the
// input dtype, as the reference casts its fp32 sums at the end. delta is
// one elementwise reduction; the wrapper forms it in torch. The kernels
// are templates on (HD, HDV), the instances of B2's forward: the square
// head dims 16-128 and MLA's q/k 192 with v 128 (deepseek-v2-lite-16b).
// Scores, q, k, dq and dk run over HD columns; v, dout and dv over HDV,
// and dp = dout v^T is a sum over HDV.
//
// What bounds it on this card: operations. The function needs five
// products per (query, key) pair of the band (scores, dp, dv, dk, dq),
// 2.5 times B2's two: 10 * hd flops a pair against 4 * hd. At hd 128 that
// is hundreds of flops a byte, far above the ~295 flop/byte where the 989
// TFLOP/s bf16 tensor-core rate, not the 3.35 TB/s of device memory,
// decides. Both routes below take two passes and do seven products a pair
// (the scores and dp once in each pass): a one-pass kernel
// (FlashAttention-2's) adds dq across key tiles with atomics, whose order
// changes from call to call, and a fixed-order dq workspace would be
// [key tiles, B, H, S, hd] fp32, 4.3 GB at qwen3-8b's train shape. With
// no atomics a call gives the same bits every time. (The bf16 route does
// one product more, below: eight.)
//
// bf16 (`flash_bwd_dkdv_bf16_kernel<HD, HDV>` and
// `flash_bwd_dq_bf16_kernel<HD, HDV>`): every product runs on the tensor
// cores as a Hopper warpgroup product (`wgmma.mma_async`, bf16 in, fp32
// accumulate), on B2's forward's building blocks (hopper_mma.cuh): bf16
// tiles in 64-column blocks of 128-byte swizzled rows, filled by 16-byte
// `cp.async` copies (rows past S zero-filled), and read by the wgmma
// descriptors K-major or MN-major as they arrived. A block is one
// warpgroup (128 threads) and one 64-row tile.
// - dk/dv pass: a block owns one KV head's 64-key tile; K and V stay in
//   shared memory. It walks the G query heads of the group and, for each,
//   the query tiles of the band (from the diagonal on, up to the window's
//   edge): the GQA sum, without atomics. Per query tile: S^T = K Q^T and
//   dP^T = V dO^T (m64n64k16, both operands in shared memory, K-major:
//   the forward's QK^T with the roles swapped); P^T = exp2(S^T * scale *
//   log2 e - lse * log2 e) and dS^T = P^T * (dP^T - delta) * scale on the
//   fp32 accumulators, lse and delta of the tile's 64 queries read from
//   shared memory; masks only on the diagonal tile, the window's edge tiles
//   and a ragged last query tile (rows >= S give p = 0). Then dV += P^T dO
//   and dK += dS^T Q with P^T and dS^T handed from the accumulators to the
//   A operand in registers as bf16, dO and Q read MN-major from the same
//   tiles: the forward's PV step. Q, dO, lse and delta of
//   the next query tile arrive by cp.async in a second stage while the
//   current one is multiplied. Key tile 0, with the most query tiles,
//   launches first.
// - dq pass: a block owns one query head's 64-row tile; Q, dO, its rows'
//   lse and delta stay resident. Over the key tiles of the band: S = Q K^T
//   and dP = dO V^T, P and dS as above, dQ += dS K with dS in registers and
//   K read MN-major (m64nHDk16, N = 192 at MLA's head dim). K and V are
//   double-buffered. The heaviest query tile launches first.
// - Registers: at (128, 128) a dk/dv thread holds dK and dV (64 + 64
//   fp32), S^T and dP^T (32 + 32) and the packed fragments; ptxas gives it
//   255 registers and no spill. At (192, 128) dK is 96: there each 64-query
//   tile runs as two halves of 32 in turn (S^T and dP^T m64n32k16, 16 + 16
//   registers; the halves not unrolled, so that one's registers are free
//   before the next), and dK stays whole in registers (255, no spill).
//   Halves that ptxas could interleave spilled 64-72 bytes; dK's columns
//   128-191 in an fp32 shared-memory accumulator spilled 44 with whole
//   tiles. Shared memory: 98 KB a dk/dv block at (128, 128), so two blocks
//   share an SM; 122 KB at (192, 128), one.
// - Rounding: dS is rounded to bf16 before the dK and dQ products, as
//   B2's forward rounds P before PV. P goes to the dV product as two bf16
//   parts, hi = bf16(P) and lo = bf16(P - hi), one more product a tile:
//   rounded once, P alone put dv 0.0209 of max(1, |ref|) off the fp32
//   reference on a card test (hd 32, G 6, S 63), past the bf16 tolerance
//   of 2e-2, where dS's rounding keeps dk and dq within 0.017. The
//   reference and the plain version keep both fp32.
// Not yet: TMA copies under mbarriers, warp specialisation (a producer
// warp and two consumer warpgroups), overlap of one tile's elementwise
// work with the next tile's products, a persistent grid.
//
// fp32 (`flash_bwd_dkdv_kernel<HD, HDV>` and `flash_bwd_dq_kernel<HD,
// HDV>`, the FMA route): the same two passes on the CUDA cores. Tiles sit
// in shared memory as fp32 rows padded by one word; 256 threads, each
// holding a 4 x 4 block of scores and 4 rows x hd/16 columns of its sums.
// At hd 128 a block holds 162 KB; at (192, 128) the dk/dv pass holds two
// [64][193] and two [64][129] tiles and two score tiles, 194 KB, and the
// dq pass 178 KB, inside the 227 KB a block may opt into. The tests, the
// fp32 model-gradient checks and the card-vs-CPU gradients hold it to
// 2e-5, which bf16 tensor-core products would not.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BT = 64;        // rows of a query tile and keys of a key tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RPT = 4;        // tile rows per thread (BT / 16)
constexpr int PST = BT + 1;   // padded row of a score tile

// rows [row0, row0 + BT) of a [S, HD] slab into a [BT][HD + 1] tile; rows
// past S zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int S) {
  constexpr int ST = HD + 1;
  for (int i = threadIdx.x; i < BT * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int pos = row0 + r;
    dst[r * ST + d] = pos < S ? src[(size_t)pos * HD + d] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int window) {
  bool ok = kpos <= qpos && qpos < S;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// grid (ceil(S / BT), KV, B); block THREADS; dynamic shared memory:
//   k_s, q_s [BT][HD + 1] | v_s, do_s [BT][HDV + 1] | p_s, ds_s [BT][BT + 1]
//   (key-major) | lse_s, dl_s [BT]
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int KV, int S, int window, float scale) {
  constexpr int ST = HD + 1, SV = HDV + 1;
  constexpr int NC = HD / 16, NV = HDV / 16;  // sum columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;
  float* q_s = k_s + BT * ST;
  float* v_s = q_s + BT * ST;
  float* do_s = v_s + BT * SV;
  float* p_s = do_s + BT * SV;
  float* ds_s = p_s + BT * PST;
  float* lse_s = ds_s + BT * PST;
  float* dl_s = lse_s + BT;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int k_lo = kt * BT;
  const int nq = (S + BT - 1) / BT;
  // query tiles that see a key of this tile: from the diagonal on, and
  // with a window up to the last row whose band reaches the tile
  int qt_hi = nq - 1;
  if (window > 0) qt_hi = min(qt_hi, (k_lo + BT - 1 + window - 1) / BT);

  const size_t kv_off = ((size_t)b * KV + kvh) * (size_t)S * HD;
  const size_t vv_off = ((size_t)b * KV + kvh) * (size_t)S * HDV;
  load_tile<HD>(k_s, k + kv_off, k_lo, S);
  load_tile<HDV>(v_s, v + vv_off, k_lo, S);

  float acc_k[RPT][NC], acc_v[RPT][NV];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) acc_v[i][c] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_off = ((size_t)b * H + h) * (size_t)S * HD;
    const size_t o_off = ((size_t)b * H + h) * (size_t)S * HDV;
    const float* lse_bh = lse + ((size_t)b * H + h) * S;
    const float* dl_bh = delta + ((size_t)b * H + h) * S;
    for (int qt = kt; qt <= qt_hi; ++qt) {
      const int q_lo = qt * BT;
      __syncthreads();  // the previous tile's sums have read q_s, do_s
      load_tile<HD>(q_s, q + q_off, q_lo, S);
      load_tile<HDV>(do_s, dout + o_off, q_lo, S);
      if (tid < BT) {
        const int qpos = q_lo + tid;
        lse_s[tid] = qpos < S ? lse_bh[qpos] : 0.f;
        dl_s[tid] = qpos < S ? dl_bh[qpos] : 0.f;
      }
      __syncthreads();

      // scores and dp, transposed: keys ty*4 + i, queries tx + 16 j; at a
      // square head dim one loop over d, as in the first version of this
      // kernel, so that its bits stay
      float s[RPT][4], dp[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      if constexpr (HD == HDV) {
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
          float kv_[RPT], vv[RPT], qv[4], dov[4];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            kv_[i] = k_s[(ty * RPT + i) * ST + d];
            vv[i] = v_s[(ty * RPT + i) * SV + d];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qv[j] = q_s[(tx + 16 * j) * ST + d];
            dov[j] = do_s[(tx + 16 * j) * SV + d];
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(kv_[i], qv[j], s[i][j]);
              dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
            }
        }
      } else {
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
          float kv_[RPT], qv[4];
#pragma unroll
          for (int i = 0; i < RPT; ++i) kv_[i] = k_s[(ty * RPT + i) * ST + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) qv[j] = q_s[(tx + 16 * j) * ST + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(kv_[i], qv[j], s[i][j]);
        }
#pragma unroll 4
        for (int d = 0; d < HDV; ++d) {
          float vv[RPT], dov[4];
#pragma unroll
          for (int i = 0; i < RPT; ++i) vv[i] = v_s[(ty * RPT + i) * SV + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) dov[j] = do_s[(tx + 16 * j) * SV + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int kr = ty * RPT + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const bool ok = visible(q_lo + qr, k_lo + kr, S, window);
          const float p = ok ? expf(s[i][j] * scale - lse_s[qr]) : 0.f;
          p_s[kr * PST + qr] = p;
          ds_s[kr * PST + qr] = p * (dp[i][j] - dl_s[qr]) * scale;
        }
      }
      __syncthreads();

      // dv += p^T dout, dk += ds^T q: keys ty*4 + i, columns tx + 16 c
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        float pv[RPT], dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = p_s[(ty * RPT + i) * PST + r];
          dsv[i] = ds_s[(ty * RPT + i) * PST + r];
        }
        if constexpr (HD == HDV) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float dov = do_s[r * SV + tx + 16 * c];
            const float qv = q_s[r * ST + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
              acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            const float dov = do_s[r * SV + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
              acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float qv = q_s[r * ST + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
              acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kpos = k_lo + ty * RPT + i;
    if (kpos >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dk[kv_off + (size_t)kpos * HD + tx + 16 * c] = acc_k[i][c];
#pragma unroll
    for (int c = 0; c < NV; ++c)
      dv[vv_off + (size_t)kpos * HDV + tx + 16 * c] = acc_v[i][c];
  }
}

// grid (ceil(S / BT), H, B), the query tile reversed from blockIdx.x;
// block THREADS; dynamic shared memory:
//   q_s, k_s [BT][HD + 1] | do_s, v_s [BT][HDV + 1] | ds_s [BT][BT + 1] |
//   lse_s, dl_s [BT]
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int KV, int S,
                        int window, float scale) {
  constexpr int ST = HD + 1, SV = HDV + 1;
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BT * ST;
  float* do_s = k_s + BT * ST;
  float* v_s = do_s + BT * SV;
  float* ds_s = v_s + BT * SV;
  float* lse_s = ds_s + BT * PST;
  float* dl_s = lse_s + BT;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q_lo = qt * BT;
  const int lowest = q_lo - window + 1;  // first key any row of the tile sees
  const int kt_lo = (window > 0 && lowest > 0) ? lowest / BT : 0;

  const size_t q_off = ((size_t)b * H + h) * (size_t)S * HD;
  const size_t o_off = ((size_t)b * H + h) * (size_t)S * HDV;
  const size_t kv_off = ((size_t)b * KV + kvh) * (size_t)S * HD;
  const size_t vv_off = ((size_t)b * KV + kvh) * (size_t)S * HDV;
  load_tile<HD>(q_s, q + q_off, q_lo, S);
  load_tile<HDV>(do_s, dout + o_off, q_lo, S);
  if (tid < BT) {
    const int qpos = q_lo + tid;
    lse_s[tid] = qpos < S ? lse[((size_t)b * H + h) * S + qpos] : 0.f;
    dl_s[tid] = qpos < S ? delta[((size_t)b * H + h) * S + qpos] : 0.f;
  }

  float acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_lo; kt <= qt; ++kt) {
    const int k_lo = kt * BT;
    __syncthreads();  // the previous tile's sums have read k_s, ds_s
    load_tile<HD>(k_s, k + kv_off, k_lo, S);
    load_tile<HDV>(v_s, v + vv_off, k_lo, S);
    __syncthreads();

    // scores and dp: queries ty*4 + i, keys tx + 16 j (one loop over d at
    // a square head dim, as in the first version)
    float s[RPT][4], dp[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    if constexpr (HD == HDV) {
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[RPT], dov[RPT], kv_[4], vv[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          qv[i] = q_s[(ty * RPT + i) * ST + d];
          dov[i] = do_s[(ty * RPT + i) * SV + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv_[j] = k_s[(tx + 16 * j) * ST + d];
          vv[j] = v_s[(tx + 16 * j) * SV + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv_[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
    } else {
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[RPT], kv_[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty * RPT + i) * ST + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv_[j] = k_s[(tx + 16 * j) * ST + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv_[j], s[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < HDV; ++d) {
        float dov[RPT], vv[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dov[i] = do_s[(ty * RPT + i) * SV + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = v_s[(tx + 16 * j) * SV + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qr = ty * RPT + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const bool ok = visible(q_lo + qr, k_lo + kc, S, window);
        const float p = ok ? expf(s[i][j] * scale - lse_s[qr]) : 0.f;
        ds_s[qr * PST + kc] = p * (dp[i][j] - dl_s[qr]) * scale;
      }
    }
    __syncthreads();

    // dq += ds k: queries ty*4 + i, columns tx + 16 c
#pragma unroll 2
    for (int c2 = 0; c2 < BT; ++c2) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = ds_s[(ty * RPT + i) * PST + c2];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv_ = k_s[c2 * ST + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(dsv[i], kv_, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q_lo + ty * RPT + i;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[q_off + (size_t)qpos * HD + tx + 16 * c] = acc[i][c];
  }
}

template <int HD, int HDV>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int H, int KV, int S, int window, float scale,
               cudaStream_t stream) {
  // two [BT][HD + 1] and two [BT][HDV + 1] tiles, two (dkdv) or one (dq)
  // score tiles, two rows: 165,888 bytes for dkdv at hd 128, 198,656 at
  // (192, 128)
  const size_t tiles = (size_t)2 * BT * (HD + 1) + (size_t)2 * BT * (HDV + 1)
                       + 2 * BT;
  const size_t smem_kv = sizeof(float) * (tiles + 2 * (size_t)BT * PST);
  const size_t smem_q = sizeof(float) * (tiles + (size_t)BT * PST);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const int nt = (S + BT - 1) / BT;
  flash_bwd_dkdv_kernel<HD, HDV>
      <<<dim3(nt, KV, B), THREADS, smem_kv, stream>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)dout, lse, delta, (float*)dk, (float*)dv, H, KV, S,
          window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<HD, HDV><<<dim3(nt, H, B), THREADS, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, H, KV, S, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warpgroup products (wgmma) on 128-byte swizzled tiles
// ---------------------------------------------------------------------------

constexpr int TC_BT = 64;   // rows of a query tile and keys of a key tile
constexpr int TC_PAD = 8;   // bf16 (16 bytes) per staged output row
constexpr float LOG2E = 1.4426950408889634f;

// 4-byte global -> shared copy; src_bytes 0 fills the word with zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// lse and delta of rows [row0, row0 + 64) of one head into dst[0, 64) and
// dst[64, 128): a thread a word; rows >= S zero-filled
__device__ __forceinline__ void load_rows(float* dst, const float* lse,
                                          const float* delta, int row0,
                                          int S, int tid) {
  const int pos = row0 + (tid & 63);
  const float* src = (tid < 64 ? lse : delta) + (pos < S ? pos : S - 1);
  cp_async4(dst + tid, src, pos < S ? 4 : 0);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_m64n32k16_ss(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_m64n64k16_ss(d, da, db, scale_d);
}

// a tile read K-major (`kmajor`) or MN-major (`mnmajor`) from shared
// memory, as a wgmma descriptor; an offset of n bytes into the tile adds
// n / 16 to it
__device__ __forceinline__ uint64_t kmajor(const void* tile) {
  return sw128_desc(tile, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(const void* tile) {
  return sw128_desc(tile, SW_BLOCK, 1024);
}

// d[64 x N] = A[64 x D] B[N x D]^T, the rows of two tiles read K-major
// (descriptors `da`, `db`): D / 16 k-steps, 32 bytes apart in a swizzled
// row, the next 64 columns one block further
template <int D, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int off = ((ks / 4) * SW_BLOCK + (ks % 4) * 32) >> 4;
    wgmma_ss<N>(d, da + off, db + off, ks > 0);
  }
}

// d[64 x N] += A[64 x K] B[K x N]: A as bf16 fragments in registers
// (`to_frags`), B K rows of a tile read MN-major (descriptor `db`), 16
// rows (2048 bytes) a step
template <int N, int K>
__device__ __forceinline__ void product_rs(float (&d)[N / 2],
                                           const uint32_t (&a)[K / 16][4],
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_pv<N>(d, a[kk], db + ((kk * 2048) >> 4));
}

// a 64 x N fp32 accumulator as the bf16 A operand of a product N deep:
// columns 16 kk .. 16 kk + 15 are k-step kk
template <int N>
__device__ __forceinline__ void to_frags(const float (&x)[N / 2],
                                         uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    f[j / 2][(j & 1) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    f[j / 2][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// the same accumulator as two bf16 operands, hi = bf16(x) and lo =
// bf16(x - hi): hi + lo carries x to ~16 bits
template <int N>
__device__ __forceinline__ void to_frags2(const float (&x)[N / 2],
                                          uint32_t (&hi)[N / 16][4],
                                          uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = x[4 * j + 2 * h], b = x[4 * j + 2 * h + 1];
      const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
      const float2 rf = __bfloat1622float2(r);
      hi[j / 2][(j & 1) * 2 + h] = *reinterpret_cast<const uint32_t*>(&r);
      lo[j / 2][(j & 1) * 2 + h] = pack_bf16(a - rf.x, b - rf.y);
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// a warpgroup's 64 x N fp32 accumulator into `stage` as bf16 rows of
// `stride` elements: each warp its 16 rows
template <int N>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* stage, int stride,
                                           const float (&acc)[N / 2],
                                           int warp, int lane) {
  __nv_bfloat16* rows = stage + warp * 16 * stride;
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<uint32_t*>(rows + (lane >> 2) * stride + j * 8 + col) =
        pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(rows + ((lane >> 2) + 8) * stride + j * 8 +
                                 col) = pack_bf16(acc[4 * j + 2],
                                                  acc[4 * j + 3]);
  }
}

// a warp's 16 staged rows of D bf16 to rows row0 + warp * 16 .. of a
// [S, D] slab as 16-byte stores; rows >= S dropped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* stage,
                                           int stride, int row0, int S,
                                           int warp, int lane) {
  constexpr int CPR = D / 8;
  const __nv_bfloat16* rows = stage + warp * 16 * stride;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    const int pos = row0 + warp * 16 + r;
    if (pos < S)
      *reinterpret_cast<uint4*>(dst + (size_t)pos * D + c * 8) =
          *reinterpret_cast<const uint4*>(rows + r * stride + c * 8);
  }
}

// grid (KV, B, ceil(S / 64)), key tile blockIdx.z (tile 0 has the most
// query tiles); one warpgroup (TC_THREADS); dynamic shared memory,
// 1024-byte aligned:
//   k [NB] | v [NBV] | q [2][NB] | dout [2][NBV] | lse, delta [2][2][64]
//   fp32
// NB = sw_blocks(HD), NBV = sw_blocks(HDV) blocks of SW_BLOCK bytes
template <int HD, int HDV>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int KV,
                               int S, int window, float scale) {
  constexpr int TILE = sw_blocks(HD) * SW_BLOCK;
  constexpr int VTILE = sw_blocks(HDV) * SW_BLOCK;
  // queries a product step takes: half a tile where dK is 96 registers
  constexpr int QW = HD > 128 ? 32 : 64;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* k_s = base;
  unsigned char* v_s = k_s + TILE;
  unsigned char* q_s = v_s + VTILE;
  unsigned char* do_s = q_s + 2 * TILE;
  float* rows_s = reinterpret_cast<float*>(do_s + 2 * VTILE);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k_lo = kt * TC_BT;
  // query tiles that see a key of this tile: from the diagonal on, and
  // with a window up to the last row whose band reaches the tile
  int qt_hi = (S + TC_BT - 1) / TC_BT - 1;
  if (window > 0) qt_hi = min(qt_hi, (k_lo + TC_BT - 1 + window - 1) / TC_BT);
  const int nqt = qt_hi - kt + 1;
  const int n_it = G * nqt;  // (query head, query tile) pairs, head-major

  const size_t kv_bh = (size_t)b * KV + kvh;
  // stage `buf` <- Q, dO, lse and delta of step `it`
  auto fetch = [&](int it, int buf) {
    const size_t bh = (size_t)b * H + kvh * G + it / nqt;
    const int q_lo = (kt + it % nqt) * TC_BT;
    load_tile_sw<HD>(q_s + buf * TILE, q + bh * S * HD, q_lo, S, tid);
    load_tile_sw<HDV>(do_s + buf * VTILE, dout + bh * S * HDV, q_lo, S, tid);
    load_rows(rows_s + buf * 2 * TC_BT, lse + bh * S, delta + bh * S, q_lo,
              S, tid);
  };
  load_tile_sw<HD>(k_s, k + kv_bh * S * HD, k_lo, S, tid);
  load_tile_sw<HDV>(v_s, v + kv_bh * S * HDV, k_lo, S, tid);
  fetch(0, 0);
  cp_async_commit();

  // this thread's accumulator rows (keys kr0, kr0 + 8) and first column
  // (query) in each 8-column group
  const int kr0 = warp * 16 + (lane >> 2);
  const int col = (lane & 3) * 2;
  const float scale_log2 = scale * LOG2E;

  float dk_acc[HD / 2], dv_acc[HDV / 2];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    // the copies were generic-proxy writes; wgmma reads through the async
    // proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (it + 1 < n_it) {
      fetch(it + 1, buf ^ 1);
      cp_async_commit();
    }
    const float* lse_b = rows_s + buf * 2 * TC_BT;
    const float* dl_b = lse_b + TC_BT;
    const int qt = kt + it % nqt;
    const int q_lo = qt * TC_BT;
    const bool masked = qt == kt || q_lo + TC_BT > S ||
                        (window > 0 && k_lo <= q_lo + TC_BT - 1 - window);
    // the halves in turn, not interleaved: their registers would not fit
#pragma unroll 1
    for (int q0 = 0; q0 < TC_BT; q0 += QW) {
      // queries q0 .. q0 + QW - 1 of the tile: rows of the Q and dO stages
      const unsigned char* qb = q_s + buf * TILE + q0 * SW_ROW;
      const unsigned char* dob = do_s + buf * VTILE + q0 * SW_ROW;

      // S^T = K Q^T, dP^T = V dO^T: rows keys, columns queries
      float st[QW / 2], dpt[QW / 2];
      zero(st);
      zero(dpt);
      wgmma_fence();
      product_ss<HD, QW>(st, kmajor(k_s), kmajor(qb));
      product_ss<HDV, QW>(dpt, kmajor(v_s), kmajor(dob));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

#pragma unroll
      for (int j = 0; j < QW / 8; ++j) {
        const int qc = q0 + j * 8 + col;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_b + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_b + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float l = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          float p = exp2f(fmaf(st[i], scale_log2, -l * LOG2E));
          if (masked) {
            const int qpos = q_lo + qc + (e & 1);
            const int kpos = k_lo + kr0 + (e & 2) * 4;
            bool ok = kpos <= qpos && qpos < S;
            if (window > 0) ok = ok && kpos > qpos - window;
            p = ok ? p : 0.f;
          }
          st[i] = p;
          dpt[i] = p * (dpt[i] - dl) * scale;
        }
      }
      uint32_t ph[QW / 16][4], pl[QW / 16][4], dsf[QW / 16][4];
      to_frags2<QW>(st, ph, pl);
      to_frags<QW>(dpt, dsf);

      // dV += P^T dO in two parts (P^T = hi + lo), dK += dS^T Q
      wgmma_fence();
      product_rs<HDV, QW>(dv_acc, ph, mnmajor(dob));
      product_rs<HDV, QW>(dv_acc, pl, mnmajor(dob));
      product_rs<HD, QW>(dk_acc, dsf, mnmajor(qb));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
  }

  // stage dK in the Q stages and dV in the dO stages (free once every
  // product is done), then write them out as 16-byte rows
  __syncthreads();
  constexpr int KST = HD + TC_PAD, VST = HDV + TC_PAD;
  __nv_bfloat16* dk_st = reinterpret_cast<__nv_bfloat16*>(q_s);
  __nv_bfloat16* dv_st = reinterpret_cast<__nv_bfloat16*>(do_s);
  stage_rows<HD>(dk_st, KST, dk_acc, warp, lane);
  stage_rows<HDV>(dv_st, VST, dv_acc, warp, lane);
  __syncwarp();
  store_rows<HD>(dk + kv_bh * S * HD, dk_st, KST, k_lo, S, warp, lane);
  store_rows<HDV>(dv + kv_bh * S * HDV, dv_st, VST, k_lo, S, warp, lane);
}

// grid (H, B, ceil(S / 64)), the query tile reversed from blockIdx.z
// (heaviest first); one warpgroup (TC_THREADS); dynamic shared memory,
// 1024-byte aligned:
//   q [NB] | dout [NBV] | k [2][NB] | v [2][NBV]
template <int HD, int HDV>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int H, int KV,
                             int S, int window, float scale) {
  constexpr int TILE = sw_blocks(HD) * SW_BLOCK;
  constexpr int VTILE = sw_blocks(HDV) * SW_BLOCK;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* q_s = base;
  unsigned char* do_s = q_s + TILE;
  unsigned char* k_s = do_s + VTILE;
  unsigned char* v_s = k_s + 2 * TILE;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tile first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q_lo = qt * TC_BT;
  // key tiles of the band: kt_lo up to the diagonal tile qt
  const int lowest = q_lo - window + 1;  // first key any row of the tile sees
  const int kt_lo = (window > 0 && lowest > 0) ? lowest / TC_BT : 0;
  const int n_tiles = qt - kt_lo + 1;

  const size_t bh = (size_t)b * H + h;
  const size_t kv_bh = (size_t)b * KV + kvh;
  const __nv_bfloat16* k_bh = k + kv_bh * S * HD;
  const __nv_bfloat16* v_bh = v + kv_bh * S * HDV;
  load_tile_sw<HD>(q_s, q + bh * S * HD, q_lo, S, tid);
  load_tile_sw<HDV>(do_s, dout + bh * S * HDV, q_lo, S, tid);
  load_tile_sw<HD>(k_s, k_bh, kt_lo * TC_BT, S, tid);
  load_tile_sw<HDV>(v_s, v_bh, kt_lo * TC_BT, S, tid);
  cp_async_commit();

  // this thread's rows (queries) and first column (key) in each group
  const int row0 = q_lo + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int col = (lane & 3) * 2;
  const float scale_log2 = scale * LOG2E;
  // rows >= S compute on zero-filled q and dout and are not written
  const float* lse_bh = lse + bh * S;
  const float* dl_bh = delta + bh * S;
  const float l0 = row0 < S ? lse_bh[row0] * LOG2E : 0.f;
  const float l1 = row1 < S ? lse_bh[row1] * LOG2E : 0.f;
  const float dl0 = row0 < S ? dl_bh[row0] : 0.f;
  const float dl1 = row1 < S ? dl_bh[row1] : 0.f;

  float dq_acc[HD / 2];
  zero(dq_acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt_lo + it;
    const int buf = it & 1;
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile_sw<HD>(k_s + (buf ^ 1) * TILE, k_bh, (kt + 1) * TC_BT, S,
                       tid);
      load_tile_sw<HDV>(v_s + (buf ^ 1) * VTILE, v_bh, (kt + 1) * TC_BT, S,
                        tid);
      cp_async_commit();
    }
    const unsigned char* kb = k_s + buf * TILE;
    const unsigned char* vb = v_s + buf * VTILE;

    // S = Q K^T, dP = dO V^T: rows queries, columns keys
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wgmma_fence();
    product_ss<HD, 64>(s, kmajor(q_s), kmajor(kb));
    product_ss<HDV, 64>(dp, kmajor(do_s), kmajor(vb));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const int k_lo = kt * TC_BT;
    const bool masked = kt == qt ||
                        (window > 0 && k_lo <= q_lo + TC_BT - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = exp2f(fmaf(s[i], scale_log2, -(e < 2 ? l0 : l1)));
        if (masked) {
          const int kpos = k_lo + j * 8 + col + (e & 1);
          const int qpos = e < 2 ? row0 : row1;
          bool ok = kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          p = ok ? p : 0.f;
        }
        dp[i] = p * (dp[i] - (e < 2 ? dl0 : dl1)) * scale;
      }
    }
    uint32_t dsf[4][4];
    to_frags<64>(dp, dsf);

    // dQ += dS K
    wgmma_fence();
    product_rs<HD, 64>(dq_acc, dsf, mnmajor(kb));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
  }

  // stage dQ in the K stages (free once every product is done), then
  // write it out as 16-byte rows
  __syncthreads();
  constexpr int QST = HD + TC_PAD;
  __nv_bfloat16* dq_st = reinterpret_cast<__nv_bfloat16*>(k_s);
  stage_rows<HD>(dq_st, QST, dq_acc, warp, lane);
  __syncwarp();
  store_rows<HD>(dq + bh * S * HD, dq_st, QST, q_lo, S, warp, lane);
}

template <int HD, int HDV>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int B, int H, int KV, int S,
                int window, float scale, cudaStream_t stream) {
  constexpr int NB = sw_blocks(HD), NBV = sw_blocks(HDV);
  // dk/dv: k, v, two q and two dout stages, two stages of lse and delta,
  // the 1024-byte alignment: 100,352 bytes at (128, 128), 124,928 at (192,
  // 128). dq: q, dout, two k and two v stages: 99,328 and 123,904
  const size_t smem_kv = (size_t)(3 * NB + 3 * NBV) * SW_BLOCK +
                         2 * 2 * TC_BT * sizeof(float) + 1024;
  const size_t smem_q = (size_t)(3 * NB + 3 * NBV) * SW_BLOCK + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const int nt = (S + TC_BT - 1) / TC_BT;
  typedef const __nv_bfloat16* In;
  typedef __nv_bfloat16* Out;
  flash_bwd_dkdv_bf16_kernel<HD, HDV>
      <<<dim3(KV, B, nt), TC_THREADS, smem_kv, stream>>>(
          (In)q, (In)k, (In)v, (In)dout, lse, delta, (Out)dk, (Out)dv, H, KV,
          S, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_bf16_kernel<HD, HDV>
      <<<dim3(H, B, nt), TC_THREADS, smem_q, stream>>>(
          (In)q, (In)k, (In)v, (In)dout, lse, delta, (Out)dq, H, KV, S,
          window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,H,S,hd]; k [B,KV,S,hd]; v [B,KV,S,hd_v]; dout [B,H,S,hd_v]; lse,
// delta [B,H,S] float32; dq, dk, dv as q, k, v. dtype: 0 = float32 (the
// FMA kernels), 1 = bfloat16 (the tensor-core kernels; q, k, v, dout
// 16-byte aligned); (hd, hd_v) one of (16, 16), (32, 32), (64, 64), (128,
// 128), (192, 128). Two kernels on `stream`: dk/dv, then dq. Returns a
// cudaError_t (0 = success).
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int H, int KV, int S, int hd, int hd_v,
              int window, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV == 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
#define FLASH_BWD_CASE(A, BV)                                                \
  if (hd == A && hd_v == BV)                                                 \
    return dtype == 0                                                        \
               ? launch_f32<A, BV>(q, k, v, dout, l, dl, dq, dk, dv, B, H,   \
                                   KV, S, window, scale, st)                 \
               : launch_bf16<A, BV>(q, k, v, dout, l, dl, dq, dk, dv, B, H,  \
                                    KV, S, window, scale, st);
  FLASH_BWD_CASE(16, 16)
  FLASH_BWD_CASE(32, 32)
  FLASH_BWD_CASE(64, 64)
  FLASH_BWD_CASE(128, 128)
  FLASH_BWD_CASE(192, 128)
#undef FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
