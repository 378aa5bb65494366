// Causal flash attention backward for Hopper (sm_90a), native GQA,
// optional sliding window: dq, dk, dv of B2's function (flash_attention.cu).
//
// Replaces: the jnp custom VJP `_flash_bwd` (src/repro/models/attention.py)
// that the reference model's training attention differentiates through;
// it is the backward of B2, whose forward replaces the Pallas kernel of
// src/repro/kernels/flash_attention.py (no Pallas backward exists).
// Same function: from q [B,H,S,hd], k, v [B,KV,S,hd], the forward's out
// [B,H,S,hd] and natural-log lse [B,H,S] (float32), and dout [B,H,S,hd]:
//   p  = exp(scale * q k^T - lse)        (masked entries 0)
//   dv = p^T dout, dp = dout v^T, delta = rowsum(dout * out),
//   ds = p * (dp - delta) * scale, dq = ds k, dk = ds^T q,
// with head h reading KV head h / (H / KV), and dk, dv summed over the
// G = H / KV query heads of each KV head. Masks as B2's: kpos <= qpos, and
// kpos > qpos - window when window > 0. Everything is computed in fp32 and
// written in the input dtype, as the reference casts its fp32 sums at the
// end. delta is one elementwise reduction; the wrapper forms it in torch.
//
// What bounds it on this card: operations. The function needs five
// products per (query, key) pair of the band (scores, dp, dv, dk, dq),
// 2.5 times B2's two: 10 * hd flops a pair against 4 * hd. At hd 128 that
// is hundreds of flops a byte, far above where the arithmetic rate, not
// the 3.35 TB/s of device memory, decides. The two passes below do seven
// (the scores and dp once in each pass).
//
// What the design does (FlashAttention-2's two passes, no atomics, so one
// call gives the same bits every time):
// - `flash_bwd_dkdv_kernel`: a block owns one KV head's 64-key tile and
//   keeps its dk and dv in registers. It loops over the G query heads of
//   its group and, for each, over the 64-row query tiles that attend to
//   the tile (from the diagonal tile on, up to the window's edge), which
//   is the GQA sum without atomics. For each query tile it recomputes p
//   and dp from lse, forms ds, and adds p^T dout and ds^T q.
// - `flash_bwd_dq_kernel`: a block owns one query head's 64-row tile and
//   keeps dq in registers; it loops over the key tiles of the band and
//   adds ds k. Query tiles launch heaviest first.
// - Tiles sit in shared memory as fp32 rows padded by one word (bf16
//   inputs are widened on the load); 256 threads, each holding a 4 x 4
//   block of scores and 4 rows x hd/16 columns of its sums, fused
//   multiply-adds on the CUDA cores. At hd 128 a block holds 162 KB.
// Not yet: mma.sync or wgmma products on the tensor cores for bf16, TMA
// copies, a pipeline of tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // rows of a query tile and keys of a key tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RPT = 4;        // tile rows per thread (BT / 16)
constexpr int PST = BT + 1;   // padded row of a score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + BT) of a [S, HD] slab into a [BT][HD + 1] fp32 tile;
// rows past S zero-filled
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S) {
  constexpr int ST = HD + 1;
  for (int i = threadIdx.x; i < BT * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int pos = row0 + r;
    dst[r * ST + d] = pos < S ? to_f(src[(size_t)pos * HD + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int window) {
  bool ok = kpos <= qpos && qpos < S;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// grid (ceil(S / BT), KV, B); block THREADS; dynamic shared memory:
//   k_s, v_s, q_s, do_s [BT][HD + 1] | p_s, ds_s [BT][BT + 1] (key-major)
//   | lse_s, dl_s [BT]
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int KV, int S,
                          int window, float scale) {
  constexpr int ST = HD + 1;
  constexpr int NC = HD / 16;  // sum columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BT * ST;
  float* q_s = v_s + BT * ST;
  float* do_s = q_s + BT * ST;
  float* p_s = do_s + BT * ST;
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
  load_tile<T, HD>(k_s, k + kv_off, k_lo, S);
  load_tile<T, HD>(v_s, v + kv_off, k_lo, S);

  float acc_k[RPT][NC], acc_v[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_off = ((size_t)b * H + h) * (size_t)S * HD;
    const float* lse_bh = lse + ((size_t)b * H + h) * S;
    const float* dl_bh = delta + ((size_t)b * H + h) * S;
    for (int qt = kt; qt <= qt_hi; ++qt) {
      const int q_lo = qt * BT;
      __syncthreads();  // the previous tile's sums have read q_s, do_s
      load_tile<T, HD>(q_s, q + q_off, q_lo, S);
      load_tile<T, HD>(do_s, dout + q_off, q_lo, S);
      if (tid < BT) {
        const int qpos = q_lo + tid;
        lse_s[tid] = qpos < S ? lse_bh[qpos] : 0.f;
        dl_s[tid] = qpos < S ? dl_bh[qpos] : 0.f;
      }
      __syncthreads();

      // scores and dp, transposed: keys ty*4 + i, queries tx + 16 j
      float s[RPT][4], dp[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv_[RPT], vv[RPT], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv_[i] = k_s[(ty * RPT + i) * ST + d];
          vv[i] = v_s[(ty * RPT + i) * ST + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(tx + 16 * j) * ST + d];
          dov[j] = do_s[(tx + 16 * j) * ST + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv_[i], qv[j], s[i][j]);
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
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = do_s[r * ST + tx + 16 * c];
          const float qv = q_s[r * ST + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
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
    for (int c = 0; c < NC; ++c) {
      const size_t o = kv_off + (size_t)kpos * HD + tx + 16 * c;
      store(dk + o, acc_k[i][c]);
      store(dv + o, acc_v[i][c]);
    }
  }
}

// grid (ceil(S / BT), H, B), the query tile reversed from blockIdx.x;
// block THREADS; dynamic shared memory:
//   q_s, do_s, k_s, v_s [BT][HD + 1] | ds_s [BT][BT + 1] | lse_s, dl_s [BT]
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int KV, int S, int window, float scale) {
  constexpr int ST = HD + 1;
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BT * ST;
  float* k_s = do_s + BT * ST;
  float* v_s = k_s + BT * ST;
  float* ds_s = v_s + BT * ST;
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
  const size_t kv_off = ((size_t)b * KV + kvh) * (size_t)S * HD;
  load_tile<T, HD>(q_s, q + q_off, q_lo, S);
  load_tile<T, HD>(do_s, dout + q_off, q_lo, S);
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
    load_tile<T, HD>(k_s, k + kv_off, k_lo, S);
    load_tile<T, HD>(v_s, v + kv_off, k_lo, S);
    __syncthreads();

    // scores and dp: queries ty*4 + i, keys tx + 16 j
    float s[RPT][4], dp[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RPT], dov[RPT], kv_[4], vv[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = q_s[(ty * RPT + i) * ST + d];
        dov[i] = do_s[(ty * RPT + i) * ST + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv_[j] = k_s[(tx + 16 * j) * ST + d];
        vv[j] = v_s[(tx + 16 * j) * ST + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv_[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
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
      store(dq + q_off + (size_t)qpos * HD + tx + 16 * c, acc[i][c]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int B, int H, int KV, int S, int window, float scale,
           cudaStream_t stream) {
  // four [BT][HD + 1] tiles, two (dkdv) or one (dq) score tiles, two rows:
  // 165,888 bytes for dkdv at hd 128
  const size_t tiles = (size_t)4 * BT * (HD + 1) + 2 * BT;
  const size_t smem_kv = sizeof(float) * (tiles + 2 * (size_t)BT * PST);
  const size_t smem_q = sizeof(float) * (tiles + (size_t)BT * PST);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const int nt = (S + BT - 1) / BT;
  flash_bwd_dkdv_kernel<T, HD><<<dim3(nt, KV, B), THREADS, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, H, KV, S, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, HD><<<dim3(nt, H, B), THREADS, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, H, KV, S, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int B, int H, int KV, int S, int hd, int window,
              float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV,
                           S, window, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV,
                           S, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV,
                           S, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV,
                            S, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, dout [B,H,S,hd]; k, v [B,KV,S,hd]; lse, delta [B,H,S] float32; dq,
// dk, dv as q, k, v. dtype: 0 = float32, 1 = bfloat16; hd one of 16, 32,
// 64, 128. Two kernels on `stream`: dk/dv, then dq. Returns a cudaError_t
// (0 = success).
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int H, int KV, int S, int hd, int window,
              float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV == 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, dout, l, dl, dq, dk, dv, B, H, KV, S,
                            hd, window, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, dout, l, dl, dq, dk, dv, B, H,
                                    KV, S, hd, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
