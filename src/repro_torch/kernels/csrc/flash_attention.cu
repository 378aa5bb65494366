// Causal flash attention forward for Hopper (sm_90a), native GQA,
// optional sliding window.
//
// Replaces: the Pallas TPU kernel `flash_attention` / `_fa_kernel`
// (src/repro/kernels/flash_attention.py). Same function: q [B,H,S,hd],
// k/v [B,KV,S,hd] -> [B,H,S,hd], head h reads KV head h / (H/KV), mask
// kpos <= qpos (and kpos > qpos - window when window > 0), fp32 online
// softmax, masked scores -1e30, a row with no valid key returns 0. In the
// port it takes the role of the prefill attention that the JAX model
// computes with the jnp pair-list scan (models/attention.py).
//
// What bounds it on this card: operations. At qwen3-8b prompt lengths
// (hundreds to thousands of tokens, hd 128) causal attention does about
// 2*S^2*hd*H flops on (4*S*hd*H) * 2 bytes, hundreds of flops per byte, so
// the limit is the 989 TFLOP/s bf16 tensor-core rate.
//
// What the design does about it, in this first version: it keeps all the
// work of a 64-row query tile on chip. The Q tile stays resident in shared
// memory while the block walks the K/V tiles of the causal (and sliding
// window) band only, so S^2/2 rather than S^2 work is done and scores never
// reach device memory. Each of the 128 threads owns an 8 x 4 block of the
// score tile and an 8 x (hd/16) block of the output, accumulating in fp32
// registers with FMA; row statistics are reduced with warp shuffles. Ragged
// edges are masked in the kernel (kpos < S, qpos < S), so S needs no
// padding. The products run on the CUDA cores, not the tensor cores: moving
// QK^T and PV onto mma/wgmma with TMA-fed tiles is the work that closes the
// gap to the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128; // 8 row groups x 16 column lanes
constexpr int RPT = 8;       // rows per thread
constexpr int CPT = 4;       // score columns per thread (BK / 16)
constexpr int MAX_OCOL = 8;  // output columns per thread (hd / 16 <= 8)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

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
//   q_s [BQ][hd + 1] | k_s [BK][hd + 1] | v_s [BK][hd] | p_s [BQ][BK + 1]
template <typename T>
__global__ void flash_fwd_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ out,
                                 int H, int KV, int S, int hd, int window,
                                 float scale) {
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // row group: rows ty*RPT .. ty*RPT+RPT-1
  const int tx = tid % 16;  // column lane: columns tx + 16*j
  const int ncol = hd / 16;
  const int qst = hd + 1, kst = hd + 1, pst = BK + 1;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * qst;
  float* v_s = k_s + BK * kst;
  float* p_s = v_s + BK * hd;

  const int q_lo = qt * BQ;
  const T* q_bh = q + ((size_t)b * H + h) * (size_t)S * hd;
  const T* k_bh = k + ((size_t)b * KV + kvh) * (size_t)S * hd;
  const T* v_bh = v + ((size_t)b * KV + kvh) * (size_t)S * hd;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    const int qpos = q_lo + r;
    q_s[r * qst + d] = qpos < S ? to_f(q_bh[(size_t)qpos * hd + d]) : 0.f;
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
      const bool in = kpos < S;
      k_s[c * kst + d] = in ? to_f(k_bh[(size_t)kpos * hd + d]) : 0.f;
      v_s[c * hd + d] = in ? to_f(v_bh[(size_t)kpos * hd + d]) : 0.f;
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
        vv[j] = j < ncol ? v_s[c * hd + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pv = p_s[(ty * RPT + i) * pst + c];
#pragma unroll
        for (int j = 0; j < MAX_OCOL; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
  }

  T* o_bh = out + ((size_t)b * H + h) * (size_t)S * hd;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q_lo + ty * RPT + i;
    if (qpos >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < MAX_OCOL; ++j)
      if (j < ncol)
        from_f(acc[i][j] * inv, o_bh + (size_t)qpos * hd + tx + 16 * j);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int hd, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (hd + 1) +
                                       (size_t)BK * (hd + 1) +
                                       (size_t)BK * hd + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KV, S, hd, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. hd must be a multiple of 16, <= 128
// (the wrapper checks). Returns a cudaError_t (0 = success).
int flash_fwd(const void* q, const void* k, const void* v, void* out, int B,
              int H, int KV, int S, int hd, int window, float scale,
              int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (hd % 16 != 0 || hd > 16 * MAX_OCOL || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, KV, S, hd, window, scale,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, hd, window, scale,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
