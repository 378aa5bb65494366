// Paged decode attention for Hopper (sm_90a): one new token per slot
// attends to its K/V through a page table.
//
// Replaces: the Pallas TPU kernel `_paged_decode_pallas` / `_pd_kernel`
// (src/repro/kernels/paged_attention.py). Same function: single-token GQA
// attention, pools [NP, page, KV, hd], table [B, MP] int32, lengths [B]
// int32, fp32 online softmax, positions >= length masked with -1e30, a
// row with no valid position returns 0 (the l == 0 guard).
//
// What bounds it on this card: device-memory bytes. Each live K/V token
// is read once and used for G = H/KV dot products of hd terms, about one
// flop per byte, far below the ~295 flop/byte where the H100's tensor
// cores would become the limit. Bound = (live K/V bytes + q + out + table)
// / 3.35 TB/s.
//
// What the design does about it: one block per (slot, kv head), so the G
// query heads sharing a KV head read each K/V page once (KV is never
// expanded to H heads). Each block walks only the slot's live pages,
// min(ceil(len / page), MP) of them, reading its own table entries, so
// work scales with the live length and never reads the table past MP (a
// parked slot may keep a length longer than a narrowed table). Page
// tiles are staged through shared memory with row-contiguous loads. This
// first version keeps to simple and correct: at qwen3-8b decode with 4
// slots the grid is only 32 blocks on 132 SMs, so splitting the sequence
// across blocks (split-K) is the next step for bandwidth.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// grid (KV, B); block THREADS; dynamic shared memory laid out as
//   q_s [G][hd] | k_s [page][hd + 1] | v_s [page][hd] | p_s [G][page]
//   | acc_s [G][hd] | m_s [G] | l_s [G] | corr_s [G]
template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pages,
                                    const T* __restrict__ v_pages,
                                    const int32_t* __restrict__ table,
                                    const int32_t* __restrict__ lengths,
                                    T* __restrict__ out, int H, int KV,
                                    int hd, int page, int MP, float scale) {
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int kst = hd + 1;  // padded K row: dot products walk rows, not banks

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * hd;
  float* v_s = k_s + page * kst;
  float* p_s = v_s + page * hd;
  float* acc_s = p_s + G * page;
  float* m_s = acc_s + G * hd;
  float* l_s = m_s + G;
  float* corr_s = l_s + G;

  const T* q_b = q + ((size_t)b * H + (size_t)kv * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) {
    q_s[i] = to_f(q_b[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  const int len = lengths[b];
  int n_pages = len > 0 ? (len + page - 1) / page : 0;
  if (n_pages > MP) n_pages = MP;

  for (int p = 0; p < n_pages; ++p) {
    const int pid = table[(size_t)b * MP + p];
    __syncthreads();  // previous tile fully consumed (and init visible)
    const size_t page_base = (size_t)pid * page * KV * hd;
    for (int i = tid; i < page * hd; i += THREADS) {
      const int t = i / hd, d = i % hd;
      const size_t off = page_base + ((size_t)t * KV + kv) * hd + d;
      k_s[t * kst + d] = to_f(k_pages[off]);
      v_s[t * hd + d] = to_f(v_pages[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * page; i += THREADS) {
      const int g = i / page, t = i % page;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + t * kst;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (p * page + t >= len) s = NEG_INF;
      p_s[i] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
      float* row = p_s + g * page;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, row[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float e = expf(row[t] - m_new);
        row[t] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
      corr_s[g] = corr;
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd, d = i % hd;
      const float* row = p_s + g * page;
      float a = acc_s[i] * corr_s[g];
      for (int t = 0; t < page; ++t) a = fmaf(row[t], v_s[t * hd + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();
  T* o_b = out + ((size_t)b * H + (size_t)kv * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) {
    const float l = l_s[i / hd];
    from_f(acc_s[i] / (l == 0.f ? 1.f : l), o_b + i);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, void* out, int B, int H,
           int KV, int hd, int page, int MP, float scale,
           cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * ((size_t)G * hd + (size_t)page * (hd + 1) +
                       (size_t)page * hd + (size_t)G * page +
                       (size_t)G * hd + 3 * (size_t)G);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages,
      (const int32_t*)table, (const int32_t*)lengths, (T*)out, H, KV, hd,
      page, MP, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* lengths, void* out, int B,
                 int H, int KV, int hd, int page, int MP, float scale,
                 int dtype, void* stream) {
  if (B == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, lengths, out, B, H, KV,
                         hd, page, MP, scale, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out, B,
                                 H, KV, hd, page, MP, scale,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
