// Paged decode attention for Hopper (sm_90a): one new token per slot
// attends to its K/V through a page table.
//
// Replaces: the Pallas TPU kernel `_paged_decode_pallas` / `_pd_kernel`
// (src/repro/kernels/paged_attention.py). Same function: single-token GQA
// attention, pools [NP, page, KV, hd], table [B, MP] int32, lengths [B]
// int32, fp32 online softmax, positions >= length masked, a row with no
// valid position returns 0 (the l == 0 guard).
//
// What bounds it on this card: device-memory bytes. Each live K/V token
// is read once and used for G = H/KV dot products of hd terms, about one
// flop per byte, far below the ~295 flop/byte where the H100's tensor
// cores would become the limit. Bound = (live K/V bytes + q + out + table)
// / 3.35 TB/s. CUDA-core FMAs suffice; what the card needs is enough
// loads in flight, from enough blocks.
//
// What the design does about it (flash-decoding, two kernels):
// - `paged_decode_split_kernel`, grid (splits, H / GT, B): the slot's
//   table is cut into partitions of `pp` pages, one block each, so a
//   4-slot batch gives hundreds of blocks instead of one per (slot, KV
//   head). A block attends the GT query heads that share one KV head
//   (GT = G for G in 1, 2, 4) over the live positions of its
//   partition, min(length, MP * page) capped, so it never reads the table
//   past MP and a parked slot's long length is clamped. A block whose
//   partition starts at or past that writes m = -1e30, l = 0 and reads
//   nothing.
// - Inside a block each warp takes rows (tokens) in turn: hd / (16 /
//   sizeof(T)) lanes cover one row with 16-byte loads at the pool's real
//   stride (rows of one KV head lie KV * hd apart), so a warp reads 2
//   (bf16, hd 128) to 16 rows at once, and four rows per lane group are
//   loaded before any is reduced. q for the GT heads sits in registers,
//   pre-scaled into the log2 domain; dot products are reduced with
//   shuffles and each lane group keeps its own online softmax in
//   registers. Lane groups and warps are combined once, at the end, with
//   shuffles and one pass through shared memory: no `__syncthreads` per
//   page. The block writes its partial (m, l, acc[GT][hd]) in fp32.
// - `paged_decode_reduce_kernel`, grid (H, B): rescales each partition's
//   partial by exp2(m_i - m_max), skips empty ones (l_i == 0), adds them
//   in partition order and divides by the summed l: no atomics, so the
//   card repeats bit for bit; all partitions empty (length 0) gives 0.
// The number of partitions comes from MP, page and the partition size
// alone (the wrapper), never from `lengths`: no host read, and the launch
// shape stays fixed for a captured graph.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;  // rows each lane group loads before reducing
constexpr int REDUCE_THREADS = 128;

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes of T, kept as loaded (four 32-bit words) and widened to fp32
// one element at a time where it is used
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static float get(const uint4& v, int e) {
    return __uint_as_float(word(v, e));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2i is the low half of word i; a bf16 is the top half of a float
  __device__ __forceinline__ static float get(const uint4& v, int e) {
    const uint32_t w = word(v, e / 2);
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// grid (splits, H / GT, B); block THREADS; static shared memory for the
// combine of the warps. Partials: acc [B, H, splits, HD], ml [B, H,
// splits, 2] (m in the log2 domain, l), both fp32.
template <typename T, int HD, int GT>
__global__ void __launch_bounds__(THREADS)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int32_t* __restrict__ table,
                              const int32_t* __restrict__ lengths,
                              float* __restrict__ part_acc,
                              float* __restrict__ part_ml, int H, int KV,
                              int page, int MP, int pp, float scale_log2) {
  constexpr int VN = Vec<T>::N;   // elements per 16-byte load
  constexpr int LPR = HD / VN;    // lanes per row
  constexpr int RPW = 32 / LPR;   // rows a warp covers at once
  static_assert(HD % VN == 0 && LPR <= 32 && 32 % LPR == 0, "head dim");

  __shared__ float sm_acc[WARPS][GT][HD];
  __shared__ float sm_m[WARPS][GT], sm_l[WARPS][GT];

  const int split = blockIdx.x, splits = gridDim.x;
  const int h0 = blockIdx.y * GT;
  const int b = blockIdx.z;
  const int kv = h0 / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / LPR, chunk = lane % LPR;

  int len = lengths[b];
  if (len > MP * page) len = MP * page;  // a parked slot past its table
  const int t0 = split * pp * page;
  const int t1 = min(len, t0 + pp * page);
  // partial of head h0 + g: index ((b * H + h0 + g) * splits + split)
  const size_t pbase = ((size_t)b * H + h0) * splits + split;
  if (t0 >= t1) {
    if (threadIdx.x < GT) {
      part_ml[(pbase + (size_t)threadIdx.x * splits) * 2] = NEG_INF;
      part_ml[(pbase + (size_t)threadIdx.x * splits) * 2 + 1] = 0.f;
    }
    return;
  }

  float qr[GT][VN];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < VN; ++e)
      qr[g][e] = to_f(q[((size_t)b * H + h0 + g) * HD + chunk * VN + e]) *
                 scale_log2;

  float m[GT], l[GT], acc[GT][VN];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)KV * HD;  // between tokens of a page
  const int32_t* tab = table + (size_t)b * MP;
  constexpr int STEP = WARPS * UNROLL * RPW;  // rows per block iteration
  for (int base = t0 + warp * UNROLL * RPW; base < t1; base += STEP) {
    uint4 kx[UNROLL], vx[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * RPW + slot;
      ok[u] = t < t1;
      kx[u] = vx[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        const int pid = tab[t / page];
        const size_t off = ((size_t)pid * page + t % page) * row_stride +
                           (size_t)kv * HD + chunk * VN;
        kx[u] = __ldg(reinterpret_cast<const uint4*>(k_pages + off));
        vx[u] = __ldg(reinterpret_cast<const uint4*>(v_pages + off));
      }
    }
    float s[UNROLL][GT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VN; ++e)
          d = fmaf(qr[g][e], Vec<T>::get(kx[u], e), d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][g] = d;
      }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = ok[u] ? exp2f(s[u][g] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VN; ++e)
          acc[g][e] = fmaf(p, Vec<T>::get(vx[u], e), acc[g][e]);
      }
    }
  }

  // combine the lane groups of the warp (lanes of one chunk, other rows)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn), c = exp2f(mo - mn);
      m[g] = mn;
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int e = 0; e < VN; ++e) sm_acc[warp][g][chunk * VN + e] = acc[g][e];
      if (chunk == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // combine the warps in a fixed order; a warp with no rows has l = 0
  for (int i = threadIdx.x; i < GT * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (sm_l[w][g] > 0.f) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (sm_l[w][g] > 0.f) {
        const float c = exp2f(sm_m[w][g] - mx);
        a += sm_acc[w][g][d] * c;
        lsum += sm_l[w][g] * c;
      }
    }
    const size_t pi = pbase + (size_t)g * splits;
    part_acc[pi * HD + d] = a;
    if (d == 0) {
      part_ml[pi * 2] = mx;
      part_ml[pi * 2 + 1] = lsum;
    }
  }
}

// grid (H, B); block REDUCE_THREADS, one thread per output element
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
    paged_decode_reduce_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               T* __restrict__ out, int H, int hd,
                               int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const float* ml = part_ml + bh * splits * 2;
  const float* acc = part_acc + bh * splits * hd;
  float mx = NEG_INF;
  for (int i = 0; i < splits; ++i)
    if (ml[2 * i + 1] > 0.f) mx = fmaxf(mx, ml[2 * i]);
  for (int d = threadIdx.x; d < hd; d += REDUCE_THREADS) {
    float a = 0.f, lsum = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float li = ml[2 * i + 1];
      if (li > 0.f) {  // an empty partition wrote no acc
        const float c = exp2f(ml[2 * i] - mx);
        a += acc[(size_t)i * hd + d] * c;
        lsum += li * c;
      }
    }
    from_f(lsum > 0.f ? a / lsum : 0.f, out + bh * hd + d);
  }
}

template <typename T, int HD, int GT>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* lengths, float* part_acc,
                 float* part_ml, int B, int H, int KV, int page, int MP,
                 int pp, int splits, float scale_log2, cudaStream_t stream) {
  dim3 grid(splits, H / GT, B);
  paged_decode_split_kernel<T, HD, GT><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages,
      (const int32_t*)table, (const int32_t*)lengths, part_acc, part_ml, H,
      KV, page, MP, pp, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k_pages, const void* v_pages,
              const void* table, const void* lengths, float* part_acc,
              float* part_ml, int B, int H, int KV, int page, int MP, int pp,
              int splits, float scale_log2, cudaStream_t stream) {
  const int G = H / KV;
#define REPRO_SPLIT(GT)                                                     \
  return launch_split<T, HD, GT>(q, k_pages, v_pages, table, lengths,       \
                                 part_acc, part_ml, B, H, KV, page, MP, pp, \
                                 splits, scale_log2, stream)
  // the largest of 4, 2, 1 that divides G: one block per KV head for G in
  // 1, 2, 4 (qwen3-8b has 4, moonshot-v1-16b-a3b 1), several otherwise
  if (G % 4 == 0) REPRO_SPLIT(4);
  if (G % 2 == 0) REPRO_SPLIT(2);
  REPRO_SPLIT(1);
#undef REPRO_SPLIT
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, void* out, void* scratch,
           int B, int H, int KV, int hd, int page, int MP, int pp,
           float scale, cudaStream_t stream) {
  const int splits = (MP + pp - 1) / pp;
  float* part_acc = (float*)scratch;
  float* part_ml = part_acc + (size_t)B * H * splits * hd;
  const float sl2 = scale * LOG2E;
  int err;
  switch (hd) {
    case 16:
      err = launch_hd<T, 16>(q, k_pages, v_pages, table, lengths, part_acc,
                             part_ml, B, H, KV, page, MP, pp, splits, sl2,
                             stream);
      break;
    case 32:
      err = launch_hd<T, 32>(q, k_pages, v_pages, table, lengths, part_acc,
                             part_ml, B, H, KV, page, MP, pp, splits, sl2,
                             stream);
      break;
    case 64:
      err = launch_hd<T, 64>(q, k_pages, v_pages, table, lengths, part_acc,
                             part_ml, B, H, KV, page, MP, pp, splits, sl2,
                             stream);
      break;
    case 128:
      err = launch_hd<T, 128>(q, k_pages, v_pages, table, lengths, part_acc,
                              part_ml, B, H, KV, page, MP, pp, splits, sl2,
                              stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  paged_decode_reduce_kernel<T><<<dim3(H, B), REDUCE_THREADS, 0, stream>>>(
      part_acc, part_ml, (T*)out, H, hd, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; hd 16, 32, 64 or 128; pools 16-byte
// aligned (the wrapper checks). `pp` pages per partition; `scratch` holds
// B * H * ceil(MP / pp) * (hd + 2) floats. Returns a cudaError_t (0 =
// success).
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* lengths, void* out,
                 void* scratch, int B, int H, int KV, int hd, int page,
                 int MP, int pp, float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  if (H % KV != 0 || pp < 1 || MP < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, lengths, out, scratch,
                         B, H, KV, hd, page, MP, pp, scale,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out,
                                 scratch, B, H, KV, hd, page, MP, pp, scale,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
