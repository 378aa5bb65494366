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
// What bounds it on this card: operations, from S ~ 200 up. Causal
// attention does about 2*S^2*hd*H flops on (4*S*hd*H) * 2 bytes: at hd 128
// that is hundreds of flops per byte, above the ~295 flop/byte where the
// 989 TFLOP/s bf16 tensor-core rate, not the 3.35 TB/s of device memory,
// becomes the limit.
//
// What the design does about it (bf16, `flash_fwd_bf16_kernel<HD>`, HD 16,
// 32, 64 or 128):
// - QK^T and PV run on the tensor cores as Hopper warpgroup products
//   (`wgmma.mma_async` m64n64k16 for the scores, m64nHDk16 for the
//   output, bf16 in, fp32 accumulate). A block is one warpgroup and one
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
// - The online softmax runs on the fp32 accumulators in registers (quad
//   shuffles for the row max; the row sum stays per thread until the
//   end). Masks are computed only on the diagonal tile and the sliding
//   window's edge tiles; tiles wholly outside the band are skipped. The
//   diagonal tile comes first, so every valid row has a real maximum
//   from its first tile on.
// - Query tiles launch heaviest first (the last tile of the causal band
//   has the most keys), so the tail of the grid is the light tiles.
// Not yet: TMA copies under mbarriers, a producer warp and two consumer
// warpgroups (warp specialisation), overlap of one tile's softmax with the
// next tile's products, a persistent grid.
//
// fp32 inputs take `flash_fwd_kernel`, the FMA kernel on the CUDA cores
// (a 64-row query tile, an 8 x 4 score block and an 8 x hd/16 output
// block per thread, fp32 tiles in shared memory): the tests and the fp32
// model check hold it to 2e-5, which bf16 tensor-core products would not.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128; // 8 row groups x 16 column lanes
constexpr int RPT = 8;       // rows per thread
constexpr int CPT = 4;       // score columns per thread (BK / 16)
constexpr int MAX_OCOL = 8;  // output columns per thread (hd / 16 <= 8)

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
__global__ void flash_fwd_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out, int H, int KV,
                                 int S, int hd, int window, float scale) {
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
  const float* q_bh = q + ((size_t)b * H + h) * (size_t)S * hd;
  const float* k_bh = k + ((size_t)b * KV + kvh) * (size_t)S * hd;
  const float* v_bh = v + ((size_t)b * KV + kvh) * (size_t)S * hd;

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
      const bool in = kpos < S;
      k_s[c * kst + d] = in ? k_bh[(size_t)kpos * hd + d] : 0.f;
      v_s[c * hd + d] = in ? v_bh[(size_t)kpos * hd + d] : 0.f;
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

  float* o_bh = out + ((size_t)b * H + h) * (size_t)S * hd;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q_lo + ty * RPT + i;
    if (qpos >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < MAX_OCOL; ++j)
      if (j < ncol) o_bh[(size_t)qpos * hd + tx + 16 * j] = acc[i][j] * inv;
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KV, int S, int hd, int window, float scale,
               cudaStream_t stream) {
  if (hd % 16 != 0 || hd > 16 * MAX_OCOL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)BQ * (hd + 1) +
                                       (size_t)BK * (hd + 1) +
                                       (size_t)BK * hd + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, H, KV,
      S, hd, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warpgroup products (wgmma) on 128-byte swizzled tiles, cp.async
// double buffering
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;              // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BQ = 16 * TC_WARPS;     // 64 query rows per block
constexpr int TC_BK = 64;                // keys per tile
constexpr int TC_PAD = 8;                // bf16 (16 bytes) per staged out row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int SW_ROW = 128;            // bytes per swizzled row (64 bf16)
constexpr int SW_BLOCK = 64 * SW_ROW;  // one 64-row x 64-column block

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle (layout type 1, bits 62-63)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers an async product wrote: keep their reads after the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] (shared, K-major) * B[16 x 64] (shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 16] += A[64 x 16] (registers) * B[16 x 16] (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] (registers) * B[16 x 32] (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<16>(float (&o)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_m64n16k16_rs(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&o)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_m64n32k16_rs(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_m64n64k16_rs(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_m64n128k16_rs(o, a, db);
}

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

// 64 rows of HD bf16 from row `row0` of a [S, HD] slab into 64-column
// blocks of 128-byte rows, 16-byte chunk c of row r at chunk c ^ (r % 8)
// (the 128-byte swizzle wgmma reads); rows >= S zero-filled
template <int HD>
__device__ __forceinline__ void load_tile_sw(unsigned char* dst,
                                             const __nv_bfloat16* src,
                                             int row0, int S, int tid) {
  constexpr int CPR = HD / 8;
#pragma unroll
  for (int i = tid; i < 64 * CPR; i += TC_THREADS) {
    const int r = i / CPR, c = i % CPR;
    const int pos = row0 + r;
    const int src_row = pos < S ? pos : S - 1;
    cp_async16(dst + (c / 8) * SW_BLOCK + r * SW_ROW +
                   (((c % 8) ^ (r & 7)) << 4),
               src + (size_t)src_row * HD + c * 8, pos < S ? 16 : 0);
  }
}

// grid (H, B, ceil(S / 64)), the query tile reversed from blockIdx.z; one
// warpgroup (TC_THREADS); dynamic shared memory, 1024-byte aligned:
//   q [NB blocks] | k [2][NB] | v [2][NB], NB = max(1, HD / 64)
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, int H, int KV,
                          int S, int window, float scale_log2) {
  constexpr int NB = HD >= 64 ? HD / 64 : 1;
  constexpr int TILE = NB * SW_BLOCK;  // bytes of one 64-row tile
  constexpr int ONT = HD / 8;
  constexpr int CPR = HD / 8;

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
  const __nv_bfloat16* v_bh = v + ((size_t)b * KV + kvh) * (size_t)S * HD;

  // key tiles of the band, diagonal first: kt_hi down to kt_lo
  const int kt_hi = qt;  // TC_BQ == TC_BK: the diagonal tile
  const int lowest = q_lo - window + 1;  // first key any row of the tile needs
  const int kt_lo = (window > 0 && lowest > 0) ? lowest / TC_BK : 0;
  const int n_tiles = kt_hi - kt_lo + 1;

  load_tile_sw<HD>(q_s, q_bh, q_lo, S, tid);
  load_tile_sw<HD>(k_s, k_bh, kt_hi * TC_BK, S, tid);
  load_tile_sw<HD>(v_s, v_bh, kt_hi * TC_BK, S, tid);
  cp_async_commit();

  const int row0 = q_lo + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int col = (lane & 3) * 2;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
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
      load_tile_sw<HD>(v_s + (buf ^ 1) * TILE, v_bh, (kt - 1) * TC_BK, S,
                       tid);
      cp_async_commit();
    }
    const unsigned char* kb = k_s + buf * TILE;
    const unsigned char* vb = v_s + buf * TILE;

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
      wgmma_pv<HD>(o, pf[kk], sw128_desc(vb + kk * 2048, SW_BLOCK, 1024));
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

  // stage the 64 rows in the K buffers (free once every product is done)
  // with padded rows, then write them out as 16-byte rows
  __syncthreads();
  constexpr int OST = HD + TC_PAD;
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
  __nv_bfloat16* o_bh = out + ((size_t)b * H + h) * (size_t)S * HD;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    const int qpos = q_lo + warp * 16 + r;
    if (qpos < S)
      *reinterpret_cast<uint4*>(o_bh + (size_t)qpos * HD + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * OST + c * 8);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int KV, int S, int window, float scale,
                 cudaStream_t stream) {
  constexpr int NB = HD >= 64 ? HD / 64 : 1;
  const size_t smem = (size_t)5 * NB * SW_BLOCK + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + TC_BQ - 1) / TC_BQ);
  flash_fwd_bf16_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, H, KV, S, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (hd a multiple of 16, <= 128), 1 = bfloat16 (hd 16,
// 32, 64 or 128; q, k, v 16-byte aligned). The wrapper checks both.
// Returns a cudaError_t (0 = success).
int flash_fwd(const void* q, const void* k, const void* v, void* out, int B,
              int H, int KV, int S, int hd, int window, float scale,
              int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, H, KV, S, hd, window, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_bf16<16>(q, k, v, out, B, H, KV, S, window, scale, st);
    case 32:
      return launch_bf16<32>(q, k, v, out, B, H, KV, S, window, scale, st);
    case 64:
      return launch_bf16<64>(q, k, v, out, B, H, KV, S, window, scale, st);
    case 128:
      return launch_bf16<128>(q, k, v, out, B, H, KV, S, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
