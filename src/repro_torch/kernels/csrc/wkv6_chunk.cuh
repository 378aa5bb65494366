// Device code that B4 (wkv6.cu, the chunked WKV-6 forward) and B4-bwd
// (wkv6_bwd.cu, its backward) share: 16-byte cp.async copies, the chunk
// loader (a chunk of a [B, S, H, hd] tensor into shared memory, bf16
// staged and upcast, the ragged tail masked to zeros), the 4 x 4 register
// tile product, each chunk's cumulative log-decay with k_carry and w_c =
// exp(cum_last) (B4's pass (a)), the chunk's increment product a^T b over
// its tokens, and the elementwise carry over the chunks (B4's pass (b)).
// The two sources compile them alike, so B4 keeps its bits and B4-bwd
// forms the same increments. Every function is inline in an anonymous
// namespace: each source compiles into a library of its own.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A chunk of a [B, S, H, hd] tensor into shared memory [CP][HDP], rows
// `ld` apart (a multiple of 4), zeros past S, past C and past hd. With
// `async` (hd * sizeof(T) a multiple of 16, so HDP = hd, and 16-byte
// aligned rows) the rows go by cp.async, all in flight at once, in T's own
// type; the caller waits. Otherwise element by element, upcast to fp32
// (`dst` then holds floats).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x,
                                           void* dst, int ld, bool async,
                                           size_t base, size_t row, int t0,
                                           int S, int C, int CP, int hd,
                                           int HDP) {
  if (async) {
    constexpr int PER = 16 / sizeof(T);
    const int n_vec = HDP / PER;
    T* d = static_cast<T*>(dst);
    for (int i = threadIdx.x; i < CP * n_vec; i += blockDim.x) {
      const int t = i / n_vec, j = (i % n_vec) * PER;
      const bool valid = t < C && t0 + t < S;
      cp_async16(d + t * ld + j,
                 x + base + (size_t)(t0 + (valid ? t : 0)) * row + j,
                 valid ? 16 : 0);
    }
    return;
  }
  float* d = static_cast<float*>(dst);
  for (int i = threadIdx.x; i < CP * HDP; i += blockDim.x) {
    const int t = i / HDP, j = i % HDP;
    const bool valid = t < C && t0 + t < S && j < hd;
    d[t * ld + j] = valid ? to_f(x[base + (size_t)(t0 + t) * row + j]) : 0.f;
  }
}

// a bf16 tile [CP][HDP] staged by cp.async, upcast to fp32 rows `ld` apart
__device__ __forceinline__ void upcast(const __nv_bfloat16* src, float* dst,
                                       int ld, int CP, int HDP) {
  for (int i = 8 * threadIdx.x; i < CP * HDP; i += 8 * blockDim.x) {
    const uint4 q = *reinterpret_cast<const uint4*>(src + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]),
                 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    float* o = dst + (i / HDP) * ld + i % HDP;
    *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(o + 4) = make_float4(c.x, c.y, d.x, d.y);
  }
}

// load r/k/v-type tiles (T) and logw (fp32) of one chunk into fp32 tiles
// (rows lds[n] apart; logw's HDP apart): by cp.async where the shapes
// allow, r/k/v through `stage` when T is bf16; returns with every tile in
// place (after a barrier) and, with `async`, every cp.async the thread
// issued before it complete
template <typename T, int N>
__device__ __forceinline__ void load_tiles(const T* const* xs,
                                           float* const* dsts,
                                           const int* lds,
                                           const float* __restrict__ logw,
                                           float* lw_dst, void* stage,
                                           bool async, size_t base,
                                           size_t row, int t0, int S, int C,
                                           int CP, int hd, int HDP) {
  constexpr bool BF16 = sizeof(T) == 2;
  for (int n = 0; n < N; ++n)
    if (async && BF16)
      load_chunk(xs[n], static_cast<T*>(stage) + n * CP * HDP, HDP, true,
                 base, row, t0, S, C, CP, hd, HDP);
    else
      load_chunk(xs[n], dsts[n], lds[n], async, base, row, t0, S, C, CP, hd,
                 HDP);
  load_chunk(logw, lw_dst, HDP, async, base, row, t0, S, C, CP, hd, HDP);
  if (async) cp_async_wait_all();
  __syncthreads();
  if constexpr (BF16) {
    if (async) {
      for (int n = 0; n < N; ++n)
        upcast(reinterpret_cast<const __nv_bfloat16*>(stage) + n * CP * HDP,
               dsts[n], lds[n], CP, HDP);
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void fma4x4(float acc[4][4], float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// per channel d (one thread each, NT threads): the inclusive cumulative
// log-decay of the chunk in token order, in place of logw (lw_s
// [CP][HDP]); k_carry = k * exp(cum_last - cum) in place of k (k_s
// [CP][HDP]); w_out[d] = exp(cum_last)
template <int NT>
__device__ __forceinline__ void chunk_decays(float* lw_s, float* k_s,
                                             float* __restrict__ w_out,
                                             int HDP, int C) {
  for (int d = threadIdx.x; d < HDP; d += NT) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      acc += lw_s[t * HDP + d];
      lw_s[t * HDP + d] = acc;
    }
    for (int t = 0; t < C; ++t)
      k_s[t * HDP + d] *= expf(acc - lw_s[t * HDP + d]);
    w_out[d] = expf(acc);
  }
}

// out [HDP][HDP] (device memory) = a^T b over the chunk's C tokens, a and
// b [CP][HDP] in shared memory: 4 x 4 tiles of (d, e) on NT threads, each
// a sum in token order
template <int NT>
__device__ __forceinline__ void chunk_increment(const float* a_s,
                                                const float* b_s,
                                                float* __restrict__ out,
                                                int HDP, int C) {
  const int G = HDP / 4;
  for (int tile = threadIdx.x; tile < G * G; tile += NT) {
    const int d0 = 4 * (tile / G), e0 = 4 * (tile % G);
    float acc[4][4] = {};
    for (int t = 0; t < C; ++t)
      fma4x4(acc, *reinterpret_cast<const float4*>(a_s + t * HDP + d0),
             *reinterpret_cast<const float4*>(b_s + t * HDP + e0));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + (size_t)(d0 + i) * HDP + e0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// one step of the carry over the chunks, elementwise in (d, e): the state
// S_{c+1} = w_c * S_c + dS_c, and its adjoint lam_c = w_c * lam_{c+1} + G_c
__device__ __forceinline__ float carry(float w, float s, float inc) {
  return fmaf(w, s, inc);
}

}  // namespace
