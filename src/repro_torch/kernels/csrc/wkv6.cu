// RWKV-6 WKV recurrence for Hopper (sm_90a): chunked prefill (kernel B4)
// and single-token decode (kernel B3).
//
// Replaces: the Pallas TPU kernels `wkv6_chunked` / `_wkv_kernel` and
// `wkv6_decode` / `_wkv_decode_kernel` (src/repro/kernels/wkv6.py). Same
// functions. Per (batch, head) with the [hd, hd] fp32 state S (key dim x
// value dim), one token computes
//   y_e = sum_d r_d (S_de + u_d k_d v_e),   S'_de = w_d S_de + k_d v_e.
// B4 runs a whole prompt in chunks of C tokens from the cumulative
// log-decay cum (logw = log w < 0): with cum_excl = cum - logw,
//   A = strictly_lower((r * exp(cum_excl)) (k * exp(-cum))^T)     [C, C]
//   y = A v + diag(r . (u * k)) v + (r * exp(cum_excl)) S
//   S = exp(cum_last) * S + (k * exp(cum_last - cum))^T v
// which is the factorisation of the JAX model's `wkv_chunked`
// (src/repro/models/rwkv.py), kept as it is so that the kernel and the
// plain version round alike. The clamp of the model's decay rates bounds
// exp(-cum) by about exp(32 * e^0.5) ~ 1e23 at C = 32, inside fp32. In
// the port the two kernels take the places where the JAX model computes
// the same math in jnp: the chunked scan of prefill and the einsums of
// decode.
//
// What bounds them on this card.
// - B4: operations, on the CUDA cores in fp32. At rwkv6-1.6b prefill
//   (H 32, hd 64, C 32) a chunk of one head does 4*C*hd*(C + hd) flops
//   (~786 kflop) on C*hd*(3*2 + 4 + 4) bytes (~29 KB of bf16 r/k/v, fp32
//   logw and fp32 y), ~27 flops per byte; the state never leaves the chip.
//   The fp32 form is what the decay factorisation needs, so the bound is
//   the 67 TFLOP/s fp32 rate, a little above the bytes bound.
// - B3: bytes. One token reads and writes the [hd, hd] fp32 state of each
//   (slot, head), 2 * B * H * hd^2 * 4 bytes, for ~4 flops per state entry.
//
// What the designs do about it, in this first version.
// - B4: the TPU kernel carries S in VMEM scratch across a sequential grid
//   axis of chunks. Blocks on Hopper run in any order and carry nothing,
//   so one block per (batch, head) walks all of that head's chunks itself
//   and keeps S in shared memory for the whole prompt: S crosses device
//   memory twice (S0 in, S out), not once per chunk. Each chunk's r, k, v
//   and logw tiles are read from the [B, S, H, hd] layout with strides
//   (no transpose, no padded copy) and upcast to fp32 in shared memory;
//   the ragged tail is masked at load (k = v = 0 and logw = 0 past S).
//   Rows of r and k are padded to hd + 1 floats so that the score loop,
//   whose lanes walk different rows, hits distinct banks. At B = 1 this is
//   only H = 32 blocks on 132 SMs and every product runs on the CUDA
//   cores: splitting the value dim across blocks and mma-based products
//   are the next steps.
// - B3: one block per (slot, head), one thread per value column e, so a
//   warp reads 32 neighbouring S_de at once (coalesced) and each state
//   entry is read once and written once. The new state goes to a fresh
//   tensor, as the TPU kernel's output does; freezing parked slots is the
//   model's job, not the kernel's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// grid (H, B); block CHUNK_THREADS; dynamic shared memory (floats):
//   S_s [hd][hd] | r_s [C][hd+1] | k_s [C][hd+1] | kc_s [C][hd]
//   | v_s [C][hd] | lw_s [C][hd] | cum_s [C][hd] | A_s [C][C] | diag_s [C]
//   | wl_s [hd] | we_s [hd] | u_s [hd]
template <typename T>
__global__ void wkv6_chunked_kernel(const T* __restrict__ r,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const float* __restrict__ logw,
                                    const float* __restrict__ u,
                                    const float* __restrict__ s0,
                                    float* __restrict__ y,
                                    float* __restrict__ s_out, int S, int H,
                                    int hd, int C) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int hs = hd + 1;

  extern __shared__ float smem[];
  float* S_s = smem;
  float* r_s = S_s + hd * hd;
  float* k_s = r_s + C * hs;
  float* kc_s = k_s + C * hs;
  float* v_s = kc_s + C * hd;
  float* lw_s = v_s + C * hd;
  float* cum_s = lw_s + C * hd;
  float* A_s = cum_s + C * hd;
  float* diag_s = A_s + C * C;
  float* wl_s = diag_s + C;
  float* we_s = wl_s + hd;
  float* u_s = we_s + hd;

  const size_t bh = (size_t)b * H + h;
  const float* s0_bh = s0 + bh * hd * hd;
  for (int i = tid; i < hd * hd; i += CHUNK_THREADS) S_s[i] = s0_bh[i];
  for (int i = tid; i < hd; i += CHUNK_THREADS) u_s[i] = u[(size_t)h * hd + i];

  const size_t row = (size_t)H * hd;  // stride of one token
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const int n_chunks = (S + C - 1) / C;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * C;
    __syncthreads();  // the previous chunk is fully consumed (init visible)
    for (int i = tid; i < C * hd; i += CHUNK_THREADS) {
      const int t = i / hd, d = i % hd;
      const bool valid = t0 + t < S;
      const size_t off = base + (size_t)(t0 + t) * row + d;
      r_s[t * hs + d] = valid ? to_f(r[off]) : 0.f;
      k_s[t * hs + d] = valid ? to_f(k[off]) : 0.f;
      v_s[i] = valid ? to_f(v[off]) : 0.f;
      lw_s[i] = valid ? logw[off] : 0.f;
    }
    __syncthreads();
    // inclusive cumulative log-decay per channel; the u bonus per row
    for (int d = tid; d < hd; d += CHUNK_THREADS) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += lw_s[t * hd + d];
        cum_s[t * hd + d] = acc;
      }
      wl_s[d] = acc;
      we_s[d] = expf(acc);
    }
    for (int t = tid; t < C; t += CHUNK_THREADS) {
      float acc = 0.f;
      for (int d = 0; d < hd; ++d)
        acc = fmaf(r_s[t * hs + d], u_s[d] * k_s[t * hs + d], acc);
      diag_s[t] = acc;
    }
    __syncthreads();
    // decayed factors, in place of r and k (the bonus has used them)
    for (int i = tid; i < C * hd; i += CHUNK_THREADS) {
      const int t = i / hd, d = i % hd;
      const float cum = cum_s[i];
      const float kk = k_s[t * hs + d];
      r_s[t * hs + d] *= expf(cum - lw_s[i]);
      k_s[t * hs + d] = kk * expf(-cum);
      kc_s[i] = kk * expf(wl_s[d] - cum);
    }
    __syncthreads();
    // strictly lower [C, C] scores
    for (int i = tid; i < C * C; i += CHUNK_THREADS) {
      const int t = i / C, s = i % C;
      float acc = 0.f;
      if (s < t) {
        const float* rr = r_s + t * hs;
        const float* kr = k_s + s * hs;
        for (int d = 0; d < hd; ++d) acc = fmaf(rr[d], kr[d], acc);
      }
      A_s[i] = acc;
    }
    __syncthreads();
    // y = A v + diag v + r_dec S, for the chunk's valid rows
    for (int i = tid; i < C * hd; i += CHUNK_THREADS) {
      const int t = i / hd, e = i % hd;
      if (t0 + t >= S) continue;
      float acc = 0.f;
      for (int s = 0; s < t; ++s)
        acc = fmaf(A_s[t * C + s], v_s[s * hd + e], acc);
      acc = fmaf(diag_s[t], v_s[i], acc);
      float st = 0.f;
      const float* rr = r_s + t * hs;
      for (int d = 0; d < hd; ++d) st = fmaf(rr[d], S_s[d * hd + e], st);
      y[base + (size_t)(t0 + t) * row + e] = acc + st;
    }
    __syncthreads();  // every read of S_s is done before it changes
    // S = exp(cum_last) S + k_carry^T v
    for (int i = tid; i < hd * hd; i += CHUNK_THREADS) {
      const int d = i / hd, e = i % hd;
      float acc = 0.f;
      for (int t = 0; t < C; ++t)
        acc = fmaf(kc_s[t * hd + d], v_s[t * hd + e], acc);
      S_s[i] = we_s[d] * S_s[i] + acc;
    }
  }
  __syncthreads();
  float* so = s_out + bh * hd * hd;
  for (int i = tid; i < hd * hd; i += CHUNK_THREADS) so[i] = S_s[i];
}

// grid (H, B); block hd threads, one per value column e; dynamic shared
// memory r_s | k_s | w_s | u_s, hd floats each
template <typename T>
__global__ void wkv6_decode_kernel(const T* __restrict__ r,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const float* __restrict__ w,
                                   const float* __restrict__ u,
                                   const float* __restrict__ s,
                                   float* __restrict__ y,
                                   float* __restrict__ s_out, int H,
                                   int hd) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int e = threadIdx.x;
  extern __shared__ float smem[];
  float* r_s = smem;
  float* k_s = r_s + hd;
  float* w_s = k_s + hd;
  float* u_s = w_s + hd;

  const size_t bh = (size_t)b * H + h;
  const size_t vo = bh * hd;
  r_s[e] = to_f(r[vo + e]);
  k_s[e] = to_f(k[vo + e]);
  w_s[e] = w[vo + e];
  u_s[e] = u[(size_t)h * hd + e];
  const float ve = to_f(v[vo + e]);
  __syncthreads();

  const float* S = s + bh * hd * hd;
  float* So = s_out + bh * hd * hd;
  float acc = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float sde = S[d * hd + e];
    const float kv = k_s[d] * ve;
    acc = fmaf(r_s[d], sde + u_s[d] * kv, acc);
    So[d * hd + e] = w_s[d] * sde + kv;
  }
  y[vo + e] = acc;
}

size_t chunked_smem(int hd, int C) {
  return sizeof(float) *
         ((size_t)hd * hd + 2 * (size_t)C * (hd + 1) + 4 * (size_t)C * hd +
          (size_t)C * C + C + 3 * (size_t)hd);
}

template <typename T>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* y,
                   void* s_out, int B, int S, int H, int hd, int C,
                   cudaStream_t stream) {
  const size_t smem = chunked_smem(hd, C);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  wkv6_chunked_kernel<T><<<grid, CHUNK_THREADS, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out, S, H, hd,
      C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s, void* y, void* s_out, int B,
                  int H, int hd, cudaStream_t stream) {
  dim3 grid(H, B);
  wkv6_decode_kernel<T><<<grid, hd, 4 * hd * sizeof(float), stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s, (float*)y, (float*)s_out, H, hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v: [B, S, H, hd] of `dtype` (0 = float32, 1 = bfloat16); logw:
// [B, S, H, hd] float32; u: [H, hd] float32; s0: [B, H, hd, hd] float32
// -> y [B, S, H, hd] float32, s_out [B, H, hd, hd] float32. Chunks of
// C tokens (1 <= C <= 32). Returns a cudaError_t (0 = success).
int wkv6_chunked(const void* r, const void* k, const void* v,
                 const void* logw, const void* u, const void* s0, void* y,
                 void* s_out, int B, int S, int H, int hd, int C, int dtype,
                 void* stream) {
  if (B == 0 || H == 0) return 0;
  if (dtype == 0)
    return launch_chunked<float>(r, k, v, logw, u, s0, y, s_out, B, S, H, hd,
                                 C, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_chunked<__nv_bfloat16>(r, k, v, logw, u, s0, y, s_out, B,
                                         S, H, hd, C, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// r, k, v: [B, H, hd] of `dtype`; w: [B, H, hd] float32 (the decay
// multiplier); u: [H, hd] float32; s: [B, H, hd, hd] float32 -> y
// [B, H, hd] float32, s_out [B, H, hd, hd] float32 (a separate tensor).
int wkv6_decode(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s, void* y, void* s_out, int B,
                int H, int hd, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (dtype == 0)
    return launch_decode<float>(r, k, v, w, u, s, y, s_out, B, H, hd,
                                (cudaStream_t)stream);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(r, k, v, w, u, s, y, s_out, B, H, hd,
                                        (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
