// RWKV-6 WKV recurrence, backward of the chunked prefill (kernel B4-bwd),
// for Hopper (sm_90a).
//
// Replaces: jax.grad of the jnp `wkv_chunked` (src/repro/models/rwkv.py)
// that the reference trains RWKV-6 through; it is the backward of B4
// (csrc/wkv6.cu), whose forward replaces the Pallas kernel `wkv6_chunked`
// of src/repro/kernels/wkv6.py (no Pallas backward exists). Per (batch,
// head), with
// the [hd, hd] fp32 state S (key dim d x value dim e) and w_t = exp(logw_t),
// token t computes
//   y_t = r_t^T S_{t-1} + (r_t . (u * k_t)) v_t,
//   S_t = w_t * S_{t-1} + k_t v_t^T      (S_0 = state0, S_T = s_out).
// Given dy and d s_out, the adjoint lam_t of S_t runs backwards,
//   lam_T = d s_out,  lam_{t-1} = w_t * lam_t + r_t dy_t^T,
// and the gradients are
//   dr_t[d] = (S_{t-1} dy_t)[d] + u_d k_t[d] (v_t . dy_t)
//   dk_t[d] = (lam_t v_t)[d] + r_t[d] u_d (v_t . dy_t)
//   dv_t[e] = (lam_t^T k_t)[e] + (r_t . (u * k_t)) dy_t[e]
//   du[d] = sum_t r_t[d] k_t[d] (v_t . dy_t),  d state0 = lam_0,
//   dlogw_t[d] = w_t[d] sum_e lam_t[d,e] S_{t-1}[d,e].
// The last needs S_{t-1} and lam_t at the same step, one walked forwards and
// the other backwards. It is rewritten through Q_t[d] = sum_e lam_t[d,e]
// S_t[d,e]: from the two updates, dlogw_t = Q_t - a_t and Q_{t-1} = Q_t -
// a_t + b_t, with a_t = k_t * (lam_t v_t) and b_t = r_t * (S_{t-1} dy_t),
// both products the other gradients form anyway, and Q_T = sum_e
// d s_out * s_out from the forward walk's last state. So dlogw is a
// reverse running sum, and no state of any step is stored.
//
// What bounds it on this card: operations, fp32 on the CUDA cores, and a
// serial dependency over the tokens. Each token and head needs ~10 hd^2
// flops (the state and adjoint updates and the three products over a row
// or column); at rwkv6-1.6b's training shape (H 32, hd 64, S 4096, B 1)
// that is ~5.4 GFLOP, ~80 us at 67 TFLOP/s, while the bytes (r, k, v,
// logw, dy read, their gradients written: ~200 MB with bf16 r, k, v)
// take ~60 us at 3.35 TB/s.
//
// What the design does. Row d of S and of lam evolve alone (every factor of
// their updates is indexed by d or broadcast along the row), and so do
// dr_t[d], dk_t[d], dlogw_t[d] and du[d]; only dv needs a column, which a
// transposed walk gives. Three kernels, each one thread per (row, group of
// EP entries of the row): EP state entries in registers, the row's dot
// products summed over its NG groups by warp shuffles (a butterfly, so
// every lane gets the same bits), NG a power of two.
// - `wkv6_bwd_state_kernel` walks forwards with S: dr_t, b_t (into the
//   dlogw buffer), du per (b, h, d) (the wrapper sums over b), and Q_T;
// - `wkv6_bwd_key_kernel` walks backwards with lam by rows: dk_t, dlogw_t
//   (reading b_t back and carrying Q), and d state0;
// - `wkv6_bwd_value_kernel` walks backwards with lam^T by columns: dv_t.
// A block of THREADS threads takes THREADS / NG rows (or columns) of one
// (b, h): 4 blocks a head at hd 64 (NG 8), 128 blocks at B 1, H 32. Each
// block stages TT tokens of its inputs in shared memory at a time (bf16
// upcast, logw turned into w once, zeros past S and past hd), so the walk
// reads shared memory only. No atomics: one call gives the same bits every
// time. Every sum runs in a fixed order; against the plain version (autograd
// through the chunked form) they differ in rounding only.
// Not yet: the chunk-parallel form of B4's passes, which would fill the
// card at B 1 (128 blocks of 4 warps keep ~1 warp on each scheduler here).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int EP = 8;    // entries of a row (or column) a thread holds
constexpr int TT = 32;   // tokens staged in shared memory at a time
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the sum of x over the NG lanes of a row's groups (aligned, contiguous)
template <int NG>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int m = NG / 2; m >= 1; m /= 2) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

// tokens [t0, t0 + TT) of columns [c0, c0 + n) of a [B, S, H, hd] tensor
// into dst [TT][n], upcast (and exp'd with `exp_w`), zeros past S and hd
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x,
                                      size_t base, size_t row, int t0, int S,
                                      int c0, int n, int hd,
                                      bool exp_w = false) {
  for (int i = threadIdx.x; i < TT * n; i += THREADS) {
    const int tt = i / n, c = c0 + i % n;
    const bool ok = t0 + tt < S && c < hd;
    const float val = ok ? to_f(x[base + (size_t)(t0 + tt) * row + c]) : 0.f;
    dst[i] = exp_w ? (ok ? expf(val) : 1.f) : val;
  }
}

// grid (ceil(HDP / R), H, B), R = THREADS / NG rows a block; dynamic shared
// memory: v_s, dy_s [TT][HDP] | r_s, k_s, w_s [TT][R] (HDP = NG * EP).
// Thread (row d, group g) holds S[d, g*EP .. g*EP + EP).
template <typename T, int NG>
__global__ void __launch_bounds__(THREADS)
    wkv6_bwd_state_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ logw,
                          const float* __restrict__ u,
                          const float* __restrict__ s0,
                          const float* __restrict__ dy,
                          const float* __restrict__ ds_out,
                          T* __restrict__ dr, float* __restrict__ bbuf,
                          float* __restrict__ du_part,
                          float* __restrict__ q_last, int S, int H, int hd) {
  constexpr int HDP = NG * EP, R = THREADS / NG;
  extern __shared__ float smem[];
  float* v_s = smem;
  float* dy_s = v_s + TT * HDP;
  float* r_s = dy_s + TT * HDP;
  float* k_s = r_s + TT * R;
  float* w_s = k_s + TT * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rr = threadIdx.x / NG, g = threadIdx.x % NG;
  const int d0 = blockIdx.x * R, d = d0 + rr, e0 = g * EP;
  const bool row_ok = d < hd;
  const size_t row = (size_t)H * hd;
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const size_t bh = (size_t)b * H + h;
  const float ud = row_ok ? u[(size_t)h * hd + d] : 0.f;

  float st[EP];
#pragma unroll
  for (int j = 0; j < EP; ++j)
    st[j] = row_ok && e0 + j < hd ? s0[(bh * hd + d) * hd + e0 + j] : 0.f;
  float du = 0.f;
  for (int t0 = 0; t0 < S; t0 += TT) {
    __syncthreads();  // the previous tile is read
    stage(v_s, v, base, row, t0, S, 0, HDP, hd);
    stage(dy_s, dy, base, row, t0, S, 0, HDP, hd);
    stage(r_s, r, base, row, t0, S, d0, R, hd);
    stage(k_s, k, base, row, t0, S, d0, R, hd);
    stage(w_s, logw, base, row, t0, S, d0, R, hd, true);
    __syncthreads();
    const int n = min(TT, S - t0);
    for (int tt = 0; tt < n; ++tt) {
      float vv[EP], gy[EP];
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        vv[j] = v_s[tt * HDP + e0 + j];
        gy[j] = dy_s[tt * HDP + e0 + j];
      }
      float sdy = 0.f, vdy = 0.f;
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        sdy = fmaf(st[j], gy[j], sdy);
        vdy = fmaf(vv[j], gy[j], vdy);
      }
      sdy = group_sum<NG>(sdy);
      vdy = group_sum<NG>(vdy);
      const float rt = r_s[tt * R + rr], kt = k_s[tt * R + rr],
                  wt = w_s[tt * R + rr];
      if (g == 0 && row_ok) {
        const size_t o = base + (size_t)(t0 + tt) * row + d;
        store(dr + o, fmaf(ud * kt, vdy, sdy));
        bbuf[o] = rt * sdy;
      }
      du = fmaf(rt * kt, vdy, du);
#pragma unroll
      for (int j = 0; j < EP; ++j) st[j] = fmaf(wt, st[j], kt * vv[j]);
    }
  }
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < EP; ++j)
    if (row_ok && e0 + j < hd)
      q = fmaf(ds_out[(bh * hd + d) * hd + e0 + j], st[j], q);
  q = group_sum<NG>(q);
  if (g == 0 && row_ok) {
    q_last[bh * hd + d] = q;
    du_part[bh * hd + d] = du;
  }
}

// grid, block and shared memory as the state kernel's. Thread (row d,
// group g) holds lam[d, g*EP .. g*EP + EP), from d s_out down to lam_0.
template <typename T, int NG>
__global__ void __launch_bounds__(THREADS)
    wkv6_bwd_key_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ logw,
                        const float* __restrict__ u,
                        const float* __restrict__ dy,
                        const float* __restrict__ ds_out,
                        const float* __restrict__ q_last,
                        T* __restrict__ dk, float* __restrict__ dlogw,
                        float* __restrict__ ds0, int S, int H, int hd) {
  constexpr int HDP = NG * EP, R = THREADS / NG;
  extern __shared__ float smem[];
  float* v_s = smem;
  float* dy_s = v_s + TT * HDP;
  float* r_s = dy_s + TT * HDP;
  float* k_s = r_s + TT * R;
  float* w_s = k_s + TT * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rr = threadIdx.x / NG, g = threadIdx.x % NG;
  const int d0 = blockIdx.x * R, d = d0 + rr, e0 = g * EP;
  const bool row_ok = d < hd;
  const size_t row = (size_t)H * hd;
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const size_t bh = (size_t)b * H + h;
  const float ud = row_ok ? u[(size_t)h * hd + d] : 0.f;

  float lam[EP];
#pragma unroll
  for (int j = 0; j < EP; ++j)
    lam[j] = row_ok && e0 + j < hd ? ds_out[(bh * hd + d) * hd + e0 + j]
                                   : 0.f;
  float qc = row_ok ? q_last[bh * hd + d] : 0.f;  // Q_t, carried down
  const int n_tiles = (S + TT - 1) / TT;
  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * TT;
    __syncthreads();
    stage(v_s, v, base, row, t0, S, 0, HDP, hd);
    stage(dy_s, dy, base, row, t0, S, 0, HDP, hd);
    stage(r_s, r, base, row, t0, S, d0, R, hd);
    stage(k_s, k, base, row, t0, S, d0, R, hd);
    stage(w_s, logw, base, row, t0, S, d0, R, hd, true);
    __syncthreads();
    for (int tt = min(TT, S - t0) - 1; tt >= 0; --tt) {
      float vv[EP], gy[EP];
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        vv[j] = v_s[tt * HDP + e0 + j];
        gy[j] = dy_s[tt * HDP + e0 + j];
      }
      float lv = 0.f, vdy = 0.f;
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        lv = fmaf(lam[j], vv[j], lv);
        vdy = fmaf(vv[j], gy[j], vdy);
      }
      lv = group_sum<NG>(lv);
      vdy = group_sum<NG>(vdy);
      const float rt = r_s[tt * R + rr], kt = k_s[tt * R + rr],
                  wt = w_s[tt * R + rr];
      if (g == 0 && row_ok) {
        const size_t o = base + (size_t)(t0 + tt) * row + d;
        const float a = kt * lv;
        store(dk + o, fmaf(rt * ud, vdy, lv));
        const float bt = dlogw[o];  // b_t, from the state kernel
        dlogw[o] = qc - a;
        qc = qc - a + bt;           // Q_{t-1}
      }
#pragma unroll
      for (int j = 0; j < EP; ++j) lam[j] = fmaf(wt, lam[j], rt * gy[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < EP; ++j)
    if (row_ok && e0 + j < hd) ds0[(bh * hd + d) * hd + e0 + j] = lam[j];
}

// grid (ceil(HDP / R), H, B); dynamic shared memory: r_s, k_s, w_s
// [TT][HDP] | dy_s [TT][R]. Thread (column e, group g) holds lam[g*EP ..
// g*EP + EP, e], from d s_out down.
template <typename T, int NG>
__global__ void __launch_bounds__(THREADS)
    wkv6_bwd_value_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const float* __restrict__ logw,
                          const float* __restrict__ u,
                          const float* __restrict__ dy,
                          const float* __restrict__ ds_out,
                          T* __restrict__ dv, int S, int H, int hd) {
  constexpr int HDP = NG * EP, R = THREADS / NG;
  extern __shared__ float smem[];
  float* r_s = smem;
  float* k_s = r_s + TT * HDP;
  float* w_s = k_s + TT * HDP;
  float* dy_s = w_s + TT * HDP;
  const int h = blockIdx.y, b = blockIdx.z;
  const int cc = threadIdx.x / NG, g = threadIdx.x % NG;
  const int c0 = blockIdx.x * R, e = c0 + cc, dd = g * EP;
  const bool col_ok = e < hd;
  const size_t row = (size_t)H * hd;
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const size_t bh = (size_t)b * H + h;

  float lam[EP], uu[EP];
#pragma unroll
  for (int j = 0; j < EP; ++j) {
    const bool ok = col_ok && dd + j < hd;
    lam[j] = ok ? ds_out[(bh * hd + dd + j) * hd + e] : 0.f;
    uu[j] = dd + j < hd ? u[(size_t)h * hd + dd + j] : 0.f;
  }
  const int n_tiles = (S + TT - 1) / TT;
  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * TT;
    __syncthreads();
    stage(r_s, r, base, row, t0, S, 0, HDP, hd);
    stage(k_s, k, base, row, t0, S, 0, HDP, hd);
    stage(w_s, logw, base, row, t0, S, 0, HDP, hd, true);
    stage(dy_s, dy, base, row, t0, S, c0, R, hd);
    __syncthreads();
    for (int tt = min(TT, S - t0) - 1; tt >= 0; --tt) {
      float rv[EP], kv[EP], wv[EP];
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        rv[j] = r_s[tt * HDP + dd + j];
        kv[j] = k_s[tt * HDP + dd + j];
        wv[j] = w_s[tt * HDP + dd + j];
      }
      float lk = 0.f, bonus = 0.f;
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        lk = fmaf(lam[j], kv[j], lk);
        bonus = fmaf(rv[j], uu[j] * kv[j], bonus);
      }
      lk = group_sum<NG>(lk);
      bonus = group_sum<NG>(bonus);
      const float gy = dy_s[tt * R + cc];
      if (g == 0 && col_ok)
        store(dv + base + (size_t)(t0 + tt) * row + e, fmaf(bonus, gy, lk));
#pragma unroll
      for (int j = 0; j < EP; ++j) lam[j] = fmaf(wv[j], lam[j], rv[j] * gy);
    }
  }
}

template <typename T, int NG>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, const void* dy, const void* ds_out,
           void* dr, void* dk, void* dv, void* dlogw, void* du_part,
           void* ds0, void* q_last, int B, int S, int H, int hd,
           cudaStream_t stream) {
  constexpr int HDP = NG * EP, R = THREADS / NG;
  const size_t smem_rows = sizeof(float) * TT * (2 * HDP + 3 * R);
  const size_t smem_cols = sizeof(float) * TT * (3 * HDP + R);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(wkv6_bwd_state_kernel<T, NG>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_rows)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(wkv6_bwd_key_kernel<T, NG>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_rows)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(wkv6_bwd_value_kernel<T, NG>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_cols)) != cudaSuccess)
    return (int)err;
  const dim3 grid((hd + R - 1) / R, H, B);
  wkv6_bwd_state_kernel<T, NG><<<grid, THREADS, smem_rows, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw,
      (const float*)u, (const float*)s0, (const float*)dy,
      (const float*)ds_out, (T*)dr, (float*)dlogw, (float*)du_part,
      (float*)q_last, S, H, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_key_kernel<T, NG><<<grid, THREADS, smem_rows, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw,
      (const float*)u, (const float*)dy, (const float*)ds_out,
      (const float*)q_last, (T*)dk, (float*)dlogw, (float*)ds0, S, H, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_value_kernel<T, NG><<<grid, THREADS, smem_cols, stream>>>(
      (const T*)r, (const T*)k, (const float*)logw, (const float*)u,
      (const float*)dy, (const float*)ds_out, (T*)dv, S, H, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ng(const void* r, const void* k, const void* v, const void* logw,
              const void* u, const void* s0, const void* dy,
              const void* ds_out, void* dr, void* dk, void* dv, void* dlogw,
              void* du_part, void* ds0, void* q_last, int B, int S, int H,
              int hd, cudaStream_t st) {
#define WKV6_BWD_NG(NG)                                                    \
  if (hd <= NG * EP)                                                       \
    return launch<T, NG>(r, k, v, logw, u, s0, dy, ds_out, dr, dk, dv,     \
                         dlogw, du_part, ds0, q_last, B, S, H, hd, st);
  WKV6_BWD_NG(1)
  WKV6_BWD_NG(2)
  WKV6_BWD_NG(4)
  WKV6_BWD_NG(8)
  WKV6_BWD_NG(16)
#undef WKV6_BWD_NG
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// r, k, v: [B, S, H, hd] of `dtype` (0 = float32, 1 = bfloat16); logw, dy:
// [B, S, H, hd] float32; u: [H, hd] float32; s0, ds_out: [B, H, hd, hd]
// float32 -> dr, dk, dv [B, S, H, hd] of `dtype`, dlogw [B, S, H, hd]
// float32, du_part [B, H, hd] float32 (du summed over each batch row; the
// caller sums over B), ds0 [B, H, hd, hd] float32. q_last: B * H * hd
// float32 of workspace. 1 <= hd <= 128. Three kernels on `stream`. Returns
// a cudaError_t (0 = success).
int wkv6_chunked_bwd(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* s0,
                     const void* dy, const void* ds_out, void* dr, void* dk,
                     void* dv, void* dlogw, void* du_part, void* ds0,
                     void* q_last, int B, int S, int H, int hd, int dtype,
                     void* stream) {
  if (B == 0 || H == 0) return 0;
  if (hd < 1 || hd > 16 * EP || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_ng<float>(r, k, v, logw, u, s0, dy, ds_out, dr, dk, dv,
                            dlogw, du_part, ds0, q_last, B, S, H, hd, st);
  if (dtype == 1)
    return launch_ng<__nv_bfloat16>(r, k, v, logw, u, s0, dy, ds_out, dr, dk,
                                    dv, dlogw, du_part, ds0, q_last, B, S, H,
                                    hd, st);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
