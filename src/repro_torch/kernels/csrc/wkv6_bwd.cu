// RWKV-6 WKV recurrence, backward of the chunked prefill (kernel B4-bwd),
// for Hopper (sm_90a).
//
// Replaces: jax.grad of the jnp `wkv_chunked` (src/repro/models/rwkv.py)
// that the reference trains RWKV-6 through; it is the backward of B4
// (csrc/wkv6.cu), whose forward replaces the Pallas kernel `wkv6_chunked`
// of src/repro/kernels/wkv6.py (no Pallas backward exists). Per (batch,
// head), with the [hd, hd] fp32 state S (key dim d x value dim e) and w_t =
// exp(logw_t), token t computes
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
// The last needs S_{t-1} and lam_t at the same step. Through Q_t[d] =
// sum_e lam_t[d,e] S_t[d,e]: dlogw_t = Q_t - a_t and Q_{t-1} = Q_t - a_t +
// b_t, with a_t = k_t * (lam_t v_t) and b_t = r_t * (S_{t-1} dy_t).
//
// The chunk form. Over chunks of C tokens, with B4's factorisation (cum the
// chunk's inclusive cumulative log-decay, cum_excl = cum before each token,
// r_dec = r * exp(cum_excl), k_inv = k * exp(-cum), k_carry = k *
// exp(cum_last - cum), w_c = exp(cum_last), A = B4's strictly lower
// scores), S_c the state entering chunk c and lam_c its adjoint:
//   S_{c+1} = w_c * S_c + k_carry^T v,   lam_c = w_c * lam_{c+1} + r_dec^T dy,
// both elementwise in (d, e), and inside the chunk, with M =
// strictly_lower(dy v^T) and dr', dk' the gradients without u's bonus:
//   dr' = exp(cum_excl) * (dy S_c^T + M k_inv)
//   dk' = exp(-cum) * (M^T r_dec) + exp(cum_last - cum) * (v lam_{c+1}^T)
//   dv  = A^T dy + diag(r . (u * k)) dy + k_carry lam_{c+1}
// and at the chunk's last token Q = sum_e lam_{c+1} * S_{c+1}, so dlogw
// is a carried sum over the chunk's own C tokens. Each chunk needs S_c,
// lam_{c+1} and that one Q row: nothing orders the chunks but the two
// elementwise carries.
//
// What bounds it on this card: operations, fp32 on the CUDA cores. The
// function needs ~10 hd^2 flops a token and head (the state and adjoint
// updates and the three products over a row or column); at rwkv6-1.6b's
// training shape (H 32, hd 64, S 4096, B 1) that is ~5.4 GFLOP, ~80 us at
// 67 TFLOP/s, while the bytes (r, k, v, logw, dy read, their gradients
// written: ~200 MB with bf16 r, k, v) take ~60 us at 3.35 TB/s. The chunk
// form does more, ~2 (5 C hd^2 + 5 C^2 hd) flops a chunk and head (each
// product below), 1.5x the function's count at hd 64 and C 32, and moves
// each chunk's increments, S_c and lam_{c+1} through device memory: nine
// hd^2 fp32 tiles of traffic a chunk (written by pass 1, read, rewritten
// and read back by pass 2, read by pass 3), ~600 MB at that shape, ~180
// us at 3.35 TB/s. The fp32 form is what the decay factorisation needs
// (TF32 keeps three digits, and exp(-cum) reaches ~1e23 at C = 32, inside
// fp32).
//
// What the design does: B4's passes, run backwards, three kernels a call.
// - `wkv6_bwd_chunk_state_kernel`, one block per (batch, head, chunk):
//   the chunk's dS_c = k_carry^T v and w_c (B4's pass (a), the same
//   device code, from wkv6_chunk.cuh) and G_c = r_dec^T dy, into two
//   [HDP][HDP] workspaces.
// - `wkv6_bwd_scan_kernel`, a row of lanes per (batch, head, d), four
//   entries of the row a lane: the adjoint's carry from d s_out down,
//   overwriting each G_c with lam_{c+1} and writing d state0 = lam_0; then
//   the state's carry from state0 up, overwriting each dS_c with S_c and
//   forming Q_c = sum_e lam_{c+1} * S_{c+1} by a butterfly of warp
//   shuffles (the same bits on every lane and call). Both carries keep the
//   loads of eight chunks in flight, as B4's pass (b).
// - `wkv6_bwd_chunk_grad_kernel`, one block per (batch, head, chunk): the
//   chunk's tiles, lam_{c+1} and its Q row by cp.async; the decayed
//   factors; A and M; dv, then dk' (with lam_{c+1}), then S_c into the
//   space lam_{c+1} leaves and dr'; a and b kept on chip; then one thread
//   per channel walks the chunk's C tokens down for dlogw and sums du's
//   partial. The wrapper sums du over the batch and the chunks.
// The grid of passes 1 and 3 is B * H * ceil(S / C) blocks: 4096 at
// rwkv6's training shape. Every product is register-tiled, 4 x 4 outputs a
// thread: a token-row operand is read as float4 along its rows, four rows
// GT = CP / 4 apart on each thread (rows tl, tl + GT, ...) so that the 8
// lanes of a 16-byte load phase read consecutive rows, whose stride RS
// (HDP padded so that RS / 4 is odd) puts them on distinct banks, while
// the other operand's rows are the same on those lanes (a broadcast);
// the triangular products skip the rows a triangle zeroes. The ragged tail
// is masked at load (k = v = r = dy = 0, logw = 0 past S), so any hd <= 128
// and any C <= 32 run and nothing padded is copied. No atomics: one call
// gives the same bits every time; every sum runs in a fixed order, and
// against the plain version (autograd through the chunked form) they
// differ in rounding only. At hd 128 pass 3 holds 213 KB of shared memory
// (one block an SM), at hd 64 98 KB (two).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"

namespace {

constexpr int STATE_THREADS = 128;   // pass 1
constexpr int SCAN_THREADS = 128;    // pass 2
constexpr int SCAN_AHEAD = 8;        // chunks of pass 2 loaded at once
constexpr int GRAD_THREADS = 128;    // pass 3
constexpr unsigned FULL = 0xffffffffu;

// the sum of x over the NG lanes of a row (aligned, contiguous), the same
// bits on every lane
template <int NG>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int m = NG / 2; m >= 1; m /= 2) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[i][j] += p_i . q_j over HDP, p_i = P's row tl + GT * i (rows ld_p
// apart), q_j = Q's row q0 + j (rows ld_q apart), in steps of 4 columns
__device__ __forceinline__ void dot_tile(float acc[4][4], const float* P,
                                         int ld_p, int tl, int GT,
                                         const float* Q, int ld_q, int q0,
                                         int HDP) {
  for (int x = 0; x < HDP; x += 4) {
    float4 p[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (tl + GT * i) * ld_p + x);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = *reinterpret_cast<const float4*>(Q + (q0 + j) * ld_q + x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(p[i], q[j], acc[i][j]);
  }
}

// acc[i][j] += sum_s L[s][tl + GT * i] * R[s][c0 + j] over s in [s_lo,
// s_hi): L rows ld_l apart (C x C or channel-major), R rows ld_r apart
__device__ __forceinline__ void outer_tile(float acc[4][4], const float* L,
                                           int ld_l, int tl, int GT,
                                           const float* R, int ld_r, int c0,
                                           int s_lo, int s_hi) {
  for (int s = s_lo; s < s_hi; ++s) {
    const float* l = L + s * ld_l + tl;
    fma4x4(acc, make_float4(l[0], l[GT], l[2 * GT], l[3 * GT]),
           *reinterpret_cast<const float4*>(R + s * ld_r + c0));
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_vec4(float* p, const float o[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_vec4(__nv_bfloat16* p,
                                           const float o[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// columns c0 .. c0 + 3 of a row of a [B, S, H, hd] gradient, those < hd
template <typename T>
__device__ __forceinline__ void store_row4(T* p, const float o[4], int c0,
                                           int hd) {
  if ((hd & 3) == 0) {
    store_vec4(p, o);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < hd) store(p + j, o[j]);
  }
}

// Pass 1. grid (n_chunks, H, B); block STATE_THREADS; dynamic shared
// memory k_s | v_s | r_s | y_s | lw_s | stage (two tiles), [CP][HDP]
// floats each. Writes ws_s[b,h,c] = dS_c and ws_l[b,h,c] = G_c [HDP][HDP],
// wl[b,h,c] = exp(cum_last) [HDP].
template <typename T>
__global__ void __launch_bounds__(STATE_THREADS)
    wkv6_bwd_chunk_state_kernel(const T* __restrict__ r,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ logw,
                                const float* __restrict__ dy,
                                float* __restrict__ ws_s,
                                float* __restrict__ ws_l,
                                float* __restrict__ wl, int S, int H, int hd,
                                int C, int async) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int HDP = round4(hd), CP = round4(C);
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + CP * HDP;
  float* r_s = v_s + CP * HDP;
  float* y_s = r_s + CP * HDP;
  float* lw_s = y_s + CP * HDP;
  float* stage = lw_s + CP * HDP;           // bf16 k, v, r, on their way

  const size_t row = (size_t)H * hd;
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const int t0 = c * C;
  load_chunk(dy, y_s, HDP, async, base, row, t0, S, C, CP, hd, HDP);
  const T* xs[3] = {k, v, r};
  float* const ds[3] = {k_s, v_s, r_s};
  const int lds[3] = {HDP, HDP, HDP};
  load_tiles<T, 3>(xs, ds, lds, logw, lw_s, stage, async, base, row, t0, S,
                   C, CP, hd, HDP);

  const size_t bhc = ((size_t)b * H + h) * n_chunks + c;
  // B4's pass (a): cum in place of logw, k_carry in place of k, w_c; then,
  // on each channel's own thread, r_dec = r * exp(cum_excl) in place of r
  chunk_decays<STATE_THREADS>(lw_s, k_s, wl + bhc * HDP, HDP, C);
  for (int d = threadIdx.x; d < HDP; d += STATE_THREADS)
    for (int t = 1; t < C; ++t)
      r_s[t * HDP + d] *= expf(lw_s[(t - 1) * HDP + d]);
  __syncthreads();
  chunk_increment<STATE_THREADS>(k_s, v_s, ws_s + bhc * HDP * HDP, HDP, C);
  chunk_increment<STATE_THREADS>(r_s, y_s, ws_l + bhc * HDP * HDP, HDP, C);
}

// Pass 2. grid (ceil(HDP / (SCAN_THREADS / NG)), B * H); NG lanes a row
// (NG a power of two, 4 * NG >= HDP), entries e0 .. e0 + 3 a lane. The
// adjoint from d s_out down (ws_l[c]: G_c -> lam_{c+1}; ds0 = lam_0), then
// the state from s0 up (ws_s[c]: dS_c -> S_c; wq[c] = Q_c).
template <int NG>
__global__ void __launch_bounds__(SCAN_THREADS)
    wkv6_bwd_scan_kernel(const float* __restrict__ s0,
                         const float* __restrict__ ds_out,
                         float* __restrict__ ws_s, float* __restrict__ ws_l,
                         const float* __restrict__ wl,
                         float* __restrict__ wq, float* __restrict__ ds0,
                         int hd, int n_chunks) {
  const int HDP = round4(hd);
  const int d = blockIdx.x * (SCAN_THREADS / NG) + threadIdx.x / NG;
  const int g = threadIdx.x % NG, e0 = 4 * g;
  const size_t bh = blockIdx.y;
  // lanes past the workspace's row still take part in the shuffles
  const bool live = d < HDP && e0 < HDP;
  const size_t step = (size_t)HDP * HDP;
  const size_t off = bh * n_chunks * step + (size_t)(live ? d : 0) * HDP +
                     (live ? e0 : 0);
  float* ps = ws_s + off;
  float* pl = ws_l + off;
  const float* w = wl + bh * n_chunks * HDP + (live ? d : 0);
  float lam[4], st[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = live && d < hd && e0 + j < hd;
    const size_t o = (bh * hd + d) * hd + e0 + j;
    lam[j] = ok ? ds_out[o] : 0.f;
    st[j] = ok ? s0[o] : 0.f;
  }

  // the adjoint: lam_c = w_c * lam_{c+1} + G_c, keeping lam_{c+1} in G_c
  int c = n_chunks;
  for (; c >= SCAN_AHEAD; c -= SCAN_AHEAD) {
    float4 gc[SCAN_AHEAD];
    float wc[SCAN_AHEAD];
#pragma unroll
    for (int j = 0; j < SCAN_AHEAD; ++j) {
      const int cc = c - 1 - j;
      gc[j] = live ? *reinterpret_cast<const float4*>(pl + cc * step)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      wc[j] = live ? w[(size_t)cc * HDP] : 1.f;
    }
#pragma unroll
    for (int j = 0; j < SCAN_AHEAD; ++j) {
      const int cc = c - 1 - j;
      if (live)
        *reinterpret_cast<float4*>(pl + cc * step) =
            make_float4(lam[0], lam[1], lam[2], lam[3]);
      lam[0] = carry(wc[j], lam[0], gc[j].x);
      lam[1] = carry(wc[j], lam[1], gc[j].y);
      lam[2] = carry(wc[j], lam[2], gc[j].z);
      lam[3] = carry(wc[j], lam[3], gc[j].w);
    }
  }
  for (; c > 0; --c) {
    const int cc = c - 1;
    if (!live) continue;
    const float4 gc = *reinterpret_cast<const float4*>(pl + cc * step);
    const float wc = w[(size_t)cc * HDP];
    *reinterpret_cast<float4*>(pl + cc * step) =
        make_float4(lam[0], lam[1], lam[2], lam[3]);
    lam[0] = carry(wc, lam[0], gc.x);
    lam[1] = carry(wc, lam[1], gc.y);
    lam[2] = carry(wc, lam[2], gc.z);
    lam[3] = carry(wc, lam[3], gc.w);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (live && d < hd && e0 + j < hd)
      ds0[(bh * hd + d) * hd + e0 + j] = lam[j];

  // the state: S_{c+1} = w_c * S_c + dS_c, keeping S_c in dS_c, and Q_c =
  // sum_e lam_{c+1} * S_{c+1} (lam_{c+1} is this lane's own write above)
  float* q = wq + bh * n_chunks * HDP + d;
  for (c = 0; c < n_chunks; c += SCAN_AHEAD) {
    const int n = min(SCAN_AHEAD, n_chunks - c);
    float4 dsc[SCAN_AHEAD], ln[SCAN_AHEAD];
    float wc[SCAN_AHEAD];
#pragma unroll
    for (int j = 0; j < SCAN_AHEAD; ++j) {
      const bool ok = live && j < n;
      dsc[j] = ok ? *reinterpret_cast<const float4*>(ps + (c + j) * step)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      ln[j] = ok ? *reinterpret_cast<const float4*>(pl + (c + j) * step)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      wc[j] = ok ? w[(size_t)(c + j) * HDP] : 1.f;
    }
#pragma unroll
    for (int j = 0; j < SCAN_AHEAD; ++j) {
      if (j >= n) break;
      if (live)
        *reinterpret_cast<float4*>(ps + (c + j) * step) =
            make_float4(st[0], st[1], st[2], st[3]);
      st[0] = carry(wc[j], st[0], dsc[j].x);
      st[1] = carry(wc[j], st[1], dsc[j].y);
      st[2] = carry(wc[j], st[2], dsc[j].z);
      st[3] = carry(wc[j], st[3], dsc[j].w);
      float p = ln[j].x * st[0];
      p = fmaf(ln[j].y, st[1], p);
      p = fmaf(ln[j].z, st[2], p);
      p = fmaf(ln[j].w, st[3], p);
      p = group_sum<NG>(p);
      if (g == 0 && d < HDP) q[(size_t)(c + j) * HDP] = p;
    }
  }
}

// pass 3's token-tile row stride: HDP, or HDP + 4 where HDP / 4 is even,
// so that RS / 4 is odd and 8 consecutive rows fall on distinct banks
__host__ __device__ __forceinline__ int grad_rs(int HDP) {
  return (HDP / 4) % 2 ? HDP : HDP + 4;
}

__host__ __device__ __forceinline__ size_t grad_smem_floats(int hd, int C) {
  const size_t HDP = round4(hd), CP = round4(C), RS = grad_rs(HDP);
  return 6 * CP * RS + 2 * CP * HDP + 3 * CP * CP + HDP * HDP + 2 * HDP +
         2 * CP;
}

// Pass 3. grid (n_chunks, H, B); block GRAD_THREADS; dynamic shared memory
// (floats): r_s, k_s, v_s, y_s (dy), rd_s (r_dec; later b), ki_s (k_inv)
// [CP][RS] (bf16 r, k, v staged in rd_s and ki_s on their way) | c_s
// (logw, then cum) [CP][HDP] | kc_t (k_carry^T [HDP][CP]; later a
// [CP][HDP]) | am_s (A[t][s]), m_s (M[t][s]), mt_s (M^T) [CP][CP] | h_s
// (lam_{c+1}, later S_c) [HDP][HDP] | u_s, q_s [HDP] | bonus, vdy [CP].
template <typename T>
__global__ void __launch_bounds__(GRAD_THREADS)
    wkv6_bwd_chunk_grad_kernel(const T* __restrict__ r,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ logw,
                               const float* __restrict__ u,
                               const float* __restrict__ dy,
                               const float* __restrict__ ws_s,
                               const float* __restrict__ ws_l,
                               const float* __restrict__ wq,
                               T* __restrict__ dr, T* __restrict__ dk,
                               T* __restrict__ dv,
                               float* __restrict__ dlogw,
                               float* __restrict__ du_part, int S, int H,
                               int hd, int C, int async) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int HDP = round4(hd), CP = round4(C), RS = grad_rs(HDP);
  const int GT = CP / 4, GH = HDP / 4;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;
  float* k_s = r_s + CP * RS;
  float* v_s = k_s + CP * RS;
  float* y_s = v_s + CP * RS;
  float* rd_s = y_s + CP * RS;
  float* ki_s = rd_s + CP * RS;
  float* c_s = ki_s + CP * RS;
  float* kc_t = c_s + CP * HDP;
  float* am_s = kc_t + HDP * CP;
  float* m_s = am_s + CP * CP;
  float* mt_s = m_s + CP * CP;
  float* h_s = mt_s + CP * CP;
  float* u_s = h_s + HDP * HDP;
  float* q_s = u_s + HDP;
  float* bonus = q_s + HDP;
  float* vdy = bonus + CP;
  float* a_s = kc_t;                        // once dv is formed
  float* b_s = rd_s;                        // once dk is formed

  const size_t row = (size_t)H * hd;
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const int t0 = c * C;
  const int n_valid = min(C, S - t0);
  const size_t bhc = ((size_t)b * H + h) * n_chunks + c;
  for (int d = tid; d < HDP; d += GRAD_THREADS) {
    u_s[d] = d < hd ? u[(size_t)h * hd + d] : 0.f;
    q_s[d] = wq[bhc * HDP + d];
  }
  // lam_{c+1} on its way beside the chunk's tiles
  const float* lam = ws_l + bhc * HDP * HDP;
  for (int i = 4 * tid; i < HDP * HDP; i += 4 * GRAD_THREADS)
    cp_async16(h_s + i, lam + i);
  load_chunk(dy, y_s, RS, async, base, row, t0, S, C, CP, hd, HDP);
  const T* xs[3] = {r, k, v};
  float* const dsts[3] = {r_s, k_s, v_s};
  const int lds[3] = {RS, RS, RS};
  load_tiles<T, 3>(xs, dsts, lds, logw, c_s, rd_s, async, base, row, t0, S,
                   C, CP, hd, HDP);

  // per channel: cum in place of logw, in token order, and the decayed
  // factors r_dec, k_inv and k_carry^T (zeros on the padded rows)
  for (int d = tid; d < HDP; d += GRAD_THREADS) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      acc += c_s[t * HDP + d];
      c_s[t * HDP + d] = acc;
    }
    float excl = 0.f;
    for (int t = 0; t < CP; ++t) {
      const float cm = t < C ? c_s[t * HDP + d] : acc;
      const float kt = k_s[t * RS + d];
      rd_s[t * RS + d] = t ? r_s[t * RS + d] * expf(excl) : r_s[d];
      ki_s[t * RS + d] = kt * expf(-cm);
      kc_t[d * CP + t] = kt * expf(acc - cm);
      excl = cm;
    }
  }
  // per token: u's bonus r . (u * k) on the last CP threads, v . dy on the
  // CP before them, each in channel order
  const int tb = tid - (GRAD_THREADS - CP), tv = tb + CP;
  if (tb >= 0) {
    float acc = 0.f;
    for (int d = 0; d < hd; ++d)
      acc = fmaf(r_s[tb * RS + d], u_s[d] * k_s[tb * RS + d], acc);
    bonus[tb] = acc;
  } else if (tv >= 0) {
    float acc = 0.f;
    for (int e = 0; e < hd; ++e)
      acc = fmaf(v_s[tv * RS + e], y_s[tv * RS + e], acc);
    vdy[tv] = acc;
  }
  cp_async_wait_all();
  __syncthreads();

  // A = strictly_lower(r_dec k_inv^T) and M = strictly_lower(dy v^T), both
  // [t][s]; M also transposed
  for (int job = tid; job < 2 * GT * GT; job += GRAD_THREADS) {
    const bool is_m = job >= GT * GT;
    const int tile = is_m ? job - GT * GT : job;
    const int tl = tile % GT, s0 = 4 * (tile / GT);
    float acc[4][4] = {};
    dot_tile(acc, is_m ? y_s : rd_s, RS, tl, GT, is_m ? v_s : ki_s, RS, s0,
             HDP);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tl + GT * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + j;
        const float x = s < t ? acc[i][j] : 0.f;
        if (is_m) {
          m_s[t * CP + s] = x;
          mt_s[s * CP + t] = x;
        } else {
          am_s[t * CP + s] = x;
        }
      }
    }
  }
  __syncthreads();

  // dv = A^T dy + diag(bonus) dy + k_carry lam_{c+1}, 4 x 4 tiles of (t, e)
  for (int tile = tid; tile < GT * GH; tile += GRAD_THREADS) {
    const int tl = tile % GT, e0 = 4 * (tile / GT);
    float z1[4][4] = {}, z2[4][4] = {};
    outer_tile(z1, am_s, CP, tl, GT, y_s, RS, e0, tl + 1, CP);
    outer_tile(z2, kc_t, CP, tl, GT, h_s, HDP, e0, 0, HDP);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tl + GT * i;
      if (t >= n_valid) continue;
      const float4 gy = *reinterpret_cast<const float4*>(y_s + t * RS + e0);
      const float gv[4] = {gy.x, gy.y, gy.z, gy.w};
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = __fadd_rn(fmaf(bonus[t], gv[j], z1[i][j]), z2[i][j]);
      store_row4(dv + base + (size_t)(t0 + t) * row + e0, o, e0, hd);
    }
  }
  __syncthreads();

  // dk' = exp(-cum) (M^T r_dec) + exp(cum_last - cum) (v lam_{c+1}^T),
  // 4 x 4 tiles of (t, d); a = k * dk' into a_s; dk = dk' + r u (v . dy)
  const float* c_last = c_s + (C - 1) * HDP;
  for (int tile = tid; tile < GT * GH; tile += GRAD_THREADS) {
    const int tl = tile % GT, d0 = 4 * (tile / GT);
    float y1[4][4] = {}, y2[4][4] = {};
    outer_tile(y1, m_s, CP, tl, GT, rd_s, RS, d0, tl + 1, CP);
    dot_tile(y2, v_s, RS, tl, GT, h_s, HDP, d0, HDP);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tl + GT * i;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + j;
        const float cm = c_s[t * HDP + d];
        const float dkp = fmaf(expf(-cm), y1[i][j],
                               expf(c_last[d] - cm) * y2[i][j]);
        a_s[t * HDP + d] = k_s[t * RS + d] * dkp;
        o[j] = fmaf(r_s[t * RS + d] * u_s[d], vdy[t], dkp);
      }
      if (t < n_valid)
        store_row4(dk + base + (size_t)(t0 + t) * row + d0, o, d0, hd);
    }
  }
  __syncthreads();

  // S_c into the space lam_{c+1} leaves
  const float* S_c = ws_s + bhc * HDP * HDP;
  for (int i = 4 * tid; i < HDP * HDP; i += 4 * GRAD_THREADS)
    cp_async16(h_s + i, S_c + i);
  cp_async_wait_all();
  __syncthreads();

  // dr' = exp(cum_excl) (dy S_c^T + M k_inv), 4 x 4 tiles of (t, d); b = r
  // * dr' into b_s; dr = dr' + u k (v . dy)
  for (int tile = tid; tile < GT * GH; tile += GRAD_THREADS) {
    const int tl = tile % GT, d0 = 4 * (tile / GT);
    float x1[4][4] = {}, x2[4][4] = {};
    dot_tile(x1, y_s, RS, tl, GT, h_s, HDP, d0, HDP);
    outer_tile(x2, mt_s, CP, tl, GT, ki_s, RS, d0, 0, tl + 3 * GT);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tl + GT * i;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + j;
        const float e_excl = t ? expf(c_s[(t - 1) * HDP + d]) : 1.f;
        const float drp = e_excl * __fadd_rn(x1[i][j], x2[i][j]);
        b_s[t * RS + d] = r_s[t * RS + d] * drp;
        o[j] = fmaf(u_s[d] * k_s[t * RS + d], vdy[t], drp);
      }
      if (t < n_valid)
        store_row4(dr + base + (size_t)(t0 + t) * row + d0, o, d0, hd);
    }
  }
  __syncthreads();

  // per channel, down the chunk's tokens: dlogw_t = Q_t - a_t, Q_{t-1} =
  // Q_t - a_t + b_t from the chunk's Q; du's partial r k (v . dy)
  for (int d = tid; d < hd; d += GRAD_THREADS) {
    float q = q_s[d], du = 0.f;
    for (int t = n_valid - 1; t >= 0; --t) {
      const float a = a_s[t * HDP + d];
      dlogw[base + (size_t)(t0 + t) * row + d] = q - a;
      q = q - a + b_s[t * RS + d];
      du = fmaf(r_s[t * RS + d] * k_s[t * RS + d], vdy[t], du);
    }
    du_part[bhc * hd + d] = du;
  }
}

template <int NG>
int launch_scan(const void* s0, const void* ds_out, void* ws_s, void* ws_l,
                const void* wl, void* wq, void* ds0, int B, int H, int hd,
                int n_chunks, cudaStream_t stream) {
  constexpr int RPB = SCAN_THREADS / NG;
  const dim3 grid((round4(hd) + RPB - 1) / RPB, B * H);
  wkv6_bwd_scan_kernel<NG><<<grid, SCAN_THREADS, 0, stream>>>(
      (const float*)s0, (const float*)ds_out, (float*)ws_s, (float*)ws_l,
      (const float*)wl, (float*)wq, (float*)ds0, hd, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, const void* dy, const void* ds_out,
           void* dr, void* dk, void* dv, void* dlogw, void* du_part,
           void* ds0, void* ws_s, void* ws_l, void* wl, void* wq, int B,
           int S, int H, int hd, int C, cudaStream_t stream) {
  const int HDP = round4(hd), CP = round4(C);
  const int n_chunks = (S + C - 1) / C;
  // cp.async loads: rows of 16-byte multiples, every pointer aligned
  const int async =
      (hd * sizeof(T)) % 16 == 0 && hd % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(logw) |
        reinterpret_cast<uintptr_t>(dy)) &
       15) == 0;
  const size_t smem1 = sizeof(float) * 7 * CP * HDP;
  const size_t smem3 = sizeof(float) * grad_smem_floats(hd, C);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(wkv6_bwd_chunk_state_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem1)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(wkv6_bwd_chunk_grad_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem3)) != cudaSuccess)
    return (int)err;
  const dim3 grid(n_chunks, H, B);
  wkv6_bwd_chunk_state_kernel<T><<<grid, STATE_THREADS, smem1, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw,
      (const float*)dy, (float*)ws_s, (float*)ws_l, (float*)wl, S, H, hd, C,
      async);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int lanes = HDP / 4;
  int rc;
  if (lanes <= 1)
    rc = launch_scan<1>(s0, ds_out, ws_s, ws_l, wl, wq, ds0, B, H, hd,
                        n_chunks, stream);
  else if (lanes <= 2)
    rc = launch_scan<2>(s0, ds_out, ws_s, ws_l, wl, wq, ds0, B, H, hd,
                        n_chunks, stream);
  else if (lanes <= 4)
    rc = launch_scan<4>(s0, ds_out, ws_s, ws_l, wl, wq, ds0, B, H, hd,
                        n_chunks, stream);
  else if (lanes <= 8)
    rc = launch_scan<8>(s0, ds_out, ws_s, ws_l, wl, wq, ds0, B, H, hd,
                        n_chunks, stream);
  else if (lanes <= 16)
    rc = launch_scan<16>(s0, ds_out, ws_s, ws_l, wl, wq, ds0, B, H, hd,
                         n_chunks, stream);
  else
    rc = launch_scan<32>(s0, ds_out, ws_s, ws_l, wl, wq, ds0, B, H, hd,
                         n_chunks, stream);
  if (rc != 0) return rc;
  wkv6_bwd_chunk_grad_kernel<T><<<grid, GRAD_THREADS, smem3, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw,
      (const float*)u, (const float*)dy, (const float*)ws_s,
      (const float*)ws_l, (const float*)wq, (T*)dr, (T*)dk, (T*)dv,
      (float*)dlogw, (float*)du_part, S, H, hd, C, async);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v: [B, S, H, hd] of `dtype` (0 = float32, 1 = bfloat16); logw, dy:
// [B, S, H, hd] float32; u: [H, hd] float32; s0, ds_out: [B, H, hd, hd]
// float32 -> dr, dk, dv [B, S, H, hd] of `dtype`, dlogw [B, S, H, hd]
// float32, du_part [B, H, n_chunks, hd] float32 (du summed over each
// chunk's tokens; the caller sums over B and the chunks), ds0 [B, H, hd,
// hd] float32. Chunks of C tokens (1 <= C <= 32), 1 <= hd <= 128, n_chunks
// = ceil(S / C), HDP = hd rounded up to a multiple of 4. Workspace, float32:
// ws_s, ws_l B * H * n_chunks * HDP^2 each, wl, wq B * H * n_chunks * HDP
// each. Three kernels on `stream`. Returns a cudaError_t (0 = success).
int wkv6_chunked_bwd(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* s0,
                     const void* dy, const void* ds_out, void* dr, void* dk,
                     void* dv, void* dlogw, void* du_part, void* ds0,
                     void* ws_s, void* ws_l, void* wl, void* wq, int B, int S,
                     int H, int hd, int C, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (hd < 1 || hd > 128 || C < 1 || C > 32 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(r, k, v, logw, u, s0, dy, ds_out, dr, dk, dv, dlogw,
                         du_part, ds0, ws_s, ws_l, wl, wq, B, S, H, hd, C,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, u, s0, dy, ds_out, dr, dk,
                                 dv, dlogw, du_part, ds0, ws_s, ws_l, wl, wq,
                                 B, S, H, hd, C, st);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
