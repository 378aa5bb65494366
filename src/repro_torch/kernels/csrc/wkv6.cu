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
//   y = A v + diag(r . (u * k)) v + (r * exp(cum_excl)) S_c
//   S_{c+1} = exp(cum_last) * S_c + (k * exp(cum_last - cum))^T v
// which is the factorisation of the JAX model's `wkv_chunked`
// (src/repro/models/rwkv.py), kept as it is so that the kernel and the
// plain version round alike. The clamp of the model's decay rates bounds
// exp(-cum) by about exp(32 * e^0.5) ~ 1e23 at C = 32, inside fp32. In
// the port the two kernels take the places where the JAX model computes
// the same math in jnp: the chunked scan of prefill and the einsums of
// decode.
//
// What bounds them on this card.
// - B4: operations, on the CUDA cores in fp32, close to the bytes. At
//   rwkv6-1.6b prefill (H 32, hd 64, C 32) a chunk of one head does
//   ~2*C*hd*(C + 2*hd) flops on C*hd*(3*2 + 4 + 4) bytes of bf16 r/k/v,
//   fp32 logw and fp32 y. The fp32 form is what the decay factorisation
//   needs (TF32 keeps three digits, and exp(-cum) reaches 1e23).
// - B3: bytes. One token reads and writes the [hd, hd] fp32 state of each
//   (slot, head), 2 * B * H * hd^2 * 4 bytes, for ~4 flops per state entry.
//
// What the designs do about it.
// - B4, chunk-parallel in three passes (one wrapper call). The only thing
//   that orders the chunks is the state carry, and that carry is
//   elementwise in (d, e): S_{c+1} = w_c * S_c + dS_c. So
//   (a) `wkv6_chunk_state_kernel`, one block per (batch, head, chunk):
//       the chunk's increment dS_c = k_carry^T v and its decay w_c =
//       exp(cum_last), into a workspace;
//   (b) `wkv6_state_scan_kernel`, one thread per (batch, head, d, e): the
//       recurrence over the chunks, with the loads of eight chunks in
//       flight (they do not depend on the carry); it overwrites each dS_c
//       with the state S_c entering chunk c, and writes the final state;
//   (c) `wkv6_chunk_output_kernel`, one block per (batch, head, chunk):
//       the whole of y for the chunk, A v + diag v + r_dec S_c, written
//       once. One block per (batch, head) walking its chunks in order would
//       be 32 blocks on 132 SMs at B = 1, each chunk a row of barriers; the
//       grid of (a) and (c) is 1536 blocks at S 1531.
//   Pass (c) recomputes the cumulative decay and reads r, k, v, logw again
//   instead of (a) writing a partial y that (c) would read back: that
//   moves fewer bytes (bf16 r/k/v) and writes y once. The workspace is
//   B*H*n_chunks*hd^2 fp32 (25 MB at S 1531), one tensor for dS_c and S_c.
//   Every product is register-tiled: a thread owns a 4 x 4 tile of its
//   output and reads two float4 from shared memory for 16 FMAs. A chunk's
//   tiles arrive by 16-byte cp.async, every load of the block in flight at
//   once (bf16 staged, then upcast in shared memory): a load-then-store
//   loop would keep one load a thread in flight, and the passes would wait
//   on memory. Pass (c) fetches S_c by cp.async into the space r, k and
//   logw leave once the decayed factors are formed, while it computes the
//   scores. Rows and columns are padded to a multiple of 4 in shared memory
//   (zeros), and the ragged tail is masked at load (k = v = 0 and logw = 0
//   past S), so any hd <= 128 and any C <= 32 run and nothing is copied
//   padded (an hd whose rows are not 16-byte multiples loads element by
//   element). All of it is fp32 on the CUDA cores; the tensor cores
//   (3xTF32) are the next step. Every sum runs in token or channel order
//   with fused multiply-adds (the bonus one thread per token, the carry
//   fmaf(w, S, dS)), as a kernel that walked the chunks one after another
//   would round them: splitting the walk into passes changes no bit.
// - B3: the state streams through once, so what counts is how much of it
//   is in flight. Column e of S' and y_e need column e of S alone, so a
//   (slot, head) splits across blocks by value columns, 16 a block, with
//   no sum across blocks: 512 blocks at rwkv6-1.6b's B 4, H 32, hd 64.
//   Each block fetches its hd x 16 tile by 16-byte cp.async, every row in
//   flight at once (4 KB at hd 64, 8 KB at hd 128), with r, k, w, u for
//   every d and v for its columns; then its first warp sums y, one
//   thread a column over d in order, while the others write S' as float4
//   rows. The sum and the update are written with the fused multiply-adds
//   that nvcc made of the first version's one-thread-a-column loop, so
//   they keep its bits. That sum stays hd dependent multiply-adds a
//   column, begun once the tile is in: on an H100 it is what keeps the
//   kernel above an elementwise pass over the same bytes. The new state
//   goes to a fresh tensor, as the TPU kernel's output does; freezing
//   parked slots is the model's job, not the kernel's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_THREADS = 128;   // passes (a) and (c)
constexpr int SCAN_THREADS = 256;    // pass (b)
constexpr int SCAN_AHEAD = 8;        // chunks of pass (b) loaded at once
constexpr int DEC_THREADS = 128;     // B3
constexpr int DEC_TE = 16;           // B3: value columns a block
constexpr int DEC_MAX_HD = 128;      // B3: the tile and vectors on chip

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
// place (after a barrier)
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

// (a) grid (n_chunks, H, B); block CHUNK_THREADS; dynamic shared memory
// k_s | v_s | lw_s | stage, [CP][HDP] floats each. Writes ws[b,h,c] =
// dS_c [HDP][HDP] and wl[b,h,c] = exp(cum_last) [HDP].
template <typename T>
__global__ void wkv6_chunk_state_kernel(const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ logw,
                                        float* __restrict__ ws,
                                        float* __restrict__ wl, int S, int H,
                                        int hd, int C, int async) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int HDP = round4(hd), CP = round4(C), tid = threadIdx.x;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + CP * HDP;
  float* lw_s = v_s + CP * HDP;
  float* stage = lw_s + CP * HDP;           // bf16 k and v, on their way

  const size_t row = (size_t)H * hd;
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const int t0 = c * C;
  const T* xs[2] = {k, v};
  float* const ds[2] = {k_s, v_s};
  const int lds[2] = {HDP, HDP};
  load_tiles<T, 2>(xs, ds, lds, logw, lw_s, stage, async, base, row, t0, S,
                   C, CP, hd, HDP);

  const size_t bhc = ((size_t)b * H + h) * n_chunks + c;
  // per channel: the inclusive cumulative log-decay, in token order, then
  // k_carry = k * exp(cum_last - cum) in place of k
  for (int d = tid; d < HDP; d += CHUNK_THREADS) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      acc += lw_s[t * HDP + d];
      lw_s[t * HDP + d] = acc;
    }
    for (int t = 0; t < C; ++t)
      k_s[t * HDP + d] *= expf(acc - lw_s[t * HDP + d]);
    wl[bhc * HDP + d] = expf(acc);
  }
  __syncthreads();

  // dS = k_carry^T v, 4 x 4 tiles of (d, e)
  const int G = HDP / 4;
  float* out = ws + bhc * HDP * HDP;
  for (int tile = tid; tile < G * G; tile += CHUNK_THREADS) {
    const int d0 = 4 * (tile / G), e0 = 4 * (tile % G);
    float acc[4][4] = {};
    for (int t = 0; t < C; ++t)
      fma4x4(acc, *reinterpret_cast<const float4*>(k_s + t * HDP + d0),
             *reinterpret_cast<const float4*>(v_s + t * HDP + e0));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + (size_t)(d0 + i) * HDP + e0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// (b) grid (ceil(HDP^2 / SCAN_THREADS), B * H); one thread per (d, e).
// S = S0; for each chunk c: ws[c] <- S, S <- w_c * S + dS_c; s_out = S.
__global__ void wkv6_state_scan_kernel(const float* __restrict__ s0,
                                       float* __restrict__ ws,
                                       const float* __restrict__ wl,
                                       float* __restrict__ s_out, int hd,
                                       int n_chunks) {
  const int HDP = round4(hd);
  const int i = blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (i >= HDP * HDP) return;
  const int d = i / HDP, e = i % HDP;
  const size_t bh = blockIdx.y;
  const bool real = d < hd && e < hd;
  const size_t so = bh * hd * hd + (size_t)d * hd + e;
  float s = real ? s0[so] : 0.f;
  float* p = ws + bh * n_chunks * HDP * HDP + i;
  const float* w = wl + bh * n_chunks * HDP + d;
  const size_t step = (size_t)HDP * HDP;
  int c = 0;
  for (; c + SCAN_AHEAD <= n_chunks; c += SCAN_AHEAD) {
    float ds[SCAN_AHEAD], wc[SCAN_AHEAD];
#pragma unroll
    for (int j = 0; j < SCAN_AHEAD; ++j) {
      ds[j] = p[(c + j) * step];
      wc[j] = w[(size_t)(c + j) * HDP];
    }
#pragma unroll
    for (int j = 0; j < SCAN_AHEAD; ++j) {
      p[(c + j) * step] = s;
      s = fmaf(wc[j], s, ds[j]);
    }
  }
  for (; c < n_chunks; ++c) {
    const float ds = p[c * step];
    p[c * step] = s;
    s = fmaf(w[(size_t)c * HDP], s, ds);
  }
  if (real) s_out[so] = s;
}

// r_s, k_s [CP][HDP + 4] | lw_s [CP][HDP], later S_c [HDP][HDP]
__host__ __device__ size_t output_region(int hd, int C) {
  const size_t HDP = round4(hd), CP = round4(C);
  const size_t a = CP * (2 * (HDP + 4) + HDP), b = HDP * HDP;
  return a > b ? a : b;
}

// (c) grid (n_chunks, H, B); block CHUNK_THREADS; dynamic shared memory
// (floats): [r_s, k_s (rows HDP + 4 apart, so that the bonus's threads,
// one per row, spread over the banks) | lw_s, later S_c] | v_s [CP][HDP] |
// rd_t, ki_t [HDP][CP + 4] (before them, bf16 r, k, v on their way) | a_t
// [CP][CP] | diag [CP] | u_s [HDP]. rd_t and ki_t are r_dec and k_inv
// transposed (channel-major), a_t the scores transposed (a_t[s][t] =
// A[t][s]), so that every product reads float4 along its output's rows.
template <typename T>
__global__ void wkv6_chunk_output_kernel(const T* __restrict__ r,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         const float* __restrict__ logw,
                                         const float* __restrict__ u,
                                         const float* __restrict__ ws,
                                         float* __restrict__ y, int S, int H,
                                         int hd, int C, int async) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int HDP = round4(hd), CP = round4(C), CS = CP + 4, RS = HDP + 4;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;
  float* k_s = r_s + CP * RS;
  float* lw_s = k_s + CP * RS;
  float* S_s = smem;                        // once r, k and logw are used
  float* v_s = smem + output_region(hd, C);
  float* rd_t = v_s + CP * HDP;
  float* ki_t = rd_t + HDP * CS;
  float* a_t = ki_t + HDP * CS;
  float* diag = a_t + CP * CP;
  float* u_s = diag + CP;

  const size_t row = (size_t)H * hd;
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const int t0 = c * C;
  for (int d = tid; d < HDP; d += CHUNK_THREADS)
    u_s[d] = d < hd ? u[(size_t)h * hd + d] : 0.f;
  // bf16 r, k and v are staged where rd_t and ki_t go later
  const T* xs[3] = {r, k, v};
  float* const ds[3] = {r_s, k_s, v_s};
  const int lds[3] = {RS, RS, HDP};
  load_tiles<T, 3>(xs, ds, lds, logw, lw_s, rd_t, async, base, row, t0, S,
                   C, CP, hd, HDP);

  // the u bonus of each row, in channel order: one thread per token, on
  // the last threads, while the first ones walk the channels below
  const int t_bonus = tid - (CHUNK_THREADS - CP);
  if (t_bonus >= 0) {
    float acc = 0.f;
    for (int d = 0; d < hd; ++d)
      acc = fmaf(r_s[t_bonus * RS + d], u_s[d] * k_s[t_bonus * RS + d], acc);
    diag[t_bonus] = acc;
  }
  // per channel: the cumulative log-decay in token order, and the decayed
  // factors r_dec = r * exp(cum - logw), k_inv = k * exp(-cum)
  for (int d = tid; d < HDP; d += CHUNK_THREADS) {
    float acc = 0.f;
    for (int t = 0; t < CP; ++t) {
      const float l = lw_s[t * HDP + d];
      acc += l;
      rd_t[d * CS + t] = r_s[t * RS + d] * expf(acc - l);
      ki_t[d * CS + t] = k_s[t * RS + d] * expf(-acc);
    }
  }
  __syncthreads();

  // S_c into the space of r, k and logw, while the scores are computed
  const float* S_c = ws + (((size_t)b * H + h) * n_chunks + c) * HDP * HDP;
  for (int i = 4 * tid; i < HDP * HDP; i += 4 * CHUNK_THREADS)
    cp_async16(S_s + i, S_c + i);

  // strictly lower scores A[t][s] = r_dec[t] . k_inv[s], 4 x 4 tiles
  const int GC = CP / 4;
  for (int tile = tid; tile < GC * GC; tile += CHUNK_THREADS) {
    const int tt = 4 * (tile / GC), s0 = 4 * (tile % GC);
    float acc[4][4] = {};
    if (s0 < tt + 3)
      for (int d = 0; d < HDP; ++d)
        fma4x4(acc, *reinterpret_cast<const float4*>(rd_t + d * CS + tt),
               *reinterpret_cast<const float4*>(ki_t + d * CS + s0));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + j;
      *reinterpret_cast<float4*>(a_t + s * CP + tt) = make_float4(
          s < tt ? acc[0][j] : 0.f, s < tt + 1 ? acc[1][j] : 0.f,
          s < tt + 2 ? acc[2][j] : 0.f, s < tt + 3 ? acc[3][j] : 0.f);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // y = (A v + diag v) + r_dec S_c, 4 x 4 tiles of (t, e)
  const int G = HDP / 4;
  for (int tile = tid; tile < GC * G; tile += CHUNK_THREADS) {
    const int tt = 4 * (tile / G), e0 = 4 * (tile % G);
    float in[4][4] = {}, st[4][4] = {};
    for (int s = 0; s < tt + 3 && s < CP; ++s)
      fma4x4(in, *reinterpret_cast<const float4*>(a_t + s * CP + tt),
             *reinterpret_cast<const float4*>(v_s + s * HDP + e0));
    for (int d = 0; d < HDP; ++d)
      fma4x4(st, *reinterpret_cast<const float4*>(rd_t + d * CS + tt),
             *reinterpret_cast<const float4*>(S_s + d * HDP + e0));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tt + i;
      if (t >= C || t0 + t >= S) break;
      const float4 vt = *reinterpret_cast<const float4*>(v_s + t * HDP + e0);
      const float vv[4] = {vt.x, vt.y, vt.z, vt.w};
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = __fadd_rn(fmaf(diag[t], vv[j], in[i][j]), st[i][j]);
      float* yo = y + base + (size_t)(t0 + t) * row + e0;
      if ((hd & 3) == 0) {
        *reinterpret_cast<float4*>(yo) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e0 + j < hd) yo[j] = o[j];
      }
    }
  }
}

// B3: grid (B * H, ceil(hd / DEC_TE)); block DEC_THREADS. A block owns
// value columns e0 .. e0 + te - 1 of one (slot, head): column e of S' and
// y_e read column e of S alone, so the tiles need nothing from each other.
// With `vec` (hd a multiple of 4, s and s_out 16-byte aligned) the hd x te
// tile of S comes by 16-byte cp.async, every row in flight at once, and S'
// goes out as float4 rows; otherwise element by element. The first warp
// sums y while the others write S'. Both round as one thread per column
// walking d = 0 .. hd-1 did (nvcc's contraction of `fmaf(r, S + u * kv,
// acc)` and `w * S + kv` in the first version of this kernel, written
// out):
//   kv = k_d * v_e,  acc = fma(r_d, fma(u_d, kv, S_de), acc),
//   S'_de = fma(w_d, S_de, kv).
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
    wkv6_decode_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u,
                       const float* __restrict__ s, float* __restrict__ y,
                       float* __restrict__ s_out, int H, int hd, int vec) {
  __shared__ __align__(16) float S_s[DEC_MAX_HD * DEC_TE];
  __shared__ float r_s[DEC_MAX_HD], k_s[DEC_MAX_HD], w_s[DEC_MAX_HD],
      u_s[DEC_MAX_HD], v_s[DEC_TE];
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int e0 = blockIdx.y * DEC_TE;
  const int te = min(DEC_TE, hd - e0);
  const int tid = threadIdx.x;
  const size_t vo = (size_t)bh * hd;
  const float* S = s + vo * hd + e0;
  float* So = s_out + vo * hd + e0;

  // every load of the block in flight at once: the vectors into registers
  // (a load whose value went straight to shared memory would hold its
  // thread until it came), then the tile, then the vectors' stores
  static_assert(DEC_THREADS >= DEC_MAX_HD, "one vector entry a thread");
  float rd = 0.f, kd = 0.f, wd = 0.f, ud = 0.f, ve = 0.f;
  if (tid < hd) {
    rd = to_f(r[vo + tid]);
    kd = to_f(k[vo + tid]);
    wd = w[vo + tid];
    ud = u[(size_t)h * hd + tid];
  }
  if (tid < te) ve = to_f(v[vo + e0 + tid]);
  if (vec) {
    for (int i = tid; i < hd * (DEC_TE / 4); i += DEC_THREADS) {
      const int d = i / (DEC_TE / 4), c = 4 * (i % (DEC_TE / 4));
      if (c < te) cp_async16(S_s + d * DEC_TE + c, S + d * hd + c);
    }
  } else {
    for (int i = tid; i < hd * DEC_TE; i += DEC_THREADS) {
      const int d = i / DEC_TE, c = i % DEC_TE;
      if (c < te) S_s[d * DEC_TE + c] = S[d * hd + c];
    }
  }
  if (tid < hd) {
    r_s[tid] = rd;
    k_s[tid] = kd;
    w_s[tid] = wd;
    u_s[tid] = ud;
  }
  if (tid < te) v_s[tid] = ve;
  if (vec) cp_async_wait_all();
  __syncthreads();

  // y on the first warp, one thread a column, d in order; S' on the other
  // warps, four columns a thread, at the same time
  static_assert(DEC_TE <= 32, "the y threads are one warp");
  if (tid < 32) {
    if (tid >= te) return;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      const float kv = __fmul_rn(k_s[d], ve);
      acc = fmaf(r_s[d], fmaf(u_s[d], kv, S_s[d * DEC_TE + tid]), acc);
    }
    y[vo + e0 + tid] = acc;
    return;
  }
  for (int i = tid - 32; i < hd * (DEC_TE / 4); i += DEC_THREADS - 32) {
    const int d = i / (DEC_TE / 4), c = 4 * (i % (DEC_TE / 4));
    if (c >= te) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = c + j < te ? fmaf(w_s[d], S_s[d * DEC_TE + c + j],
                               __fmul_rn(k_s[d], v_s[c + j]))
                        : 0.f;
    if (vec) {
      *reinterpret_cast<float4*>(So + d * hd + c) =
          make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < te) So[d * hd + c + j] = o[j];
    }
  }
}

size_t output_smem(int hd, int C) {
  const size_t HDP = round4(hd), CP = round4(C);
  return sizeof(float) * (output_region(hd, C) + CP * HDP +
                          2 * HDP * (CP + 4) + CP * CP + CP + HDP);
}

template <typename T>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* y,
                   void* s_out, void* ws, void* wl, int B, int S, int H,
                   int hd, int C, cudaStream_t stream) {
  const int HDP = round4(hd), CP = round4(C);
  const int n_chunks = (S + C - 1) / C;
  const size_t smem_a = sizeof(float) * 4 * CP * HDP;
  // cp.async loads: rows of 16-byte multiples, every pointer aligned
  const int async =
      (hd * sizeof(T)) % 16 == 0 && hd % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(logw)) &
       15) == 0;
  const size_t smem_c = output_smem(hd, C);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk_state_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wkv6_chunk_output_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_chunks, H, B);
  wkv6_chunk_state_kernel<T><<<grid, CHUNK_THREADS, smem_a, stream>>>(
      (const T*)k, (const T*)v, (const float*)logw, (float*)ws, (float*)wl,
      S, H, hd, C, async);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 scan_grid((HDP * HDP + SCAN_THREADS - 1) / SCAN_THREADS, B * H);
  wkv6_state_scan_kernel<<<scan_grid, SCAN_THREADS, 0, stream>>>(
      (const float*)s0, (float*)ws, (const float*)wl, (float*)s_out, hd,
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_chunk_output_kernel<T><<<grid, CHUNK_THREADS, smem_c, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw,
      (const float*)u, (const float*)ws, (float*)y, S, H, hd, C, async);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s, void* y, void* s_out, int B,
                  int H, int hd, cudaStream_t stream) {
  if (hd < 1 || hd > DEC_MAX_HD || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int vec = hd % 4 == 0 && ((reinterpret_cast<uintptr_t>(s) |
                                   reinterpret_cast<uintptr_t>(s_out)) &
                                  15) == 0;
  const dim3 grid(B * H, (hd + DEC_TE - 1) / DEC_TE);
  wkv6_decode_kernel<T><<<grid, DEC_THREADS, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s, (float*)y, (float*)s_out, H, hd,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v: [B, S, H, hd] of `dtype` (0 = float32, 1 = bfloat16); logw:
// [B, S, H, hd] float32; u: [H, hd] float32; s0: [B, H, hd, hd] float32
// -> y [B, S, H, hd] float32, s_out [B, H, hd, hd] float32. Chunks of
// C tokens (1 <= C <= 32), hd <= 128. ws: B * H * n_chunks * HDP^2 and wl:
// B * H * n_chunks * HDP float32 of workspace (n_chunks = ceil(S / C), HDP
// = hd rounded up to a multiple of 4). Three kernels on `stream`. Returns a
// cudaError_t (0 = success).
int wkv6_chunked(const void* r, const void* k, const void* v,
                 const void* logw, const void* u, const void* s0, void* y,
                 void* s_out, void* ws, void* wl, int B, int S, int H,
                 int hd, int C, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (dtype == 0)
    return launch_chunked<float>(r, k, v, logw, u, s0, y, s_out, ws, wl, B,
                                 S, H, hd, C, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_chunked<__nv_bfloat16>(r, k, v, logw, u, s0, y, s_out, ws,
                                         wl, B, S, H, hd, C,
                                         (cudaStream_t)stream);
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
