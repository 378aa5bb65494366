// First-order linear recurrence for Hopper (sm_90a): the Mamba selective
// scan's inner engine (kernel B6).
//
// Replaces: the Pallas TPU kernel `linear_scan` / `_scan_kernel`
// (src/repro/kernels/linear_scan.py). Same function, the oracle
// `linear_scan_ref` (src/repro/kernels/ref.py): for a, b [B, T, D, N] and
// h0 [B, D, N], all float32,
//   h_t = a_t * h_{t-1} + b_t   (h_{-1} = h0),
// returning every h_t as h_all [B, T, D, N] and the last as h_last
// [B, D, N]. In the port it runs each 256-token chunk of Mamba prefill
// (models/mamba.py), where the JAX model has an associative scan.
//
// What bounds it on this card: device-memory bytes. Each element does one
// multiply and one add per step on 12 bytes (a and b read once, h_all
// written once), a fraction of an operation per byte. At jamba-v0.1-52b
// prefill (B 1, a chunk of T 256, D 8192, N 16) that is ~403 MB, ~0.12 ms
// at 3.35 TB/s.
//
// What the design does about it. The TPU kernel gives each grid program
// one (batch, 256-channel block) and streams its [T, Dblk, N] slab through
// VMEM, the (Dblk, N) plane on the vector lanes. On Hopper:
// - one thread owns one (b, d, n) element and loops over t with h in a
//   register, so nothing is carried between blocks and h never touches
//   device memory between steps;
// - at each step neighbouring threads read neighbouring d * N + n
//   addresses of a_t and b_t and write neighbouring addresses of h_all, so
//   every load and store of a warp is one coalesced 128-byte transaction;
// - the loads of UNROLL steps are issued before their FMAs: they do not
//   depend on h, so each thread keeps 2 * UNROLL loads in flight, which is
//   what a bytes-bound loop with a serial dependency needs;
// - at B 1, D 8192, N 16 that is 131072 threads (512 blocks of 256), which
//   fills the 132 SMs.
// The multiply and the add round separately (__fmul_rn, __fadd_rn), as
// the plain PyTorch version's two element-wise ops do, so the kernel
// equals it bit for bit.
//
// The backward (B6-bwd, `linear_scan_bwd_kernel`) replaces no Pallas
// kernel: the reference trains Mamba through jax.grad of its jnp
// `_chunk_scan` (src/repro/models/mamba.py). The adjoint of the recurrence
// is itself a linear scan, run from the last step down: with g_t the
// gradient of h_t and g_last that of h_last,
//   lam_T = g_T + g_last,  lam_t = g_t + a_{t+1} * lam_{t+1},
//   db_t = lam_t,  da_t = lam_t * h_{t-1} (h0 at the first step),
//   dh0 = a_1 * lam_1.
// Bytes bound it as the forward: a, g and the saved h_all read once, da and
// db written once, 20 bytes an element a step (at jamba's chunk, ~671 MB,
// ~0.2 ms at 3.35 TB/s). The same design: one thread per (b, d, n) element,
// t looping downwards with lam in a register, neighbouring threads on
// neighbouring addresses, the loads of UNROLL steps issued before their
// arithmetic. Each step rounds as the plain version's ops do (a multiply,
// then an add; a multiply for da).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__global__ void linear_scan_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   const float* __restrict__ h0,
                                   float* __restrict__ h_all,
                                   float* __restrict__ h_last, int T,
                                   long long DN, long long total) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long bi = i / DN;          // batch row
  const long long e = i - bi * DN;      // d * N + n
  const long long base = bi * (long long)T * DN + e;
  float h = h0[i];
  int t = 0;
  for (; t + UNROLL <= T; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = base + (long long)(t + u) * DN;
      av[u] = __ldg(a + off);
      bv[u] = __ldg(b + off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      h_all[base + (long long)(t + u) * DN] = h;
    }
  }
  for (; t < T; ++t) {
    const long long off = base + (long long)t * DN;
    h = __fadd_rn(__fmul_rn(__ldg(a + off), h), __ldg(b + off));
    h_all[off] = h;
  }
  h_last[i] = h;
}

// grid ceil(B * D * N / THREADS); one thread per (b, d, n), t from T - 1
// down to 0
__global__ void linear_scan_bwd_kernel(const float* __restrict__ a,
                                       const float* __restrict__ h0,
                                       const float* __restrict__ h_all,
                                       const float* __restrict__ g_all,
                                       const float* __restrict__ g_last,
                                       float* __restrict__ da,
                                       float* __restrict__ db,
                                       float* __restrict__ dh0, int T,
                                       long long DN, long long total) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long bi = i / DN;
  const long long e = i - bi * DN;
  const long long base = bi * (long long)T * DN + e;
  // lam_{t+1} * a_{t+1}, carried down; at the top it is g_last
  float carry = g_last[i];
  int t = T - 1;
  for (; t - UNROLL + 1 >= 1; t -= UNROLL) {
    float gv[UNROLL], av[UNROLL], hv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = base + (long long)(t - u) * DN;
      gv[u] = __ldg(g_all + off);
      av[u] = __ldg(a + off);
      hv[u] = __ldg(h_all + off - DN);  // h_{t-u-1}, t - u >= 1
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = base + (long long)(t - u) * DN;
      const float lam = __fadd_rn(gv[u], carry);
      db[off] = lam;
      da[off] = __fmul_rn(lam, hv[u]);
      carry = __fmul_rn(av[u], lam);
    }
  }
  for (; t >= 0; --t) {
    const long long off = base + (long long)t * DN;
    const float lam = __fadd_rn(__ldg(g_all + off), carry);
    db[off] = lam;
    da[off] = __fmul_rn(lam, t > 0 ? __ldg(h_all + off - DN) : h0[i]);
    carry = __fmul_rn(__ldg(a + off), lam);
  }
  dh0[i] = carry;
}

}  // namespace

extern "C" {

// a, b, h_all: [B, T, D, N] float32; h0, h_last: [B, D, N] float32, all
// contiguous. Returns a cudaError_t (0 = success).
int linear_scan(const void* a, const void* b, const void* h0, void* h_all,
                void* h_last, int B, int T, int D, int N, void* stream) {
  const long long DN = (long long)D * N;
  const long long total = (long long)B * DN;
  if (total == 0) return 0;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  linear_scan_kernel<<<(unsigned)blocks, THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h_all,
      (float*)h_last, T, DN, total);
  return (int)cudaGetLastError();
}

// a, h_all, g_all, da, db: [B, T, D, N] float32; h0, g_last, dh0:
// [B, D, N] float32, all contiguous. g_all and g_last are the gradients of
// h_all and h_last; writes da, db and dh0. Returns a cudaError_t.
int linear_scan_bwd(const void* a, const void* h0, const void* h_all,
                    const void* g_all, const void* g_last, void* da, void* db,
                    void* dh0, int B, int T, int D, int N, void* stream) {
  const long long DN = (long long)D * N;
  const long long total = (long long)B * DN;
  if (total == 0) return 0;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  linear_scan_bwd_kernel<<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h0, (const float*)h_all,
      (const float*)g_all, (const float*)g_last, (float*)da, (float*)db,
      (float*)dh0, T, DN, total);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
