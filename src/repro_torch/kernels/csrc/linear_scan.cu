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

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
