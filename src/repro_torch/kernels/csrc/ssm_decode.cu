// One Mamba (S6) decode token for Hopper (sm_90a): the discretised state
// update and its contraction with C (kernel B5).
//
// Replaces: the Pallas TPU kernel `ssm_decode_step` / `_ssm_dec_kernel`
// (src/repro/kernels/ssm_decode.py). Same function, the oracle
// `ssm_decode_step_ref` (src/repro/kernels/ref.py): for h, dA [B, Di, N],
// dtx [B, Di] and B_ssm, C_ssm [B, N], all float32,
//   h'[b,d,n] = dA[b,d,n] * h[b,d,n] + dtx[b,d] * B_ssm[b,n]
//   y[b,d]    = sum_n h'[b,d,n] * C_ssm[b,n],
// the T = 1 step of `linear_scan` followed by the C contraction. In the
// port it runs every Mamba layer's decode step (models/mamba.py), where
// the JAX model writes the same step in jnp.
//
// What bounds it on this card: device-memory bytes, or below that the
// launch itself. Each state element does ~4 flops on 12 bytes (h and dA
// read, h' written). At jamba-v0.1-52b decode (B 4, Di 8192, N 16) that is
// ~6.3 MB, ~1.9 us at 3.35 TB/s: about the latency of one launch and one
// round trip to device memory.
//
// What the design does about it. The TPU kernel gives each grid program
// one (batch, 256-channel block) and contracts the [Dblk, N] plane with C
// on the matrix unit. On Hopper:
// - one thread owns one (b, d, n) element, so neighbouring threads read
//   and write neighbouring addresses of h, dA and h' (coalesced), and
//   B 4 x Di 8192 x N 16 gives 2048 blocks of 256 threads;
// - N divides the warp's 32 lanes (the wrapper checks), so the N lanes of
//   one (b, d) sit in one warp and y[b, d] is their sum, reduced with
//   __shfl_xor_sync in log2(N) steps and written by lane n = 0: no shared
//   memory and no second pass;
// - threads past the end take part in the shuffles with a zero, so every
//   shuffle runs with the whole warp.
// The state update rounds each op (__fmul_rn, __fadd_rn) as the plain
// PyTorch version does, so h' equals it, and the T = 1 step of B6, bit
// for bit; y is summed in another order and agrees to fp32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void ssm_decode_kernel(const float* __restrict__ h,
                                  const float* __restrict__ dA,
                                  const float* __restrict__ dtx,
                                  const float* __restrict__ b_ssm,
                                  const float* __restrict__ c_ssm,
                                  float* __restrict__ y,
                                  float* __restrict__ h_out, int Di, int N,
                                  long long total) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = i < total;
  float part = 0.f;
  if (valid) {
    const long long bd = i / N;           // b * Di + d
    const int n = (int)(i - bd * N);
    const long long bi = bd / Di;
    const float hn = __fadd_rn(__fmul_rn(__ldg(dA + i), __ldg(h + i)),
                               __fmul_rn(__ldg(dtx + bd),
                                         __ldg(b_ssm + bi * N + n)));
    h_out[i] = hn;
    part = __fmul_rn(hn, __ldg(c_ssm + bi * N + n));
  }
  for (int off = N / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (valid && i % N == 0) y[i / N] = part;
}

}  // namespace

extern "C" {

// h, dA, h_out: [B, Di, N] float32; dtx, y: [B, Di] float32; b_ssm, c_ssm:
// [B, N] float32, all contiguous; N must divide 32. Returns a cudaError_t
// (0 = success).
int ssm_decode(const void* h, const void* dA, const void* dtx,
               const void* b_ssm, const void* c_ssm, void* y, void* h_out,
               int B, int Di, int N, void* stream) {
  if (N < 1 || N > 32 || 32 % N) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * Di * N;
  if (total == 0) return 0;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssm_decode_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)dA, (const float*)dtx,
      (const float*)b_ssm, (const float*)c_ssm, (float*)y, (float*)h_out, Di,
      N, total);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
