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
// on the matrix unit. On Hopper the state has to stream at the memory's
// rate, so every byte of it should be in flight at once:
// - one thread owns four neighbouring n of one (b, d): float4 loads of h
//   and dA and a float4 store of h', 32 bytes of loads a thread in flight.
//   At jamba's B 4, Di 8192, N 16 that is 131072 threads, 512 blocks of
//   256: one wave;
// - a block owns a range of d of one batch row (grid (d-ranges, B)), so
//   its indices need no division by a runtime value (a shift by
//   log2(threads per d)), in 32-bit math (the wrapper checks the sizes);
// - dtx is loaded once per d and B_ssm, C_ssm once per block, into shared
//   memory, instead of once per state element;
// - N divides 32 (the wrapper checks), so the threads of one (b, d) sit in
//   one warp and y[b, d] is their sum by __shfl_xor_sync, written by the
//   first of them: no second pass. Threads past Di shuffle a zero, so every
//   shuffle runs with the whole warp.
// N < 4, or h, dA or h' not 16-byte aligned, takes the same kernel with one
// n a thread (VEC = 1), as the first version of this kernel ran.
// The state update rounds each op (__fmul_rn, __fadd_rn) as the plain
// PyTorch version does, so h' equals it, and the T = 1 step of B6, bit for
// bit. y keeps the first version's sum, one thread per n with shuffles at
// offsets N/2, ..., 1: with four n a thread, the offsets N/2 .. 4 are
// shuffles at thread offsets N/8 .. 1, component by component, and the
// offsets 2 and 1 add (c0 + c2) + (c1 + c3) in the thread; y is the same
// bits, and agrees with the plain version to fp32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// VEC n a thread (4 or 1); lg = log2(N / VEC), the threads of one (b, d).
// Grid (ceil(Di / (THREADS >> lg)), B).
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    ssm_decode_kernel(const float* __restrict__ h,
                      const float* __restrict__ dA,
                      const float* __restrict__ dtx,
                      const float* __restrict__ b_ssm,
                      const float* __restrict__ c_ssm, float* __restrict__ y,
                      float* __restrict__ h_out, int Di, int N, int lg) {
  __shared__ float b_s[32], c_s[32], x_s[THREADS];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int per = THREADS >> lg;                 // d a block
  const int d0 = blockIdx.x * per;
  const int dl = tid >> lg, q = tid & ((1 << lg) - 1);
  const bool valid = d0 + dl < Di;
  const int row = b * Di + d0 + dl;              // b * Di + d
  const int at = row * N + q * VEC;
  float hv[VEC], av[VEC];
  if (valid) {
    if constexpr (VEC == 4) {
      const float4 h4 = __ldg(reinterpret_cast<const float4*>(h + at));
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(dA + at));
      hv[0] = h4.x, hv[1] = h4.y, hv[2] = h4.z, hv[3] = h4.w;
      av[0] = a4.x, av[1] = a4.y, av[2] = a4.z, av[3] = a4.w;
    } else {
      hv[0] = __ldg(h + at);
      av[0] = __ldg(dA + at);
    }
  }
  if (tid < N) {
    b_s[tid] = __ldg(b_ssm + b * N + tid);
    c_s[tid] = __ldg(c_ssm + b * N + tid);
  }
  if (tid < per && d0 + tid < Di) x_s[tid] = __ldg(dtx + b * Di + d0 + tid);
  __syncthreads();

  float p[VEC];
  if (valid) {
    const float xd = x_s[dl];
    float hn[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int n = q * VEC + j;
      hn[j] = __fadd_rn(__fmul_rn(av[j], hv[j]), __fmul_rn(xd, b_s[n]));
      p[j] = __fmul_rn(hn[j], c_s[n]);
    }
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(h_out + at) =
          make_float4(hn[0], hn[1], hn[2], hn[3]);
    else
      h_out[at] = hn[0];
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = 0.f;
  }
  for (int off = (1 << lg) >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      p[j] += __shfl_xor_sync(0xffffffffu, p[j], off);
  if (valid && q == 0) {
    if constexpr (VEC == 4)
      y[row] = (p[0] + p[2]) + (p[1] + p[3]);
    else
      y[row] = p[0];
  }
}

int log2_exact(int x) {
  int lg = 0;
  while ((1 << lg) < x) ++lg;
  return lg;
}

}  // namespace

extern "C" {

// h, dA, h_out: [B, Di, N] float32; dtx, y: [B, Di] float32; b_ssm, c_ssm:
// [B, N] float32, all contiguous; N must divide 32, B * Di * N < 2^31 and
// B <= 65535. Returns a cudaError_t (0 = success).
int ssm_decode(const void* h, const void* dA, const void* dtx,
               const void* b_ssm, const void* c_ssm, void* y, void* h_out,
               int B, int Di, int N, void* stream) {
  if (N < 1 || N > 32 || 32 % N || B < 0 || Di < 0 || B > 65535 ||
      (long long)B * Di * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Di * N == 0) return 0;
  const bool vec =
      N % 4 == 0 && ((reinterpret_cast<uintptr_t>(h) |
                      reinterpret_cast<uintptr_t>(dA) |
                      reinterpret_cast<uintptr_t>(h_out)) & 15) == 0;
  const int lg = log2_exact(vec ? N / 4 : N);
  const int per = THREADS >> lg;
  const dim3 grid((Di + per - 1) / per, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    ssm_decode_kernel<4><<<grid, THREADS, 0, st>>>(
        (const float*)h, (const float*)dA, (const float*)dtx,
        (const float*)b_ssm, (const float*)c_ssm, (float*)y, (float*)h_out,
        Di, N, lg);
  else
    ssm_decode_kernel<1><<<grid, THREADS, 0, st>>>(
        (const float*)h, (const float*)dA, (const float*)dtx,
        (const float*)b_ssm, (const float*)c_ssm, (float*)y, (float*)h_out,
        Di, N, lg);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
