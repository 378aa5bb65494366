// MoE token dispatch for Hopper (sm_90a): the Dynamic-MultiQueue enqueue
// (kernel B7). Token rows are scattered into per-expert queues that share
// one capacity buffer [E, C, D], each at its (expert, position).
//
// Replaces: the Pallas TPU kernel `moe_dispatch` / `_dispatch_kernel`
// (src/repro/kernels/moe_dispatch.py). Same function, the oracle
// `moe_dispatch_ref` (src/repro/kernels/ref.py): row t of tokens [T, D]
// lands at out[expert_ids[t], positions[t]]; a row whose position is at or
// past C is dropped (a full queue rejects the push); every slot no row
// lands in stays zero. The positions come from a cumsum over the routing,
// so no two kept rows share a slot. The copy is bit for bit, so the result
// equals the plain version exactly.
//
// What bounds it on this card: device-memory bytes. It does no arithmetic;
// the least it must move is each kept token row read once and the whole
// buffer written once (E * C * D elements, zeros included). At
// moonshot-v1-16b-a3b prefill (T = 1900 * 6 rows, D 2048, E 64, C 223,
// bf16) that is ~105 MB, ~31 us at 3.35 TB/s. At decode (T = 4 * 6 rows,
// C 4) it is ~1.2 MB, under 1 us: there the kernel is latency-bound, its
// time the cost of a launch and one round trip to device memory.
//
// What the design does about it. The TPU kernel runs one grid step per
// token, with the indices scalar-prefetched so that the output BlockSpec
// can chase them, an aliased zero buffer as its output, and an overflow
// row C as the target of dropped rows. None of that carries over:
// - each warp takes one token row and loads that row's (expert, position)
//   itself (all lanes read the same word: one broadcast transaction);
// - a row with position >= C (or an id out of range) writes nothing, so
//   there is no overflow row and nothing to slice off;
// - the row is copied as raw bits with 16-byte loads and stores, lane i on
//   the i-th 16 bytes, so a warp moves 512 contiguous bytes per step, both
//   sides coalesced; where a row's start is not 16-byte aligned on either
//   side (D * element size not a multiple of 16), the row, or its last
//   D mod (16 / element size) elements, go element by element;
// - the zeros come from one cudaMemsetAsync of the buffer on the same
//   stream before the copy, which the copy then overwrites where rows land.
//   The memset writes the kept slots once more than the bound counts
//   (~46 MB of the 105 at prefill); a later version can zero only the
//   slots no row fills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;  // one warp per token row

// Elem: the storage type of one element (uint32_t for float32, uint16_t
// for bfloat16); the copy never looks at the values.
template <typename Elem>
__global__ void moe_dispatch_kernel(const Elem* __restrict__ tokens,
                                    const int32_t* __restrict__ expert_ids,
                                    const int32_t* __restrict__ positions,
                                    Elem* __restrict__ out, int n_rows,
                                    int D, int E, int C) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (t >= n_rows) return;
  const int e = expert_ids[t];
  const int p = positions[t];
  if (e < 0 || e >= E || p < 0 || p >= C) return;  // the push is rejected

  const Elem* src = tokens + (size_t)t * D;
  Elem* dst = out + ((size_t)e * C + p) * D;
  constexpr int PER_VEC = 16 / sizeof(Elem);
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const int n_vec = D / PER_VEC;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int i = lane; i < n_vec; i += 32) d4[i] = s4[i];
    done = n_vec * PER_VEC;
  }
  for (int i = done + lane; i < D; i += 32) dst[i] = src[i];  // scalar tail
}

template <typename Elem>
int launch(const void* tokens, const void* expert_ids, const void* positions,
           void* out, int T, int D, int E, int C, cudaStream_t stream) {
  const size_t out_bytes = (size_t)E * C * D * sizeof(Elem);
  if (out_bytes == 0) return 0;
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  if (T == 0 || D == 0) return 0;
  const int blocks = (T + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  moe_dispatch_kernel<Elem><<<blocks, THREADS, 0, stream>>>(
      (const Elem*)tokens, (const int32_t*)expert_ids,
      (const int32_t*)positions, (Elem*)out, T, D, E, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tokens: [T, D] of elements of `elem_size` bytes (4 = float32, 2 =
// bfloat16); expert_ids, positions: [T] int32; out: [E, C, D] of the same
// elements, written whole (zeros, then the kept rows). Returns a
// cudaError_t (0 = success).
int moe_dispatch(const void* tokens, const void* expert_ids,
                 const void* positions, void* out, int T, int D, int E,
                 int C, int elem_size, void* stream) {
  if (elem_size == 4)
    return launch<uint32_t>(tokens, expert_ids, positions, out, T, D, E, C,
                            (cudaStream_t)stream);
  if (elem_size == 2)
    return launch<uint16_t>(tokens, expert_ids, positions, out, T, D, E, C,
                            (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
