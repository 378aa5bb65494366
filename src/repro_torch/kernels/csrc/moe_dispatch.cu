// MoE token dispatch for Hopper (sm_90a): the Dynamic-MultiQueue enqueue
// (kernel B7). Token rows are scattered into per-expert queues that share
// one capacity buffer [E, C, D], each at its (expert, position).
//
// Replaces: the Pallas TPU kernel `moe_dispatch` / `_dispatch_kernel`
// (src/repro/kernels/moe_dispatch.py). Same function, the oracle
// `moe_dispatch_ref` (src/repro/kernels/ref.py): row t of tokens [T, D]
// lands at out[expert_ids[t], positions[t]]; a row whose position is at or
// past C, or whose id is out of range, is dropped (a full queue rejects the
// push); every slot no row lands in is zero. The positions need not be
// dense from 0. No two kept rows should share a slot (positions from a
// cumsum over the routing never do); if two do, the later row wins, as in a
// scatter done in row order. The copy is bit for bit, so the result equals
// the plain version exactly.
//
// What bounds it on this card: device-memory bytes. It does no arithmetic;
// the least it must move is each kept token row read once and the whole
// buffer written once (E * C * D elements, zeros included). At
// moonshot-v1-16b-a3b prefill (T = 1900 * 6 rows, D 2048, E 64, C 223,
// bf16) that is ~105 MB, ~31 us at 3.35 TB/s. At decode (T = 4 * 6 rows,
// C 4) it is ~1.2 MB, under 1 us: there the kernel is latency-bound, its
// time the cost of one launch and one round trip to device memory.
//
// What the design does about it: one launch that writes every output byte
// exactly once. The TPU kernel runs one grid step per token, chasing
// scalar-prefetched indices with its output BlockSpec into an aliased zero
// buffer with an overflow row for dropped rows. A scatter by token rows
// cannot know which slots stay empty: it needs a memset of the whole buffer
// first, two launches, and writes the kept slots twice (~46 MB of the 105
// at moonshot prefill). Instead, each block owns a tile of TILE_SLOTS slots
// of one expert (a gather by slots):
// - it scans the [T] expert ids (11,400 int32 at moonshot prefill: they
//   stay in L2 and are a few percent of the bytes moved), 16 ids a thread
//   in flight at once, so that the scan is three round trips to L2 there
//   and not one per row; it reads the position only of rows with its
//   expert, all of a round's at once, and records in shared memory,
//   for each slot of its tile, the row that lands there (the largest such
//   row index, by atomicMax, so the result does not depend on the order
//   of the scan);
// - then each warp writes whole slots: the row's bits with 16-byte loads
//   and stores, lane i on the i-th 16 bytes, or zeros where no row landed.
//   Where a row's start is not 16-byte aligned on either side (D * element
//   size not a multiple of 16, or a token view at an odd offset), slots go
//   element by element.
// A slot-tiled gather keeps the copy coalesced on both sides and needs no
// sort of the routing, which would be a second launch.
//
// The backward (B7-bwd, `moe_dispatch_bwd_kernel`) replaces no Pallas
// kernel: the reference differentiates the jnp scatter
// `buf.at[g, e, pos].set(x, mode="drop")` of `_moe_mlp_local`
// (src/repro/models/moe.py) with jax.grad, whose transpose for the scattered
// rows is a gather. Row t's gradient is the gradient of the slot it landed
// in, dbuf[expert_ids[t], positions[t]], and zero for a dropped row. It is
// bytes-bound as the forward is: each kept row's slot read once and every
// row of d_tokens written once (at moonshot prefill, T 11400, D 2048, bf16,
// ~93 MB, ~28 us at 3.35 TB/s). One warp copies one row at a time, 16 bytes
// a lane where both sides are aligned, so every load and store of a warp is
// coalesced; a block takes BWD_ROWS rows. No two blocks write one row, so
// there are no atomics and the copy is bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_SLOTS = 32;
constexpr int SCAN = 16;  // ids a thread loads at once, a multiple of 4

// grid (E, ceil(C / TILE_SLOTS)); block THREADS. Elem: the storage type of
// one element (uint32_t for float32, uint16_t for bfloat16); the copy
// never looks at the values. `vec`: every row start on both sides is
// 16-byte aligned, so rows copy as uint4.
template <typename Elem>
__global__ void moe_dispatch_kernel(const Elem* __restrict__ tokens,
                                    const int32_t* __restrict__ expert_ids,
                                    const int32_t* __restrict__ positions,
                                    Elem* __restrict__ out, int n_rows,
                                    int D, int C, int vec) {
  __shared__ int slot_row[TILE_SLOTS];
  const int e = blockIdx.x;
  const int p0 = blockIdx.y * TILE_SLOTS;
  const int n_slots = min(TILE_SLOTS, C - p0);
  const int tid = threadIdx.x;
  if (tid < TILE_SLOTS) slot_row[tid] = -1;
  __syncthreads();

  // which row lands in each slot of the tile: SCAN ids a thread a round,
  // loaded before any is looked at (as int4 where the ids allow), then the
  // positions of the rows with this expert, loaded before any is used
  const bool ids_vec = (n_rows % 4) == 0 &&
                       (reinterpret_cast<uintptr_t>(expert_ids) & 15) == 0;
  for (int t0 = 0; t0 < n_rows; t0 += SCAN * THREADS) {
    int ids[SCAN], pos[SCAN];
    if (ids_vec) {
#pragma unroll
      for (int j = 0; j < SCAN / 4; ++j) {
        const int t = t0 + 4 * (j * THREADS + tid);
        const int4 q = t < n_rows
                           ? *reinterpret_cast<const int4*>(expert_ids + t)
                           : make_int4(-1, -1, -1, -1);
        ids[4 * j] = q.x, ids[4 * j + 1] = q.y, ids[4 * j + 2] = q.z,
        ids[4 * j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < SCAN; ++j) {
        const int t = t0 + 4 * ((j / 4) * THREADS + tid) + j % 4;
        ids[j] = t < n_rows ? expert_ids[t] : -1;
      }
    }
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      const int t = t0 + 4 * ((j / 4) * THREADS + tid) + j % 4;
      pos[j] = ids[j] == e ? positions[t] : -1;
    }
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      const int t = t0 + 4 * ((j / 4) * THREADS + tid) + j % 4;
      const int s = pos[j] - p0;
      if (ids[j] == e && s >= 0 && s < n_slots) atomicMax(&slot_row[s], t);
    }
  }
  __syncthreads();

  const int lane = tid % 32;
  Elem* tile = out + ((size_t)e * C + p0) * D;
  if (vec) {
    constexpr int PER_VEC = 16 / sizeof(Elem);
    const int n_vec = D / PER_VEC;
    for (int s = tid / 32; s < n_slots; s += WARPS) {
      const int t = slot_row[s];
      uint4* dst = reinterpret_cast<uint4*>(tile + (size_t)s * D);
      if (t < 0) {
        const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll 8
        for (int i = lane; i < n_vec; i += 32) dst[i] = z;
      } else {
        const uint4* src =
            reinterpret_cast<const uint4*>(tokens + (size_t)t * D);
#pragma unroll 8
        for (int i = lane; i < n_vec; i += 32) dst[i] = src[i];
      }
    }
  } else {
    for (int s = tid / 32; s < n_slots; s += WARPS) {
      const int t = slot_row[s];
      Elem* dst = tile + (size_t)s * D;
      const Elem* src = tokens + (size_t)(t < 0 ? 0 : t) * D;
      for (int i = lane; i < D; i += 32) dst[i] = t < 0 ? Elem(0) : src[i];
    }
  }
}

constexpr int BWD_ROWS = 32;  // rows of d_tokens a block of the backward

// grid ceil(T / BWD_ROWS); block THREADS; warp w copies rows w, w + WARPS,
// ... of the block's tile: the slot's row of dbuf, or zeros for a dropped
// row (position past C or negative, id outside [0, E)).
template <typename Elem>
__global__ void moe_dispatch_bwd_kernel(const Elem* __restrict__ dbuf,
                                        const int32_t* __restrict__ expert_ids,
                                        const int32_t* __restrict__ positions,
                                        Elem* __restrict__ d_tokens,
                                        int n_rows, int D, int E, int C,
                                        int vec) {
  const int lane = threadIdx.x % 32;
  const int t_end = min(n_rows, (blockIdx.x + 1) * BWD_ROWS);
  for (int t = blockIdx.x * BWD_ROWS + threadIdx.x / 32; t < t_end;
       t += WARPS) {
    const int e = expert_ids[t], p = positions[t];
    const bool kept = e >= 0 && e < E && p >= 0 && p < C;
    const Elem* src = dbuf + ((size_t)(kept ? e : 0) * C + (kept ? p : 0)) * D;
    Elem* dst = d_tokens + (size_t)t * D;
    if (vec) {
      constexpr int PER_VEC = 16 / sizeof(Elem);
      const int n_vec = D / PER_VEC;
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll 8
      for (int i = lane; i < n_vec; i += 32) d4[i] = kept ? s4[i] : z;
    } else {
      for (int i = lane; i < D; i += 32) dst[i] = kept ? src[i] : Elem(0);
    }
  }
}

template <typename Elem>
int launch_bwd(const void* dbuf, const void* expert_ids,
               const void* positions, void* d_tokens, int T, int D, int E,
               int C, cudaStream_t stream) {
  if ((size_t)T * D == 0) return 0;
  const int vec = ((size_t)D * sizeof(Elem)) % 16 == 0 &&
                  ((reinterpret_cast<uintptr_t>(dbuf) |
                    reinterpret_cast<uintptr_t>(d_tokens)) & 15) == 0;
  moe_dispatch_bwd_kernel<Elem>
      <<<(T + BWD_ROWS - 1) / BWD_ROWS, THREADS, 0, stream>>>(
          (const Elem*)dbuf, (const int32_t*)expert_ids,
          (const int32_t*)positions, (Elem*)d_tokens, T, D, E, C, vec);
  return (int)cudaGetLastError();
}

template <typename Elem>
int launch(const void* tokens, const void* expert_ids, const void* positions,
           void* out, int T, int D, int E, int C, cudaStream_t stream) {
  if ((size_t)E * C * D == 0) return 0;
  const int vec = ((size_t)D * sizeof(Elem)) % 16 == 0 &&
                  ((reinterpret_cast<uintptr_t>(tokens) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  dim3 grid(E, (C + TILE_SLOTS - 1) / TILE_SLOTS);
  moe_dispatch_kernel<Elem><<<grid, THREADS, 0, stream>>>(
      (const Elem*)tokens, (const int32_t*)expert_ids,
      (const int32_t*)positions, (Elem*)out, T, D, C, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tokens: [T, D] of elements of `elem_size` bytes (4 = float32, 2 =
// bfloat16); expert_ids, positions: [T] int32; out: [E, C, D] of the same
// elements, every byte written once by one kernel (T may be 0: all zeros).
// Returns a cudaError_t (0 = success).
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

// dbuf: [E, C, D] of elements of `elem_size` bytes; expert_ids, positions:
// [T] int32 -> d_tokens [T, D] of the same elements, every row written once
// (a kept row's slot, or zeros). Returns a cudaError_t (0 = success).
int moe_dispatch_bwd(const void* dbuf, const void* expert_ids,
                     const void* positions, void* d_tokens, int T, int D,
                     int E, int C, int elem_size, void* stream) {
  if (elem_size == 4)
    return launch_bwd<uint32_t>(dbuf, expert_ids, positions, d_tokens, T, D,
                                E, C, (cudaStream_t)stream);
  if (elem_size == 2)
    return launch_bwd<uint16_t>(dbuf, expert_ids, positions, d_tokens, T, D,
                                E, C, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
