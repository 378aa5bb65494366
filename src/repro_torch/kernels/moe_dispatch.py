"""MoE token dispatch (kernel B7): the Dynamic-MultiQueue enqueue.

``moe_dispatch`` is the wrapper of the hand-written CUDA kernel in
``csrc/moe_dispatch.cu``, which replaces the Pallas TPU kernel
``repro.kernels.moe_dispatch.moe_dispatch``. ``moe_dispatch_plain`` is the
same function in plain PyTorch, as ``ref.moe_dispatch_ref`` computes it
(``index_put_`` into a zeroed ``[E, C+1, D]`` whose row C takes the
dropped rows, then a slice): the wrapper takes it only for CPU tensors,
and the tests and ``chip_smoke.py`` hold the kernel against it, for
exact equality; ``meta`` tensors get the kernel's output as a shape
alone, for the dry run. ``moe_dispatch_tiles_plain`` is the kernel's own
algorithm in plain PyTorch (per tile of slots, the row that lands in
each slot, then one write of every slot), which the CPU tests hold
equal to both.

Training: when grad mode is on and the tokens require grad, the wrapper
goes through ``_MoeDispatch``, whose backward is ``moe_dispatch_bwd``,
the wrapper of the hand-written B7-bwd kernel (``csrc/moe_dispatch.cu``):
each row's gradient is its slot's, gathered from the buffer's gradient,
and zero for a dropped row, as ``jax.grad`` transposes the reference's
``.at[].set(mode="drop")`` scatter. ``moe_dispatch_bwd_plain`` is the
same gather in plain PyTorch; the CPU takes it.

Contract (the TPU kernel's): tokens [T, D]; expert_ids, positions [T]
int32, positions >= 0 -> [E, C, D] in the tokens' dtype. Row t lands at
(expert_ids[t], positions[t]); rows with a position at or past C, or an
id outside [0, E), are dropped; slots no row lands in are zero. The
positions need not be dense from 0. No two kept rows may share a slot
(positions from a cumsum over the routing never do).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, work

_DTYPES = (torch.float32, torch.bfloat16)


def moe_dispatch_plain(tokens, expert_ids, positions, n_experts: int,
                       capacity: int):
    """Scatter into a zeroed buffer with an overflow row, then slice it
    off. Rows with an id outside [0, E) go to the overflow row too, as
    the reference's scatter drops them."""
    T, D = tokens.shape
    ids = expert_ids.long()
    drop = (ids < 0) | (ids >= n_experts) | (positions < 0)
    pos = torch.where(drop, capacity,
                      torch.clamp(positions, max=capacity)).long()
    buf = torch.zeros(n_experts, capacity + 1, D, dtype=tokens.dtype,
                      device=tokens.device)
    buf.index_put_((torch.where(drop, 0, ids), pos), tokens)
    return buf[:, :capacity]


TILE_SLOTS = 32     # slots of one expert a block of the kernel owns


def moe_dispatch_tiles_plain(tokens, expert_ids, positions, n_experts: int,
                             capacity: int, tile_slots: int = TILE_SLOTS):
    """The kernel's gather by slots, in plain PyTorch: for each tile of
    ``tile_slots`` slots of one expert, the row that lands in each slot
    (the largest, should two land in one), found by scanning every id;
    then each slot written once, with its row or with zeros."""
    T, D = tokens.shape
    n_tiles = -(-capacity // tile_slots)
    rows = torch.arange(T, device=tokens.device)
    pos = positions.long()
    slot_row = torch.full((n_experts, n_tiles, tile_slots), -1,
                          dtype=torch.long, device=tokens.device)
    for e in range(n_experts):
        mine = expert_ids == e                       # the scan of the ids
        for j in range(n_tiles):
            p0 = j * tile_slots
            s = pos - p0
            n_slots = min(tile_slots, capacity - p0)
            hit = mine & (s >= 0) & (s < n_slots)
            slot_row[e, j].scatter_reduce_(0, s[hit], rows[hit], "amax")
    slot_row = slot_row.reshape(n_experts, n_tiles * tile_slots)[
        :, :capacity]
    # one write per slot: its row, or the zero row T where none landed
    rows_or_zero = torch.cat([tokens, tokens.new_zeros(1, D)])
    return rows_or_zero[torch.where(slot_row >= 0, slot_row, T)]


def _check(tokens, expert_ids, positions, n_experts, capacity):
    if tokens.dim() != 2 or tuple(expert_ids.shape) != tokens.shape[:1] \
            or positions.shape != expert_ids.shape:
        raise ValueError(f"want tokens [T,D], expert_ids and positions [T]; "
                         f"got {tuple(tokens.shape)}, "
                         f"{tuple(expert_ids.shape)}, "
                         f"{tuple(positions.shape)}")
    if n_experts < 1 or capacity < 1:
        raise ValueError(f"want n_experts >= 1 and capacity >= 1; got "
                         f"{n_experts}, {capacity}")
    if tokens.dtype not in _DTYPES:
        raise TypeError(f"moe_dispatch takes float32 or bfloat16 tokens; "
                        f"got {tokens.dtype}")
    if expert_ids.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError(f"expert_ids and positions must be int32; got "
                        f"{expert_ids.dtype}, {positions.dtype}")
    devs = {t.device for t in (tokens, expert_ids, positions)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device; got {devs}")


def moe_dispatch_bwd_plain(dbuf, expert_ids, positions):
    """The gradient of the tokens from the buffer's, dbuf [E,C,D] ->
    [T,D]: row t takes slot (expert_ids[t], positions[t]), or zeros where
    the row was dropped."""
    E, C, D = dbuf.shape
    ids, pos = expert_ids.long(), positions.long()
    kept = (ids >= 0) & (ids < E) & (pos >= 0) & (pos < C)
    rows = torch.cat([dbuf.reshape(E * C, D), dbuf.new_zeros(1, D)])
    return rows[torch.where(kept, ids * C + pos, E * C)]


class _MoeDispatch(torch.autograd.Function):
    """B7 under autograd: the forward is the dispatch, the backward the
    B7-bwd gather (``moe_dispatch_bwd``); ids and positions take no
    gradient."""

    @staticmethod
    def forward(ctx, tokens, expert_ids, positions, n_experts, capacity):
        ctx.save_for_backward(expert_ids, positions)
        return _dispatch(tokens, expert_ids, positions, n_experts, capacity)

    @staticmethod
    def backward(ctx, dbuf):
        ids, pos = ctx.saved_tensors
        return (moe_dispatch_bwd(dbuf.contiguous(), ids, pos), None, None,
                None, None)


def moe_dispatch(tokens, expert_ids, positions, n_experts: int,
                 capacity: int):
    """tokens [T,D] -> per-expert capacity buffers [E,C,D]. CUDA tensors
    launch the B7 kernel (one launch that writes every slot once, T = 0
    included); CPU tensors take ``moe_dispatch_plain``; meta tensors give
    the buffers as a shape and compute nothing (the dry run). With grad
    on and tokens that require it, the call goes through ``_MoeDispatch``."""
    _check(tokens, expert_ids, positions, n_experts, capacity)
    if torch.is_grad_enabled() and tokens.requires_grad:
        return _MoeDispatch.apply(tokens, expert_ids, positions, n_experts,
                                  capacity)
    return _dispatch(tokens, expert_ids, positions, n_experts, capacity)


def _dispatch(tokens, expert_ids, positions, n_experts, capacity):
    where = _build.route("moe_dispatch", tokens, expert_ids, positions)
    if where == "cpu":
        return moe_dispatch_plain(tokens, expert_ids, positions, n_experts,
                                  capacity)
    T, D = tokens.shape
    # as many rows kept as the buffer holds: the ids stay on the device
    work.report("moe_dispatch", work.moe_dispatch(
        T, D, n_experts, capacity, work.dtype_name(tokens)))
    out = torch.empty(n_experts, capacity, D, dtype=tokens.dtype,
                      device=tokens.device)
    if where == "meta":
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    with torch.cuda.device(tokens.device):
        err = lib.moe_dispatch(tokens.data_ptr(), expert_ids.data_ptr(),
                               positions.data_ptr(), out.data_ptr(), T, D,
                               n_experts, capacity, tokens.element_size(),
                               stream)
    _build.check(lib, err, "moe_dispatch")
    moe_dispatch.launches += 1
    return out


moe_dispatch.launches = 0


def moe_dispatch_bwd(dbuf, expert_ids, positions):
    """The tokens' gradient [T,D] from the buffer's dbuf [E,C,D]. CUDA
    tensors launch the B7-bwd kernel (one launch, a warp a row, every row
    written once); CPU tensors take ``moe_dispatch_bwd_plain``; meta
    tensors give the gradient as a shape and compute nothing."""
    if dbuf.dim() != 3 or expert_ids.dim() != 1 \
            or positions.shape != expert_ids.shape:
        raise ValueError(f"want dbuf [E,C,D], expert_ids and positions [T]; "
                         f"got {tuple(dbuf.shape)}, "
                         f"{tuple(expert_ids.shape)}, "
                         f"{tuple(positions.shape)}")
    E, C, D = dbuf.shape
    if dbuf.dtype not in _DTYPES or expert_ids.dtype != torch.int32 \
            or positions.dtype != torch.int32:
        raise TypeError(f"moe_dispatch_bwd takes a float32 or bfloat16 "
                        f"dbuf and int32 ids and positions; got "
                        f"{dbuf.dtype}, {expert_ids.dtype}, "
                        f"{positions.dtype}")
    if {t.device for t in (dbuf, expert_ids, positions)} != {dbuf.device}:
        raise ValueError("all inputs must be on one device")
    where = _build.route("moe_dispatch_bwd", dbuf, expert_ids, positions)
    if where == "cpu":
        return moe_dispatch_bwd_plain(dbuf, expert_ids, positions)
    T = expert_ids.shape[0]
    work.report("moe_dispatch_bwd", work.moe_dispatch_bwd(
        T, D, E, C, work.dtype_name(dbuf)))
    out = torch.empty(T, D, dtype=dbuf.dtype, device=dbuf.device)
    if where == "meta":
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dbuf.device).cuda_stream
    with torch.cuda.device(dbuf.device):
        err = lib.moe_dispatch_bwd(dbuf.data_ptr(), expert_ids.data_ptr(),
                                   positions.data_ptr(), out.data_ptr(), T,
                                   D, E, C, dbuf.element_size(), stream)
    _build.check(lib, err, "moe_dispatch_bwd")
    moe_dispatch_bwd.launches += 1
    return out


moe_dispatch_bwd.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_dispatch")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.moe_dispatch.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.moe_dispatch.restype = I
    lib.moe_dispatch_bwd.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.moe_dispatch_bwd.restype = I
    return lib
