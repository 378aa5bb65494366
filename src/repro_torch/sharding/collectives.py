"""Collectives over one mesh axis, with the gradients ``shard_map`` gives.

The reference writes its multi-device bodies inside ``shard_map`` and
differentiates through ``psum``, ``pmax`` and tiled ``all_gather``; the
port's bodies are plain functions on each rank's local shards, and these
are their collectives over one axis's process group (``group(policy,
axis)``), as autograd Functions:

- ``psum``: the sum over the group; its backward is the identity (the
  result is replicated, and every rank's cotangent is already whole).
  It is Megatron's g, the exit of a tensor-parallel block.
- ``copy_in``: the identity; its backward sums the cotangent over the
  group. It is Megatron's f, the entry of a tensor-parallel block, where
  each rank's cotangent of a replicated input is a partial sum.
- ``pmean``: the mean over the group; its backward divides by the
  group's size.
- ``pmax``: the maximum over the group, with no gradient (the
  reference's ``pmax`` of a ``stop_gradient``).
- ``all_gather``: shards concatenated along a dim (tiled); its backward
  is the reduce-scatter of the FSDP gradient flow: the cotangent summed
  over the group, this rank's slice kept.

One transport serves every backend, with calls that gloo and NCCL both
take: gloo has no CUDA reduce-scatter and moves CUDA tensors through the
host, so the reduce-scatter is an ``all_to_all`` and a sum of the n
parts on each rank in rank order; 16-bit floats travel as their raw
bytes and are summed in float32 (they round once, on the way back). So
a step gives the same numbers on either backend. A group of one rank
moves nothing. ``reset_counts`` and
``counts`` give the collectives run since, by kind, with the bytes of
each rank's tensor entering them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.distributed as dist

_COUNTS: Dict[str, list] = {}


def reset_counts() -> None:
    _COUNTS.clear()


def counts() -> Dict[str, dict]:
    """{kind: {"calls", "bytes"}} since ``reset_counts``."""
    return {k: {"calls": n, "bytes": b} for k, (n, b) in
            sorted(_COUNTS.items())}


def _count(kind: str, t: torch.Tensor) -> None:
    rec = _COUNTS.setdefault(kind, [0, 0])
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()


def group(policy, axis: str):
    """The process group of mesh axis ``axis``."""
    return policy.mesh.get_group(axis)


def axis_index(policy, axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis``."""
    return policy.mesh.get_local_rank(axis)


def _size(g) -> int:
    return dist.get_world_size(g)


_HALF = (torch.bfloat16, torch.float16)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The tensor as it is summed: 16-bit floats widen to float32."""
    return t.float() if t.dtype in _HALF else t.contiguous()


def all_reduce(t: torch.Tensor, g, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``g`` (no autograd)."""
    if _size(g) == 1:
        return t.clone()
    w = _wide(t)
    w = w.clone() if w is t else w
    _count("all_reduce", w)
    dist.all_reduce(w, op=op, group=g)
    return w.to(t.dtype)


def gather(t: torch.Tensor, g, dim: int) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim`` in rank
    order (no autograd)."""
    n = _size(g)
    if n == 1:
        return t
    w = t.contiguous()
    if w.dtype in _HALF:
        # two bytes an element, side by side in the last dim: the byte
        # view concatenates along any dim as the elements would
        w = w.view(torch.uint8)
    _count("all_gather", w)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=g)
    return torch.cat(parts, dim=dim).view(t.dtype)


def reduce_scatter(t: torch.Tensor, g, dim: int) -> torch.Tensor:
    """``t`` summed over ``g``, this rank's 1/n slice along ``dim`` kept
    (no autograd)."""
    n = _size(g)
    if n == 1:
        return t
    w = t.movedim(dim, 0).contiguous()
    # part j of every rank to rank j (16-bit floats as their raw bytes),
    # then the n parts summed in rank order, in float32 for 16-bit floats:
    # (n - 1) / n of the tensor leaves each rank, half of what an
    # all_reduce of it sends
    wire = w.view(torch.uint8) if w.dtype in _HALF else w
    got = torch.empty_like(wire)
    _count("all_to_all", wire)
    dist.all_to_all_single(got, wire, group=g)
    parts = got.view(w.dtype).view((n, w.shape[0] // n)
                                   + tuple(w.shape[1:]))
    out = _wide(parts[0])
    for j in range(1, n):
        out = out + _wide(parts[j])
    return out.movedim(0, dim).contiguous().to(t.dtype)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.g), None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.n = _size(g)
        return all_reduce(x, g) / ctx.n

    @staticmethod
    def backward(ctx, dy):
        return dy / ctx.n, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return reduce_scatter(dy, ctx.g, ctx.dim), None, None


def psum(x: torch.Tensor, g) -> torch.Tensor:
    return x if _size(g) == 1 else _Psum.apply(x, g)


def copy_in(x: torch.Tensor, g) -> torch.Tensor:
    return x if _size(g) == 1 else _CopyIn.apply(x, g)


def pmean(x: torch.Tensor, g) -> torch.Tensor:
    return x if _size(g) == 1 else _Pmean.apply(x, g)


def pmax(x: torch.Tensor, g) -> torch.Tensor:
    with torch.no_grad():
        return all_reduce(x.detach(), g, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    return x if _size(g) == 1 else _AllGather.apply(x, g, dim)


@dataclass(frozen=True)
class MeshGroups:
    """A ``("data", "model")`` mesh as the bodies use it: each axis's
    group, size and this rank's coordinate, and whether the params are
    FSDP-sharded over ``data`` (``fsdp_params``)."""
    dp: object
    tp: object
    dp_size: int
    tp_size: int
    dp_rank: int
    tp_rank: int
    fsdp: bool

    @classmethod
    def of(cls, policy) -> "MeshGroups":
        return cls(dp=group(policy, "data"), tp=group(policy, "model"),
                   dp_size=policy.axis_size("data"),
                   tp_size=policy.axis_size("model"),
                   dp_rank=axis_index(policy, "data"),
                   tp_rank=axis_index(policy, "model"),
                   fsdp=bool(policy.rules.get("fsdp_params")))


def gather_fsdp(tree, specs, mg: MeshGroups):
    """Each leaf of ``tree`` whose logical axes in ``specs`` name
    ``data`` gathered over the data axis along that dim (differentiable:
    the gradient comes back reduce-scattered); the others as they are."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v, specs[k], mg) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_fsdp(v, s, mg) for v, s in zip(tree, specs)]
    if mg.fsdp and "data" in specs:
        return all_gather(tree, mg.dp, specs.index("data"))
    return tree
