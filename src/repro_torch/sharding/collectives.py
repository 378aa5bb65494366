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
- ``psum_inside``: the sum over the group whose backward sums too: a
  partial sum inside a parallel region (a row-parallel product) whose
  users are each rank's own slices, so that each rank's cotangent of
  the sum is partial as well (Mamba's ``x_proj``): ``copy_in(psum(y))``,
  one collective each way.
- ``pmean``: the mean over the group; its backward divides by the
  group's size.
- ``pmax``: the maximum over the group, with no gradient (the
  reference's ``pmax`` of a ``stop_gradient``).
- ``all_gather``: shards concatenated along a dim (tiled); its backward
  is the reduce-scatter of the FSDP gradient flow: the cotangent summed
  over the group, this rank's slice kept. Along the sequence it is the
  entry of a sequence-parallel region.
- ``reduce_scatter_seq``: the sum over the group, this rank's slice
  along a dim kept; its backward is the tiled gather of the cotangent.
  It is the exit of a sequence-parallel region (``all_gather``'s
  counterpart), where ``psum`` exits a tensor-parallel one.
- ``all_to_all``: parts of a dim of the sizes given sent one to each
  rank, the parts received concatenated along it in rank order; its
  backward is the inverse exchange. It moves activations from one cut
  over the group to another (Mamba's ``in_proj`` output,
  ``models/mamba.py``).

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

import weakref
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
    # part j of every rank to rank j, then the n parts summed in rank
    # order, in float32 for 16-bit floats: (n - 1) / n of the tensor
    # leaves each rank, half of what an all_reduce of it sends
    m = t.shape[dim] // n
    parts = exchange(t, g, dim, (m,) * n, (m,) * n).chunk(n, dim)
    out = _wide(parts[0])
    for p in parts[1:]:
        out = out + _wide(p)
    return out.to(t.dtype)


def exchange(t: torch.Tensor, g, dim: int, send, recv) -> torch.Tensor:
    """Parts of ``t`` along ``dim`` of sizes ``send`` to ranks 0, 1, ...
    of ``g``; the parts received, of sizes ``recv``, concatenated along
    ``dim`` in the senders' rank order (no autograd). 16-bit floats
    travel as their raw bytes."""
    if _size(g) == 1:
        return t
    w = t.movedim(dim, 0).contiguous()
    wire = w.reshape(w.shape[0], -1)
    if w.dtype in _HALF:
        wire = wire.view(torch.uint8)
    got = wire.new_empty((sum(recv), wire.shape[1]))
    _count("all_to_all", wire)
    # equal parts each way take the call without sizes
    equal = len(set(send)) == 1 and list(send) == list(recv)
    dist.all_to_all_single(got, wire,
                           output_split_sizes=None if equal else list(recv),
                           input_split_sizes=None if equal else list(send),
                           group=g)
    out = got.view(w.dtype).reshape((sum(recv),) + tuple(w.shape[1:]))
    return out.movedim(0, dim).contiguous()


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


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return reduce_scatter(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return gather(dy, ctx.g, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim, send, recv):
        ctx.g, ctx.dim, ctx.send, ctx.recv = g, dim, send, recv
        return exchange(x, g, dim, send, recv)

    @staticmethod
    def backward(ctx, dy):
        return (exchange(dy, ctx.g, ctx.dim, ctx.recv, ctx.send), None,
                None, None, None)


def psum(x: torch.Tensor, g) -> torch.Tensor:
    return x if _size(g) == 1 else _Psum.apply(x, g)


def copy_in(x: torch.Tensor, g) -> torch.Tensor:
    return x if _size(g) == 1 else _CopyIn.apply(x, g)


def psum_inside(x: torch.Tensor, g) -> torch.Tensor:
    return copy_in(psum(x, g), g)


def pmean(x: torch.Tensor, g) -> torch.Tensor:
    return x if _size(g) == 1 else _Pmean.apply(x, g)


def pmax(x: torch.Tensor, g) -> torch.Tensor:
    with torch.no_grad():
        return all_reduce(x.detach(), g, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    return x if _size(g) == 1 else _AllGather.apply(x, g, dim)


def reduce_scatter_seq(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    return x if _size(g) == 1 else _ReduceScatterSeq.apply(x, g, dim)


def all_to_all(x: torch.Tensor, g, dim: int, send, recv) -> torch.Tensor:
    """``exchange`` with the inverse exchange as its backward."""
    if _size(g) == 1:
        return x
    return _AllToAll.apply(x, g, dim, tuple(send), tuple(recv))


# the batch group of each (pod, data, model) mesh, built once: every rank
# must take part in building every such group (``new_group``)
_BATCH_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _batch_group(mesh):
    """This rank's group of the ranks that share its model coordinate on
    a ("pod", "data", "model") mesh, pod-major: the reference's batch
    axes ``("pod", "data")`` as one."""
    if mesh not in _BATCH_GROUPS:
        ranks = mesh.mesh.reshape(-1, mesh.mesh.shape[-1]).T.tolist()
        _BATCH_GROUPS[mesh] = dist.new_subgroups_by_enumeration(ranks)[0]
    return _BATCH_GROUPS[mesh]


@dataclass(frozen=True)
class MeshGroups:
    """A ``("data", "model")`` or ``("pod", "data", "model")`` mesh as the
    bodies use it: each axis's group, size and this rank's coordinate;
    the batch group over ``pod`` x ``data`` (``batch``: the tokens' rows,
    the CE's total and count, the MoE stats' mean), while FSDP gathers
    and ZeRO-1 slices stay on ``data`` alone, as the reference places
    them; ``pod`` (None without the axis) sums the gradients, pure data
    parallelism; whether the params are FSDP-sharded over ``data``
    (``fsdp_params``) and the residual stream over ``model`` between
    blocks (``sp``, ``act_seq``)."""
    dp: object
    tp: object
    pod: object
    batch: object
    dp_size: int
    tp_size: int
    pod_size: int
    dp_rank: int
    tp_rank: int
    batch_rank: int
    fsdp: bool
    sp: bool

    @classmethod
    def of(cls, policy) -> "MeshGroups":
        has_pod = "pod" in policy.mesh.mesh_dim_names
        dp = group(policy, "data")
        dp_size, dp_rank = policy.axis_size("data"), axis_index(policy,
                                                                "data")
        pod_size = policy.axis_size("pod") if has_pod else 1
        pod_rank = axis_index(policy, "pod") if has_pod else 0
        return cls(dp=dp, tp=group(policy, "model"),
                   pod=group(policy, "pod") if has_pod else None,
                   batch=_batch_group(policy.mesh) if has_pod else dp,
                   dp_size=dp_size, tp_size=policy.axis_size("model"),
                   pod_size=pod_size, dp_rank=dp_rank,
                   tp_rank=axis_index(policy, "model"),
                   batch_rank=pod_rank * dp_size + dp_rank,
                   fsdp=bool(policy.rules.get("fsdp_params")),
                   sp=policy.rules.get("act_seq") == "model")

    @property
    def batch_size(self) -> int:
        return self.pod_size * self.dp_size

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """x [b, S', D] into a region parallel over ``model``: Megatron's
        f (``copy_in``) on the rank's rows; under SP the rank's sequence
        slice gathered along dim 1, whose backward sums the cotangent
        over ``model`` and keeps the slice."""
        return all_gather(x, self.tp, 1) if self.sp else copy_in(x,
                                                                 self.tp)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """A partial sum y [b, S, D] out of the region: Megatron's g
        (``psum``); under SP summed and cut to the rank's sequence slice
        (``reduce_scatter_seq``)."""
        return reduce_scatter_seq(y, self.tp, 1) if self.sp else psum(
            y, self.tp)

    def norm_weight(self, w: torch.Tensor) -> torch.Tensor:
        """A norm's scale between regions: whole as it is; under SP each
        rank applies it to its own sequence slice, so its gradient is a
        partial sum over ``model`` (``copy_in``)."""
        return copy_in(w, self.tp) if self.sp else w


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
