"""int8 gradient compression with error feedback
(``repro.train.grad_compress``).

Each leaf is quantized to int8 with one per-tensor scale after adding the
residual the previous step's quantization left, so the noise is unbiased
over steps. ``torch.round`` rounds half to even, as ``jnp.round`` does,
so the bits are the reference's. The reference stacks a model's
repeating layers on a leading axis, so one of its leaves holds a
parameter of every group and takes one scale; the port holds a block a
layer, and ``compress_tree``'s ``stacked`` gives those layers one scale
too.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.tree import leaves, map_tree


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, scale); the scale is ``amax`` (by default x's largest
    |element|) over 127."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    amax = amax + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residuals(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_tree(grads, residuals, stacked: Sequence[Sequence[int]] = (),
                  reduce=None):
    """(dequantized grads, new residuals), two trees shaped as grads.

    Each leaf has its own scale, except that the blocks listed together
    in ``stacked`` (indices into ``grads["blocks"]``) share one scale a
    leaf: the largest |g + r| over those blocks' same leaf, the scale of
    the reference's stacked leaf. On a mesh each rank holds a shard of
    every leaf, and ``reduce`` maps the vector of its leaves' largest
    |g + r| to the largest over every rank's shards (a ``pmax``)."""
    amax = map_tree(lambda g, r: torch.max(torch.abs(g.float() + r)),
                    grads, residuals)
    if reduce is not None:
        it = iter(reduce(torch.stack(leaves(amax))).unbind())
        amax = map_tree(lambda _: next(it), amax)
    for group in stacked:
        shared = map_tree(lambda *a: torch.stack(a).max(),
                          *(amax["blocks"][b] for b in group))
        for b in group:
            amax["blocks"][b] = shared
    new_res = []

    def one(g, r, a):
        gf = g.float() + r
        deq = dequantize_int8(*quantize_int8(gf, a))
        new_res.append(gf - deq)
        return deq.to(g.dtype)
    new_g = map_tree(one, grads, residuals, amax)
    it = iter(new_res)
    return new_g, map_tree(lambda _: next(it), grads)
