"""Mixed-precision AdamW (``repro.optim.adamw``).

Params live in the model dtype (bf16 on the card); the optimizer keeps an
fp32 master copy and fp32 moments, 12 bytes a parameter beside the
param's 2 and its gradient's 2. ``adamw_update`` writes the master, the
moments and the params IN PLACE and returns the same tensors: JAX
returns new arrays, but a second copy of the fp32 state would not fit
one card at full width (qwen3-8b's embedding and head alone hold 1.24 B
parameters). The arithmetic is the reference's, op for op, in fp32.
``opt_state_specs`` gives the state's logical sharding axes, with
ZeRO-1's placement of the fp32 state over the data axis
(``_zero1_axes``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.tree import leaves, map_tree
from repro_torch.sharding.policy import map_specs


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def adamw_init(params) -> dict:
    """fp32 master (a copy, never the param itself, also for fp32
    params), zero moments, step 0 (int32, on the params' device)."""
    first = leaves(params)[0]
    return {
        "master": map_tree(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(g.float())) for g in leaves(grads)]).sum())


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 lr_fn: Optional[Callable] = None):
    """One step: global-norm clip, bias-corrected moments, decoupled
    weight decay on the master, params cast back to their dtype.
    Returns (params, opt_state, {"grad_norm", "lr"}); see the module's
    note on in-place updates."""
    step = opt_state["step"] + 1
    if lr_fn is None:
        from repro_torch.optim.schedules import cosine_schedule
        lr_fn = cosine_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps)
    lr = lr_fn(step)
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for g, m, v, ma, p in zip(leaves(grads), leaves(opt_state["m"]),
                              leaves(opt_state["v"]),
                              leaves(opt_state["master"]), leaves(params)):
        # the reference's expression, each op rounded as there (add_'s
        # alpha would fuse a product into the sum), with at most three
        # leaf-sized temporaries alive
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        upd = m / b1c
        upd.div_((v / b2c).sqrt_().add_(cfg.eps))
        upd.add_(cfg.weight_decay * ma)
        ma.sub_(upd.mul_(lr))
        del upd
        p.copy_(ma)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def _zero1_axes(axes: Tuple, shape: Tuple[int, ...], dp_size: int,
                dp_name: str = "data") -> Tuple:
    """Put the data axis on the largest free dim that ``dp_size``
    divides (ZeRO-1); ``axes`` as they are when none does."""
    best, best_dim = None, -1
    for i, (ax, n) in enumerate(zip(axes, shape)):
        if ax is None and n % dp_size == 0 and n > best_dim:
            best, best_dim = i, n
    if best is None:
        return axes
    out = list(axes)
    out[best] = dp_name
    return tuple(out)


def opt_state_specs(pspecs, params_shape, zero1: bool = False,
                    dp_size: int = 1) -> dict:
    """Logical axes of ``adamw_init``'s state from the params' spec tree
    (``lm.param_specs``) and a tree of the params' shapes (tensors, e.g.
    ``lm.abstract_params``'); with ``zero1`` the fp32 leaves also take
    the data axis."""
    if zero1:
        f32_axes = map_specs(
            lambda ax, sh: _zero1_axes(ax, tuple(sh.shape), dp_size),
            pspecs, params_shape)
    else:
        f32_axes = pspecs
    return {"master": f32_axes, "m": f32_axes, "v": f32_axes, "step": ()}
