"""The train step (``repro.train.train_step``): loss, gradients, optional
int8 compression, AdamW.

``make_train_step`` returns ``train_step(params, opt_state, tokens[,
residuals])`` with the reference's contract; ``tokens`` is an int32
tensor on the params' device. Gradients come from autograd through the
model's kernels (B2 forward with its lse, B2-bwd backward) with respect
to detached views of the params, so no ``.grad`` is kept on them. The
step updates params and optimizer state in place (``optim/adamw.py``).

Each step constructor takes a sharding ``policy``. ``train_shardings`` and
``serve_shardings`` give the reference's in and out shardings as trees
of ``(mesh, placements)`` pairs (``Policy.named``): FSDP puts the params
on the data axis too (expert tensors on their d_model dim), ZeRO-1 the
fp32 state. ``checkpoint.reshard_tree`` lays a tree out on them. The
port runs one rank, where every placement holds the whole tensor.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves, map_tree
from repro_torch.models import lm
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw_update, opt_state_specs
from repro_torch.optim.adamw import _zero1_axes
from repro_torch.sharding.policy import NULL_POLICY, Policy, map_specs
from repro_torch.train.grad_compress import compress_tree


def loss_fn(params, tokens, cfg: ModelConfig, remat: bool = True,
            policy: Policy = NULL_POLICY):
    return lm.forward_loss(params, tokens, cfg, remat=remat, policy=policy)


def value_and_grad(params, tokens, cfg: ModelConfig, remat: bool = True,
                   policy: Policy = NULL_POLICY):
    """((loss, metrics), grads): grads a tree shaped as params, each leaf
    in its param's dtype, as ``jax.value_and_grad`` gives them."""
    live = map_tree(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, tokens, cfg, remat=remat,
                                policy=policy)
        flat = leaves(live)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(got, flat))
    grads = map_tree(lambda _: next(it), params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    grad_compression: bool = False,
                    microbatch: int = 0, *,
                    policy: Policy = NULL_POLICY) -> Callable:
    """train_step(params, opt_state, tokens[, residuals]) -> (params,
    opt_state, metrics[, residuals]). ``microbatch`` > 1 accumulates
    gradients over that many row slices of the batch, in fp32, and
    reports the mean of their losses and the last slice's other
    metrics, as the reference's scan does."""
    opt_cfg = opt_cfg or AdamWConfig()
    # the blocks the reference stacks into one leaf, which compression
    # scales as one tensor: block j of every repeating group
    prefix, unit, n_groups = tf.plan_layers(cfg)
    stacked = [[len(prefix) + g * len(unit) + j for g in range(n_groups)]
               for j in range(len(unit))]

    def compute_grads(params, tokens):
        if not (microbatch and microbatch > 1):
            return value_and_grad(params, tokens, cfg, policy=policy)
        B = tokens.shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} is not a multiple of microbatch "
                             f"{microbatch}")
        mb = B // microbatch
        g_acc = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        l_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(microbatch):
            (l, metrics), g = value_and_grad(
                params, tokens[i * mb:(i + 1) * mb], cfg, policy=policy)
            for a, b in zip(leaves(g_acc), leaves(g)):
                a.add_(b)
            del g
            l_acc = l_acc + l
        g_acc = map_tree(lambda a: a.div_(microbatch), g_acc)
        return (l_acc / microbatch, metrics), g_acc

    def train_step(params, opt_state, tokens, residuals=None):
        (loss, metrics), grads = compute_grads(params, tokens)
        if grad_compression:
            grads, residuals = compress_tree(grads, residuals, stacked)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, opt_cfg)
        metrics = {"loss": loss, **metrics, **opt_metrics}
        if grad_compression:
            return params, opt_state, metrics, residuals
        return params, opt_state, metrics

    return train_step


# --------------------------------------------------------------------------
# shardings and the serving steps (the reference's launcher and dry-run)
# --------------------------------------------------------------------------

def train_shardings(cfg: ModelConfig, policy: Policy, zero1: bool = True,
                    fsdp: bool = True):
    """((params, opt_state, tokens), (params, opt_state, metrics))
    shardings of ``train_step``, the reference's production choice:
    ZeRO-1 puts the fp32 master and moments on the data axis, FSDP the
    params too, each on a free dim (expert tensors on their d_model dim);
    metrics are replicated scalars (None)."""
    pspec = lm.param_specs(cfg)
    params_shape = lm.abstract_params(cfg, tp=policy.tp_size)
    dp = policy.axis_size("data")

    def place(ax, sh):
        if "experts" in ax and len(sh.shape) >= 3:
            out = list(ax)
            for i, (a, n) in enumerate(zip(ax, sh.shape)):
                if a is None and n == cfg.d_model and n % dp == 0:
                    out[i] = "data"
                    return tuple(out)
            return ax
        return _zero1_axes(ax, tuple(sh.shape), dp)

    pspec_eff = map_specs(place, pspec, params_shape) if fsdp else pspec
    p_sh = policy.tree_named(pspec_eff)
    o_spec = opt_state_specs(pspec, params_shape, zero1=zero1, dp_size=dp)
    o_sh = {k: policy.tree_named(o_spec[k]) for k in ("master", "m", "v")}
    o_sh["step"] = policy.named()
    tok_sh = policy.named("batch", None)
    return (p_sh, o_sh, tok_sh), (p_sh, o_sh, None)


def serve_shardings(cfg: ModelConfig, policy: Policy):
    """((params, tokens, state), (logits, state)) shardings of
    ``decode_step``."""
    p_sh = policy.tree_named(lm.param_specs(cfg))
    state_sh = policy.tree_named(lm.serve_state_specs(cfg))
    return ((p_sh, policy.named("batch"), state_sh),
            (policy.named("batch", "vocab"), state_sh))


def make_decode_step(cfg: ModelConfig, policy: Policy) -> Callable:
    def decode_step(params, tokens, state):
        return lm.decode_step(params, tokens, state, cfg, policy=policy)
    return decode_step


def make_prefill_step(cfg: ModelConfig, policy: Policy,
                      cache_len: Optional[int] = None) -> Callable:
    def prefill_step(params, tokens):
        return lm.prefill(params, tokens, cfg, cache_len=cache_len,
                          policy=policy)
    return prefill_step
