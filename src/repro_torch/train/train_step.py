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
fp32 state. ``checkpoint.reshard_tree`` lays a tree out on them
(``place_train_state`` for a train step's params and state), and
``unshard_tree`` gathers the whole leaves back. On one rank every
placement holds the whole tensor. On a ("data", "model") or ("pod",
"data", "model") mesh of more ranks the train step holds each rank's
shards: it takes the rank's rows of the global batch (of each
microbatch's rows; pod-major over ``pod`` x ``data``), sums the
gradients over ``data`` (FSDP's leaves in their backward's
reduce-scatter) and then over ``pod``, and updates the rank's ZeRO-1
slice of the master and moments, gathering the params back over
``data``: params, master and moments are whole across ``pod``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves, map_tree
from repro_torch.models import lm
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw_update, opt_state_specs
from repro_torch.sharding import collectives as col
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


def _leaf_dims(cfg: ModelConfig, policy: Policy) -> list:
    """(model dim, FSDP data dim, ZeRO-1 data dim) of every param leaf,
    in ``leaves`` order, each None where the leaf is whole over that
    axis."""
    tp, dp = policy.tp_size, policy.axis_size("data")
    pspec = lm.param_specs(cfg)
    fspec = lm.fsdp_param_specs(cfg, tp, dp) \
        if policy.rules.get("fsdp_params") else pspec
    zspec = opt_state_specs(pspec, lm.abstract_params(cfg, tp=tp),
                            zero1=True, dp_size=dp)["master"]
    out = []

    def one(p, f, z):
        m = [i for i, a in enumerate(policy.spec(*p)) if a == "model"]
        out.append((m[0] if m else None,
                    f.index("data") if "data" in f else None,
                    z.index("data") if "data" in z else None))
    map_specs(one, pspec, fspec, zspec)
    return out


def _mesh_update(grads, opt_state, params, opt_cfg, mg, dims,
                 residuals=None, stacked=()):
    """AdamW on a mesh: each gradient summed over ``data`` (an FSDP
    leaf's already is), cut to the rank's ZeRO-1 slice and summed over
    ``pod``; with
    ``residuals`` (shaped as those slices) int8-compressed at the whole
    leaf's scale (the largest |g + r| over every rank's slice); the
    global norm from every distinct shard once; the master and moments
    updated on their slices; each param gathered back over ``data`` from
    the master's slices, or cut to its FSDP shard."""
    def chunk(t, dim):
        return t if dim is None else t.chunk(mg.dp_size, dim)[mg.dp_rank]

    def regather(t, have, want):
        if have == want:
            return t
        if have is not None:
            t = col.gather(t, mg.dp, have)
        return chunk(t, want)

    def pmax_all(t):
        t = col.all_reduce(t, mg.tp, torch.distributed.ReduceOp.MAX)
        return col.all_reduce(t, mg.dp, torch.distributed.ReduceOp.MAX)

    sliced = []
    for g, (_, f, z) in zip(leaves(grads), dims):
        g, have = g.float(), f
        if f is None:
            have = z
            g = col.all_reduce(g, mg.dp) if z is None else \
                col.reduce_scatter(g, mg.dp, z)
        g = regather(g, have, z)
        sliced.append(col.all_reduce(g, mg.pod) if mg.pod is not None
                      else g)
    it = iter(sliced)
    g_tree = map_tree(lambda _: next(it), grads)
    if residuals is not None:
        g_tree, residuals = compress_tree(g_tree, residuals, stacked,
                                          reduce=pmax_all)
    sq = torch.zeros((), dtype=torch.float32, device=sliced[0].device)
    for g, (m, _, z) in zip(leaves(g_tree), dims):
        if (m is not None or mg.tp_rank == 0) and \
                (z is not None or mg.dp_rank == 0):
            sq = sq + torch.sum(torch.square(g))
    gnorm = torch.sqrt(col.all_reduce(col.all_reduce(sq, mg.tp), mg.dp))
    _, opt_state, opt_metrics = adamw_update(g_tree, opt_state, None,
                                             opt_cfg, grad_norm=gnorm)
    with torch.no_grad():
        for ma, p, (_, f, z) in zip(leaves(opt_state["master"]),
                                    leaves(params), dims):
            p.copy_(regather(ma.to(p.dtype), z, f))
    return params, opt_state, opt_metrics, residuals


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    grad_compression: bool = False,
                    microbatch: int = 0, *,
                    policy: Policy = NULL_POLICY) -> Callable:
    """train_step(params, opt_state, tokens[, residuals]) -> (params,
    opt_state, metrics[, residuals]). ``microbatch`` > 1 accumulates
    gradients over that many row slices of the batch, in fp32, and
    reports the mean of their losses and the last slice's other
    metrics, as the reference's scan does. On a mesh of more ranks
    ``params`` and ``opt_state`` are the rank's shards on
    ``train_shardings(cfg, policy, fsdp=<the policy's fsdp_params>)``,
    ZeRO-1's (``place_train_state``), ``tokens`` the global batch,
    the same on every rank, and ``residuals`` shaped as the rank's master
    slices (``init_residuals(opt_state["master"])``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    mesh = policy.n_ranks > 1
    if mesh:
        policy.require_supported("make_train_step", cfg, train=True)
        mg = col.MeshGroups.of(policy)
        dims = _leaf_dims(cfg, policy)

    def rows(t):
        """This rank's rows of a global batch: its slice over ``pod`` x
        ``data``, pod-major."""
        if not mesh:
            return t
        if t.shape[0] % mg.batch_size:
            raise ValueError(f"batch rows {t.shape[0]} are not a multiple "
                             f"of the batch axes {mg.batch_size}")
        b = t.shape[0] // mg.batch_size
        return t[mg.batch_rank * b:(mg.batch_rank + 1) * b]
    # the blocks the reference stacks into one leaf, which compression
    # scales as one tensor: block j of every repeating group
    prefix, unit, n_groups = tf.plan_layers(cfg)
    stacked = [[len(prefix) + g * len(unit) + j for g in range(n_groups)]
               for j in range(len(unit))]

    def compute_grads(params, tokens):
        if not (microbatch and microbatch > 1):
            return value_and_grad(params, rows(tokens), cfg, policy=policy)
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
                params, rows(tokens[i * mb:(i + 1) * mb]), cfg,
                policy=policy)
            for a, b in zip(leaves(g_acc), leaves(g)):
                a.add_(b)
            del g
            l_acc = l_acc + l
        g_acc = map_tree(lambda a: a.div_(microbatch), g_acc)
        return (l_acc / microbatch, metrics), g_acc

    def train_step(params, opt_state, tokens, residuals=None):
        (loss, metrics), grads = compute_grads(params, tokens)
        if mesh:
            params, opt_state, opt_metrics, residuals = _mesh_update(
                grads, opt_state, params, opt_cfg, mg, dims,
                residuals if grad_compression else None, stacked)
        else:
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
    pspec_eff = lm.fsdp_param_specs(cfg, policy.tp_size, dp) if fsdp \
        else pspec
    p_sh = policy.tree_named(pspec_eff)
    o_spec = opt_state_specs(pspec, params_shape, zero1=zero1, dp_size=dp)
    o_sh = {k: policy.tree_named(o_spec[k]) for k in ("master", "m", "v")}
    o_sh["step"] = policy.named()
    tok_sh = policy.named("batch", None)
    return (p_sh, o_sh, tok_sh), (p_sh, o_sh, None)


def place_train_state(params, cfg: ModelConfig, policy: Policy,
                      opt_state=None):
    """(params[, opt_state]) whole on every rank -> this rank's shards
    as ``make_train_step`` takes them on a mesh: ``train_shardings`` with
    the policy's FSDP flag. Without ``opt_state`` a fresh AdamW state is
    made from the rank's ZeRO-1 slices of the params (``adamw_init``), so
    no rank holds the whole fp32 state. Copies: the step updates them in
    place, and a shard that is the whole leaf must not write into the
    caller's."""
    from repro_torch.checkpoint import reshard_tree
    from repro_torch.optim import adamw_init
    (p_sh, o_sh, _), _ = train_shardings(
        cfg, policy, fsdp=bool(policy.rules.get("fsdp_params")))

    def place(tree, sh):
        return map_tree(lambda t: t.clone(), reshard_tree(tree, sh))
    if opt_state is None:
        opt = adamw_init(reshard_tree(params, o_sh["master"]))
    else:
        opt = {k: place(opt_state[k], o_sh[k])
               for k in ("master", "m", "v")}
        opt["step"] = opt_state["step"].clone()
    return place(params, p_sh), opt


def unshard_tree(tree, shardings):
    """Each rank's shard of every leaf -> the whole leaf on every rank,
    gathered over each mesh dim that shards it (``reshard_tree``'s
    inverse)."""
    from torch.distributed.tensor import Shard

    def walk(x, sh):
        if isinstance(x, dict):
            return {k: walk(x[k], sh[k]) for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(a, b) for a, b in zip(x, sh))
        mesh, placements = sh
        for i, pl in enumerate(placements):
            if isinstance(pl, Shard):
                x = col.gather(x, mesh.get_group(i), pl.dim)
        return x
    return walk(tree, shardings)


def gathered_grads(grads, cfg: ModelConfig, policy: Policy):
    """The rank's gradients of ``value_and_grad`` on a mesh -> the whole
    gradients on every rank: summed over ``data`` (an FSDP leaf's already
    are) and ``pod``, and gathered over every mesh dim that shards the
    param."""
    mg = col.MeshGroups.of(policy)
    summed = [g if f is not None else col.all_reduce(g, mg.dp)
              for g, (_, f, _) in zip(leaves(grads),
                                      _leaf_dims(cfg, policy))]
    if mg.pod is not None:
        summed = [col.all_reduce(g, mg.pod) for g in summed]
    it = iter(summed)
    (p_sh, _, _), _ = train_shardings(
        cfg, policy, fsdp=bool(policy.rules.get("fsdp_params")))
    return unshard_tree(map_tree(lambda _: next(it), grads), p_sh)


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
