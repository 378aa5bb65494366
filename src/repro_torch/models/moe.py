"""Mixture-of-Experts with capacity-based dispatch and combine.

The JingZhao Dynamic MultiQueue of the model: tokens are enqueued
dynamically into per-expert logical queues that share one capacity buffer
([groups, experts, capacity, d_model]); a full queue rejects the push.
The semantics are the JAX package's single-device ``_moe_mlp_local``
(``repro.models.moe``): an fp32 router (softmax, top-k, renormalise), the
Switch load-balance aux loss ``moe_aux`` and the dropped share
``moe_dropped``, queue positions from a cumsum of one-hots over the
flattened (token, k) order, the grouped expert GEMMs over every slot of
the buffer, and a combine back to token order. The enqueue itself runs
kernel B7 (``kernels.moe_dispatch``), launched once per layer for all
groups.

The combine adds each token's kept expert outputs in ascending expert
id, rounding in the activation dtype after each add, as the reference's
scatter-add over the buffer in [G, E, C] order does. It gathers instead
of scatter-adding, so no atomics decide the order and a run repeats bit
for bit on the card. On a mesh of more ranks ``moe_mlp_sharded`` is
the reference's expert-parallel ``_moe_mlp_sharded``: each rank enqueues
into its own E/tp queues.

Nothing here reads the device from the host: the capacity comes from
shapes, and no op's output shape depends on tensor values.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_dispatch import moe_dispatch
from repro_torch.models.layers import (dense_mlp, init_dense_mlp, mlp_specs,
                                       silu)
from repro_torch.sharding import collectives as col


def init_moe(cfg: ModelConfig, normal, dtype) -> dict:
    """One MoE block's params with the JAX ``init_moe`` shapes, dtypes and
    scales: the router [D,E] in fp32, the experts' [E,D,F] / [E,F,D]
    SwiGLU weights and the shared experts' dense MLP in ``dtype``.
    ``normal(shape, scale, dtype)`` draws each leaf."""
    moe = cfg.moe
    d, E, dE = cfg.d_model, moe.n_experts, moe.d_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dE)
    p = {"router": normal((d, E), 0.02, torch.float32),
         "w_gate": normal((E, d, dE), s_in, dtype),
         "w_up": normal((E, d, dE), s_in, dtype),
         "w_down": normal((E, dE, d), s_out, dtype)}
    if moe.n_shared:
        p["shared"] = init_dense_mlp(normal, d, moe.n_shared * dE, cfg.act,
                                     dtype)
    return p


def moe_specs(cfg: ModelConfig) -> dict:
    """Logical sharding axes of ``init_moe``'s leaves."""
    s = {"router": (None, "experts"), "w_gate": ("experts", None, None),
         "w_up": ("experts", None, None),
         "w_down": ("experts", None, None)}
    if cfg.moe.n_shared:
        s["shared"] = mlp_specs(cfg)
    return s


def capacity(tokens_per_group: int, cfg: ModelConfig,
             capacity_factor: Optional[float] = None) -> int:
    """Slots per expert queue: max(4, ceil(K * S / E * cf)), from shapes
    only (the reference's ``_capacity``)."""
    moe = cfg.moe
    cf = capacity_factor if capacity_factor is not None \
        else moe.capacity_factor
    return max(4, int(math.ceil(moe.top_k * tokens_per_group
                                / moe.n_experts * cf)))


def route(x, router, top_k: int):
    """fp32 router: x [..., D] -> (probs [..., E], top_w [..., K]
    renormalised, top_e [..., K] int64, best first)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_w, top_e = torch.topk(probs, top_k, dim=-1)
    return probs, top_w / top_w.sum(-1, keepdim=True), top_e


def _routed_experts(x, router, w_gate, w_up, w_down, cfg: ModelConfig,
                    C: int, e0: int = 0):
    """Route x [G,S,D] over all E experts with the full fp32 router
    [D,E], then enqueue, run and combine the experts e0 .. e0+E_loc-1
    whose weights are given ([E_loc, ...]); every expert on one rank.
    Returns (out [G,S,D], the aux loss's share of those experts, the
    dropped share). Queue positions count every expert's tokens, so a
    token is dropped as it is on one rank."""
    moe = cfg.moe
    G, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    E_loc = w_gate.shape[0]
    dev = x.device
    experts = torch.arange(E, device=dev)

    # ---- router (fp32) and the Switch load-balance loss ----------------
    probs, top_w, top_e = route(x, router, K)                    # [G,S,*]
    frac_routed = (top_e[..., :1] == experts).float().mean((0, 1))
    aux = E * torch.sum((frac_routed * probs.mean((0, 1)))[e0:e0 + E_loc])

    # ---- dispatch: enqueue each (token, k) at its queue position --------
    e_flat = top_e.reshape(G, S * K)
    onehot = (e_flat[..., None] == experts).to(torch.int32)      # [G,SK,E]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
        -1, e_flat[..., None])[..., 0] - 1                        # [G,SK]
    dropped = 1.0 - (pos < C).float().mean()
    # a dropped or another rank's entry takes a queue id past the last,
    # which B7 drops
    local = e_flat - e0
    keep = (pos < C) & (local >= 0) & (local < E_loc)
    queue = torch.where(keep, local + E_loc * torch.arange(G, device=dev)
                        [:, None], G * E_loc)                     # g*E_loc + e
    buf = moe_dispatch(x.repeat_interleave(K, dim=1).reshape(G * S * K, D),
                       queue.to(torch.int32).reshape(-1), pos.reshape(-1),
                       G * E_loc, C).reshape(G, E_loc, C, D)

    # ---- grouped expert GEMMs over every slot ----------------------------
    h = silu(torch.einsum("gecd,edf->gecf", buf, w_gate)) \
        * torch.einsum("gecd,edf->gecf", buf, w_up)
    y = torch.einsum("gecf,efd->gecd", h, w_down)             # [G,E_loc,C,D]

    # ---- combine: each token's kept outputs, ascending expert id ---------
    e_sorted, order = torch.sort(top_e, dim=-1)                   # [G,S,K]
    pos_k = pos.reshape(G, S, K).gather(-1, order)
    w_k = top_w.gather(-1, order)
    local_k = e_sorted - e0
    mine = (local_k >= 0) & (local_k < E_loc) & (pos_k < C)
    slot = ((torch.arange(G, device=dev)[:, None, None] * E_loc
             + local_k.clamp(0, E_loc - 1)) * C
            + torch.clamp(pos_k, max=C - 1))
    y_w = (y.reshape(G * E_loc * C, D)[slot].float()
           * w_k[..., None]).to(x.dtype)                          # [G,S,K,D]
    y_w = y_w.masked_fill(~mine[..., None], 0)
    out = y_w[:, :, 0]
    for k in range(1, K):
        out = out + y_w[:, :, k]
    return out, aux, dropped


def moe_mlp(x, p, cfg: ModelConfig,
            capacity_factor: Optional[float] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [G, S, D] (groups are sequences, or one group of decode tokens)
    -> (out [G, S, D], {"moe_aux", "moe_dropped"} 0-d fp32 tensors)."""
    C = capacity(x.shape[1], cfg, capacity_factor)
    out, aux, dropped = _routed_experts(x, p["router"], p["w_gate"],
                                        p["w_up"], p["w_down"], cfg, C)
    if cfg.moe.n_shared:
        out = out + dense_mlp(x, p["shared"], cfg)
    return out, {"moe_aux": aux, "moe_dropped": dropped}


def moe_mlp_sharded(x, p, cfg: ModelConfig, mg
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``moe_mlp`` expert-parallel on a mesh (the reference's
    ``_moe_mlp_sharded``): x [G_loc,S,D] is the rank's sequences,
    replicated over ``model`` (under SP its 1/tp of each sequence,
    gathered along it first: ``MeshGroups.enter``); the router's [D,
    E/tp] shard is gathered over ``model``, routing runs over all E
    experts, and the rank enqueues (B7, B7-bwd), runs and combines only
    its E/tp experts; with the shared experts' column/row-parallel
    partial, the output is summed over ``model`` (under SP
    reduce-scattered back to the rank's slice: ``MeshGroups.leave``).
    ``moe_aux`` is the experts' shares summed over ``model``, then, as
    ``moe_dropped``, averaged over the batch group (``pod`` x ``data``,
    the reference's ``dp_axes``): the mean of each batch shard's product
    of means."""
    x = mg.enter(x)
    C = capacity(x.shape[1], cfg)
    router = col.all_gather(p["router"], mg.tp, 1)
    e0 = mg.tp_rank * p["w_gate"].shape[0]
    out, aux, dropped = _routed_experts(x, router, p["w_gate"], p["w_up"],
                                        p["w_down"], cfg, C, e0)
    if cfg.moe.n_shared:
        out = out + dense_mlp(x, p["shared"], cfg)
    aux = col.pmean(col.psum(aux, mg.tp), mg.batch)
    return mg.leave(out), {"moe_aux": aux,
                           "moe_dropped": col.pmean(dropped, mg.batch)}
