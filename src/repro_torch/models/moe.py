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
for bit on the card. The expert-sharded path (``_moe_mlp_sharded``) is
not ported: the port runs on one card (ROADMAP A13).

Nothing here reads the device from the host: the capacity comes from
shapes, and no op's output shape depends on tensor values.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_dispatch import moe_dispatch
from repro_torch.models.layers import dense_mlp, init_dense_mlp, silu


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


def moe_mlp(x, p, cfg: ModelConfig,
            capacity_factor: Optional[float] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [G, S, D] (groups are sequences, or one group of decode tokens)
    -> (out [G, S, D], {"moe_aux", "moe_dropped"} 0-d fp32 tensors)."""
    moe = cfg.moe
    G, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    C = capacity(S, cfg, capacity_factor)
    dev = x.device
    experts = torch.arange(E, device=dev)

    # ---- router (fp32) and the Switch load-balance loss ----------------
    probs, top_w, top_e = route(x, p["router"], K)               # [G,S,*]
    frac_routed = (top_e[..., :1] == experts).float().mean((0, 1))
    aux = E * torch.sum(frac_routed * probs.mean((0, 1)))

    # ---- dispatch: enqueue each (token, k) at its queue position --------
    e_flat = top_e.reshape(G, S * K)
    onehot = (e_flat[..., None] == experts).to(torch.int32)      # [G,SK,E]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
        -1, e_flat[..., None])[..., 0] - 1                        # [G,SK]
    keep = pos < C
    dropped = 1.0 - keep.float().mean()
    queue = e_flat + E * torch.arange(G, device=dev)[:, None]    # g*E + e
    buf = moe_dispatch(x.repeat_interleave(K, dim=1).reshape(G * S * K, D),
                       queue.to(torch.int32).reshape(-1), pos.reshape(-1),
                       G * E, C).reshape(G, E, C, D)

    # ---- grouped expert GEMMs over every slot ----------------------------
    h = silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    y = torch.einsum("gecf,efd->gecd", h, p["w_down"])            # [G,E,C,D]

    # ---- combine: each token's kept outputs, ascending expert id ---------
    e_sorted, order = torch.sort(top_e, dim=-1)                   # [G,S,K]
    pos_k = pos.reshape(G, S, K).gather(-1, order)
    w_k = top_w.gather(-1, order)
    slot = ((torch.arange(G, device=dev)[:, None, None] * E + e_sorted) * C
            + torch.clamp(pos_k, max=C - 1))
    y_w = (y.reshape(G * E * C, D)[slot].float()
           * w_k[..., None]).to(x.dtype)                          # [G,S,K,D]
    y_w = y_w.masked_fill((pos_k >= C)[..., None], 0)
    out = y_w[:, :, 0]
    for k in range(1, K):
        out = out + y_w[:, :, k]

    if moe.n_shared:
        out = out + dense_mlp(x, p["shared"], cfg)
    return out, {"moe_aux": aux, "moe_dropped": dropped}
