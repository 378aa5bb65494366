"""Weight bridge between the JAX package's param pytree, as numpy, and
the port's params dict, both ways, and the same for AdamW's state.

The JAX stack stores its repeating unit of blocks with a leading group
axis (``stack.groups.b{j}``, after any ``stack.prefix`` blocks); the port
holds one block per layer. This module unstacks the groups into layer
order and keeps every matrix in its ``[in, out]`` layout; jamba's unit
of eight mixed Mamba and attention blocks unstacks like any other.
Leaves the tree holds in float32 stay float32 (in a bf16 model, RWKV's
mixing, decay, bonus and norm vectors, Mamba's ``dt_bias``, ``A_log``
and ``D_skip``, the MoE routers); the others take ``dtype``. The caller
converts the JAX arrays to numpy (``jax.tree.map(np.asarray, params)``),
so the port itself never imports JAX. ``params_to_numpy`` restacks the
port's layers into the reference's layout (gradients too: they have the
params' structure), each leaf a float32 array (bf16 widened, exactly),
so tests compare trees leaf by leaf; ``opt_state_to_numpy`` and
``opt_state_from_numpy`` carry AdamW's ``{master, m, v, step}`` across.
The bridge reads each leaf's shape as it is, so the reference's
tp-aligned parameters (``init_params(..., tp=)``: query heads padded and
KV heads duplicated to ``transformer.eff_heads``) cross unchanged.
``unstack_layers`` orders any tree of the reference's stack layout
(params, or spec and shape trees) by layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import map_tree
from repro_torch.models import transformer as tf


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(stack: dict, cfg: ModelConfig, take) -> list:
    """The reference's ``{prefix, groups}`` stack -> one block per layer,
    in layer order; ``take(leaf, g)`` reads group g of a stacked leaf."""
    prefix, unit, n_groups = tf.plan_layers(cfg)
    blocks = list(stack["prefix"])
    for g in range(n_groups):
        for j in range(len(unit)):
            blocks.append(_map(lambda a: take(a, g),
                               stack["groups"][f"b{j}"]))
    return blocks


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None,
                      dtype=torch.float32) -> dict:
    """{embed, stack: {prefix, groups}, final_norm[, head]} numpy tree ->
    {embed, blocks: [one dict per layer], final_norm[, head]} tensors."""
    device = resolve_device(device)

    def tensor(a):
        # through float32: exact for float32 and bfloat16 sources (numpy
        # has no bfloat16 of its own)
        a = np.asarray(a)
        out = torch.float32 if a.dtype == np.float32 else dtype
        return torch.from_numpy(
            np.ascontiguousarray(a.astype(np.float32))).to(
                device=device, dtype=out)

    blocks = [_map(tensor, b) for b in unstack_layers(
        tree["stack"], cfg, lambda a, g: np.asarray(a)[g])]
    params = {"embed": tensor(tree["embed"]), "blocks": blocks,
              "final_norm": tensor(tree["final_norm"])}
    if "head" in tree:
        params["head"] = tensor(tree["head"])
    return params


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """{embed, blocks, final_norm[, head]} tensors -> {embed, stack:
    {prefix, groups}, final_norm[, head]} float32 numpy, the groups'
    layers stacked on a leading axis as the reference stores them."""
    def array(t):
        return t.detach().float().cpu().numpy()

    prefix, unit, n_groups = tf.plan_layers(cfg)
    blocks = params["blocks"]
    stack = {"prefix": [_map(array, b) for b in blocks[:len(prefix)]],
             "groups": None}
    if n_groups:
        grouped = blocks[len(prefix):]
        per = len(unit)

        def stacked(j):
            layers = [grouped[g * per + j] for g in range(n_groups)]
            return map_tree(lambda *ts: np.stack([array(t) for t in ts]),
                            *layers)
        stack["groups"] = {f"b{j}": stacked(j) for j in range(per)}
    tree = {"embed": array(params["embed"]), "stack": stack,
            "final_norm": array(params["final_norm"])}
    if "head" in params:
        tree["head"] = array(params["head"])
    return tree


def opt_state_to_numpy(opt_state: dict, cfg: ModelConfig) -> dict:
    """AdamW's state in the reference's layout: master, m and v as
    ``params_to_numpy`` trees, step an int32 scalar."""
    out = {k: params_to_numpy(opt_state[k], cfg)
           for k in ("master", "m", "v")}
    out["step"] = np.int32(int(opt_state["step"]))
    return out


def opt_state_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's AdamW state (numpy) -> the port's, every moment
    and master leaf float32."""
    device = resolve_device(device)
    out = {k: params_from_numpy(tree[k], cfg, device=device,
                                dtype=torch.float32)
           for k in ("master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=device)
    return out
