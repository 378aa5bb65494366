"""Weight bridge: the JAX package's param pytree, as numpy, to the port's
params dict.

The JAX stack stores its repeating unit of blocks with a leading group
axis (``stack.groups.b{j}``, after any ``stack.prefix`` blocks); the port
holds one block per layer. This module unstacks the groups into layer
order and keeps every matrix in its ``[in, out]`` layout; jamba's unit
of eight mixed Mamba and attention blocks unstacks like any other.
Leaves the tree holds in float32 stay float32 (in a bf16 model, RWKV's
mixing, decay, bonus and norm vectors, Mamba's ``dt_bias``, ``A_log``
and ``D_skip``, the MoE routers); the others take ``dtype``. The caller
converts the JAX arrays to numpy (``jax.tree.map(np.asarray, params)``),
so the port itself never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as tf


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


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

    prefix, unit, n_groups = tf.plan_layers(cfg)
    stack = tree["stack"]
    blocks = [_map(tensor, b) for b in stack["prefix"]]
    for g in range(n_groups):
        for j in range(len(unit)):
            blocks.append(_map(lambda a: tensor(np.asarray(a)[g]),
                               stack["groups"][f"b{j}"]))
    params = {"embed": tensor(tree["embed"]), "blocks": blocks,
              "final_norm": tensor(tree["final_norm"])}
    if "head" in tree:
        params["head"] = tensor(tree["head"])
    return params
