"""Fault-tolerance demo on the PyTorch port (the counterpart of
examples/ft_demo.py): an identical training run under SR and GBN
recovery with injected failures; shows SR's goodput advantage and that
both reach the same parameters.

  PYTHONPATH=src python examples_torch/ft_demo.py [--device cpu]

``run(cfg, params, inputs, device)`` trains ``steps`` steps from
``params`` with no failures, then under SR and under GBN at
``failure_rate`` (each run from its own copy of ``params``, since AdamW
updates in place), on the synthetic data of ``inputs`` (``DataConfig``
fields), and returns each policy's recovery counters, goodput, its
largest parameter drift from the no-failure run and the gradients it
computed.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import SMOKE_CONFIGS
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import leaves, map_tree
from repro_torch.data import DataConfig, SyntheticPackedDataset
from repro_torch.ft import FaultTolerantTrainer, FTConfig
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.train_step import value_and_grad

N_WORKERS = 4


def model_config():
    return SMOKE_CONFIGS["musicgen-large"].scaled(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=256)


def make_inputs(vocab_size: int) -> dict:
    return {"seq_len": 64, "global_batch": 4, "vocab_size": vocab_size}


def train(cfg, params, inputs: dict, device, policy: str,
          failure_rate: float, steps: int):
    """(params, FTStats, gradient calls) of one run from a step-0
    checkpoint in a temporary directory."""
    data = SyntheticPackedDataset(DataConfig(**inputs))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    calls = [0]

    def grad_fn(p, t):
        calls[0] += 1
        return value_and_grad(p, t, cfg)[1], {}

    def update_fn(g, o, p):
        return adamw_update(g, o, p, ocfg)

    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d)
        opt = adamw_init(params)
        ckpt.save(0, (params, opt), blocking=True)
        tr = FaultTolerantTrainer(
            grad_fn, update_fn, data, ckpt,
            FTConfig(policy=policy, failure_rate=failure_rate,
                     checkpoint_every=10, seed=11), n_workers=N_WORKERS,
            device=device)
        params, opt, stats = tr.run(params, opt, steps)
        ckpt.wait()
    return params, stats, calls[0]


def run(cfg, params, inputs: dict, device=None, *, failure_rate=0.08,
        steps=30) -> dict:
    device = resolve_device(device)

    def copy():
        return map_tree(lambda t: t.clone(), params)

    ref, _, ref_calls = train(cfg, copy(), inputs, device, "sr", 0.0, steps)
    out = {"no_failure_grad_calls": ref_calls}
    for pol in ("sr", "gbn"):
        p, s, calls = train(cfg, copy(), inputs, device, pol, failure_rate,
                            steps)
        drift = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(leaves(ref), leaves(p)))
        eff = s.steps / (s.steps + s.steps_replayed
                         + s.microbatches_recomputed / N_WORKERS)
        out[pol] = {"steps": s.steps, "failures": s.failures,
                    "microbatches_recomputed": s.microbatches_recomputed,
                    "steps_replayed": s.steps_replayed,
                    "checkpoints_restored": s.checkpoints_restored,
                    "goodput": eff, "param_drift_vs_no_failure": drift,
                    "grad_calls": calls}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config()
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    out = run(cfg, params, make_inputs(cfg.vocab_size), device)
    for pol in ("sr", "gbn"):
        s = out[pol]
        print(f"{pol.upper():3s}: failures={s['failures']:2d} "
              f"recomputed_mb={s['microbatches_recomputed']:2d} "
              f"replayed={s['steps_replayed']:3d} "
              f"restores={s['checkpoints_restored']} "
              f"goodput={s['goodput']:.3f} "
              f"param_drift_vs_no_failure="
              f"{s['param_drift_vs_no_failure']:.2e}")
    return out


if __name__ == "__main__":
    main()
