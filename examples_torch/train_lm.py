"""End-to-end training example on the PyTorch port (the counterpart of
examples/train_lm.py): data pipeline -> fault-tolerant trainer ->
checkpoints, with failure injection and both recovery policies.

Default runs a ~6M-parameter model for 200 steps; pass
``--dim/--layers/--steps`` to scale it (the trainer is the one the
launcher uses, src/repro_torch/launch/train.py).

  PYTHONPATH=src python examples_torch/train_lm.py --steps 200
  PYTHONPATH=src python examples_torch/train_lm.py --device cpu \\
      --steps 30 --dim 64 --layers 2 --seq 64 --batch 4 --vocab 256

``run(cfg, params, inputs, device, **options)`` trains on the synthetic
data of ``inputs`` (``DataConfig`` fields) and returns the initial and
final loss on a held-out batch, the recovery counters, the gradients
computed, the seconds (after a synchronize) and tokens/s. Checkpoints
go to ``--ckpt-dir`` (``build/train_lm_ckpt`` under the checkout by
default); the trainer's GBN restores the newest step there, so give
each run a directory of its own.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.timing import Timer
from repro_torch.core.tree import leaves
from repro_torch.data import DataConfig, SyntheticPackedDataset
from repro_torch.ft import FaultTolerantTrainer, FTConfig
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.train_step import value_and_grad

N_WORKERS = 4
CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "train_lm_ckpt"


def model_config(dim=256, layers=4, vocab=4096) -> ModelConfig:
    return ModelConfig(
        name="trainer-demo", family="dense", n_layers=layers, d_model=dim,
        n_heads=dim // 64 or 2, n_kv_heads=max(1, (dim // 64 or 2) // 2),
        head_dim=64, d_ff=dim * 4, vocab_size=vocab)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, params, inputs: dict, device=None, *, steps=200, policy="sr",
        failure_rate=0.02, ckpt_dir=CKPT_DIR) -> dict:
    device = resolve_device(device)
    data = SyntheticPackedDataset(DataConfig(**inputs))
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    calls = [0]

    def grad_fn(p, t):
        calls[0] += 1
        return value_and_grad(p, t, cfg)[1], {}

    def loss_fn(p, t):
        with torch.no_grad():
            return float(lm.forward_loss(p, t, cfg)[0])

    def update_fn(g, o, p):
        return adamw_update(g, o, p, ocfg)

    opt = adamw_init(params)
    ckpt = Checkpointer(str(ckpt_dir))
    ckpt.save(0, (params, opt), blocking=True)
    trainer = FaultTolerantTrainer(
        grad_fn, update_fn, data, ckpt,
        FTConfig(policy=policy, failure_rate=failure_rate,
                 checkpoint_every=25), n_workers=N_WORKERS, device=device)
    eval_toks = torch.as_tensor(data.batch_at(10_000)[0], device=device)
    initial = loss_fn(params, eval_toks)
    _sync(device)
    t = Timer()
    params, opt, stats = trainer.run(params, opt, steps)
    _sync(device)
    dt = t.elapsed()
    final = loss_fn(params, eval_toks)
    ckpt.wait()
    tokens = stats.steps * inputs["global_batch"] * inputs["seq_len"]
    return {"initial_loss": initial, "final_loss": final,
            "steps": stats.steps, "failures": stats.failures,
            "microbatches_recomputed": stats.microbatches_recomputed,
            "steps_replayed": stats.steps_replayed,
            "checkpoints_restored": stats.checkpoints_restored,
            "grad_calls": calls[0], "seconds": dt,
            "tokens_per_s": tokens / dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--policy", default="sr", choices=["sr", "gbn"])
    ap.add_argument("--failure-rate", type=float, default=0.02)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config(args.dim, args.layers, args.vocab)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    n = sum(p.numel() for p in leaves(params))
    print(f"model: {n / 1e6:.1f}M params | policy={args.policy} "
          f"failure_rate={args.failure_rate} | {device.type}")
    out = run(cfg, params, {"seq_len": args.seq, "global_batch": args.batch,
                            "vocab_size": args.vocab}, device,
              steps=args.steps, policy=args.policy,
              failure_rate=args.failure_rate, ckpt_dir=args.ckpt_dir)
    print("initial loss:", out["initial_loss"])
    print("final loss:  ", out["final_loss"])
    print(f"steps={out['steps']} failures={out['failures']} "
          f"recomputed_mb={out['microbatches_recomputed']} "
          f"replayed={out['steps_replayed']} "
          f"restores={out['checkpoints_restored']}")
    print(f"tokens/s: {out['tokens_per_s']:.0f}")
    return out


if __name__ == "__main__":
    main()
