"""Training launcher of the port (``repro.launch.train``).

Builds the model with random weights (seed 0, as the reference's
``PRNGKey(0)``), AdamW, the
synthetic packed data, and runs the train step with checkpoints every
``--ckpt-every`` steps (params, optimizer state and the data's step);
``--resume`` continues from the newest one in ``--ckpt-dir``.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --layers 14 --seq 4096 --batch 2 --microbatch 2 --steps 8

runs on the first CUDA card unless ``--device cpu``. The flags are the
reference's, with ``--layers`` to cut the depth for one card (the whole
qwen3-8b with AdamW's fp32 state needs 131 GB) and ``--device``. One
device: ``--multipod`` (sharding) is ROADMAP A13b. The dense-attention
family trains (``lm.train_supported``); the other families are A12b.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.timing import Timer
from repro_torch.data import DataConfig, SyntheticPackedDataset
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step

DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_ckpt")


def main(argv=None) -> dict:
    """Train as the flags say; returns every step's metrics (host
    floats), the run's totals, and the final params and optimizer
    state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.multipod:
        raise NotImplementedError("one device; see ROADMAP A13b (sharding)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    if not lm.train_supported(cfg):
        raise NotImplementedError(
            f"training {cfg.name} is ROADMAP A12b; the port trains the "
            f"dense-attention family")
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(cfg, gen, device=device)
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                                            total_steps=args.steps),
                           microbatch=args.microbatch)
    data = SyntheticPackedDataset(DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size))
    ckpt = Checkpointer(args.ckpt_dir)
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        (params, opt), meta = ckpt.restore((params, opt))
        start = meta["step"]
        data.load_state_dict(meta["extra"].get("data", {"step": start}))
        print(f"resumed from step {start}")

    steps = []
    timer = Timer()
    for i in range(start, args.steps):
        t = Timer()
        toks, _ = data.next_batch()
        params, opt, metrics = step(params, opt,
                                    torch.as_tensor(toks, device=device))
        rec = {"step": i, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "seconds": t.elapsed()}
        steps.append(rec)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={rec['loss']:.4f} "
                  f"gnorm={rec['grad_norm']:.3f} lr={rec['lr']:.2e}")
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, (params, opt),
                      extra={"data": data.state_dict()})
    ckpt.wait()
    dt = timer.elapsed()
    n = args.steps - start
    tok_s = n * args.batch * args.seq / dt if n else 0.0
    print(f"done: {n} steps, {tok_s:.0f} tok/s")
    return {"arch": cfg.name, "layers": cfg.n_layers, "start": start,
            "steps": steps, "seconds": dt, "tokens_per_s": tok_s,
            "params": params, "opt_state": opt}



if __name__ == "__main__":
    main()
