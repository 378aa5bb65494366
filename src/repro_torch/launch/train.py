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
qwen3-8b with AdamW's fp32 state needs 131 GB) and ``--device``. Every
registry config trains: ``--arch rwkv6-1.6b``, ``moonshot-v1-16b-a3b``,
``deepseek-v2-lite-16b`` and ``jamba-v0.1-52b`` as the dense ones.

The run is laid out by a sharding policy, as the reference's, with the
reference's choices: sequence parallelism and FSDP unless ``--smoke``,
ZeRO-1 always, and the pod axis's batch rules on a ("pod", "data",
"model") mesh. The mesh is the one-rank smoke mesh (``launch/mesh.py``),
where the policy changes only the specs, or the mesh of ranks ``main``
is given (``mesh=``: each rank of a ``launch/mesh.py`` ``spawn`` calls
it with its ``make_mesh``), on which the run trains its rank's shards
(``place_train_state``: the params on ``train_shardings``, AdamW's state
made from the rank's ZeRO-1 slices; each step takes the global batch and
keeps the rank's rows; every config but deepseek-v2-lite-16b's MLA, so
rwkv6-1.6b and jamba-v0.1-52b too), each rank checkpointing its own
shards under
``<ckpt-dir>/rank<r>``. ``--multipod`` asks for the two-pod production
mesh of 512 ranks: in a world of another size it raises ``ValueError``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.timing import Timer
from repro_torch.data import DataConfig, SyntheticPackedDataset
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import make_policy
from repro_torch.train.train_step import make_train_step, place_train_state

DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_ckpt")


def main(argv=None, mesh=None) -> dict:
    """Train as the flags say, on ``mesh`` if given (a mesh of ranks),
    else the smoke mesh or ``--multipod``'s; returns every step's metrics
    (host floats), the run's totals, and the final params and optimizer
    state (the rank's shards on a mesh of more ranks)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--multipod", action="store_true",
                    help="the two-pod (2, 16, 16) production mesh: needs "
                         "512 ranks, so one device raises ValueError")
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
    device = resolve_device(args.device)
    if mesh is None:
        mesh = (make_production_mesh(multi_pod=True, device=device)
                if args.multipod else make_smoke_mesh(device))
    policy = make_policy(mesh, multi_pod="pod" in mesh.mesh_dim_names,
                         sp=not args.smoke, fsdp=not args.smoke)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt = place_train_state(
        lm.init_params(cfg, gen, device=device, tp=policy.tp_size), cfg,
        policy)
    step = make_train_step(cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                                            total_steps=args.steps),
                           microbatch=args.microbatch, policy=policy)
    data = SyntheticPackedDataset(DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size))
    ckpt_dir = args.ckpt_dir
    if policy.n_ranks > 1:
        ckpt_dir = str(Path(ckpt_dir) / f"rank{dist.get_rank()}")
    ckpt = Checkpointer(ckpt_dir)
    start = 0
    if args.resume and latest_step(ckpt_dir) is not None:
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
