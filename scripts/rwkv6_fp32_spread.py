#!/usr/bin/env python3
"""How far rwkv6-1.6b SMOKE's fp32 gradient on the card lies from its
float64 value, on one rank and on a (2, 2) ("data", "model") mesh of four
gloo ranks sharing the card, for each seed.

    PYTHONPATH=src python3 scripts/rwkv6_fp32_spread.py [--seeds 0 1 2 3]

chip_smoke.py's ranks phase, its first fp32 SMOKE run of rwkv6 (4 rows of
64 tokens over two data shards, FSDP and SP off, TF32 off), at each seed
(weights from the seed, tokens from the seed + 1), its comparisons
recorded and not held (``chip_smoke._ranks_smoke``). For each seed it
prints, as the worst leaf's max |difference| over that leaf's largest
|value|: the mesh against one rank (the mean of the two shards' one-rank
card gradients), each of them against the same one-rank gradient in
float64 (``chip_smoke._float64_spread``: every op of the stack in
float64 on the CPU, the WKV through its plain version), the largest
excess on a leaf of the mesh's distance from float64 over the one-rank
run's, and whether the ranks phase would pass it
(``chip_smoke.ranks_grads_ok``). The fp32 runs take the card: without
one it exits 1.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn  # noqa: E402

ARCH = "rwkv6-1.6b"


def _spread(rank, store, seeds):
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(chip_smoke.RANKS_MESH, ("data", "model"),
                     device="cuda", backend=chip_smoke.RANKS_BACKEND,
                     store=store, rank=rank)
    out = []
    for seed in seeds:
        rec = chip_smoke._ranks_smoke(torch, mesh, ARCH, False, False, rank,
                                      seed=seed, check=False)
        if rank == 0:
            out.append({"seed": seed, "device": "cuda",
                        "mesh_vs_one_rank": [rec["grad_err"],
                                             rec["grad_worst"]],
                        "one_rank_vs_float64": rec["float64"]["one_rank"],
                        "mesh_vs_float64": rec["float64"]["run"],
                        "excess": [rec["float64"]["excess"],
                                   rec["float64"]["excess_leaf"]],
                        "passes": chip_smoke.ranks_grads_ok(rec)})
    return out if rank == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("rwkv6_fp32_spread: no CUDA device; the fp32 runs take "
                 "the card")
    # once, before the ranks load them
    from repro_torch.kernels import _build
    _build.build_all()
    for row in spawn(_spread, 4, args.seeds, timeout=600)[0]:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
