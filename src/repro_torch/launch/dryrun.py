"""The one-card dry run: walk every (arch x shape) step on ``meta``
(the port's counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for its TPU pod meshes and
reads XLA's memory and cost analyses. The port runs one card eagerly,
so each cell builds its step on the ``meta`` device and runs it once
under ``launch/cost_walk.CostWalk``: parameters from
``lm.abstract_params``, AdamW's state from ``adamw_init`` (train), the
inputs from ``lm.input_specs`` at ``--batch`` rows (``CARD_BATCH`` by
default), ``--microbatch`` (``TRAIN_MICROBATCH``, else 2) and remat for
train, ``--layers`` of the config's depth (all by default), and for
decode the reference's per-slot state or, with ``--kv-layout paged``,
page pools (B1's path for plain attention). No value is
computed and no card is needed; the kernels' wrappers return their
outputs' shapes and report their work. The record (JSON under
``results/dryrun_torch/``) holds the argument, output and peak bytes,
FLOPs and HBM bytes whole and by class, and each kernel's calls and work.

``--fit`` also finds the deepest depth whose peak fits the budget:
``--memory-gb`` (1e9 bytes), or with a card the free bytes
``torch.cuda.mem_get_info()`` reports; with neither it raises. The
walk leaves out what the CUDA context and the libraries' workspaces
hold (``chip_smoke.py``'s dryrun phase measures them).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --memory-gb 80 [--fit]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --memory-gb 80

``--multipod`` and any mesh of more than one rank are refused (ROADMAP
A13b-5b). A step that raises fails its cell; a failed cell makes the run
exit nonzero.
"""
from __future__ import annotations

import argparse
import json
import traceback
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.configs.shapes import (CARD_BATCH, DEFAULT_MICROBATCH,
                                        SHAPES_BY_NAME, TRAIN_MICROBATCH,
                                        applicable_shapes)
from repro_torch.core.timing import Timer
from repro_torch.launch.cost_walk import CostWalk, device_tensors
from repro_torch.models import lm
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init
from repro_torch.sharding.policy import MULTI_RANK, NULL_POLICY
from repro_torch.train.train_step import (make_decode_step,
                                          make_prefill_step, make_train_step)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def build_step(cfg, shape, batch: int, microbatch: int = 0,
               kv_layout: str = "dense"):
    """(step, args) of one cell: the train, prefill or decode step of
    ``cfg`` and its arguments, abstract on ``meta``; decode on the
    ``kv_layout`` state (``lm.input_specs``)."""
    specs = lm.input_specs(cfg, shape, batch=batch, kv_layout=kv_layout)
    params = lm.abstract_params(cfg)
    if shape.kind == "train":
        step = make_train_step(cfg, microbatch=microbatch)
        return step, (params, adamw_init(params), specs["tokens"])
    if shape.kind == "prefill":
        return make_prefill_step(cfg, NULL_POLICY), (params, specs["tokens"])
    return (make_decode_step(cfg, NULL_POLICY),
            (params, specs["tokens"], specs["state"]))


def walk_step(step: Callable, args) -> dict:
    """Run ``step(*args)`` once under a ``CostWalk``; the walk's record
    with the memory of the reference's ``memory_analysis``: argument,
    output, alias (output storages that are arguments) and peak bytes,
    and the walk's seconds."""
    timer = Timer()
    walk = CostWalk()
    walk.track(args)
    # before the step: AdamW puts a new step counter into its state's dict
    arg_ids = {id(t.untyped_storage()) for t in device_tensors(args)}
    with walk:
        out = step(*args)
    rec = walk.record()
    outs = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in device_tensors(out)}
    rec["memory"] = {
        "argument_bytes": walk.argument_bytes,
        "output_bytes": sum(outs.values()),
        "alias_bytes": sum(n for k, n in outs.items() if k in arg_ids),
        "peak_bytes": walk.peak_bytes,
        "temp_bytes": walk.peak_bytes - walk.argument_bytes,
    }
    rec["walk_s"] = timer.elapsed()
    return rec


def cell_peak(cfg, shape, batch: int, microbatch: int,
              kv_layout: str = "dense") -> int:
    step, args = build_step(cfg, shape, batch, microbatch, kv_layout)
    return walk_step(step, args)["memory"]["peak_bytes"]


def fit_depth(cfg, shape, batch: int, microbatch: int, budget: float,
              peak_of: Optional[Callable] = None,
              kv_layout: str = "dense") -> dict:
    """The deepest depth in [1, cfg.n_layers] whose walked peak is at most
    ``budget`` bytes (0 if one layer does not fit), assuming the peak
    grows with depth. After 1 and 2 layers each probe is the depth the
    line through the two nearest walked peaks reaches the budget at
    (a layer further where that repeats a probe). ``peak_of(depth)``
    replaces the walk (the tests' peaks). Returns {"depth",
    "budget_bytes", "peaks"}."""
    peak_of = peak_of or (lambda n: cell_peak(
        cfg.scaled(n_layers=n), shape, batch, microbatch, kv_layout))
    peaks: Dict[int, int] = {}
    lo, hi = 0, cfg.n_layers + 1    # depth lo fits (0: none), hi does not
    d = 1
    while hi - lo > 1:
        peaks[d] = peak_of(d)
        if peaks[d] <= budget:
            lo = d
        else:
            hi = d
        if lo in peaks and hi in peaks:         # between the two
            d = lo + int((budget - peaks[lo]) * (hi - lo)
                         // (peaks[hi] - peaks[lo]))
        elif lo - 1 in peaks:                   # on from the last two
            d = lo + int((budget - peaks[lo])
                         // max(peaks[lo] - peaks[lo - 1], 1))
        else:
            d = lo + 1
        d = min(max(d, lo + 1), hi - 1)
    return {"depth": lo, "budget_bytes": budget,
            "peaks": {str(k): p for k, p in sorted(peaks.items())}}


def budget_bytes(memory_gb: Optional[float]) -> float:
    """``memory_gb`` GB, or the card's free bytes; never a default."""
    if memory_gb:
        return memory_gb * 1e9
    if torch.cuda.is_available():
        return float(torch.cuda.mem_get_info()[0])
    raise ValueError("dryrun: give --memory-gb, or run beside a CUDA card "
                     "whose free memory is the budget")


def run_cell(arch: str, shape_name: str, batch: Optional[int] = None,
             microbatch: Optional[int] = None, layers: int = 0,
             fit: bool = False, memory_gb: Optional[float] = None,
             tag: str = "", kv_layout: str = "dense") -> dict:
    full = get_config(arch)
    cfg = full.scaled(n_layers=layers) if layers else full
    shape = SHAPES_BY_NAME[shape_name]
    batch = batch or CARD_BATCH[shape_name]
    if shape.kind != "train":
        mb = 0
    elif microbatch is None:
        mb = TRAIN_MICROBATCH.get(arch, DEFAULT_MICROBATCH)
    else:
        mb = microbatch
    if shape.kind == "train" and mb > 1 and batch % mb:
        raise ValueError(f"dryrun: batch {batch} is not a multiple of "
                         f"microbatch {mb}")
    layout = kv_layout if shape.kind == "decode" else None
    step, args = build_step(cfg, shape, batch, mb, kv_layout)
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "tag": tag, "device": "meta", "ranks": 1, "kv_layout": layout,
           "layers": cfg.n_layers, "full_layers": full.n_layers,
           "batch": batch, "seq_len": shape.seq_len, "microbatch": mb,
           "remat": shape.kind == "train", "dtype": cfg.dtype}
    rec.update(walk_step(step, args))
    if memory_gb or fit:
        budget = budget_bytes(memory_gb)
        rec["budget_bytes"] = budget
        rec["fits"] = rec["memory"]["peak_bytes"] <= budget
    if fit:
        rec["fit"] = fit_depth(full, shape, batch, mb, budget,
                               kv_layout=kv_layout)
    return rec


def cell_list(kv_layout: str = "dense"):
    """Every arch x applicable shape; with ``paged``, the decode cells
    of the configs that page pools serve."""
    if kv_layout == "dense":
        return [(arch, s.name) for arch in ARCH_NAMES
                for s in applicable_shapes(arch)]
    return [(arch, s.name) for arch in ARCH_NAMES
            for s in applicable_shapes(arch) if s.kind == "decode"
            and (tf.paged_stack_supported(get_config(arch))
                 or tf.latent_paged_stack_supported(get_config(arch)))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one-card dry run on meta")
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true",
                    help="every arch x applicable shape")
    ap.add_argument("--batch", type=int, default=0,
                    help="rows (default: CARD_BATCH of the shape)")
    ap.add_argument("--microbatch", type=int,
                    help="train: gradient accumulation (default: "
                         "TRAIN_MICROBATCH, else 2)")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (default: the config's)")
    ap.add_argument("--fit", action="store_true",
                    help="also find the deepest depth that fits")
    ap.add_argument("--memory-gb", type=float,
                    help="the budget in GB (default: the card's free "
                         "memory; without a card it must be given)")
    ap.add_argument("--kv-layout", choices=("dense", "paged"),
                    default="dense",
                    help="decode's state: per-slot slabs and carries (the "
                         "reference's) or page pools (plain attention: "
                         "B1; MLA: latent pools)")
    ap.add_argument("--multipod", action="store_true",
                    help="the reference's 2 x 16 x 16 mesh: refused")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.multipod:
        raise NotImplementedError(f"dryrun: the (2, 16, 16) multi-pod mesh "
                                  f"has 512 ranks; the walk runs one rank; "
                                  f"{MULTI_RANK}")
    if args.all:
        cells = cell_list(args.kv_layout)
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    if args.fit or args.memory_gb:
        budget_bytes(args.memory_gb)        # raise before any walk
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch, shape in cells:
        print(f"=== {arch} x {shape} ===", flush=True)
        try:
            rec = run_cell(arch, shape, args.batch or None, args.microbatch,
                           args.layers, args.fit, args.memory_gb, args.tag,
                           args.kv_layout)
        except Exception as e:          # a failed cell fails the run
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
            continue
        fname = out_dir / f"{args.tag}__{arch}__{shape}.json"
        fname.write_text(json.dumps(rec, indent=1))
        m = rec["memory"]
        line = (f"  ok: {rec['layers']} layers, batch {rec['batch']}: "
                f"peak {m['peak_bytes'] / 1e9:.2f} GB (arguments "
                f"{m['argument_bytes'] / 1e9:.2f}), "
                f"{rec['flops'] / 1e12:.2f} TFLOP, "
                f"{rec['hbm_bytes'] / 1e9:.1f} GB moved, walk "
                f"{rec['walk_s']:.1f} s")
        if "fit" in rec:
            line += f"; deepest that fits: {rec['fit']['depth']}"
        print(line, flush=True)
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
