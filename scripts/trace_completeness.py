#!/usr/bin/env python3
"""Does torch.profiler see every kernel the port launches? moonshot-v1-16b-
a3b (48 layers, full width, 56.7 GB of bf16 weights) on the paged engine,
as chip_smoke.py serves it, with its 1900-token prefill (and, every
eighth session, one decode span) traced in one profiler session after
another.

    PYTHONPATH=src python3 scripts/trace_completeness.py [--sessions N]

Odd sessions trace the work alone and match each CUDA runtime launch to
its kernel record by CUPTI correlation id: how many records are missing,
whether they are the session's first launches, and the CPU ops of the
first few. Even sessions trace it as chip_smoke.py does (``_profile``:
PAD_LAUNCHES empty kernels ahead of the work): how many of the empty
kernels were lost, and whether every port kernel the wrappers launched
shows (``_traced``'s check). One JSON line per session, a summary, then
the card's name and power limit. Needs a CUDA card.
"""
import argparse
import gc
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.api import EngineConfig, Request  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")


def bare(fn):
    """Trace ``fn`` alone; match launches to kernel records."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launches, kernels, ops = [], set(), []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name() in LAUNCH_APIS:
                launches.append(e)
            elif not e.name().startswith("cuda"):
                ops.append(e)
        elif not e.name().startswith(("Memcpy", "Memset")):
            kernels.add(e.correlation_id())
    launches.sort(key=lambda e: e.start_ns())
    lost = [i for i, e in enumerate(launches)
            if e.correlation_id() not in kernels]
    first = []
    for i in lost[:8]:
        start = launches[i].start_ns()
        encl = [o for o in ops if o.start_ns() <= start <= o.end_ns()]
        inner = min(encl, key=lambda o: o.duration_ns(), default=None)
        first.append(inner.name() if inner is not None else None)
    return {"launches": len(launches), "lost": len(lost),
            "lost_are_the_first": lost == list(range(len(lost))),
            "first_lost_ops": first}


def padded(fn):
    """Trace ``fn`` as chip_smoke.py does."""
    win = cs._profile(torch, "cuda", fn)
    try:
        rec = cs._traced(torch, win)
        return {"pad_lost": win["pad_dropped"], "complete": True,
                "port_kernels": {k: v["launches"]
                                 for k, v in rec["port_kernels"].items()},
                "calls": win["calls"]}
    except cs.Check as e:
        return {"pad_lost": win["pad_dropped"], "complete": False,
                "check": str(e), "calls": win["calls"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_completeness: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    cfg = get_config("moonshot-v1-16b-a3b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in cs.PROMPT_LENS]
    ecfg = EngineConfig(slots=4, cache_len=2048, page_size=16, n_pages=640,
                        decode_span=8, eos_token=-1, kv_layout="paged",
                        prefill_chunk=0, prefix_cache_entries=0)
    run = {}

    def engine():
        run.pop("eng", None)
        gc.collect()
        eng = run["eng"] = ServingEngine(cfg, params, ecfg, device="cuda")
        return eng

    def prefill():
        eng = engine()
        eng.submit(Request(0, prompts[-1].copy(), max_new_tokens=1 << 20))
        return eng._admit

    def decode():
        eng = engine()
        for i, p in enumerate(prompts[:ecfg.slots]):
            eng.submit(Request(i, p.copy(), max_new_tokens=1 << 20))
        eng.step()
        return eng.step

    summary = {"bare_lost": [], "pad_lost": [], "padded_incomplete": 0}
    for i in range(args.sessions):
        what, make = ("decode", decode) if i % 8 >= 6 else ("prefill",
                                                            prefill)
        if i % 2 == 0:
            rec = bare(make())
            summary["bare_lost"].append(rec["lost"])
        else:
            rec = padded(make())
            summary["pad_lost"].append(rec["pad_lost"])
            summary["padded_incomplete"] += not rec["complete"]
        cs.emit({"session": i + 1, "what": what,
                 "pad": i % 2 == 1, **rec})
    cs.emit(summary)
    print(subprocess.run(cs.SMI_QUERY, capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
