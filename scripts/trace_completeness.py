#!/usr/bin/env python3
"""Does torch.profiler see every kernel the port launches? Traced in one
profiler session after another, as chip_smoke.py serves them:

- moonshot-v1-16b-a3b (48 layers, full width, 56.7 GB of bf16 weights) on
  the paged engine, its 1900-token prefill (and, every eighth session, one
  decode span);
- rwkv6-1.6b (24 layers, full width) on the recurrent engine, a decode
  span (8 steps of 4 slots: the window in which a trace once held 178 of
  its 192 ``wkv6_decode`` kernels) and its 1531-token prefill in turns.

    PYTHONPATH=src python3 scripts/trace_completeness.py \\
        [--arch moonshot-v1-16b-a3b|rwkv6-1.6b] [--sessions N]

With moonshot, odd sessions trace the work alone and match each CUDA
runtime launch to its kernel record by CUPTI correlation id: how many
records are missing, whether they are the session's first launches, and
the CPU ops of the first few; even sessions trace it as chip_smoke.py does
(``_profile``: PAD_LAUNCHES empty kernels ahead of the work). With rwkv6
every session traces as chip_smoke.py does. Every ``_profile`` session is
read twice: as ``_traced`` reads it (how many of the empty kernels were
lost, and whether every port kernel the wrappers launched shows), and
record by record over the ``chip_smoke.work`` window, each CUDA runtime
launch in the window matched to its kernel record by correlation id:
launches with no record (their index and time in the window, the CPU op
around them), records that start before the window on the host's clock,
each launch's latency to its record's start, the window's records counted
by correlation, by the earlier host-clock reading of chip_smoke.py (from
the annotation's earliest start) and by its device-clock one (from the
last empty kernel's end), and port kernels' records with no launch. One JSON line per session, a summary, then the
card's name and power limit. Needs a CUDA card.
"""
import argparse
import gc
import subprocess
import sys
from collections import Counter
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
ENGINES = {
    "moonshot-v1-16b-a3b": dict(cache_len=2048, n_pages=640,
                                kv_layout="paged"),
    "rwkv6-1.6b": dict(cache_len=2048, n_pages=4, kv_layout="recurrent")}


def _is_kernel(e):
    return (e.device_type() != DeviceType.CPU and e.name() != cs.WORK
            and not e.name().startswith(("Memcpy", "Memset")))


def _inner_op(ops, t):
    """The innermost CPU op running at host time ``t`` (ns), or None."""
    encl = [o for o in ops if o.start_ns() <= t <= o.end_ns()]
    inner = min(encl, key=lambda o: o.duration_ns(), default=None)
    return inner.name() if inner is not None else None


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
    return {"launches": len(launches), "lost": len(lost),
            "lost_are_the_first": lost == list(range(len(lost))),
            "first_lost_ops": [_inner_op(ops, launches[i].start_ns())
                               for i in lost[:8]]}


def window(prof):
    """Every CUDA runtime launch in the ``chip_smoke.work`` window matched
    to its kernel record by correlation id (records anywhere in the
    session); each launch's latency to its record's start, host clock to
    device clock (a negative one is the clocks' misalignment); and the
    window's kernel records counted three ways: by a launch in the window,
    from the annotation's earliest start (host or device record:
    ``_profile``'s earlier reading) and from the last empty kernel's end
    (device clock: its reading now), all kernels and the port's."""
    events = prof.profiler.kineto_results.events()
    work = [e for e in events if e.name() == cs.WORK]
    host = [e for e in work if e.device_type() == DeviceType.CPU]
    w0, w1 = host[0].start_ns(), host[0].end_ns()
    old0 = min(e.start_ns() for e in work)
    kernels = {e.correlation_id(): e for e in events if _is_kernel(e)}
    pads = [k for k in kernels.values() if "spin_kernel" in k.name()]
    dev0 = max(k.end_ns() for k in pads)
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    all_launches = {e.correlation_id() for e in cpu
                    if e.name() in LAUNCH_APIS}
    ops = [e for e in cpu if e.name() not in LAUNCH_APIS
           and not e.name().startswith("cuda") and e.name() != cs.WORK]
    launches = sorted((e for e in cpu if e.name() in LAUNCH_APIS
                       and w0 <= e.start_ns() <= w1),
                      key=lambda e: e.start_ns())
    n = len(launches)
    lost, early, lat = [], [], []
    for i, e in enumerate(launches):
        k = kernels.get(e.correlation_id())
        if k is None:
            lost.append({"index": i, "of": n,
                         "us_into_window": (e.start_ns() - w0) / 1e3,
                         "us_before_end": (w1 - e.start_ns()) / 1e3,
                         "op": _inner_op(ops, e.start_ns())})
            continue
        lat.append((k.start_ns() - e.start_ns()) / 1e3)
        if k.start_ns() < w0:
            early.append({"index": i, "kernel": k.name()[:60],
                          "us_before_host_start": (w0 - k.start_ns()) / 1e3,
                          "us_before_old_start": (old0 - k.start_ns()) / 1e3,
                          "launch_to_start_us": lat[-1]})
    in_window = {e.correlation_id() for e in launches}
    counts = {w: Counter() for w in ("correlation", "old_start",
                                     "device_start")}
    orphans = Counter()
    for corr, k in kernels.items():
        if "spin_kernel" in k.name():
            continue
        name = cs._kernel_name(k.name()) or "other"
        for way, ok in (("correlation", corr in in_window),
                        ("old_start", k.start_ns() >= old0),
                        ("device_start", k.start_ns() >= dev0)):
            if ok:
                counts[way][name] += 1
                counts[way]["all"] += 1
        if corr not in all_launches and name != "other":
            orphans[name] += 1
    return {"window_launches": n, "lost": len(lost), "lost_at": lost[:32],
            "records_before_host_start": len(early), "early": early[:8],
            "launch_to_start_us_min": min(lat, default=None),
            "negative_latencies": sum(x < 0 for x in lat),
            "device_annotation": len(work) > len(host),
            "old_start_us_before_host_start": (w0 - old0) / 1e3,
            "device_start_us_before_host_start": (w0 - dev0) / 1e3,
            "counts": {w: dict(c) for w, c in counts.items()},
            "port_records_without_launch": dict(orphans)}


def padded(fn):
    """Trace ``fn`` as chip_smoke.py does, and read the window both ways."""
    win = cs._profile(torch, "cuda", fn)
    rec = {"pad_lost": win["pad_dropped"], "calls": win["calls"],
           **window(win["prof"])}
    try:
        traced = cs._traced(torch, win)
        rec.update(complete=True, port_kernels={
            k: v["launches"] for k, v in traced["port_kernels"].items()})
    except cs.Check as e:
        rec.update(complete=False, check=str(e))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=tuple(ENGINES),
                    default="moonshot-v1-16b-a3b")
    ap.add_argument("--sessions", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_completeness: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in cs.PROMPT_LENS]
    ecfg = EngineConfig(slots=4, page_size=16, decode_span=8, eos_token=-1,
                        prefill_chunk=0, prefix_cache_entries=0,
                        **ENGINES[args.arch])
    rwkv = args.arch == "rwkv6-1.6b"
    run = {}

    def engine():
        run.pop("eng", None)
        gc.collect()
        eng = run["eng"] = ServingEngine(cfg, params, ecfg, device="cuda")
        return eng

    def prefill():
        eng = engine()
        prompt = prompts[cs.PROMPT_LENS.index(1531)] if rwkv else prompts[-1]
        eng.submit(Request(0, prompt.copy(), max_new_tokens=1 << 20))
        return eng._admit

    def decode():
        eng = engine()
        for i, p in enumerate(prompts[:ecfg.slots]):
            eng.submit(Request(i, p.copy(), max_new_tokens=1 << 20))
        eng.step()
        return eng.step

    summary = {"arch": args.arch, "bare_lost": [], "pad_lost": [],
               "window_lost": [], "records_before_host_start": [],
               "negative_latencies": [], "old_reading_short": [],
               "padded_incomplete": 0}
    for i in range(args.sessions):
        if rwkv:
            what, make = (("decode", decode) if i % 2 == 0
                          else ("prefill", prefill))
            pad = True
        else:
            what, make = (("decode", decode) if i % 8 >= 6
                          else ("prefill", prefill))
            pad = i % 2 == 1
        if pad:
            rec = padded(make())
            summary["pad_lost"].append(rec["pad_lost"])
            summary["window_lost"].append(rec["lost"])
            summary["records_before_host_start"].append(
                rec["records_before_host_start"])
            summary["negative_latencies"].append(rec["negative_latencies"])
            c = rec["counts"]
            summary["old_reading_short"].append(
                c["correlation"].get("all", 0) - c["old_start"].get("all", 0))
            summary["padded_incomplete"] += not rec["complete"]
        else:
            rec = bare(make())
            summary["bare_lost"].append(rec["lost"])
        cs.emit({"session": i + 1, "what": what, "pad": pad, **rec})
    cs.emit(summary)
    print(subprocess.run(cs.SMI_QUERY, capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
