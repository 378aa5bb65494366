#!/usr/bin/env python3
"""Parent against change on rwkv6-1.6b's training path, one checkout at a
time, so that one chip call can run parent, change, change, parent.

    python3 scripts/rwkv6_ab.py kernels TREE OUT  # B4/B3 outputs -> OUT,
                                                  # B4-bwd ms and error
    python3 scripts/rwkv6_ab.py train TREE        # the train step's seconds
    python3 scripts/rwkv6_ab.py same OUT OUT...   # outputs equal bit for bit

TREE is the root of a checkout (the parent's unpacked from ``git archive``
into a directory ``.gitignore`` lists, or ``.``); its ``src`` is imported,
and it builds its own kernels under its own ``build/``. ``kernels`` saves
B4's outputs at 12 (shape, dtype) points and B3's at one into OUT
(``torch.save``), and prints B4-bwd's CUDA-event median ms (L2 flushed, a
spin ahead of each call, as chip_smoke.py times), its workspace peak and
each gradient's error against the plain version in float64 at rwkv6's H 32,
hd 64, S 1531 and 4096, bf16 r/k/v. ``train`` runs
``repro_torch.launch.train`` with the smoke's arguments (24 layers, seq
4096, batch 2 in 2 microbatches, bf16, remat) for 7 steps in a fresh
process and prints each step's seconds, the median of steps 1-6 and the
peak memory. ``same`` compares the first OUT's tensors with the others'.
Needs a CUDA card; prints JSON lines.
"""
import json
import statistics
import sys
import time
from pathlib import Path

import torch

SPIN_CYCLES = 100_000
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")


def _import_wkv6(tree):
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import wkv6
    return wkv6


def _inputs(seed, B, S, H, hd, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (rnd(B, S, H, hd).to(dtype) for _ in range(3))
    logw = -torch.exp(torch.clamp(rnd(B, S, H, hd), -8, 0.5))
    return r, k, v, logw, rnd(H, hd) * 0.1, rnd(B, H, hd, hd) * 0.1


def _time_ms(fn, n=20):
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernels(tree, out):
    wk = _import_wkv6(tree)
    t0 = time.time()
    wk._lib()
    wk._bwd_lib()
    res = {"tree": str(tree), "build_s": time.time() - t0}
    bits = {}
    for B, S, H, hd, C in ((2, 1, 2, 64, 32), (2, 33, 2, 6, 32),
                           (1, 1531, 32, 64, 32), (2, 300, 2, 128, 16),
                           (2, 70, 2, 8, 1), (1, 200, 32, 64, 32)):
        for dt in (torch.float32, torch.bfloat16):
            y, s = wk.wkv6_chunked(*_inputs(S + hd, B, S, H, hd, dt), chunk=C)
            bits[f"{B},{S},{H},{hd},{C},{dt}"] = (y.cpu(), s.cpu())
    g = torch.Generator(device="cuda").manual_seed(3)
    r = torch.randn(4, 32, 64, generator=g, device="cuda")
    bits["decode"] = tuple(t.cpu() for t in wk.wkv6_decode(
        r, r * 0.5, r * 0.25, torch.rand(4, 32, 64, generator=g, device="cuda"),
        torch.randn(32, 64, generator=g, device="cuda"),
        torch.randn(4, 32, 64, 64, generator=g, device="cuda")))
    torch.save(bits, out)
    for S in (1531, 4096):
        ins = _inputs(0, 1, S, 32, 64, torch.bfloat16)
        g = torch.Generator(device="cuda").manual_seed(1)
        dy = torch.randn(1, S, 32, 64, generator=g, device="cuda")
        ds = torch.randn(1, 32, 64, 64, generator=g, device="cuda")
        args = (*ins, dy, ds)
        ms = _time_ms(lambda: wk.wkv6_chunked_bwd(*args))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = wk.wkv6_chunked_bwd(*args)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        ref = wk.wkv6_chunked_bwd_plain(*(t.double() for t in args))
        errs = {n: float((a.double() - b).abs().max() / b.abs().max())
                for n, a, b in zip(NAMES, got, ref)}
        res[f"bwd_S{S}"] = {"ms": ms, "call_peak_mb": peak,
                            "err_vs_plain_f64": errs}
    print(json.dumps(res), flush=True)


def train(tree):
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.launch import train as launcher
    out = launcher.main(["--arch", "rwkv6-1.6b", "--layers", "24", "--seq",
                         "4096", "--batch", "2", "--microbatch", "2",
                         "--steps", "7", "--ckpt-dir",
                         str(tree / "build" / "ab_ckpt")])
    secs = [r["seconds"] for r in out["steps"]]
    print(json.dumps({"tree": str(tree), "steps_s": secs,
                      "median_steps_1_6": statistics.median(secs[1:]),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)


def same(outs):
    ref = torch.load(outs[0])
    for out in outs[1:]:
        got = torch.load(out)
        equal = set(got) == set(ref) and all(
            torch.equal(a, b) for k in ref for a, b in zip(got[k], ref[k]))
        print(json.dumps({"a": outs[0], "b": out, "bit_equal": equal}))


def main(argv):
    if not torch.cuda.is_available():
        print("rwkv6_ab: no CUDA device", file=sys.stderr)
        return 2
    what, args = argv[0], argv[1:]
    if what == "kernels":
        kernels(Path(args[0]).resolve(), args[1])
    elif what == "train":
        train(Path(args[0]).resolve())
    elif what == "same":
        same(args)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
