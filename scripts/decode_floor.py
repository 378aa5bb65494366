#!/usr/bin/env python3
"""Device time of the decode kernels B3 (WKV-6, rwkv6-1.6b: B 4, H 32, hd
64) and B5 (Mamba SSM step, jamba-v0.1-52b: B 4, Di 8192, N 16) beside a
PyTorch elementwise pass that moves the same state bytes: the time a plain
streaming kernel takes for that traffic on this card.

    PYTHONPATH=src python3 scripts/decode_floor.py

Each function runs 40 times under torch.profiler with the L2 emptied
before every call, once by writing a 256 MB buffer (the cache is left full
of dirty lines, which the call's misses must write back) and once by
reading it (clean lines). Prints one JSON line per (function, flush): the
device µs a call (profiler mean); then the card's name and power limit.
Needs a CUDA card.
"""
import json
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import ssm_decode as sd
from repro_torch.kernels import wkv6 as wk

CALLS = 40


def device_us(fn, flush, is_kernel):
    """Mean device µs a call of the kernel whose name ``is_kernel``
    accepts, each call after ``flush``."""
    for _ in range(3):
        flush()
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            flush()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if is_kernel(e.key) and e.count == CALLS]
    if len(rows) != 1:
        raise RuntimeError(f"not one kernel: {[e.key for e in rows]}")
    return rows[0].self_device_time_total / CALLS


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_floor: no CUDA device", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r, k, v = (rnd(4, 32, 64) for _ in range(3))
    w = torch.exp(-torch.exp(torch.clamp(rnd(4, 32, 64), -8, 0.5)))
    u, s = rnd(32, 64) * 0.1, rnd(4, 32, 64, 64) * 0.1
    h, dtx, Bs, Cs = rnd(4, 8192, 16), rnd(4, 8192), rnd(4, 16), rnd(4, 16)
    dA = torch.rand(4, 8192, 16, generator=g, device="cuda") * 0.5 + 0.5
    s_out, h_out = torch.empty_like(s), torch.empty_like(h)
    buf = torch.zeros(64 << 20, device="cuda")  # fp32: sum() only reads
    flushes = {"write": buf.zero_, "read": buf.sum}

    def named(part):
        return lambda key: part in key

    def mul(key):
        return "MulFunctor" in key

    cases = (
        ("wkv6_decode (B3)", named("wkv6_decode_kernel"),
         lambda: wk.wkv6_decode(r, k, v, w, u, s)),
        ("torch.mul, B3's state bytes", mul,
         lambda: torch.mul(s, 0.5, out=s_out)),
        ("ssm_decode_step (B5)", named("ssm_decode_kernel"),
         lambda: sd.ssm_decode_step(h, dA, dtx, Bs, Cs)),
        ("torch.mul, B5's state bytes", mul,
         lambda: torch.mul(dA, h, out=h_out)))
    for flush_name, flush in flushes.items():
        for what, is_kernel, fn in cases:
            print(json.dumps({"function": what, "l2_flush": flush_name,
                              "device_us": device_us(fn, flush,
                                                     is_kernel)}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
