"""Serving launcher of the port, batch mode: submit every request up front
and serve them to completion through the serving engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 8 --cache-len 2048 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --kv-layout recurrent
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --kv-layout dense --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
      --prefill-chunk 64 --smoke --device cpu

runs on the first CUDA card with random weights; ``--smoke`` takes the
reduced config and ``--device cpu`` the plain PyTorch path. The flags
match ``repro.launch.serve`` for what the port serves: the dense layout
(every ported config, the default, as in the reference), the paged
layout (plain attention) and the recurrent layout (RWKV), greedy
sampling, monolithic or chunked prefill and the block prefix cache (the
engine's default 32 entries; plain attention stacks on dense and paged).
Live-traffic mode, the latent layout, the other samplers and crash
snapshots wait for their slices (ROADMAP queue A). The full jamba-v0.1-52b needs 103 GB of bf16
weights, more than one 80 GB card holds.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.timing import Timer
from repro_torch.models import lm
from repro_torch.serve.api import EngineConfig, Request, default_page_budget
from repro_torch.serve.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=160)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-layout", choices=("dense", "paged", "recurrent"),
                    default="dense",
                    help="StateBackend name: dense serves every config; "
                         "paged needs plain attention; recurrent needs "
                         "pure RWKV (rwkv6-1.6b)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="device page budget; 0 derives it from "
                         "slots/cache-len/page-size")
    ap.add_argument("--scheduler", default="fcfs",
                    help="Scheduler name (fcfs | priority | round_robin)")
    ap.add_argument("--qos-classes", type=int, default=2,
                    help="QoS classes; requests get class i %% N")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="stream prompts in page-aligned chunks of this "
                         "many tokens, interleaved with decode steps "
                         "(0 = monolithic prefill)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prefill tokens ingested per engine step "
                         "(0 derives it from --prefill-chunk)")
    ap.add_argument("--decode-span", type=int, default=8,
                    help="decode steps between host syncs (1 = per step)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=device)
    n_pages = args.n_pages or default_page_budget(
        args.slots, args.cache_len, args.page_size)
    ecfg = EngineConfig(
        slots=args.slots, cache_len=args.cache_len, n_pages=n_pages,
        page_size=args.page_size, kv_layout=args.kv_layout,
        scheduler=args.scheduler, qos_classes=args.qos_classes,
        eos_token=-1, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, decode_span=args.decode_span)
    eng = ServingEngine(cfg, params, ecfg, device=device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        n = int(rng.integers(8, 48))
        eng.submit(Request(i, rng.integers(1, cfg.vocab_size, size=n)
                           .astype(np.int32), max_new_tokens=args.max_new,
                           qos=i % args.qos_classes))
    timer = Timer()
    done = eng.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = timer.elapsed()
    print(f"completed {len(done)}/{args.requests} in {dt:.1f}s  "
          f"({eng.stats['decode_tokens'] / dt:.1f} decode tok/s, "
          f"{eng.stats['host_syncs']} host syncs)  "
          f"[{args.kv_layout} kv, {args.scheduler} scheduler, greedy "
          f"sampler, {n_pages} pages, prefill chunk {args.prefill_chunk}, "
          f"span {args.decode_span}, {device}]")
    print("completion order (req_id:qos):",
          " ".join(f"{r.req_id}:{r.qos}" for r in done))
    print("stats:", eng.stats)


if __name__ == "__main__":
    main()
