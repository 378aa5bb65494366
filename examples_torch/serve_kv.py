"""Serving example on the PyTorch port (the counterpart of
examples/serve_kv.py): continuous batching + paged KV accounting +
prefix cache + VoQ parking under page pressure, with subsystems picked
by name through the pluggable API.

  PYTHONPATH=src python examples_torch/serve_kv.py
  PYTHONPATH=src python examples_torch/serve_kv.py --scheduler priority
  PYTHONPATH=src python examples_torch/serve_kv.py --device cpu

``run(cfg, params, inputs, device, **options)`` serves the ten requests
of ``make_inputs`` (half of them share a 24-token prompt; odd ids take
QoS class 1) on the reference's engine settings and returns what the
script prints, with every request's stream. Wall time is taken after a
synchronize.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import SMOKE_CONFIGS
from repro_torch.core.device import resolve_device
from repro_torch.core.timing import Timer
from repro_torch.models import lm
from repro_torch.serve.api import (EngineConfig, Request, SamplingParams,
                                   make_engine)

N_REQUESTS = 10
MAX_NEW = 10


def make_inputs(vocab_size: int) -> list:
    """The ten prompts, drawn as the reference draws them: even ids the
    shared 24-token prompt, odd ids 8-39 tokens of their own."""
    rng = np.random.default_rng(0)
    base = rng.integers(1, vocab_size, size=24).astype(np.int32)
    return [base if i % 2 == 0 else rng.integers(
        1, vocab_size, size=int(rng.integers(8, 40))).astype(np.int32)
        for i in range(N_REQUESTS)]


def engine_config(kv_layout="paged", scheduler="fcfs", prefill_chunk=16,
                  decode_span=8, sampler="greedy") -> EngineConfig:
    """The paged layout keeps KV in a shared page pool behind per-slot
    page tables; the deliberately tight page budget exercises
    alloc-on-append growth, VoQ parking/eviction, and (with chunking)
    streamed prefill + refcounted prefix sharing."""
    return EngineConfig(
        slots=4, cache_len=128, n_pages=28, page_size=8, eos_token=-1,
        kv_layout=kv_layout, scheduler=scheduler, qos_classes=2,
        prefill_chunk=prefill_chunk, decode_span=decode_span,
        sampler=sampler)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, params, inputs: list, device=None, *, scheduler="fcfs",
        kv_layout="paged", prefill_chunk=16, decode_span=8,
        temperature=0.0, top_k=0, top_p=1.0, seed=0) -> dict:
    device = resolve_device(device)
    sampler = "stochastic" if temperature > 0 else "greedy"
    eng = make_engine(cfg, params, engine_config(
        kv_layout, scheduler, prefill_chunk, decode_span, sampler),
        device=device)
    sp = SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p,
                        seed=seed)
    for i, p in enumerate(inputs):
        eng.submit(Request(i, p.copy(), max_new_tokens=MAX_NEW, qos=i % 2,
                           sampling=sp))
    _sync(device)
    t = Timer()
    done = eng.run_until_done()
    _sync(device)
    dt = t.elapsed()
    same = {tuple(r.tokens_out) for r in done if r.req_id % 2 == 0}
    # greedy: shared prompts decode identically; stochastic: streams are
    # keyed by (seed, req_id), so sharers diverge by design
    return {"completed": len(done), "requests": len(inputs), "seconds": dt,
            "kv_layout": kv_layout, "scheduler": scheduler,
            "sampler": sampler,
            "decode_tokens_per_s": eng.stats["decode_tokens"] / dt,
            "stats": dict(eng.stats), "prefix_hit_rate": eng.prefix.hit_rate,
            "order": [(r.req_id, r.qos) for r in done],
            "shared_identical": len(same) == 1,
            "streams": {r.req_id: list(r.tokens_out) for r in done}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="fcfs",
                    help="fcfs | priority | round_robin")
    ap.add_argument("--kv-layout", choices=("dense", "paged"),
                    default="paged")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="page-aligned chunked-prefill width "
                         "(0 = monolithic)")
    ap.add_argument("--decode-span", type=int, default=8,
                    help="decode steps between host syncs (1 = per-step "
                         "decode)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax; > 0 "
                         "selects the stochastic sampler)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed; streams replay from "
                         "(seed, req_id)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    out = run(cfg, params, make_inputs(cfg.vocab_size), device,
              scheduler=args.scheduler, kv_layout=args.kv_layout,
              prefill_chunk=args.prefill_chunk, decode_span=args.decode_span,
              temperature=args.temperature, top_k=args.top_k,
              top_p=args.top_p, seed=args.seed)
    print(f"completed {out['completed']}/{out['requests']} in "
          f"{out['seconds']:.1f}s  [{args.kv_layout} kv, {args.scheduler} "
          f"scheduler, {device.type}]")
    print(f"decode tokens/s: {out['decode_tokens_per_s']:.1f}")
    print("engine stats:", out["stats"])
    print(f"prefix-cache hit rate: {out['prefix_hit_rate']:.2f}  "
          f"(tokens reused: {out['stats']['prefix_tokens_reused']})")
    print("completion order (req_id:qos):",
          " ".join(f"{i}:{q}" for i, q in out["order"]))
    print("shared-prompt outputs identical:", out["shared_identical"],
          f"(sampler: {out['sampler']})")
    return out


if __name__ == "__main__":
    main()
