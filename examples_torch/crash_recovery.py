"""Crash-anywhere serving demo on the PyTorch port (the counterpart of
examples/crash_recovery.py).

Three acts on one reference trace:

1. crash+restore the whole engine at EVERY step boundary of the clean
   run — every client stream stays byte-identical;
2. the recovery-policy split: restore-from-snapshot (GBN analog) vs
   replay-from-zero (SR analog), same bytes either way, different cost;
3. persistence: snapshot to disk mid-run through the Checkpointer
   manifest, "restart the process", resume, and finish identically.

  PYTHONPATH=src python examples_torch/crash_recovery.py [--device cpu]

``run(cfg, params, inputs, device)`` plays the three acts on the trace
``inputs`` (``make_inputs``: (arrival time, req_id, prompt, max new
tokens, qos) rows, rebuilt into fresh Requests for every drive) and
returns every count the script prints, with the clean run's streams and
outcomes and each act's crash log.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import SMOKE_CONFIGS
from repro_torch.core.device import resolve_device
from repro_torch.ft import crash_anywhere_sweep, drive
from repro_torch.ft.chaos import build_stack
from repro_torch.models import lm
from repro_torch.serve.api import Request
from repro_torch.serve.loadgen import TraceSpec, make_trace

N_REQUESTS = 6
SPEC = TraceSpec(arrival="bursty", rate=0.4, burst=4.0, seed=11,
                 prompt_lens=((1.0, 8, 24),), output_lens=((1.0, 6, 14),))
ENGINE = dict(slots=3, cache_len=96, kv_layout="paged", n_pages=64,
              page_size=8, decode_span=2, eos_token=-1,
              scheduler="priority", admit_capacity=64)


def model_config():
    return SMOKE_CONFIGS["qwen3-8b"].scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, dtype="float32")


def make_inputs(vocab_size: int) -> list:
    """The trace as plain rows: (t, req_id, prompt, max_new, qos)."""
    return [(t, r.req_id, r.prompt, r.max_new_tokens, r.qos)
            for t, r in make_trace(SPEC, N_REQUESTS, vocab_size)]


def run(cfg, params, inputs: list, device=None) -> dict:
    device = resolve_device(device)

    def trace():
        return [(t, Request(rid, p.copy(), max_new_tokens=n, qos=q))
                for t, rid, p, n, q in inputs]

    # -- act 1: crash at every boundary --------------------------------
    clean, reports = crash_anywhere_sweep(cfg, params, ENGINE, trace,
                                          device=device)
    out = {"clean_steps": clean.steps, "streams": clean.streams,
           "outcomes": clean.outcomes, "boundaries": len(reports),
           "snapshot_bytes": reports[0].snapshot_bytes,
           "sweep_crash_logs": [r.crash_log for r in reports],
           "policies": {}}

    # -- act 2: recovery policies --------------------------------------
    at = max(2, clean.steps // 2)
    for policy, every in (("snapshot", 1), ("replay", 1)):
        r = drive(cfg, params, ENGINE, trace(), crash_at=(at,),
                  snapshot_every=every, policy=(policy,), device=device)
        e = r.crash_log[0]
        assert r.streams == clean.streams
        out["policies"][policy] = {
            "crash_at": at, "restored_from": e["restored_from"],
            "replayed": list(e["replayed"]),
            "extra_steps": r.steps - clean.steps, "crash_log": r.crash_log}

    # -- act 3: persistence through the Checkpointer -------------------
    with tempfile.TemporaryDirectory() as d:
        fe, rebuild = build_stack(cfg, params, ENGINE, device=device)
        # stop as soon as every arrival is in (no drain): mid-run state
        handles = fe.run(trace(), max_steps=500, drain=False)
        saved_at = fe.steps
        fe.engine.save_snapshot(Checkpointer(d), step=fe.steps)
        eng2 = rebuild()                      # "the process restarts"
        eng2.load_snapshot(Checkpointer(d))
        fe.reattach(eng2)
        fe.run(max_steps=500)
        got = {h.req.req_id: tuple(h.streamed) for h in handles}
        assert got == clean.streams, "disk round-trip changed a stream"
        s = eng2.stats
        assert s["host_syncs"] == s["prefills"] + s["decode_spans"]
    out["disk"] = {"saved_at": saved_at, "finished_at": fe.steps,
                   "streams": len(got), "identical": got == clean.streams}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config()
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    out = run(cfg, params, make_inputs(cfg.vocab_size), device)
    print(f"clean run: {out['clean_steps']} steps, "
          f"{len(out['streams'])} streams")
    print(f"crash-anywhere: {out['boundaries']} boundaries swept, "
          f"all streams byte-identical "
          f"(snapshot ~{out['snapshot_bytes']} bytes)")
    for policy, tag in (("snapshot", "GBN analog"), ("replay", "SR analog")):
        p = out["policies"][policy]
        print(f"policy={policy:8s} ({tag}): crash@{p['crash_at']} "
              f"restored_from={p['restored_from']} "
              f"replayed={p['replayed']} "
              f"extra_steps={p['extra_steps']} -> streams identical")
    print(f"disk round-trip at step {out['disk']['finished_at']}: resumed "
          f"engine finished {out['disk']['streams']} streams byte-identical")
    return out


if __name__ == "__main__":
    main()
