"""Live-traffic serving demo on the PyTorch port (the counterpart of
examples/serve_live.py): the front end on top of the serve_kv.py engine,
a bursty arrival trace replayed on a virtual clock, tokens streaming out
per request as each span syncs, and a deliberately tiny wait pool so
SLO-graded admission visibly sheds the best-effort class while premium
traffic rides through.

  PYTHONPATH=src python examples_torch/serve_live.py [--device cpu]

``run(cfg, params, inputs, device, on_token=None)`` replays the trace
``inputs`` (``make_inputs``: (arrival time, req_id, prompt, max new
tokens, qos) rows) and returns every arrival's outcome, stream, TTFT and
the shed list; ``on_token(clock, req, index, token)`` sees each token as
it streams.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import SMOKE_CONFIGS
from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.api import (EngineConfig, Request, make_engine,
                                   make_frontend)
from repro_torch.serve.frontend import VirtualClock
from repro_torch.serve.loadgen import TraceSpec, make_trace

N_ARRIVALS = 14
SPEC = TraceSpec(arrival="bursty", rate=3.0, burst=8.0, seed=2,
                 prompt_lens=((1.0, 8, 24),), output_lens=((1.0, 6, 12),),
                 qos_weights=(1.0, 3.0))    # 0 = premium, 1 = best-effort


def make_inputs(vocab_size: int) -> list:
    """The trace as plain rows: (t, req_id, prompt, max_new, qos)."""
    return [(t, r.req_id, r.prompt, r.max_new_tokens, r.qos)
            for t, r in make_trace(SPEC, N_ARRIVALS, vocab_size)]


def run(cfg, params, inputs: list, device=None, on_token=None) -> dict:
    device = resolve_device(device)
    eng = make_engine(cfg, params, EngineConfig(
        slots=2, cache_len=128, n_pages=64, page_size=8, eos_token=-1,
        kv_layout="paged", scheduler="priority", qos_classes=2,
        decode_span=2, admit_capacity=4, slo_ttft=(0.0, 12.0),
        clock=VirtualClock()), device=device)
    fe = make_frontend("local", eng, step_dt=1.0)
    trace = []
    for t, rid, prompt, max_new, qos in inputs:
        r = Request(rid, prompt.copy(), max_new_tokens=max_new, qos=qos)
        cb = None if on_token is None else (
            lambda tok, idx, r=r: on_token(fe.clock(), r, idx, tok))
        trace.append((t, r, cb))
    handles = fe.run(trace)
    assert all(h.streamed == h.req.tokens_out for h in handles if h.ok)
    return {"arrivals": len(handles), "steps": fe.steps,
            "handles": [{"req_id": h.req.req_id, "qos": h.req.qos,
                         "outcome": h.outcome, "reason": h.reason,
                         "streamed": list(h.streamed), "ttft": h.ttft}
                        for h in handles],
            "shed": [h.req.req_id for h in handles
                     if h.outcome != "completed"],
            "premium_all_completed": all(h.ok for h in handles
                                         if h.req.qos == 0),
            "frontend_stats": dict(fe.stats), "engine_stats": dict(eng.stats)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    out = run(cfg, params, make_inputs(cfg.vocab_size), device,
              on_token=lambda now, r, idx, tok: print(
                  f"  t={now:5.1f}  req {r.req_id} (qos {r.qos}) "
                  f"token[{idx}] = {tok}"))
    print(f"\n{out['arrivals']} arrivals over {out['steps']} virtual steps")
    for h in out["handles"]:
        tail = (f"{len(h['streamed'])} tokens, ttft {h['ttft']:.1f}"
                if h["outcome"] == "completed" else h["reason"])
        print(f"req {h['req_id']} qos {h['qos']}: {h['outcome']} ({tail})")
    best_effort = all(h["qos"] == 1 for h in out["handles"]
                      if h["outcome"] != "completed")
    print(f"\nshed/rejected: {len(out['shed'])} — every one best-effort: "
          f"{best_effort}, every one told explicitly; premium all "
          f"completed:", out["premium_all_completed"])
    return out


if __name__ == "__main__":
    main()
