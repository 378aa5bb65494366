"""Serving launcher of the port. Batch mode submits every request up
front and serves them to completion through the serving engine; with
``--arrival-rate`` the launcher replays a Poisson or bursty timed trace
through the front end instead (live mode), on a virtual clock (one
engine step = ``--step-dt`` time units; ``--real-time`` takes the wall
clock), with per-token streaming and SLO-graded admission, and reports
each QoS class.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 8 --cache-len 2048 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --kv-layout recurrent
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --kv-layout dense --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --kv-layout latent --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
      --prefill-chunk 64 --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
      --temperature 0.8 --top-k 40 --top-p 0.95 --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
      --arrival bursty --arrival-rate 2.0 --admit-capacity 8 \
      --slo-ttft 0 30 --slo-tpot 0 8 --scheduler priority --smoke \
      --device cpu

runs on the first CUDA card with random weights; ``--smoke`` takes the
reduced config and ``--device cpu`` the plain PyTorch path. The flags
match ``repro.launch.serve`` for what the port serves: the dense layout
(every config, the default, as in the reference), the paged layout
(plain attention), the latent layout (MLA) and the recurrent layout
(RWKV), greedy and
stochastic sampling (a temperature above 0 picks ``stochastic``),
monolithic or chunked prefill, the block prefix cache (the engine's
default 32 entries; plain attention stacks on dense and paged), live
mode and crash snapshots: ``--snapshot-dir D --snapshot-every N``
persists the engine every N steps (and once at the end), ``--resume``
restores the latest snapshot from D before serving:

  PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
      --arrival-rate 0.3 --snapshot-dir snaps --snapshot-every 4 \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
      --arrival-rate 0.3 --snapshot-dir snaps --resume --smoke \
      --device cpu

The full jamba-v0.1-52b needs 103 GB of bf16 weights, more than one
80 GB card holds.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.timing import DEFAULT_CLOCK, Timer
from repro_torch.models import lm
from repro_torch.serve.api import (EngineConfig, Request, SamplingParams,
                                   default_page_budget, make_engine,
                                   make_frontend)
from repro_torch.serve.frontend import VirtualClock
from repro_torch.serve.loadgen import TraceSpec, make_trace


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else float("nan")


class _SnapshotHook:
    """Persist the engine every N front-end steps (async writes; the
    Checkpointer serializes them). Carries `.engine`, so a front end's
    reattach after crash recovery rebinds it."""

    def __init__(self, engine, ckpt, every: int):
        self.engine = engine
        self.ckpt = ckpt
        self.every = int(every)

    def __call__(self, step: int) -> None:
        if self.every > 0 and step and step % self.every == 0:
            self.engine.save_snapshot(self.ckpt, step, blocking=False)


def _make_ckpt(args):
    if not args.snapshot_dir:
        if args.resume or args.snapshot_every:
            raise SystemExit("--resume/--snapshot-every need "
                             "--snapshot-dir")
        return None
    from repro_torch.checkpoint import Checkpointer
    return Checkpointer(args.snapshot_dir)


def _maybe_resume(eng, ckpt, args) -> int:
    """Restore the latest persisted snapshot; returns the next free
    req_id so newly submitted requests never collide with restored
    ones."""
    if not args.resume:
        return 0
    from repro_torch.checkpoint import latest_step
    if latest_step(args.snapshot_dir) is None:
        print(f"# no snapshot in {args.snapshot_dir}; starting fresh")
        return 0
    snap = eng.load_snapshot(ckpt)
    live = eng.live_requests()
    done_ids = [r.req_id for r in eng.completed]
    print(f"# resumed from step {ckpt.last_saved_step or 'latest'}: "
          f"{len(live)} live + {len(done_ids)} completed requests "
          f"(snapshot t={snap['clock_t']:.1f})")
    return max([*live, *done_ids], default=-1) + 1


def _run_live(cfg, params, ecfg, sp, args, device):
    """Live mode: timed trace -> front end -> per-class report."""
    eng = make_engine(cfg, params, ecfg, device=device)
    fe = make_frontend(ecfg.frontend, eng,
                       step_dt=0.0 if args.real_time else args.step_dt)
    ckpt = _make_ckpt(args)
    base_id = 0
    if ckpt is not None:
        base_id = _maybe_resume(eng, ckpt, args)
        if args.snapshot_every:
            fe.step_hooks.append(
                _SnapshotHook(eng, ckpt, args.snapshot_every))
    spec = TraceSpec(
        arrival=args.arrival, rate=args.arrival_rate, burst=args.burst,
        prompt_lens=((0.7, 8, 32), (0.3, 32, 48)),
        output_lens=((1.0, min(4, args.max_new), args.max_new),),
        qos_weights=tuple([1.0] * args.qos_classes),
        sampling=sp, seed=args.seed)
    trace = make_trace(spec, args.requests, cfg.vocab_size,
                       start_id=base_id)
    if args.stream:
        trace = [(t, r, lambda tok, idx, r=r:
                  print(f"  req {r.req_id} (qos {r.qos}) "
                        f"token[{idx}] = {tok}"))
                 for t, r in trace]
    timer = Timer()
    handles = fe.run(trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = timer.elapsed()
    print(f"{len(handles)} arrivals over {fe.steps} steps in {dt:.1f}s  "
          f"[{args.arrival} @ {args.arrival_rate}/unit, "
          f"{ecfg.kv_layout} kv, {ecfg.scheduler} scheduler, "
          f"{ecfg.sampler} sampler, {device}]")
    print("frontend stats:", {k: v for k, v in fe.stats.items() if v})
    print("qos,n,completed,shed,rejected,ttft_p50,ttft_p95,"
          "tpot_p50,tpot_p95,goodput_slo")
    for cls in range(args.qos_classes):
        mine = [h for h in handles if h.req.qos == cls]
        ttft = [h.ttft for h in mine if h.ttft is not None]
        tpot = [h.tpot for h in mine if h.tpot is not None]
        good = sum(1 for h in mine
                   if h.meets_slo(ecfg.slo_ttft, ecfg.slo_tpot))
        print(f"{cls},{len(mine)},"
              f"{sum(1 for h in mine if h.ok)},"
              f"{sum(1 for h in mine if h.outcome == 'shed')},"
              f"{sum(1 for h in mine if h.outcome == 'rejected')},"
              f"{_pct(ttft, 50):.1f},{_pct(ttft, 95):.1f},"
              f"{_pct(tpot, 50):.2f},{_pct(tpot, 95):.2f},"
              f"{good / max(1, len(mine)):.3f}")
    for e in fe.shed_log:
        print(f"# drop: req {e['req_id']} qos {e['qos']} "
              f"reason={e['reason']} t={e['t']:.1f}")
    if (eng.stats["host_syncs"]
            != eng.stats["prefills"] + eng.stats["decode_spans"]):
        raise RuntimeError(f"host syncs off the contract: {eng.stats}")
    if not all(h.streamed == h.req.tokens_out for h in handles if h.ok):
        raise RuntimeError("a client stream differs from its tokens_out")
    if ckpt is not None and args.snapshot_every:
        eng.save_snapshot(ckpt, fe.steps, blocking=True)  # final state
        print(f"# snapshot saved to {args.snapshot_dir} "
              f"(step {fe.steps})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=160)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-layout",
                    choices=("dense", "paged", "latent", "recurrent"),
                    default="dense",
                    help="StateBackend name: dense serves every config; "
                         "paged needs plain attention; latent needs "
                         "all-MLA; recurrent needs pure RWKV/Mamba")
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
    ap.add_argument("--sampler", default=None,
                    help="Sampler name (greedy | stochastic | any "
                         "registered name); default greedy, or stochastic "
                         "when --temperature > 0")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = exact greedy argmax")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k best logits (0 = full vocab)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass to keep (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts, the "
                         "trace and the sampled streams (which replay "
                         "from (seed, req_id) whatever the batching)")
    # live mode
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="offered load in requests per time unit; > 0 "
                         "switches to live mode (timed trace through the "
                         "front end)")
    ap.add_argument("--arrival", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--burst", type=float, default=6.0,
                    help="mean burst size for --arrival bursty")
    ap.add_argument("--admit-capacity", type=int, default=16,
                    help="bounded wait pool; overload sheds the lowest "
                         "classes, never a higher one for a lower")
    ap.add_argument("--slo-ttft", type=float, nargs="*", default=(),
                    help="per-class TTFT budgets (time units, class 0 "
                         "first, <= 0 = none); waiters past budget are "
                         "shed explicitly")
    ap.add_argument("--slo-tpot", type=float, nargs="*", default=(),
                    help="per-class TPOT budgets for goodput accounting")
    ap.add_argument("--degrade-max-new", type=int, default=0,
                    help="under pressure, clamp lower-class responses to "
                         "this many tokens instead of queueing them")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they stream out per request")
    ap.add_argument("--step-dt", type=float, default=1.0,
                    help="virtual time units consumed per engine step")
    ap.add_argument("--real-time", action="store_true",
                    help="wall clock instead of the virtual clock")
    # crash recovery
    ap.add_argument("--snapshot-dir", default="",
                    help="directory for persisted engine snapshots "
                         "(Checkpointer manifest format)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="persist an engine snapshot every N steps "
                         "(async; 0 = off); a final snapshot is written "
                         "on completion")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest snapshot from "
                         "--snapshot-dir before serving; new requests "
                         "get ids after the restored ones")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=device)
    n_pages = args.n_pages or default_page_budget(
        args.slots, args.cache_len, args.page_size)
    sampler = args.sampler or (
        "stochastic" if args.temperature > 0 else "greedy")
    live = args.arrival_rate > 0
    ecfg = EngineConfig(
        slots=args.slots, cache_len=args.cache_len, n_pages=n_pages,
        page_size=args.page_size, kv_layout=args.kv_layout,
        scheduler=args.scheduler, qos_classes=args.qos_classes,
        eos_token=-1, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, decode_span=args.decode_span,
        sampler=sampler, admit_capacity=args.admit_capacity,
        degrade_max_new=args.degrade_max_new,
        slo_ttft=tuple(args.slo_ttft), slo_tpot=tuple(args.slo_tpot),
        clock=(DEFAULT_CLOCK if args.real_time or not live
               else VirtualClock()))
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed)
    if live:
        return _run_live(cfg, params, ecfg, sp, args, device)
    eng = make_engine(cfg, params, ecfg, device=device)
    ckpt = _make_ckpt(args)
    base_id = _maybe_resume(eng, ckpt, args) if ckpt is not None else 0
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        n = int(rng.integers(8, 48))
        eng.submit(Request(base_id + i, rng.integers(
            1, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=args.max_new, qos=i % args.qos_classes,
            sampling=sp))
    timer = Timer()
    if ckpt is not None and args.snapshot_every:
        step = 0
        while (eng.active.any() or eng.sched.pending
               or eng.transport.in_flight):
            eng.step()
            step += 1
            if step % args.snapshot_every == 0:
                eng.save_snapshot(ckpt, step, blocking=False)
        done = eng.completed
        eng.save_snapshot(ckpt, step, blocking=True)   # final state
    else:
        done = eng.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = timer.elapsed()
    print(f"completed {len(done)}/{args.requests} in {dt:.1f}s  "
          f"({eng.stats['decode_tokens'] / dt:.1f} decode tok/s, "
          f"{eng.stats['host_syncs']} host syncs)  "
          f"[{args.kv_layout} kv, {args.scheduler} scheduler, {sampler} "
          f"sampler, {n_pages} pages, prefill chunk {args.prefill_chunk}, "
          f"span {args.decode_span}, {device}]")
    print("completion order (req_id:qos):",
          " ".join(f"{r.req_id}:{r.qos}" for r in done))
    print("stats:", eng.stats)


if __name__ == "__main__":
    main()
