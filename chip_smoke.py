#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

1. device  — card name, power limit (nvidia-smi), torch and CUDA versions;
2. build   — nvcc build of every kernel source in the checkout;
3. kernels — each kernel (B1 paged decode, B2 flash prefill, B3 WKV-6
             decode, B4 WKV-6 chunked prefill) against its plain PyTorch
             version on the card, on the shape sweeps of
             tests/test_kernels.py and at the serving paths' shapes, with
             CUDA-event times of the kernel, the plain version and a
             library call where one exists, and the bound;
4. model   — qwen3-8b and rwkv6-1.6b at full width, 2 layers, fp32 (TF32
             off): prefill and decode on the card (kernels) against the
             CPU (plain path) on the same weights;
5. serve   — qwen3-8b through the paged engine and rwkv6-1.6b through the
             recurrent engine, each at full width and depth in bf16: 8
             requests, launch counts of the path's kernels, a second run
             that must give identical streams (for rwkv6 a third with
             fewer pages than slots, which parks and must agree too), and
             one decode span traced with torch.profiler;
6. the kernels line, the nvidia-smi line, and the final ok line.

Exits non-zero, printing no result, without a CUDA card or without the
rest of the repository, and on any failed check.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and the
# rate for each input type's operations
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

FLASH_REPLACES = "src/repro/kernels/flash_attention.py:119"
PAGED_REPLACES = "src/repro/kernels/paged_attention.py:117"
WKV_DECODE_REPLACES = "src/repro/kernels/wkv6.py:101"
WKV_CHUNKED_REPLACES = "src/repro/kernels/wkv6.py:151"
# WKV-6 outputs are fp32 whatever r/k/v's dtype, and kernel and plain
# version do fp32 math on the same upcast inputs: the tolerances of
# tests/test_kernels.py for the chunked y and state, and for decode
WKV_TOL = {"y": 2e-4, "state": 2e-5, "decode": 1e-5}
NO_WKV_LIBRARY = "none: no single PyTorch call computes WKV-6"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Check(Exception):
    """A failed smoke check."""


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Check(what)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(fn, torch, n: int = 20, warmup: int = 3) -> float:
    """Median of `n` CUDA-event-timed calls after warm-up. The 50 MB L2 is
    flushed before each call: on the serving path a kernel finds its
    inputs cold, since a layer's weights pass through between calls."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def check_flash(torch, fa, B, H, KV, S, hd, dtype, window=0, seed=0,
                timed=True):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = rnd(B, H, S, hd), rnd(B, KV, S, hd), rnd(B, KV, S, hd)
    out = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   window=window)
    name = str(dtype).split(".")[-1]
    err = float((out.float() - ref).abs().max())
    tol = TOL[name]
    ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol))
    pairs = sum(min(i + 1, window) if window > 0 else i + 1
                for i in range(S))
    esize = q.element_size()
    b_ms, b_by = bound(esize * (2 * q.numel() + k.numel() + v.numel()),
                       4.0 * hd * B * H * pairs, name)
    rec = {"phase": "kernels", "kernel": "flash_attention",
           "shape": {"B": B, "H": H, "KV": KV, "S": S, "hd": hd,
                     "window": window}, "dtype": name,
           "max_err": err, "tol": tol, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(
            lambda: fa.flash_attention(q, k, v, window=window), torch)
        rec["plain_ms"] = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, window=window), torch)
        rec["library_ms"] = (time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), torch)
            if window == 0 else None)
    emit(rec)
    require(ok, f"flash_attention disagrees with its plain version: {rec}")
    return rec


def check_paged(torch, pa, B, H, KV, hd, NP, page, MP, dtype, seed=0,
                timed=True):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q = rnd(B, H, hd)
    kp, vp = rnd(NP, page, KV, hd), rnd(NP, page, KV, hd)
    i32 = dict(generator=g, device="cuda", dtype=torch.int32)
    table = torch.randint(0, NP, (B, MP), **i32)
    lengths = torch.randint(1, MP * page + 1, (B,), **i32)
    out = pa.paged_decode_attention(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    ref = pa.paged_decode_plain(q.float(), kp.float(), vp.float(), table,
                                lengths)
    name = str(dtype).split(".")[-1]
    err = float((out.float() - ref).abs().max())
    tol = TOL[name]
    ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol))
    live = int(torch.clamp(lengths, max=MP * page).sum())
    esize = q.element_size()
    b_ms, b_by = bound(esize * (2 * live * KV * hd + 2 * q.numel())
                       + 4 * (table.numel() + lengths.numel()),
                       4.0 * H * hd * live, name)
    rec = {"phase": "kernels", "kernel": "paged_decode_attention",
           "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "NP": NP,
                     "page": page, "MP": MP}, "dtype": name,
           "lengths": lengths.tolist(), "max_err": err, "tol": tol,
           "ok": ok, "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(
            lambda: pa.paged_decode_attention(q, kp, vp, table, lengths),
            torch)
        rec["plain_ms"] = time_ms(
            lambda: pa.paged_decode_plain(q, kp, vp, table, lengths), torch)
        mask = (torch.arange(MP * page, device="cuda")[None]
                < lengths[:, None])[:, None, None, :]

        def library():
            idx = table.long()
            k = kp[idx].reshape(B, MP * page, KV, hd).transpose(1, 2)
            v = vp[idx].reshape(B, MP * page, KV, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
        rec["library_ms"] = time_ms(library, torch)
    emit(rec)
    require(ok, f"paged_decode_attention disagrees with its plain version: "
                f"{rec}")
    return rec


def _wkv_inputs(torch, seed, B, S, H, hd, dtype):
    """r, k, v [B,S,H,hd] in `dtype`; logw in the model's clamp range;
    u [H,hd] and S0 [B,H,hd,hd] fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r, k, v = (rnd(B, S, H, hd).to(dtype) for _ in range(3))
    logw = -torch.exp(torch.clamp(rnd(B, S, H, hd), -8, 0.5))
    return r, k, v, logw, rnd(H, hd) * 0.1, rnd(B, H, hd, hd) * 0.1


def _max_err(torch, pairs):
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def check_wkv_chunked(torch, wk, B, S, H, hd, dtype, chunk=32, seed=0,
                      timed=True):
    r, k, v, logw, u, s0 = _wkv_inputs(torch, seed, B, S, H, hd, dtype)
    y, s = wk.wkv6_chunked(r, k, v, logw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    ey, es = wk.wkv6_chunked_plain(r, k, v, logw, u, s0, chunk=chunk)
    tol_y, tol_s = WKV_TOL["y"], WKV_TOL["state"]
    ok = bool(torch.allclose(y, ey, atol=tol_y, rtol=tol_y)
              and torch.allclose(s, es, atol=tol_s, rtol=tol_s))
    # what these inputs need, chunk by chunk (c valid tokens): the
    # strictly-lower scores and their product with v, 2*c*(c-1)*hd; the
    # carried state read and updated, 4*c*hd^2; fp32 math, fp32 peak
    C = min(chunk, S)
    cs = [C] * (S // C) + ([S % C] if S % C else [])
    flops = B * H * sum(2 * c * (c - 1) * hd + 4 * c * hd * hd for c in cs)
    nbytes = (B * S * H * hd * (3 * r.element_size() + 4 + 4)
              + 4 * u.numel() + 2 * 4 * s0.numel())
    b_ms, b_by = bound(nbytes, flops, "float32")
    name = str(dtype).split(".")[-1]
    rec = {"phase": "kernels", "kernel": "wkv6_chunked",
           "shape": {"B": B, "S": S, "H": H, "hd": hd, "chunk": C},
           "dtype": name, "max_err": _max_err(torch, ((y, ey), (s, es))),
           "tol": {"y": tol_y, "state": tol_s}, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(
            lambda: wk.wkv6_chunked(r, k, v, logw, u, s0, chunk=chunk),
            torch)
        rec["plain_ms"] = time_ms(
            lambda: wk.wkv6_chunked_plain(r, k, v, logw, u, s0,
                                          chunk=chunk), torch)
        rec["library_ms"] = None
        rec["library"] = NO_WKV_LIBRARY
    emit(rec)
    require(ok, f"wkv6_chunked disagrees with its plain version: {rec}")
    return rec


def check_wkv_decode(torch, wk, B, H, hd, dtype, seed=0, timed=True):
    """One token against the plain version at 1e-5, and against the t = 1
    column of the chunked kernel at the chunked tolerances."""
    r, k, v, logw, u, s0 = _wkv_inputs(torch, seed, B, 1, H, hd, dtype)
    w = torch.exp(logw)
    args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    y, s = wk.wkv6_decode(*args)
    cy, cs = wk.wkv6_chunked(r, k, v, torch.log(w), u, s0, chunk=1)
    torch.cuda.synchronize()
    ey, es = wk.wkv6_decode_plain(*args)
    tol = WKV_TOL["decode"]
    ok = bool(torch.allclose(y, ey, atol=tol, rtol=tol)
              and torch.allclose(s, es, atol=tol, rtol=tol)
              and torch.allclose(cy[:, 0], y, atol=WKV_TOL["y"],
                                 rtol=WKV_TOL["y"])
              and torch.allclose(cs, s, atol=WKV_TOL["state"],
                                 rtol=WKV_TOL["state"]))
    # read r, k, v, w, u and the state once, write y and the new state
    nbytes = (B * H * hd * (3 * r.element_size() + 4 + 4)
              + 4 * u.numel() + 2 * 4 * s0.numel())
    b_ms, b_by = bound(nbytes, 7.0 * B * H * hd * hd, "float32")
    rec = {"phase": "kernels", "kernel": "wkv6_decode",
           "shape": {"B": B, "H": H, "hd": hd},
           "dtype": str(dtype).split(".")[-1],
           "max_err": _max_err(torch, ((y, ey), (s, es))),
           "max_err_vs_chunked_t1": _max_err(torch, ((cy[:, 0], y),
                                                     (cs, s))),
           "tol": tol, "ok": ok, "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(lambda: wk.wkv6_decode(*args), torch)
        rec["plain_ms"] = time_ms(lambda: wk.wkv6_decode_plain(*args),
                                  torch)
        rec["library_ms"] = None
        rec["library"] = NO_WKV_LIBRARY
    emit(rec)
    require(ok, f"wkv6_decode disagrees with its plain version: {rec}")
    return rec


def phase_kernels(torch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wkv6 as wk
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for B, H, KV, S, hd in ((2, 4, 2, 256, 64), (1, 4, 4, 200, 32),
                                (2, 8, 2, 192, 64), (1, 2, 1, 128, 16)):
            check_flash(torch, fa, B, H, KV, S, hd, dtype, timed=False)
        for B, H, KV, hd, NP, page, MP in ((2, 4, 2, 32, 16, 16, 4),
                                           (3, 8, 4, 64, 32, 8, 6),
                                           (1, 2, 1, 16, 8, 4, 3)):
            check_paged(torch, pa, B, H, KV, hd, NP, page, MP, dtype,
                        timed=False)
    for window in (32, 96):
        check_flash(torch, fa, 2, 4, 2, 256, 32, f32, window=window,
                    timed=False)
    for dtype in (f32, bf16):
        for B, S, H, hd, chunk in ((2, 64, 2, 8, 16), (1, 50, 3, 16, 32),
                                   (2, 33, 1, 8, 8), (2, 1, 2, 8, 32)):
            check_wkv_chunked(torch, wk, B, S, H, hd, dtype, chunk=chunk,
                              timed=False)
        for B, H, hd in ((2, 2, 8), (1, 3, 16), (4, 1, 8)):
            check_wkv_decode(torch, wk, B, H, hd, dtype, timed=False)
    # the serving path's shapes (qwen3-8b: H 32, KV 8, hd 128)
    main = {}
    for S in (200, 1000, 1531):
        main[("flash", S)] = check_flash(torch, fa, 1, 32, 8, S, 128, bf16)
    for MP in (16, 128):
        main[("paged", MP)] = check_paged(torch, pa, 4, 32, 8, 128, 640, 16,
                                          MP, bf16)
    # rwkv6-1.6b's (H 32, hd 64): prefill passes bf16 r/k/v, decode fp32
    for S in (200, 1000, 1531):
        main[("wkv6_chunked", S)] = check_wkv_chunked(torch, wk, 1, S, 32,
                                                      64, bf16)
    main[("wkv6_decode", 4)] = check_wkv_decode(torch, wk, 4, 32, 64, f32)
    return main


# --------------------------------------------------------------------------
# phase 4: full-width model, card (kernels) against CPU (plain path)
# --------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _paged_state(torch, lm, tf, cfg, caches, n_seq, length, page,
                 max_pages, device):
    """Paged state for `n_seq` prefilled sequences of one length, pages
    taken from a PagePool in its own (non-contiguous) order."""
    from repro_torch.core.resource import PagePool
    pool = PagePool(n_seq * max_pages + 3, page)
    pool.alloc(-1, 3)                          # non-trivial page ids
    state = lm.init_paged_serve_state(cfg, n_seq, pool.n_pages, page,
                                      max_pages, dtype=torch.float32,
                                      device=device)
    for b in range(n_seq):
        pages = pool.alloc(b, max_pages)
        one = [{k: v[b:b + 1] for k, v in layer.items()} for layer in caches]
        tf.scatter_pages(state["caches"],
                         tf.dense_to_pages(one, len(pages), page), pages)
    state["page_table"] = torch.as_tensor(
        pool.table_matrix(list(range(n_seq)), max_pages), device=device)
    state["lengths"][:] = length
    state["positions"][:] = length
    return state


def phase_model(torch, cfg, n_prompt=300, n_seq=2, steps=4, seed=0,
                tol=2e-3, device="cuda"):
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(seed)
    p_cpu = lm.init_params(cfg, gen, device="cpu", dtype=torch.float32)
    p_gpu = _to(p_cpu, device)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, size=(n_seq, n_prompt))
    errs = {}
    page = 16
    max_pages = -(-(n_prompt + steps) // page)

    def close(name, a, b):
        a, b = a.float().cpu(), b.float()
        errs[name] = max(errs.get(name, 0.0), float((a - b).abs().max()))
        require(bool(torch.allclose(a, b, atol=tol, rtol=tol)),
                f"model phase: {name} differs beyond {tol} "
                f"(max abs {errs[name]})")

    # attention stacks decode through a page table; RWKV stacks carry
    # per-slot state, compared layer by layer after prefill and each step
    paged = tf.paged_stack_supported(cfg)

    def close_state(name):
        if paged:
            return
        for a_layer, b_layer in zip(card["state"]["caches"],
                                    cpu["state"]["caches"]):
            for key in a_layer:
                close(f"{name}_{key}", a_layer[key], b_layer[key])

    runs = {}
    for dev, params in (("cpu", p_cpu), (device, p_gpu)):
        t = torch.as_tensor(tokens, device=dev)
        x, _ = tf.apply_stack(params, lm.embed(params["embed"], t), cfg,
                              {"mode": "prefill"})
        hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits, st = lm.prefill(params, t, cfg,
                                cache_len=max_pages * page)
        if paged:
            st = _paged_state(torch, lm, tf, cfg, st["caches"], n_seq,
                              n_prompt, page, max_pages, dev)
        runs[dev] = {"params": params, "hidden": hidden, "logits": [logits],
                     "state": st}
    cpu, card = runs["cpu"], runs[device]
    close("prefill_hidden", card["hidden"], cpu["hidden"])
    close("prefill_logits", card["logits"][0], cpu["logits"][0])
    close_state("prefill_state")
    toks = []
    for _ in range(steps):
        want = lm.select_token(cpu["logits"][-1])
        got = lm.select_token(card["logits"][-1]).cpu()
        require(torch.equal(want, got),
                f"model phase: greedy tokens differ: {want} vs {got}")
        toks.append(got.tolist())
        for r in (cpu, card):
            dev = r["state"]["lengths"].device
            lg, r["state"] = lm.decode_step(r["params"], want.to(dev),
                                            r["state"], cfg)
            r["logits"].append(lg)
        close("decode_logits", card["logits"][-1], cpu["logits"][-1])
        close_state("decode_state")
    rec = {"phase": "model", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
           "state": "page pools" if paged else "per-slot carry, compared",
           "prompts": [n_prompt] * n_seq, "decode_steps": steps,
           "tol": tol, "max_abs_err": errs, "greedy_tokens": toks,
           "tokens_equal": True}
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# phase 5: serve the slice at full width and depth
# --------------------------------------------------------------------------

PROMPT_LENS = (37, 200, 333, 517, 1000, 1024, 1531, 1900)


def _serve_once(torch, cfg, params, ecfg, prompts, max_new, device):
    from repro_torch.core.timing import Timer
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, ecfg, device=device)
    prefill_s = [0.0]
    inner = eng._prefill_full

    def timed_prefill(slot, req):              # measurement only
        sync(torch, device)
        t = Timer()
        inner(slot, req)
        sync(torch, device)
        prefill_s[0] += t.elapsed()
    eng._prefill_full = timed_prefill
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p.copy(), max_new_tokens=max_new))
    sync(torch, device)
    t = Timer()
    done = eng.run_until_done()
    sync(torch, device)
    return eng, done, t.elapsed(), prefill_s[0]


def profile_decode_span(torch, cfg, params, ecfg, prompts, device):
    """Where a decode span's time goes: admit and prefill the first
    `slots` prompts with one engine step, then trace the next step (a
    pure decode span) with torch.profiler. Returns the wall time, the
    summed device time of the kernels, and the top kernels by device
    time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.timing import Timer
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, ecfg, device=device)
    for i, p in enumerate(prompts[:ecfg.slots]):
        eng.submit(Request(i, p.copy(), max_new_tokens=1 << 20))
    eng.step()
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(torch, device)
    steps = eng.stats["decode_steps"]
    with profile(activities=acts) as prof:
        t = Timer()
        eng.step()
        sync(torch, device)
        wall = t.elapsed()
    # device-side rows only (kernels, copies, memsets): an op's row
    # repeats the device time of the kernels it launched
    from torch.autograd import DeviceType
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e[1])
    busy = sum(ms for _, ms, _ in events) / 1e3
    return {"decode_steps": eng.stats["decode_steps"] - steps,
            "wall_s": wall, "device_kernel_s": busy,
            "device_busy_share": busy / wall,
            "top_kernels_ms": [[k[:80], ms, n] for k, ms, n in events[:10]]}


def _wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wkv6 as wk
    return {"flash_attention": fa.flash_attention,
            "paged_decode_attention": pa.paged_decode_attention,
            "wkv6_chunked": wk.wkv6_chunked,
            "wkv6_decode": wk.wkv6_decode}


def phase_serve(torch, cfg, ecfg, path, prompt_lens=PROMPT_LENS, max_new=32,
                seed=0, device="cuda", park_pages=None):
    """Serve 8 requests at full width and depth. ``path`` maps each kernel
    the serving path must run to the counter its launches follow per
    layer ("prefills" or "decode_steps"); every kernel's count is set to
    0 just before the run and read just after. With ``park_pages`` a
    third run with that many pages (fewer than slots) must park, unpark
    and give the same streams."""
    import dataclasses
    import numpy as np
    from repro_torch.models import lm
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(cfg, gen, device=device)
    sync(torch, device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    eng, done, wall, prefill_s = _serve_once(torch, cfg, params, ecfg,
                                             prompts, max_new, device)
    launches = {n: w.launches for n, w in wrappers.items()}
    st = eng.stats
    streams = {r.req_id: list(r.tokens_out) for r in done}
    require(len(done) == len(prompts)
            and all(len(s) == max_new for s in streams.values()),
            f"serve: not every request completed with {max_new} tokens: "
            f"{ {k: len(v) for k, v in streams.items()} }")
    require(st["host_syncs"] == st["prefills"] + st["decode_spans"],
            f"serve: host_syncs {st['host_syncs']} != prefills "
            f"{st['prefills']} + decode_spans {st['decode_spans']}")
    n_layers = cfg.n_layers
    for name, per in path.items():
        require(launches[name] == n_layers * st[per] > 0,
                f"serve: {name} launches {launches[name]} != {n_layers} x "
                f"{per} ({st[per]})")
    require(all(v == 0 for n, v in launches.items() if n not in path),
            f"serve: a kernel off the {cfg.name} path launched: "
            f"{launches}")
    eng2, done2, wall2, _ = _serve_once(torch, cfg, params, ecfg, prompts,
                                        max_new, device)
    streams2 = {r.req_id: list(r.tokens_out) for r in done2}
    require(streams2 == streams, "serve: a second run gave other streams")
    del eng2
    parking = None
    if park_pages is not None:
        eng3, done3, _, _ = _serve_once(
            torch, cfg, params, dataclasses.replace(ecfg,
                                                    n_pages=park_pages),
            prompts, max_new, device)
        st3 = eng3.stats
        streams3 = {r.req_id: list(r.tokens_out) for r in done3}
        require(st3["parked"] > 0 and st3["unparked"] == st3["parked"],
                f"serve: n_pages={park_pages} did not park and unpark: "
                f"{st3}")
        require(streams3 == streams,
                "serve: the run that parks gave other streams")
        parking = {"n_pages": park_pages, "parked": st3["parked"],
                   "unparked": st3["unparked"],
                   "streams_identical": True}
        del eng3
    traced = profile_decode_span(torch, cfg, params, ecfg, prompts, device)
    decode_s = wall - prefill_s
    rec = {"phase": "serve", "arch": cfg.name, "n_layers": n_layers,
           "dtype": str(lm.param_dtype(cfg)).split(".")[-1],
           "engine": {k: getattr(ecfg, k) for k in (
               "slots", "cache_len", "page_size", "n_pages", "decode_span",
               "eos_token", "kv_layout", "prefill_chunk",
               "prefix_cache_entries")},
           "prompt_lens": list(prompt_lens), "max_new_tokens": max_new,
           "wall_s": wall, "wall_s_second_run": wall2,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "prefill_tok_per_s": st["prefill_tokens"] / prefill_s,
           "decode_tok_per_s": st["decode_tokens"] / decode_s,
           "launches": launches, "stats": st,
           "completion_order": [r.req_id for r in done],
           "streams_identical_across_runs": True,
           "parking_run": parking, "traced_decode_span": traced}
    if torch.device(device).type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(rec)
    del params, eng
    return rec


# --------------------------------------------------------------------------

def kernel_line(main, serves):
    """One row per kernel: its times at the main serving shape, its
    launches in the serve run of the path that runs it."""
    rows = []
    for name, key, src, replaces in (
            ("flash_attention", ("flash", 1531), "flash_attention.cu",
             FLASH_REPLACES),
            ("paged_decode_attention", ("paged", 128), "paged_attention.cu",
             PAGED_REPLACES),
            ("wkv6_chunked", ("wkv6_chunked", 1531), "wkv6.cu",
             WKV_CHUNKED_REPLACES),
            ("wkv6_decode", ("wkv6_decode", 4), "wkv6.cu",
             WKV_DECODE_REPLACES)):
        rec = main[key]
        launches = [s["launches"][name] for s in serves
                    if s["launches"][name]]
        require(len(launches) == 1,
                f"{name} ran on {len(launches)} serving paths, not one")
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": replaces, "launches": launches[0],
               "max_abs_err": rec["max_err"], "ms": rec["kernel_ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"],
               "library_ms": rec["library_ms"],
               "shape": rec["shape"], "checked": True}
        if "library" in rec:
            row["library"] = rec["library"]
        rows.append(row)
    return {"kernels": rows}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs.registry import get_config
        from repro_torch.core.timing import Timer
        from repro_torch.kernels import _build
        from repro_torch.serve.api import EngineConfig
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e}); run from the root "
              f"of a checkout", file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=60).stdout.strip()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]})
        t = Timer()
        logs = _build.build_all()
        emit({"phase": "build", "seconds": t.elapsed(),
              "dir": str(_build.build_dir().relative_to(ROOT)),
              "ptxas": {n: [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln]
                        for n, log in logs.items()}})
        main_shapes = phase_kernels(torch)
        cfg = get_config("qwen3-8b")
        rcfg = get_config("rwkv6-1.6b")
        for c in (cfg, rcfg):
            phase_model(torch, c.scaled(n_layers=2, dtype="float32"))
        serves = []
        for c, layout, n_pages, path, park in (
                (cfg, "paged", 640,
                 {"flash_attention": "prefills",
                  "paged_decode_attention": "decode_steps"}, None),
                (rcfg, "recurrent", 4,
                 {"wkv6_chunked": "prefills",
                  "wkv6_decode": "decode_steps"}, 3)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ecfg = EngineConfig(slots=4, cache_len=2048, page_size=16,
                                n_pages=n_pages, decode_span=8, eos_token=-1,
                                kv_layout=layout, prefill_chunk=0,
                                prefix_cache_entries=0)
            serves.append(phase_serve(torch, c, ecfg, path,
                                      park_pages=park))
        emit(kernel_line(main_shapes, serves))
    except Check as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
