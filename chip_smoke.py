#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

1. device  — card name, power limit (nvidia-smi), torch and CUDA versions;
2. build   — nvcc build of every kernel source in the checkout;
3. kernels — each kernel (B1 paged decode, B2 flash prefill, B3 WKV-6
             decode, B4 WKV-6 chunked prefill, B5 SSM decode step, B6
             linear scan, B7 MoE dispatch) against its plain PyTorch
             version on the card, on the shape sweeps of
             tests/test_kernels.py, at the edges of each kernel's design
             and at the serving paths' shapes, with CUDA-event times of
             the kernel, the plain version and a library call where one
             exists (the host's work hidden behind a spin), and the bound;
4. model   — qwen3-8b, rwkv6-1.6b, moonshot-v1-16b-a3b and jamba-v0.1-52b
             at full width, 2 layers (jamba's an attention layer with a
             dense MLP and a Mamba layer with an MoE one), fp32 (TF32
             off): prefill and decode on the card (kernels) against the
             CPU (plain path) on the same weights; for the MoE models, any
             token whose top-k expert set differs between the two is
             reported with its router gap;
5. serve   — qwen3-8b and moonshot-v1-16b-a3b through the paged engine,
             rwkv6-1.6b through the recurrent engine, each at full width
             and depth, and jamba-v0.1-52b through the dense engine at
             full width and 16 of its 32 layers (its 103 GB of bf16
             weights do not fit one card), all in bf16: 8 requests,
             launch counts of the path's kernels, a second run that must
             give identical streams (for rwkv6, moonshot and jamba a
             third with fewer pages, which parks and must agree too), and
             one decode span traced with torch.profiler (and rwkv6's
             1531-token and moonshot's 1900-token prefills), each port
             kernel's device ms and launches in the trace held to its
             wrapper's calls;
6. the kernels line, the total wall time, the nvidia-smi line, and the
   final ok line.

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
# ~50 µs of spinning at the H100's 1.98 GHz boost clock (time_ms)
SPIN_CYCLES = 100_000

FLASH_REPLACES = "src/repro/kernels/flash_attention.py:119"
PAGED_REPLACES = "src/repro/kernels/paged_attention.py:117"
WKV_DECODE_REPLACES = "src/repro/kernels/wkv6.py:101"
WKV_CHUNKED_REPLACES = "src/repro/kernels/wkv6.py:151"
MOE_REPLACES = "src/repro/kernels/moe_dispatch.py:59"
SCAN_REPLACES = "src/repro/kernels/linear_scan.py:44"
SSM_DECODE_REPLACES = "src/repro/kernels/ssm_decode.py:51"
# the __global__ functions of src/repro_torch/kernels/csrc/: B1's split and
# reduce passes, B2's tensor-core (bf16) and FMA (fp32) kernels, B4's three
# passes (chunk states, the scan of the carry, chunk outputs), B3, B5-B7
WKV_CHUNKED_KERNELS = ("wkv6_chunk_state_kernel", "wkv6_state_scan_kernel",
                       "wkv6_chunk_output_kernel")
PORT_KERNELS = ("paged_decode_split_kernel", "paged_decode_reduce_kernel",
                "flash_fwd_bf16_kernel", "flash_fwd_kernel",
                *WKV_CHUNKED_KERNELS, "wkv6_decode_kernel",
                "moe_dispatch_kernel", "linear_scan_kernel",
                "ssm_decode_kernel")
# WKV-6 outputs are fp32 whatever r/k/v's dtype, and kernel and plain
# version do fp32 math on the same upcast inputs: the tolerances of
# tests/test_kernels.py for the chunked y and state, and for decode
WKV_TOL = {"y": 2e-4, "state": 2e-5, "decode": 1e-5}
NO_WKV_LIBRARY = "none: no single PyTorch call computes WKV-6"
# B5 and B6 in fp32, as tests/test_kernels.py holds them
SSM_TOL = 1e-5
NO_SSM_LIBRARY = "none: no single PyTorch call computes this"
# the router's gap between its k-th and (k+1)-th expert below which a
# card-vs-CPU difference in the top-k set counts as a tie, not a fault
ROUTE_TIE = 1e-5


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
    inputs cold, since a layer's weights pass through between calls. A
    spin of SPIN_CYCLES is queued after the flush and before the start
    event, so that the wrapper's host work (checks, allocation, the
    launch) overlaps the spin and the window holds device time."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
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
    again = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   window=window)
    name = str(dtype).split(".")[-1]
    err = float((out.float() - ref).abs().max())
    tol = TOL[name]
    repeats = bool(torch.equal(out, again))
    ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol)) \
        and repeats
    pairs = sum(min(i + 1, window) if window > 0 else i + 1
                for i in range(S))
    esize = q.element_size()
    b_ms, b_by = bound(esize * (2 * q.numel() + k.numel() + v.numel()),
                       4.0 * hd * B * H * pairs, name)
    rec = {"phase": "kernels", "kernel": "flash_attention",
           "shape": {"B": B, "H": H, "KV": KV, "S": S, "hd": hd,
                     "window": window}, "dtype": name,
           "max_err": err, "tol": tol, "bit_equal_repeat": repeats,
           "ok": ok, "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(
            lambda: fa.flash_attention(q, k, v, window=window), torch)
        rec["plain_ms"] = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, window=window), torch)
        rec["library_ms"] = (time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), torch)
            if window == 0 else None)
        if rec["library_ms"]:
            rec["x_library"] = rec["kernel_ms"] / rec["library_ms"]
    emit(rec)
    require(ok, f"flash_attention disagrees with its plain version: {rec}")
    return rec


def check_flash_padded(torch, fa, B, H, KV, S, hd, hd_v, dtype, seed=0):
    """B2 through the model's ``chunked_causal_attention`` at head dims
    it is not built for (q/k ``hd``, v ``hd_v``): zero-padded to the next
    built head dim, the output sliced back; against the plain masked
    softmax on the unpadded tensors."""
    from repro_torch.models.attention import chunked_causal_attention
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd_v)
    n = fa.flash_attention.launches
    out = chunked_causal_attention(q, k, v)
    launched = fa.flash_attention.launches - n
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(*(t.float().transpose(1, 2)
                                     for t in (q, k, v))).transpose(1, 2)
    name = str(dtype).split(".")[-1]
    err = float((out.float() - ref).abs().max())
    tol = TOL[name]
    ok = (out.shape == (B, S, H, hd_v) and launched == 1
          and bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol)))
    rec = {"phase": "kernels", "kernel": "flash_attention",
           "route": "chunked_causal_attention (zero-padded head dims)",
           "shape": {"B": B, "H": H, "KV": KV, "S": S, "hd": hd,
                     "hd_v": hd_v}, "dtype": name, "max_err": err,
           "tol": tol, "ok": ok}
    emit(rec)
    require(ok, f"chunked_causal_attention disagrees with the plain "
                f"attention: {rec}")
    return rec


def check_paged(torch, pa, B, H, KV, hd, NP, page, MP, dtype, seed=0,
                timed=True, lengths=None):
    """B1 against its plain version on random lengths in [1, MP * page],
    or on ``lengths``; two calls must agree bit for bit."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q = rnd(B, H, hd)
    kp, vp = rnd(NP, page, KV, hd), rnd(NP, page, KV, hd)
    i32 = dict(generator=g, device="cuda", dtype=torch.int32)
    table = torch.randint(0, NP, (B, MP), **i32)
    lengths = (torch.randint(1, MP * page + 1, (B,), **i32)
               if lengths is None else
               torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    out = pa.paged_decode_attention(q, kp, vp, table, lengths)
    again = pa.paged_decode_attention(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    ref = pa.paged_decode_plain(q.float(), kp.float(), vp.float(), table,
                                lengths)
    name = str(dtype).split(".")[-1]
    err = float((out.float() - ref).abs().max())
    tol = TOL[name]
    repeats = bool(torch.equal(out, again))
    # a slot of length 0 has no keys: exactly 0
    empty_zero = not bool(out[lengths == 0].any())
    ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol)) \
        and repeats and empty_zero
    live = int(torch.clamp(lengths, max=MP * page).sum())
    esize = q.element_size()
    b_ms, b_by = bound(esize * (2 * live * KV * hd + 2 * q.numel())
                       + 4 * (table.numel() + lengths.numel()),
                       4.0 * H * hd * live, name)
    rec = {"phase": "kernels", "kernel": "paged_decode_attention",
           "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "NP": NP,
                     "page": page, "MP": MP}, "dtype": name,
           "partition_pages": pa.partition_pages(MP, page),
           "lengths": lengths.tolist(), "max_err": err, "tol": tol,
           "bit_equal_repeat": repeats, "ok": ok, "bound_ms": b_ms,
           "bound_by": b_by}
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
        rec["x_library"] = rec["kernel_ms"] / rec["library_ms"]
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
    column of the chunked kernel at the chunked tolerances; two calls must
    agree bit for bit."""
    r, k, v, logw, u, s0 = _wkv_inputs(torch, seed, B, 1, H, hd, dtype)
    w = torch.exp(logw)
    args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    y, s = wk.wkv6_decode(*args)
    y2, s2 = wk.wkv6_decode(*args)
    cy, cs = wk.wkv6_chunked(r, k, v, torch.log(w), u, s0, chunk=1)
    torch.cuda.synchronize()
    ey, es = wk.wkv6_decode_plain(*args)
    tol = WKV_TOL["decode"]
    repeats = bool(torch.equal(y, y2) and torch.equal(s, s2))
    ok = repeats and bool(torch.allclose(y, ey, atol=tol, rtol=tol)
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
           "tol": tol, "bit_equal_repeat": repeats, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(lambda: wk.wkv6_decode(*args), torch)
        rec["plain_ms"] = time_ms(lambda: wk.wkv6_decode_plain(*args),
                                  torch)
        rec["library_ms"] = None
        rec["library"] = NO_WKV_LIBRARY
    emit(rec)
    require(ok, f"wkv6_decode disagrees with its plain version: {rec}")
    return rec


def _dispatch_rows(torch, g, T, E, C, positions, seed):
    """Expert ids and queue positions. ``cumsum``: ids uniform over the
    experts, positions their cumsum, as the MoE layer computes them.
    ``sparse``: ids over E + E // 4 + 1 values (the rest out of range),
    and each expert's rows at distinct positions drawn at random from
    [0, max(2 C, its rows)): not dense from 0, permuted, some past C."""
    import numpy as np
    if positions == "cumsum":
        eids = torch.randint(0, E, (T,), generator=g, device="cuda",
                             dtype=torch.int32)
        onehot = (eids[:, None] == torch.arange(E, device="cuda")).to(
            torch.int32)
        pos = torch.cumsum(onehot, 0, dtype=torch.int32).gather(
            1, eids[:, None].long())[:, 0] - 1
        return eids, pos
    rng = np.random.default_rng(seed)
    eids = rng.integers(0, E + E // 4 + 1, size=T).astype(np.int32)
    pos = np.zeros(T, np.int32)
    for e in range(E + E // 4 + 1):
        at = np.nonzero(eids == e)[0]
        pos[at] = rng.permutation(max(2 * C, len(at)))[:len(at)]
    return (torch.from_numpy(eids).to("cuda"),
            torch.from_numpy(pos).to("cuda"))


def check_moe_dispatch(torch, md, T, D, E, C, dtype, seed=0, timed=True,
                       positions="cumsum"):
    """Exact equality with the plain version, on rows placed as
    ``_dispatch_rows`` says."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randn(T, D, generator=g, device="cuda").to(dtype)
    eids, pos = _dispatch_rows(torch, g, T, E, C, positions, seed)
    out = md.moe_dispatch(toks, eids, pos, E, C)
    torch.cuda.synchronize()
    ref = md.moe_dispatch_plain(toks, eids, pos, E, C)
    ok = bool(torch.equal(out, ref))
    keep = (eids >= 0) & (eids < E) & (pos >= 0) & (pos < C)
    kept = int(keep.sum())
    # kept rows read once, ids and positions read once, the whole buffer
    # written once; no arithmetic
    b_ms, b_by = bound(toks.element_size() * D * (kept + E * C) + 8 * T,
                       0.0, str(dtype).split(".")[-1])
    rec = {"phase": "kernels", "kernel": "moe_dispatch",
           "shape": {"T": T, "D": D, "E": E, "C": C},
           "positions": positions, "kept": kept,
           "empty_slots": E * C - kept,
           "dtype": str(dtype).split(".")[-1],
           "max_err": _max_err(torch, ((out, ref),)) if out.numel() else 0.0,
           "tol": 0.0, "ok": ok, "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(
            lambda: md.moe_dispatch(toks, eids, pos, E, C), torch)
        rec["plain_ms"] = time_ms(
            lambda: md.moe_dispatch_plain(toks, eids, pos, E, C), torch)
        k_t, k_e, k_p = toks[keep], eids[keep].long(), pos[keep].long()

        def library():
            return torch.zeros(E, C, D, dtype=dtype,
                               device="cuda").index_put_((k_e, k_p), k_t)
        rec["library_ms"] = time_ms(library, torch)
        rec["library"] = "torch.zeros + index_put_ of the kept rows"
        rec["x_library"] = rec["kernel_ms"] / rec["library_ms"]
        ok = ok and bool(torch.equal(library(), out))
        rec["ok"] = ok
    emit(rec)
    require(ok, f"moe_dispatch is not equal to its plain version: {rec}")
    return rec


def check_linear_scan(torch, ls, B, T, D, N, seed=0, timed=True):
    """B6 against its plain version at SSM_TOL. a lies in (0.5, 1), as
    exp(dt * A) does for Mamba's small dt."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(B, T, D, N, generator=g, device="cuda") * 0.5 + 0.5
    b = torch.randn(B, T, D, N, generator=g, device="cuda")
    h0 = torch.randn(B, D, N, generator=g, device="cuda")
    hs, hl = ls.linear_scan(a, b, h0)
    torch.cuda.synchronize()
    ehs, ehl = ls.linear_scan_plain(a, b, h0)
    ok = bool(torch.allclose(hs, ehs, atol=SSM_TOL, rtol=SSM_TOL)
              and torch.allclose(hl, ehl, atol=SSM_TOL, rtol=SSM_TOL))
    # a and b read once, every h_t written once, h0 read and h_last
    # written once; a multiply and an add per element and step
    b_ms, b_by = bound(4 * (3 * a.numel() + 2 * h0.numel()),
                       2.0 * a.numel(), "float32")
    rec = {"phase": "kernels", "kernel": "linear_scan",
           "shape": {"B": B, "T": T, "D": D, "N": N}, "dtype": "float32",
           "max_err": _max_err(torch, ((hs, ehs), (hl, ehl))),
           "bit_equal": bool(torch.equal(hs, ehs)), "tol": SSM_TOL,
           "ok": ok, "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(lambda: ls.linear_scan(a, b, h0), torch)
        rec["plain_ms"] = time_ms(lambda: ls.linear_scan_plain(a, b, h0),
                                  torch)
        rec["library_ms"] = None
        rec["library"] = NO_SSM_LIBRARY
    emit(rec)
    require(ok, f"linear_scan disagrees with its plain version: {rec}")
    return rec


def check_ssm_decode(torch, ls, sd, B, Di, N, seed=0, timed=True,
                     offset=0):
    """B5's y against its plain version at SSM_TOL, its h' equal to the
    plain version's and to the T = 1 slice of B6; two calls must agree bit
    for bit. With ``offset`` h and dA are contiguous views ``offset``
    elements into larger buffers (not 16-byte aligned for an offset of
    1-3: the kernel's one-n-a-thread instance)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = B * Di * N

    def state(x):
        return x[offset:].view(B, Di, N)

    h = state(torch.randn(n + offset, generator=g, device="cuda"))
    dA = state(torch.rand(n + offset, generator=g, device="cuda") * 0.5
               + 0.5)
    dtx = torch.randn(B, Di, generator=g, device="cuda")
    Bs = torch.randn(B, N, generator=g, device="cuda")
    Cs = torch.randn(B, N, generator=g, device="cuda")
    args = (h, dA, dtx, Bs, Cs)
    y, hn = sd.ssm_decode_step(*args)
    y2, hn2 = sd.ssm_decode_step(*args)
    _, sl = ls.linear_scan(dA[:, None].contiguous(),
                           (dtx[..., None] * Bs[:, None, :])[:, None]
                           .contiguous(), h)
    torch.cuda.synchronize()
    ey, ehn = sd.ssm_decode_step_plain(*args)
    repeats = bool(torch.equal(y, y2) and torch.equal(hn, hn2))
    # h' rounds op for op as the plain version and B6's step do: equal
    ok = repeats and bool(torch.allclose(y, ey, atol=SSM_TOL, rtol=SSM_TOL)
                          and torch.equal(hn, ehn) and torch.equal(sl, hn))
    # h and dA read once, h' written once, dtx, B and C read once, y
    # written once; per state element two multiplies and an add for h',
    # a multiply and an add for y
    b_ms, b_by = bound(4 * (3 * h.numel() + 2 * dtx.numel()
                            + Bs.numel() + Cs.numel()),
                       5.0 * h.numel(), "float32")
    rec = {"phase": "kernels", "kernel": "ssm_decode_step",
           "shape": {"B": B, "Di": Di, "N": N}, "dtype": "float32",
           "offset": offset,
           "max_err": _max_err(torch, ((y, ey), (hn, ehn))),
           "max_err_vs_scan_t1": _max_err(torch, ((sl, hn),)),
           "state_bit_equal": bool(torch.equal(hn, ehn)),
           "state_bit_equal_scan_t1": bool(torch.equal(sl, hn)),
           "bit_equal_repeat": repeats, "tol": SSM_TOL, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(lambda: sd.ssm_decode_step(*args), torch)
        rec["plain_ms"] = time_ms(lambda: sd.ssm_decode_step_plain(*args),
                                  torch)
        rec["library_ms"] = None
        rec["library"] = NO_SSM_LIBRARY
    emit(rec)
    require(ok, f"ssm_decode_step disagrees with its plain version: {rec}")
    return rec


def phase_kernels(torch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_decode as sd
    from repro_torch.kernels import wkv6 as wk
    f32, bf16 = torch.float32, torch.bfloat16
    # the sweeps of tests/test_kernels.py (B6, B5), a T that leaves a
    # remainder of the kernel's unrolled loop, a partial warp (B5)
    for B, T, D, N in ((2, 16, 8, 4), (1, 32, 16, 4), (3, 8, 32, 8),
                       (2, 9, 24, 16)):
        check_linear_scan(torch, ls, B, T, D, N, timed=False)
    for B, Di, N in ((2, 8, 4), (1, 32, 8), (3, 16, 4), (3, 5, 8)):
        check_ssm_decode(torch, ls, sd, B, Di, N, timed=False)
    # B5 at every N it takes (four n a thread from N 4, one below), Di
    # ragged against every block's d-range (256 / (N / 4) or 256 / N d),
    # and h, dA one element into their buffers (the one-n-a-thread
    # instance at any N)
    for N in (1, 2, 4, 8, 16, 32):
        for B, Di in ((1, 5), (3, 300)):
            for offset in (0, 1):
                check_ssm_decode(torch, ls, sd, B, Di, N, seed=N + Di,
                                 timed=False, offset=offset)
    for dtype in (f32, bf16):
        for B, H, KV, S, hd in ((2, 4, 2, 256, 64), (1, 4, 4, 200, 32),
                                (2, 8, 2, 192, 64), (1, 2, 1, 128, 16)):
            check_flash(torch, fa, B, H, KV, S, hd, dtype, timed=False)
        for B, H, KV, hd, NP, page, MP in ((2, 4, 2, 32, 16, 16, 4),
                                           (3, 8, 4, 64, 32, 8, 6),
                                           (1, 2, 1, 16, 8, 4, 3)):
            check_paged(torch, pa, B, H, KV, hd, NP, page, MP, dtype,
                        timed=False)
    for dtype in (f32, bf16):
        for window in (32, 96):
            check_flash(torch, fa, 2, 4, 2, 256, 32, dtype, window=window,
                        timed=False)
    # B2's tensor-core kernel at every head dim it is built for, on ragged
    # and tile-edge lengths, one and four query heads per KV head
    for hd in (16, 32, 64, 128):
        for S in (1, 63, 64, 65, 200, 1531):
            for B, H, KV in ((2, 4, 4), (1, 8, 2)):
                check_flash(torch, fa, B, H, KV, S, hd, bf16, timed=False)
    check_flash(torch, fa, 1, 8, 2, 1531, 128, bf16, window=96,
                timed=False)
    # B1's split edges: MP 32 at page 16 cuts a slot into partitions of 4
    # pages (64 tokens); lengths 0, 1, a page, a partition, a partition + 1,
    # MP * page and past it (clamped); MP 1 is one partition of one page;
    # G = 1 and 4 (one block per KV head), 3 and 8 (several)
    for dtype in (f32, bf16):
        for H, KV in ((4, 4), (8, 2), (6, 2), (16, 2)):
            for hd in (64, 128):
                check_paged(torch, pa, 7, H, KV, hd, 80, 16, 32, dtype,
                            timed=False,
                            lengths=[0, 1, 16, 64, 65, 512, 600])
            check_paged(torch, pa, 4, H, KV, 128, 8, 16, 1, dtype,
                        timed=False, lengths=[0, 1, 16, 40])
    for dtype in (f32, bf16):
        for B, S, H, hd, chunk in ((2, 64, 2, 8, 16), (1, 50, 3, 16, 32),
                                   (2, 33, 1, 8, 8), (2, 1, 2, 8, 32)):
            check_wkv_chunked(torch, wk, B, S, H, hd, dtype, chunk=chunk,
                              timed=False)
        for B, H, hd in ((2, 2, 8), (1, 3, 16), (4, 1, 8)):
            check_wkv_decode(torch, wk, B, H, hd, dtype, timed=False)
        # B3's column tiles: 16 columns at hd 16, 64 and 128, a partial
        # tile at hd 8, element by element at hd 6; B * H 1 and 128
        for hd in (6, 8, 16, 64, 128):
            for B, H in ((1, 1), (4, 32)):
                check_wkv_decode(torch, wk, B, H, hd, dtype, seed=hd,
                                 timed=False)
        # B4's chunk-parallel passes at their edges: one token, a chunk
        # less one, a chunk, a chunk and one, ragged tails, a long prompt
        # (48 chunks of 32, or 1531 of 1); head dims 8, 64 and 128 (rows
        # by cp.async) and 6 (element by element, padded to 8 on chip);
        # B = 2, a non-zero state0
        for S in (1, 31, 32, 33, 37, 300, 1531):
            for hd in (6, 8, 64, 128):
                for chunk in (1, 32):
                    check_wkv_chunked(torch, wk, 2, S, 2, hd, dtype,
                                      chunk=chunk, seed=S + hd,
                                      timed=False)
        # the sweep of tests/test_kernels.py, and rows of an odd width
        for T, D, E, C in ((64, 32, 8, 12), (100, 16, 4, 40), (32, 8, 2, 4),
                           (128, 64, 16, 8), (48, 7, 3, 5)):
            check_moe_dispatch(torch, md, T, D, E, C, dtype, timed=False)
        # B7's slot tiles (32 slots of one expert a block): positions not
        # dense from 0, ids out of range, rows past C, tiles no row fills
        # (C 100 for 64 rows), odd row widths, no rows at all, and a
        # moonshot-width prefill whose queues overflow
        for T, D, E, C in ((64, 32, 8, 12), (100, 16, 4, 40), (48, 7, 3, 5),
                           (64, 64, 8, 100), (0, 64, 4, 8),
                           (3000, 2048, 64, 60)):
            check_moe_dispatch(torch, md, T, D, E, C, dtype, seed=T + C,
                               timed=False, positions="sparse")
        check_moe_dispatch(torch, md, 0, 64, 4, 8, dtype, timed=False)
        # B2 through the model at head dims it is not built for: 120
        # (h2o-danube-3-4b, GQA 4:1) and q/k 48 with v 32 (MLA at SMOKE
        # size), zero-padded to 128 and 64
        for B, H, KV, S, hd, hd_v in ((1, 8, 2, 300, 120, 120),
                                      (2, 4, 1, 65, 120, 120),
                                      (1, 4, 4, 257, 48, 32),
                                      (2, 8, 8, 64, 48, 32)):
            check_flash_padded(torch, fa, B, H, KV, S, hd, hd_v, dtype)
    # the serving path's shapes (qwen3-8b: H 32, KV 8, hd 128)
    main = {}
    for S in (200, 1000, 1531):
        main[("flash", S)] = check_flash(torch, fa, 1, 32, 8, S, 128, bf16)
    for MP in (16, 128):
        main[("paged", MP)] = check_paged(torch, pa, 4, 32, 8, 128, 640, 16,
                                          MP, bf16)
    # rwkv6-1.6b's (H 32, hd 64): prefill passes bf16 r/k/v, decode fp32
    for S in (200, 1000, 1531):
        check_wkv_chunked(torch, wk, 1, S, 32, 64, f32, timed=False)
        main[("wkv6_chunked", S)] = check_wkv_chunked(torch, wk, 1, S, 32,
                                                      64, bf16)
    main[("wkv6_decode", 4)] = check_wkv_decode(torch, wk, 4, 32, 64, f32)
    # moonshot-v1-16b-a3b's: attention at H = KV = 16, hd 128; dispatch of
    # a 1900-token prompt's 6 picks per token (C 223) and of a decode
    # step's 4 slots (C 4), exact in fp32 and bf16, timed in bf16
    for S in (1000, 1900):
        main[("flash_moonshot", S)] = check_flash(torch, fa, 1, 16, 16, S,
                                                  128, bf16)
    main[("paged_moonshot", 128)] = check_paged(torch, pa, 4, 16, 16, 128,
                                                640, 16, 128, bf16)
    for dtype in (f32, bf16):
        for key, T, C in (("prefill", 1900 * 6, 223), ("decode", 4 * 6, 4)):
            rec = check_moe_dispatch(torch, md, T, 2048, 64, C, dtype,
                                     timed=dtype == bf16)
            if dtype == bf16:
                main[("moe_dispatch", key)] = rec
    # jamba-v0.1-52b's: attention at H 32, KV 8, hd 128 on a 1900-token
    # prompt; the scan of a 256-token prefill chunk and of the 108-token
    # tail of a 1900-token prompt (D = d_inner 8192, N 16); one decode
    # step of 4 slots; the dispatch of a prompt's 2 picks per token (E 16,
    # C 297, D 4096) and of a decode step's (C 4)
    main[("flash_jamba", 1900)] = check_flash(torch, fa, 1, 32, 8, 1900,
                                              128, bf16)
    for T in (256, 108):
        main[("linear_scan", T)] = check_linear_scan(torch, ls, 1, T, 8192,
                                                     16)
    main[("ssm_decode", 4)] = check_ssm_decode(torch, ls, sd, 4, 8192, 16)
    for key, T, C in (("prefill", 1900 * 2, 297), ("decode", 4 * 2, 4)):
        main[("moe_dispatch_jamba", key)] = check_moe_dispatch(
            torch, md, T, 4096, 16, C, bf16)
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
    """Prefill and ``steps`` decode steps on the card and on the CPU, on
    the same fp32 weights: hidden state, logits (and RWKV's carry) within
    ``tol``, equal greedy tokens. Routing is a discontinuity: a token that
    the card's MoE router sends to another top-k set than the CPU's must
    be a tie (a gap under ROUTE_TIE between the k-th and (k+1)-th
    probability); it is reported, left out of the ``tol`` comparison and
    its logits are checked on their own (finite on both)."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
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
    # a flip in the last layer's MoE changes only its own token's row
    moe_layers = [i for i, k in enumerate(cfg.mlp_kinds()) if k == "moe"]
    require(moe_layers in ([], [cfg.n_layers - 1]),
            f"model phase: the routing check needs at most one MoE layer, "
            f"the last; {cfg.name} has {moe_layers}")
    routes = {"cpu": [], "card": []}            # per run, in call order
    run = ["cpu"]
    flips = []
    inner_moe = moe_mod.moe_mlp

    def recording_moe_mlp(x, p, c, capacity_factor=None):  # measurement
        probs, _, top_e = moe_mod.route(x, p["router"], c.moe.top_k)
        cap = moe_mod.capacity(x.shape[1], c, capacity_factor)
        routes[run[0]].append((probs.cpu(), top_e.cpu(), cap))
        return inner_moe(x, p, c, capacity_factor)

    def kept_experts(top_e, cap):
        """Each token's experts that kept it (sorted, -1 where its queue
        was full): a flip can shift later tokens' queue positions."""
        G, S, K = top_e.shape
        flat = top_e.reshape(G, S * K)
        onehot = (flat[..., None] == torch.arange(cfg.moe.n_experts)).int()
        pos = onehot.cumsum(1).gather(-1, flat[..., None])[..., 0] - 1
        return torch.where(pos < cap, flat, -1).reshape(G, S, K).sort(
            -1).values

    def flipped(call):
        """Rows (g, s) of MoE call ``call`` that the card and the CPU
        route differently: a top-k set that differs must be a tie (router
        gap under ROUTE_TIE); a set that agrees but was kept by other
        experts was pushed out of a queue by such a tie."""
        if not moe_layers:
            return []
        K = cfg.moe.top_k
        (pc, ec, cap), (_, eg, _) = routes["cpu"][call], routes["card"][call]
        differs = (ec.sort(-1).values != eg.sort(-1).values).any(-1)
        shifted = (kept_experts(ec, cap) != kept_experts(eg, cap)).any(-1)
        rows = []
        for g, s in (differs | shifted).nonzero().tolist():
            rows.append((g, s))
            if not differs[g, s]:
                require(bool(differs[g].any()),
                        f"model phase: MoE call {call} keeps token {(g, s)} "
                        f"in other queues on the card with no flip before")
                flips.append({"call": call, "row": [g, s],
                              "cause": "queue position moved by a flip"})
                continue
            p = pc[g, s].sort(descending=True).values
            gap = float(p[K - 1] - p[K])
            flips.append({"call": call, "row": [g, s], "gap": gap})
            require(gap < ROUTE_TIE,
                    f"model phase: MoE call {call} routes token {(g, s)} to "
                    f"another top-{K} set on the card, router gap {gap} >= "
                    f"{ROUTE_TIE}")
        return rows

    def close(name, a, b, skip=()):
        a, b = a.float().cpu(), b.float()
        if skip:                               # flipped rows, checked apart
            keep = torch.ones(a.shape[:len(skip[0])], dtype=torch.bool)
            for idx in skip:
                keep[idx] = False
            a, b = a[keep], b[keep]
        errs[name] = max(errs.get(name, 0.0), float((a - b).abs().max()))
        require(bool(torch.allclose(a, b, atol=tol, rtol=tol)),
                f"model phase: {name} differs beyond {tol} "
                f"(max abs {errs[name]})")

    def check_flipped(call, row, a, b):
        """A flipped token's logits: finite on both, the error reported."""
        a, b = a.float().cpu(), b.float()
        require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                "model phase: a flipped token's logits are not finite")
        for f in flips:
            if (f["call"], tuple(f["row"])) == (call, row):
                f["logits_max_abs_err"] = float((a - b).abs().max())

    # plain attention stacks decode through a page table; the others
    # (RWKV, and jamba's attention + Mamba) from per-slot slabs and
    # carries, compared layer by layer after prefill and each step
    paged = tf.paged_stack_supported(cfg)

    def close_state(name):
        if paged:
            return
        for a_layer, b_layer in zip(card["state"]["caches"],
                                    cpu["state"]["caches"]):
            for key in a_layer:
                close(f"{name}_{key}", a_layer[key], b_layer[key])

    moe_mod.moe_mlp = recording_moe_mlp
    try:
        runs = {}
        for name, dev, params in (("cpu", "cpu", p_cpu),
                                  ("card", device, p_gpu)):
            run[0] = name
            t = torch.as_tensor(tokens, device=dev)
            x, _ = tf.apply_stack(params, lm.embed(params["embed"], t), cfg,
                                  {"mode": "prefill"})
            hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits, st = lm.prefill(params, t, cfg,
                                    cache_len=max_pages * page)
            if paged:
                st = _paged_state(torch, lm, tf, cfg, st["caches"], n_seq,
                                  n_prompt, page, max_pages, dev)
            runs[name] = {"params": params, "hidden": hidden,
                          "logits": [logits], "state": st}
        cpu, card = runs["cpu"], runs["card"]
        rows = flipped(0)
        close("prefill_hidden", card["hidden"], cpu["hidden"], rows)
        for g, s in rows:
            check_flipped(0, (g, s), *(lm.head_logits(r["hidden"][g, s],
                                           lm._head_weight(r["params"], cfg))
                            for r in (card, cpu)))
        # the last token's logits: row g flips if its last token did
        last = [(g,) for g, s in flipped(1) if s == n_prompt - 1]
        close("prefill_logits", card["logits"][0], cpu["logits"][0], last)
        for (g,) in last:
            check_flipped(1, (g, n_prompt - 1), card["logits"][0][g],
                          cpu["logits"][0][g])
        close_state("prefill_state")
        toks = []
        for i in range(steps):
            want = lm.select_token(cpu["logits"][-1])
            got = lm.select_token(card["logits"][-1]).cpu()
            same = [want[b] == got[b] for b in range(n_seq)
                    if (b,) not in last]
            require(all(same),
                    f"model phase: greedy tokens differ: {want} vs {got}")
            toks.append(got.tolist())
            for name, r in runs.items():
                run[0] = name
                dev = r["state"]["lengths"].device
                lg, r["state"] = lm.decode_step(r["params"], want.to(dev),
                                                r["state"], cfg)
                r["logits"].append(lg)
            # decode tokens are one MoE group: row (0, b) is slot b
            last = [(s,) for _, s in flipped(2 + i)]
            close("decode_logits", card["logits"][-1], cpu["logits"][-1],
                  last)
            for (b,) in last:
                check_flipped(2 + i, (0, b), card["logits"][-1][b],
                              cpu["logits"][-1][b])
            close_state("decode_state")
    finally:
        moe_mod.moe_mlp = inner_moe
    rec = {"phase": "model", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
           "layers": [list(k) for k in zip(cfg.layer_kinds(),
                                           cfg.mlp_kinds())],
           "state": ("page pools" if paged
                     else "per-slot slabs and carries, compared"),
           "prompts": [n_prompt] * n_seq, "decode_steps": steps,
           "tol": tol, "max_abs_err": errs, "greedy_tokens": toks,
           "tokens_equal": True}
    if moe_layers:
        rec["moe_route_calls"] = len(routes["cpu"])
        rec["routing_flips"] = flips
        rec["route_tie"] = ROUTE_TIE
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# phase 5: serve each slice at full width
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


# the device kernels each wrapper launches per call: B1 a split and a
# reduce pass, B2 one kernel of its dtype, B4 three passes, the rest one
WRAPPER_KERNELS = {
    "flash_attention": (("flash_fwd_bf16_kernel", "flash_fwd_kernel"), 1),
    "paged_decode_attention": (("paged_decode_split_kernel",
                                "paged_decode_reduce_kernel"), 2),
    "wkv6_chunked": (WKV_CHUNKED_KERNELS, 3),
    "wkv6_decode": (("wkv6_decode_kernel",), 1),
    "ssm_decode_step": (("ssm_decode_kernel",), 1),
    "linear_scan": (("linear_scan_kernel",), 1),
    "moe_dispatch": (("moe_dispatch_kernel",), 1)}


def _kernel_name(key):
    """The port's __global__ name in a profiler row's key, or None."""
    for name in PORT_KERNELS:
        if f"::{name}<" in key or f"::{name}(" in key:
            return name
    return None


def _traced(torch, prof, wall, calls):
    """A profiler window's device-side rows (kernels, copies, memsets; an
    op's row repeats the device time of the kernels it launched): summed
    device time and busy share, the top ten rows, and per port kernel its
    device ms, launches and µs a launch. Each wrapper called in the window
    (``calls``) must show exactly its device kernels per call: that the
    trace saw every launch, and that B7 runs as one kernel, B4 as
    three."""
    from torch.autograd import DeviceType
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e[1])
    busy = sum(ms for _, ms, _ in events) / 1e3
    ours = {}
    for key, ms, n in events:
        name = _kernel_name(key)
        if name is not None:
            row = ours.setdefault(name, {"ms": 0.0, "launches": 0})
            row["ms"] += ms
            row["launches"] += n
    for row in ours.values():
        row["us_per_launch"] = 1e3 * row["ms"] / row["launches"]
    for wrapper, n_calls in calls.items():
        names, per_call = WRAPPER_KERNELS[wrapper]
        seen = sum(ours.get(k, {}).get("launches", 0) for k in names)
        require(seen == per_call * n_calls,
                f"trace: {wrapper} was called {n_calls} times but its "
                f"kernels {names} launched {seen} times, not "
                f"{per_call} a call")
    return {"wall_s": wall, "device_kernel_s": busy,
            "device_busy_share": busy / wall,
            "top_kernels_ms": [[k[:80], ms, n] for k, ms, n in events[:10]],
            "port_kernels": ours,
            "memsets": [[k[:80], ms, n] for k, ms, n in events
                        if k.startswith("Memset")],
            "wrapper_calls": calls}


def _profile(torch, device, fn):
    """Run ``fn`` under torch.profiler (CPU and CUDA) and return the
    profile, its wall time and each wrapper's calls in the window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.timing import Timer
    wrappers = _wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(torch, device)
    with profile(activities=acts) as prof:
        t = Timer()
        fn()
        sync(torch, device)
        wall = t.elapsed()
    calls = {n: w.launches - before[n] for n, w in wrappers.items()
             if w.launches > before[n]}
    return prof, wall, calls


def streams_digest(streams) -> str:
    """sha256 of a run's token streams ({req_id: tokens}), to compare runs
    of different code without printing every token."""
    import hashlib
    text = json.dumps({str(k): [int(t) for t in v]
                       for k, v in sorted(streams.items())})
    return hashlib.sha256(text.encode()).hexdigest()


def profile_decode_span(torch, cfg, params, ecfg, prompts, device):
    """Where a decode span's time goes: admit and prefill the first
    `slots` prompts with one engine step, then trace the next step (a
    pure decode span) with torch.profiler (``_traced``)."""
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, ecfg, device=device)
    for i, p in enumerate(prompts[:ecfg.slots]):
        eng.submit(Request(i, p.copy(), max_new_tokens=1 << 20))
    eng.step()
    steps = eng.stats["decode_steps"]
    prof, wall, calls = _profile(torch, device, eng.step)
    return {"decode_steps": eng.stats["decode_steps"] - steps,
            **_traced(torch, prof, wall, calls)}


def profile_prefill(torch, cfg, params, ecfg, prompt, device):
    """Where one monolithic prefill's time goes: a fresh engine admits
    one request of ``prompt``, which prefills it, under torch.profiler
    (``_traced``)."""
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, ecfg, device=device)
    eng.submit(Request(0, prompt.copy(), max_new_tokens=1 << 20))
    prof, wall, calls = _profile(torch, device, eng._admit)
    require(eng.stats["prefills"] == 1,
            f"traced prefill: {eng.stats['prefills']} prefills, not 1")
    return {"prompt_len": len(prompt), **_traced(torch, prof, wall, calls)}


def _wrappers():
    """Every kernel wrapper of the port (B1-B7), by kernel name; each
    counts its launches in ``.launches``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_decode as sd
    from repro_torch.kernels import wkv6 as wk
    return {"flash_attention": fa.flash_attention,
            "paged_decode_attention": pa.paged_decode_attention,
            "wkv6_chunked": wk.wkv6_chunked,
            "wkv6_decode": wk.wkv6_decode,
            "ssm_decode_step": sd.ssm_decode_step,
            "linear_scan": ls.linear_scan,
            "moe_dispatch": md.moe_dispatch}


def serve_path(cfg, layout):
    """The kernels a config's serving path on ``layout`` must launch,
    each mapped to the counters its launches follow and the number of
    layers that launch it once per count: attention layers run B2 once
    per prefill and, on the paged layout only, B1 once per decode step
    (the dense layout decodes attention in plain PyTorch, as the
    reference does in jnp); RWKV layers B4 once per prefill and B3 once
    per decode step; Mamba layers B6 once per 256-token prefill chunk
    (``prefill_chunks``, counted by ``phase_serve`` from the prompts) and
    B5 once per decode step; MoE layers B7 once per prefill and once per
    decode step."""
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    path = {}
    for name, n, counters in (
            ("flash_attention", kinds.count("attn"), ("prefills",)),
            ("paged_decode_attention",
             kinds.count("attn") if layout == "paged" else 0,
             ("decode_steps",)),
            ("wkv6_chunked", kinds.count("rwkv"), ("prefills",)),
            ("wkv6_decode", kinds.count("rwkv"), ("decode_steps",)),
            ("linear_scan", kinds.count("mamba"), ("prefill_chunks",)),
            ("ssm_decode_step", kinds.count("mamba"), ("decode_steps",)),
            ("moe_dispatch", mlps.count("moe") if cfg.moe else 0,
             ("prefills", "decode_steps"))):
        if n:
            path[name] = {c: n for c in counters}
    return path


def phase_serve(torch, cfg, ecfg, path, prompt_lens=PROMPT_LENS, max_new=32,
                seed=0, device="cuda", park_pages=None, trace_prefill=None):
    """Serve 8 requests with ``cfg`` (full width; the depth it gives).
    ``path`` (``serve_path``) maps each kernel the serving path must run
    to the counters its launches follow and the layers that launch it
    per count; every kernel's count is set to 0 just before the run and
    read just after, and must equal the sum over its counters of layers
    x count. The
    engine's counters stand beside ``prefill_chunks``, the 256-token
    chunks of Mamba prefill, which the prompts give once every prompt is
    prefilled exactly once (no preemption), as the run must. With
    ``park_pages`` a third run with that many pages must park, unpark and
    give the same streams. One decode span is traced, and with
    ``trace_prefill`` (a prompt length of ``prompt_lens``) that prompt's
    prefill too."""
    import dataclasses
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.models.mamba import CHUNK
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
    require(st["prefills"] == len(prompts) and st["preempt_restarts"] == 0,
            f"serve: {st['prefills']} prefills for {len(prompts)} prompts")
    counts = dict(st, prefill_chunks=sum(-(-n // CHUNK)
                                         for n in prompt_lens))
    for name, per in path.items():
        want = sum(n * counts[c] for c, n in per.items())
        terms = [f"{n} x {c} ({counts[c]})" for c, n in per.items()]
        require(launches[name] == want > 0,
                f"serve: {name} launches {launches[name]} != "
                f"{' + '.join(terms)}")
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
    traced_prefill = (None if trace_prefill is None else profile_prefill(
        torch, cfg, params, ecfg, prompts[prompt_lens.index(trace_prefill)],
        device))
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
           "launches": launches, "launch_path": path,
           "prefill_chunks": counts["prefill_chunks"], "stats": st,
           "completion_order": [r.req_id for r in done],
           "streams_sha256": streams_digest(streams),
           "streams_identical_across_runs": True,
           "parking_run": parking, "traced_decode_span": traced,
           "traced_prefill": traced_prefill}
    if torch.device(device).type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(rec)
    del params, eng
    return rec


# --------------------------------------------------------------------------

def ptxas_summary(log: str):
    """nvcc's ``-Xptxas -v`` output per compiled kernel: [entry (mangled,
    cut to 90 characters), spill line, registers and shared memory]."""
    rows, cur = [], None
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            cur = [ln.split("'")[1][:90] if "'" in ln else ln, "", ""]
            rows.append(cur)
        elif cur is not None and "spill" in ln:
            cur[1] = ln
        elif cur is not None and "registers" in ln:
            cur[2] = ln.split(":", 1)[-1].strip()
    return rows


def kernel_line(main, serves):
    """One row per kernel: its times at the main serving shape, its
    launches summed over the serve runs of the paths that run it (each
    path's own count in ``launches_by_path``). Every kernel must have run
    on exactly the paths that declare it, and on at least one."""
    rows = []
    for name, key, src, replaces, more in (
            ("flash_attention", ("flash", 1531), "flash_attention.cu",
             FLASH_REPLACES, (("flash", 200), ("flash", 1000),
                              ("flash_moonshot", 1000),
                              ("flash_moonshot", 1900),
                              ("flash_jamba", 1900))),
            ("paged_decode_attention", ("paged", 128), "paged_attention.cu",
             PAGED_REPLACES, (("paged", 16), ("paged_moonshot", 128))),
            ("wkv6_chunked", ("wkv6_chunked", 1531), "wkv6.cu",
             WKV_CHUNKED_REPLACES, (("wkv6_chunked", 200),
                                    ("wkv6_chunked", 1000))),
            ("wkv6_decode", ("wkv6_decode", 4), "wkv6.cu",
             WKV_DECODE_REPLACES, ()),
            ("ssm_decode_step", ("ssm_decode", 4), "ssm_decode.cu",
             SSM_DECODE_REPLACES, ()),
            ("linear_scan", ("linear_scan", 256), "linear_scan.cu",
             SCAN_REPLACES, (("linear_scan", 108),)),
            ("moe_dispatch", ("moe_dispatch", "prefill"), "moe_dispatch.cu",
             MOE_REPLACES, (("moe_dispatch", "decode"),
                            ("moe_dispatch_jamba", "prefill"),
                            ("moe_dispatch_jamba", "decode")))):
        rec = main[key]
        by_path = {s["arch"]: s["launches"][name] for s in serves
                   if s["launches"][name]}
        declared = {s["arch"] for s in serves if name in s["launch_path"]}
        require(by_path and set(by_path) == declared,
                f"{name} ran on the paths {sorted(by_path)}, not on "
                f"{sorted(declared)}")
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": rec["max_err"], "ms": rec["kernel_ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"],
               "library_ms": rec["library_ms"],
               "shape": rec["shape"], "checked": True}
        if "library" in rec:
            row["library"] = rec["library"]
        if "x_library" in rec:
            row["x_library"] = rec["x_library"]
        if more:
            row["also_at"] = [{k: main[m].get(k) for k in (
                "shape", "max_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "x_library")} for m in more]
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
    total = Timer()
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
              "ptxas": {n: ptxas_summary(log) for n, log in logs.items()}})
        main_shapes = phase_kernels(torch)
        cfg = get_config("qwen3-8b")
        rcfg = get_config("rwkv6-1.6b")
        mcfg = get_config("moonshot-v1-16b-a3b")
        # jamba at full width and half depth: 16 of 32 layers, two whole
        # periods of its 8-layer pattern (14 Mamba, 2 attention, 8 MoE
        # MLPs), 52.1 GB of bf16 weights; the whole model's 103 GB does
        # not fit one 80 GB card
        jcfg = get_config("jamba-v0.1-52b").scaled(n_layers=16)
        for c in (cfg, rcfg, mcfg):
            phase_model(torch, c.scaled(n_layers=2, dtype="float32"))
            gc.collect()
        # jamba's first two layers are both Mamba: the 2-layer model takes
        # an attention layer (dense MLP, first_dense) and a Mamba layer
        # (MoE MLP), ~14.5 GB of fp32 weights on each side
        phase_model(torch, jcfg.scaled(n_layers=2, dtype="float32",
                                       layer_pattern=("attn", "mamba")))
        gc.collect()
        serves = []
        # moonshot and jamba last, each alone on the card after the
        # others' weights are freed: moonshot's 56.7 GB of bf16 weights and
        # 640-page pool (4.0 GB), jamba's 52.1 GB; 200 pages make either
        # park (moonshot's largest request needs 121 pages, jamba's two
        # largest worst-case footprints 121 + 98 on the dense layout)
        # rwkv6's 1531-token prefill (B4) and moonshot's 1900-token one
        # (B7) are traced as well
        for c, layout, n_pages, park, traced in (
                (cfg, "paged", 640, None, None),
                (rcfg, "recurrent", 4, 3, 1531),
                (mcfg, "paged", 640, 200, 1900),
                (jcfg, "dense", 640, 200, None)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ecfg = EngineConfig(slots=4, cache_len=2048, page_size=16,
                                n_pages=n_pages, decode_span=8, eos_token=-1,
                                kv_layout=layout, prefill_chunk=0,
                                prefix_cache_entries=0)
            serves.append(phase_serve(torch, c, ecfg,
                                      serve_path(c, layout),
                                      park_pages=park,
                                      trace_prefill=traced))
        emit(kernel_line(main_shapes, serves))
        emit({"phase": "total", "seconds": total.elapsed()})
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
