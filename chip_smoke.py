#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only train [--train-layers N] [--arch A ...]
    python3 chip_smoke.py --only examples
    python3 chip_smoke.py --only ranks

The second builds the kernels and runs only the backward kernels' rows
(B2-bwd at qwen3-8b's train shape; the others for the other --arch
configs) and the training phases (8 below) of the --arch configs (all
four of TRAIN_ARCHS if none is given), then the dryrun phase over them,
printing no result line; the third and fourth build the kernels and run
only the examples phase or only the ranks phase, printing no result
line.

Phases, each printing one JSON object per line:

1. device  — card name, power limit (nvidia-smi), torch and CUDA versions;
2. build   — nvcc build of every kernel source in the checkout; fails if
             ptxas reports a spill in a B2-bwd tensor-core kernel;
3. kernels — each kernel (B1 paged decode, B2 flash prefill, B3 WKV-6
             decode, B4 WKV-6 chunked prefill, B5 SSM decode step, B6
             linear scan, B7 MoE dispatch) against its plain PyTorch
             version on the card, on the shape sweeps of
             tests/test_kernels.py, at the edges of each kernel's design
             and at the serving paths' shapes, with CUDA-event times of
             the kernel, the plain version and a library call where one
             exists (the host's work hidden behind a spin), and the bound;
             B2 also at h2o-danube-3-4b's shape (hd 120 padded to 128, a
             window of 4096, S 4500 and 7000, against SDPA with a band
             mask) and nemotron-4-15b's (G 6), B1 at nemotron's G 6 and
             musicgen-large's G 1 at hd 64; B2's (192, 128) instance (q/k
             192, v 128: MLA at full width) on its edge sweep and at
             deepseek-v2-lite-16b's prefill shape (H = KV = 16, S 1000 and
             1900) in fp32 and bf16, against SDPA at the same shape;
             B2's log-sum-exp and B2-bwd (training's backward) against
             their plain versions on a sweep (hd 16-128; G 1, 4, 6; S 1,
             63, 65, 200, 1000; window 0 and 48; fp32 and bf16) and,
             for B2-bwd's tensor-core (bf16) route, at every instance
             on its tile edges (S 64, 127-129; windows 0, 48, 64, 65),
             bit for bit across calls, and at qwen3-8b's train shape:
             bf16 beside SDPA's backward, fp32 within 4e-5; the training
             kernels of the other families against their plain
             versions, bit for bit across calls: B2-bwd's (192, 128)
             instance on a sweep and at deepseek-v2-lite-16b's H = KV =
             16, S 1900 and 4096 (beside SDPA's backward on its efficient
             backend), B7-bwd (exact) on the forward's sweep and at
             moonshot's prefill (T 11400, D 2048, E 64, C 223), B6-bwd on
             a sweep and at jamba's chunk (T 256, D 8192, N 16), B4-bwd on
             a sweep (S 1-300 around chunk edges, chunks 32 and 16, hd
             6-128) and at rwkv6-1.6b's H 32, hd 64, S 1531 and 4096;
4. model   — qwen3-8b, rwkv6-1.6b, moonshot-v1-16b-a3b, jamba-v0.1-52b,
             qwen1.5-4b, nemotron-4-15b, h2o-danube-3-4b, chameleon-34b,
             musicgen-large and deepseek-v2-lite-16b (decoding through its
             latent pools) at full width, 2 layers (jamba's an attention
             layer with a dense MLP and a Mamba layer with an MoE one),
             fp32 (TF32 off; nemotron and chameleon at 1 layer, for
             time): prefill and decode on the card (kernels)
             against the CPU (plain path) on the same weights, danube also
             at 1 layer on a 7000-token prompt past its window and 8 decode
             steps around its ring slabs (the rotary angles' bits at long
             positions); for the MoE models, any
             token whose top-k expert set differs between the two is
             reported with its router gap; for qwen3 and moonshot also a
             300-token prompt chained through ``prefill_chunk`` in 64-token
             chunks, card against CPU, and for qwen3 the card's chained
             logits against its monolithic ones (1e-4 of the logit scale);
5. serve   — qwen3-8b, nemotron-4-15b and moonshot-v1-16b-a3b through
             the paged engine, rwkv6-1.6b through the recurrent engine,
             h2o-danube-3-4b through the dense engine (prompts of 37-7000
             tokens around its window, cache_len 8192), deepseek-v2-lite-16b
             through the latent engine (B2's (192, 128) instance in every
             prefill), each at full width, qwen3 and rwkv6 at full depth,
             for time moonshot at 6 of 48 layers, deepseek at 4 of 27,
             danube at 6 of 24 and nemotron at 8 of 32, and
             jamba-v0.1-52b through the dense engine at
             full width and 8 of its 32 layers (its 103 GB of bf16
             weights do not fit one card), all in bf16: 8 requests,
             launch counts of the path's kernels, a second run that must
             give identical streams (qwen3's first run under the one-rank
             cuda mesh's sharding policy, through ``make_engine``, its
             second under NULL_POLICY with the digest recorded there, and
             its params laid out on ``serve_shardings`` by
             ``reshard_tree`` bit for bit; for rwkv6, danube, moonshot and
             jamba
             a third with fewer pages, which parks and must agree too;
             for deepseek as well),
             and one decode span traced with torch.profiler (and rwkv6's
             1531-token, danube's 7000-token, nemotron's, moonshot's and
             deepseek's 1900-token prefills), each port
             kernel's device ms and launches in the trace held to its
             wrapper's calls; then chunked prefill with the prefix cache:
             qwen3-8b on the paged engine at 5 and on the dense engine at
             4 of its 36 layers, 8 chat requests under one
             512-token system prompt in 256-token chunks, twice (equal
             streams, >= 4 prefix hits of 512 tokens each, launches held to
             the counters, the pool empty after), beside the same prompts
             without the cache and monolithically, with each request's time
             to first token and one traced chunk;
6. sampling — ``derive_keys``, ``sample_logits`` and ``token_logprob``
             on the card against the port's CPU path at qwen3's vocab
             (keys and bits bit for bit, Gumbel noise within 4 ulp, tokens
             under the margin rule with flips counted, logprobs within
             1e-5, bit for bit across calls and neighbours), one call's
             device µs and launches;
   substrate — an ``MQState`` op sequence whose rings wrap, on the card
             bit for bit against the CPU; ``batched_enqueue`` at
             moonshot's prefill shape bit for bit against B7's kernel
             (buffers and kept rows); one ``measure_ppu`` reading of B2 at
             qwen3's S 1000 beside a ``Pipeline``'s H100 bound, with the
             card's name and power limit; ``simulate`` at the reference
             tests' configurations and their claims;
   serve_sampled — qwen3-8b paged with the stochastic sampler: t = 0
             at full depth gives the greedy phase's digest; then at
             SAMPLED_LAYERS of its 36 layers, mixed SamplingParams
             (logprobs on half) give the same streams across runs, spans
             1 and 8, parking and batch neighbours; launches and host
             syncs held; a sampled traced span beside a greedy one (the
             sampler's device share);
   frontend — ``LocalFrontend`` over a poisson ``make_trace`` on the same
             engine with a VirtualClock: terminal outcomes, streams equal
             to ``tokens_out``, class 1 alone shed or rejected, two runs
             identical, per-class TTFT and TPOT;
7. crash   — crash and restore, each run built as
             ``repro_torch.ft.chaos.drive`` builds it (``ft.build_stack``,
             a ServingFaultInjector and a CrashInjector on the front end's
             step hooks): the front end's trace on qwen3-8b paged (36
             layers) with a snapshot every step and crashes at three
             boundaries (one on a park storm's, whose parked payloads must
             be in the snapshot restored there), then with a snapshot
             every 4 steps, a stale restore and class 1 replayed from
             zero: outcomes and streams equal the clean front-end run's
             (stamps too, with fresh snapshots); once through the
             Checkpointer's files onto a fresh engine; then rwkv6-1.6b
             recurrent and deepseek-v2-lite-16b latent, crashed on the
             first boundary after one request completed (its empty slot
             then decodes over restored state), and h2o-danube-3-4b dense
             (ring slabs; 700 pages, so the clean run must park and
             unpark) crashed on a boundary at which a request is parked,
             with the payload in the restored snapshot, at full width and
             depth, a clean and a crashed drive each with the same
             streams; every drive's launches held to (layers of its kind)
             x its counters summed over the engines it went through;
             snapshot bytes and the seconds to snapshot, restore, save and
             load;
8. model_grads — qwen3-8b, rwkv6-1.6b and deepseek-v2-lite-16b (its
             dense first layer and an MoE layer) at full width and 2
             layers, jamba-v0.1-52b at 1 (a Mamba layer), fp32: the loss
             and every gradient on the card against the CPU, the routed
             experts compared; then rwkv6-1.6b at RWKV_DEEP_LAYERS of
             its 24 layers and 4096 tokens in fp32, B4 and B4-bwd at each
             layer's own
             inputs against the plain version in float64, and the whole
             model's gradient with the WKV in four forms;
   train   — qwen3-8b at full width and TRAIN_LAYERS of its 36 layers,
             deepseek-v2-lite-16b at 7 of 27, rwkv6-1.6b at all 24,
             jamba-v0.1-52b at 1 of 32, in bf16 through
             ``repro_torch.launch.train`` (seq 4096, batch 2 in 2
             microbatches, remat): every step's loss, grad norm, lr
             and seconds, tokens/s, peak memory, every kernel's launches
             held to ``train_kernel_calls`` x microbatches x steps (the
             launcher trains under the one-rank cuda mesh's policy, its
             params on ``train_shardings``; qwen3's losses and grad norms
             equal to those recorded under NULL_POLICY), the
             loss falling on a repeated batch, one traced step (every
             B2-bwd call there on the tensor-core pair), and for
             deepseek two gradients of one batch bit for bit (NULL_POLICY
             against the launcher's policy); a run stopped
             at its step-4 checkpoint and resumed against the
             uninterrupted one (rwkv6-1.6b, 1 layer); the
             FaultTolerantTrainer's SR
             and GBN recovery on the trainer demo against its no-failure
             params; one qwen3-8b step also under the cost walk on the
             card, whose kernel calls and work must equal the dry run's
             walk of that step on meta;
   dryrun  — ``repro_torch.launch.dryrun``'s walk on meta of each train
             run's step, its predicted peak within 5% of the peak the
             train phase measured, beside the walk's bound seconds and the
             measured step seconds; the same for a 36-layer qwen3-8b
             prefill of 1900 tokens run here; the deepest qwen3-8b and
             deepseek-v2-lite-16b that fit the card's free bytes at the
             train runs' shape (``fit_depth``); the CUDA context, the
             libraries' memory and the cuBLAS workspace, which the walk
             leaves out;
   ranks   — four processes (``launch.mesh.spawn``) on a (2, 2)
             ("data", "model") mesh and a (2, 1, 2) ("pod", "data",
             "model") one, all on the one card over gloo (NCCL takes one
             GPU per rank), the kernels loaded from the build phase's
             directory: SMOKE qwen3-8b, qwen1.5-4b, moonshot-v1-16b-a3b,
             rwkv6-1.6b and jamba-v0.1-52b in fp32 (TF32 off), FSDP off
             and on, SP, and SP on the pod mesh: forward_loss's loss,
             stats and gathered gradients against the mean over the data
             shards of one-rank runs on the card (loss 1e-5 relative,
             gradients 1e-4 of each leaf's largest; rwkv6's no further
             from its float64 value on any leaf than the one-rank runs'
             plus 1e-4), each SP run also against the run before it;
             then qwen3-8b, moonshot and rwkv6 at 2 layers and jamba at
             1, at full width, bf16, batch 4 x 1024, under the launcher's
             production policy (SP, FSDP, ZeRO-1), 2 steps (qwen3,
             moonshot) or 4 on a repeated batch: losses finite and
             falling, step 1 within 2e-2 of the one-rank card run's, each
             rank's step seconds, peak memory and a step's collectives
             with their bytes; every rank's B2, B2-bwd, B4, B4-bwd, B6,
             B6-bwd, B7 and B7-bwd launches held to its gradient calls;
   examples — the six scripts of examples_torch/, each through its
             ``run`` on the card and, in worker processes meanwhile, on
             the CPU from the same weights and inputs: the quickstart on
             all ten SMOKE configs in fp32 (TF32 off; loss 1e-5, grad
             norm 1e-4, tokens under the margin rule) and at full width
             in bf16 for the six configs trained nowhere else here, at
             the depth (up to 2) the dry run's walk fits into the free
             bytes, the peak within 5% of the walk's, 4 steps on a
             repeated batch with the loss falling; serve_kv on SMOKE
             qwen3-8b in fp32 on both layouts, the three schedulers,
             prefill chunks 0 and 16, greedy and t = 0.8 (streams under
             the margin rule, every counter equal); serve_live,
             crash_recovery and ft_demo at their own sizes (outcomes,
             streams, crash logs, FT counters equal); train_lm's main at
             its 200 steps (the loss falling, tokens/s); the quickstart's
             main on its default device; every run's launches held to
             the model calls and gradients it made;
9. the kernels line, the total wall time, the nvidia-smi line, and the
   final ok line.

Every phase call prints its wall seconds on a line of its own.

Exits non-zero, printing no result, without a CUDA card or without the
rest of the repository, and on any failed check.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]

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
# The backward kernels have no Pallas kernel to replace: the reference
# differentiates its training attention through the jnp custom VJP
# `_flash_bwd`, and the other families through jax.grad of their jnp forms
# (the dispatch scatter of `_moe_mlp_local`, `_chunk_scan`, `wkv_chunked`)
FLASH_BWD_REPLACES = "src/repro/models/attention.py:119"
MOE_BWD_REPLACES = "src/repro/models/moe.py:237"
SCAN_BWD_REPLACES = "src/repro/models/mamba.py:76"
WKV_BWD_REPLACES = "src/repro/models/rwkv.py:105"
# the __global__ functions of src/repro_torch/kernels/csrc/: B1's split and
# reduce passes, B2's tensor-core (bf16) kernel, its (192, 128) instance
# named apart (MLA's q/k 192 with v 128), and its FMA (fp32) kernel, B4's
# three passes (chunk states, the scan of the carry, chunk outputs), B3,
# B5-B7, and the backward kernels
WKV_CHUNKED_KERNELS = ("wkv6_chunk_state_kernel", "wkv6_state_scan_kernel",
                       "wkv6_chunk_output_kernel")
FLASH_MLA_KERNEL = "flash_fwd_bf16_kernel<192, 128>"
# B2-bwd: a dk/dv pass and a dq pass a call, on the tensor cores for bf16
# (the train paths' type) and on the CUDA cores (FMA) for fp32; B4-bwd:
# B4's passes run backwards (every chunk's state and adjoint increments,
# the two carries over the chunks, every chunk's gradients), under names
# of its own
FLASH_BWD_BF16_KERNELS = ("flash_bwd_dkdv_bf16_kernel",
                          "flash_bwd_dq_bf16_kernel")
FLASH_BWD_KERNELS = (*FLASH_BWD_BF16_KERNELS, "flash_bwd_dkdv_kernel",
                     "flash_bwd_dq_kernel")
WKV_BWD_KERNELS = ("wkv6_bwd_chunk_state_kernel", "wkv6_bwd_scan_kernel",
                   "wkv6_bwd_chunk_grad_kernel")
PORT_KERNELS = ("paged_decode_split_kernel", "paged_decode_reduce_kernel",
                FLASH_MLA_KERNEL, "flash_fwd_bf16_kernel", "flash_fwd_kernel",
                *FLASH_BWD_KERNELS,
                *WKV_CHUNKED_KERNELS, "wkv6_decode_kernel", *WKV_BWD_KERNELS,
                "moe_dispatch_kernel", "moe_dispatch_bwd_kernel",
                "linear_scan_kernel", "linear_scan_bwd_kernel",
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

def seconds(phase: str, label: str, fn, *args, **kw):
    """Run one phase call and print its wall seconds on a line of its
    own."""
    from repro_torch.core.timing import Timer
    t = Timer()
    out = fn(*args, **kw)
    emit({"phase": phase, "label": label, "seconds": t.elapsed()})
    return out


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


def _work():
    """``repro_torch/kernels/work.py``: each kernel call's bytes and
    operations, the one count of the smoke, the dry run and the walk."""
    from repro_torch.kernels import work
    return work


def bound(work):
    """(ms, "bytes" or "operations") of a kernel call's work, priced at
    the H100 SXM's data-sheet peaks (dense): device memory rate and each
    input type's rate."""
    kw = _work()
    return kw.bound_s(work) * 1e3, kw.bound_by(work)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def sdpa_split_backends(torch, q, k, v):
    """SDPA's fused backends that take these q, k, v (a v head dim of its
    own): each tried alone; the ones that refuse raise."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    takes = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)
            torch.cuda.synchronize()
            takes.append(backend.name)
        except RuntimeError:
            pass
    return takes


def check_flash(torch, fa, B, H, KV, S, hd, dtype, window=0, seed=0,
                timed=True, hd_v=None):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    hd_v = hd_v or hd

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = rnd(B, H, S, hd), rnd(B, KV, S, hd), rnd(B, KV, S, hd_v)
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
    ok = ok and out.shape == (B, H, S, hd_v)
    b_ms, b_by = bound(_work().flash_attention(B, H, KV, S, hd, hd_v,
                                               window, name))
    shape = {"B": B, "H": H, "KV": KV, "S": S, "hd": hd, "window": window}
    if hd_v != hd:
        shape["hd_v"] = hd_v
    rec = {"phase": "kernels", "kernel": "flash_attention",
           "shape": shape, "dtype": name,
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
        if hd_v != hd:
            takes = sdpa_split_backends(torch, q, k, v)
            rec["library"] = (
                f"scaled_dot_product_attention; fused backends that take "
                f"q/k {hd} with v {hd_v}: "
                f"{', '.join(takes) if takes else 'none (the math path)'}")
    emit(rec)
    require(ok, f"flash_attention disagrees with its plain version: {rec}")
    return rec


def check_flash_padded(torch, fa, B, H, KV, S, hd, hd_v, dtype, seed=0):
    """B2 through the model's ``chunked_causal_attention`` at head dims
    (q/k ``hd``, v ``hd_v``) it has no instance for, zero-padded to the
    next built head dim and the output sliced back, or at the (192, 128)
    instance, unpadded; against the plain masked softmax on the unpadded
    tensors."""
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
           "route": ("chunked_causal_attention (the (192, 128) instance)"
                     if (hd, hd_v) in fa.INSTANCES else
                     "chunked_causal_attention (zero-padded head dims)"),
           "shape": {"B": B, "H": H, "KV": KV, "S": S, "hd": hd,
                     "hd_v": hd_v}, "dtype": name, "max_err": err,
           "tol": tol, "ok": ok}
    emit(rec)
    require(ok, f"chunked_causal_attention disagrees with the plain "
                f"attention: {rec}")
    return rec


def check_flash_bwd(torch, fa, B, H, KV, S, hd, dtype, window=0, seed=0,
                    timed=True, tol=None, hd_v=None):
    """B2's lse and B2-bwd against their plain versions on the same
    inputs, each within ``tol`` (by default TOL of the dtype) of max(1,
    |ref|); two calls give the same
    bits; B2 with and without lse the same out. Timed: B2-bwd, the plain
    backward, and as the library's, the backward of SDPA's forward +
    backward (causal only; at a v head dim of its own, ``hd_v``, on SDPA's
    efficient backend, which takes q/k 192 with v 128); B2 with and
    without lse beside them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = torch.Generator(device="cuda").manual_seed(seed)
    hd_v = hd_v or hd

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v, do = rnd(B, H, S, hd), rnd(B, KV, S, hd), rnd(B, KV, S, hd_v), \
        rnd(B, H, S, hd_v)
    out, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
    plain_out = fa.flash_attention(q, k, v, window=window)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    torch.cuda.synchronize()
    _, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          window=window, return_lse=True)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       out.float(), lse, do.float(),
                                       window=window)
    name = str(dtype).split(".")[-1]
    tol = tol or TOL[name]

    def rel(a, b):
        return float(((a.float() - b).abs() / b.abs().clamp(min=1)).max())
    errs = {"lse": rel(lse, ref_lse), "dq": rel(grads[0], ref[0]),
            "dk": rel(grads[1], ref[1]), "dv": rel(grads[2], ref[2])}
    repeats = all(torch.equal(a, b) for a, b in zip(grads, again))
    same_out = bool(torch.equal(out, plain_out))
    ok = max(errs.values()) <= tol and repeats and same_out
    # the function's work: five products a band pair; q, k, v, out, dout
    # and lse read once, dq, dk, dv written once
    b_ms, b_by = bound(_work().flash_attention_bwd(B, H, KV, S, hd, hd_v,
                                                   window, name))
    shape = {"B": B, "H": H, "KV": KV, "S": S, "hd": hd, "window": window}
    if hd_v != hd:
        shape["hd_v"] = hd_v
    rec = {"phase": "kernels", "kernel": "flash_attention_bwd",
           "shape": shape, "dtype": name,
           "max_err": max(errs.values()), "errs": errs, "tol": tol,
           "bit_equal_repeat": repeats, "lse_out_equal": same_out, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, window=window), torch)
        rec["plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, do, window=window), torch)
        rec["fwd_ms"] = time_ms(lambda: fa.flash_attention(
            q, k, v, window=window), torch)
        rec["fwd_lse_ms"] = time_ms(lambda: fa.flash_attention(
            q, k, v, window=window, return_lse=True), torch)
        # B2 with lse beside its plain version and SDPA's forward; its
        # bound: two products a pair, q, k, v read, out and lse written
        rec["fwd_plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, window=window, return_lse=True), torch)
        rec["fwd_bound_ms"], rec["fwd_bound_by"] = bound(
            _work().flash_attention(B, H, KV, S, hd, hd_v, window, name,
                                    lse=True))
        rec["library_ms"] = None
        if window == 0:
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            gqa = {"enable_gqa": True} if H != KV else {}
            if hd_v == hd:
                o = F.scaled_dot_product_attention(qs, ks, vs,
                                                   is_causal=True, **gqa)
                rec["library"] = ("the backward of "
                                  "scaled_dot_product_attention(is_causal, "
                                  "enable_gqa)")
            else:
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    o = F.scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=True, **gqa)
                rec["library"] = ("the backward of scaled_dot_product_"
                                  "attention(is_causal) on its efficient "
                                  "backend")
            rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
                o, (qs, ks, vs), do, retain_graph=True), torch)
            rec["x_library"] = rec["kernel_ms"] / rec["library_ms"]
            del o
            rec["fwd_library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, **gqa), torch)
    emit(rec)
    require(ok, f"flash_attention_bwd disagrees with its plain version: "
                f"{rec}")
    return rec


def check_flash_band(torch, fa, B, H, KV, S, hd, window, dtype, seed=0):
    """B2 as a sliding-window model calls it (h2o-danube-3-4b): q, k, v
    [B,n,S,hd] at a head dim B2 is not built for, zero-padded to the next
    built one, the unpadded scale passed, the output's first hd columns
    against the plain version on the unpadded tensors; two calls bit for
    bit. Timed: the kernel on the padded tensors, the plain version, and
    SDPA with a boolean band mask on the unpadded ones. The bound counts
    the band's pairs at hd."""
    import math
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = rnd(B, H, S, hd), rnd(B, KV, S, hd), rnd(B, KV, S, hd)
    P = next(d for d in fa.HEAD_DIMS if d >= hd)
    qp, kp, vp = (F.pad(t, (0, P - hd)).contiguous() for t in (q, k, v))
    scale = 1.0 / math.sqrt(hd)

    def kernel():
        return fa.flash_attention(qp, kp, vp, window=window, scale=scale)
    out = kernel()[..., :hd]
    again = kernel()[..., :hd]
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   window=window)
    name = str(dtype).split(".")[-1]
    err = float((out.float() - ref).abs().max())
    tol = TOL[name]
    repeats = bool(torch.equal(out, again))
    ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol)) \
        and repeats and bool(torch.equal(kernel()[..., hd:],
                                         torch.zeros_like(qp[..., hd:])))
    b_ms, b_by = bound(_work().flash_attention(B, H, KV, S, hd, hd, window,
                                               name))
    pos = torch.arange(S, device="cuda")
    band = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)
    rec = {"phase": "kernels", "kernel": "flash_attention",
           "route": "zero-padded head dim, sliding window",
           "shape": {"B": B, "H": H, "KV": KV, "S": S, "hd": hd,
                     "hd_padded": P, "window": window}, "dtype": name,
           "max_err": err, "tol": tol, "bit_equal_repeat": repeats,
           "ok": ok, "bound_ms": b_ms, "bound_by": b_by,
           "library_max_abs_err": float((library().float() - ref)
                                        .abs().max()),
           "kernel_ms": time_ms(kernel, torch),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(
               q, k, v, window=window), torch),
           "library_ms": time_ms(library, torch),
           "library": "scaled_dot_product_attention, boolean band mask"}
    rec["x_library"] = rec["kernel_ms"] / rec["library_ms"]
    emit(rec)
    require(ok, f"flash_attention (band) disagrees with its plain "
                f"version: {rec}")
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
    b_ms, b_by = bound(_work().paged_decode_attention(B, H, KV, hd, MP, page,
                                                      name, live=live))
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
    # what these inputs need, chunk by chunk; fp32 math, fp32 peak
    C = min(chunk, S)
    name = str(dtype).split(".")[-1]
    b_ms, b_by = bound(_work().wkv6_chunked(B, S, H, hd, C, name))
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
    b_ms, b_by = bound(_work().wkv6_decode(B, H, hd,
                                           str(dtype).split(".")[-1]))
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


def _dispatch_rows(torch, g, T, E, C, positions, seed, groups=1, tp=1):
    """Expert ids and queue positions. ``cumsum``: ids uniform over the
    experts, positions their cumsum, as the MoE layer computes them.
    ``sparse``: ids over E + E // 4 + 1 values (the rest out of range),
    and each expert's rows at distinct positions drawn at random from
    [0, max(2 C, its rows)): not dense from 0, permuted, some past C.
    ``mesh``: the last of ``tp`` model ranks on the expert-parallel path
    (``moe._routed_experts``): ``groups`` sequences of T / groups rows,
    each row's expert uniform over all tp * E / groups experts and its
    position that expert's cumsum in its sequence; a row the rank keeps
    takes queue g * E_loc + its local expert, any other (another rank's
    expert, or past C) queue E."""
    import numpy as np
    if positions == "mesh":
        e_loc, n = E // groups, T // groups
        ids = torch.randint(0, e_loc * tp, (groups, n), generator=g,
                            device="cuda")
        onehot = (ids[..., None] == torch.arange(e_loc * tp,
                                                 device="cuda")).to(
            torch.int32)
        pos = torch.cumsum(onehot, 1, dtype=torch.int32).gather(
            -1, ids[..., None])[..., 0] - 1
        local = ids - e_loc * (tp - 1)
        keep = (pos < C) & (local >= 0) & (local < e_loc)
        queue = torch.where(keep, local + e_loc * torch.arange(
            groups, device="cuda")[:, None], E)
        return queue.to(torch.int32).reshape(-1), pos.reshape(-1)
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
                       positions="cumsum", groups=1, tp=1):
    """Exact equality with the plain version, on rows placed as
    ``_dispatch_rows`` says."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randn(T, D, generator=g, device="cuda").to(dtype)
    eids, pos = _dispatch_rows(torch, g, T, E, C, positions, seed, groups,
                               tp)
    out = md.moe_dispatch(toks, eids, pos, E, C)
    torch.cuda.synchronize()
    ref = md.moe_dispatch_plain(toks, eids, pos, E, C)
    ok = bool(torch.equal(out, ref))
    keep = (eids >= 0) & (eids < E) & (pos >= 0) & (pos < C)
    kept = int(keep.sum())
    # kept rows read once, ids and positions read once, the whole buffer
    # written once; no arithmetic
    b_ms, b_by = bound(_work().moe_dispatch(T, D, E, C,
                                            str(dtype).split(".")[-1],
                                            kept=kept))
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
    b_ms, b_by = bound(_work().linear_scan(B, T, D, N))
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
    b_ms, b_by = bound(_work().ssm_decode_step(B, Di, N))
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


def check_moe_dispatch_bwd(torch, md, T, D, E, C, dtype, seed=0,
                           timed=True, positions="cumsum", groups=1, tp=1):
    """B7-bwd equal to its plain gather, on rows placed as
    ``_dispatch_rows`` says; two calls give the same bits."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dbuf = torch.randn(E, C, D, generator=g, device="cuda").to(dtype)
    eids, pos = _dispatch_rows(torch, g, T, E, C, positions, seed, groups,
                               tp)
    out = md.moe_dispatch_bwd(dbuf, eids, pos)
    again = md.moe_dispatch_bwd(dbuf, eids, pos)
    torch.cuda.synchronize()
    ref = md.moe_dispatch_bwd_plain(dbuf, eids, pos)
    repeats = bool(torch.equal(out, again))
    ok = bool(torch.equal(out, ref)) and repeats
    keep = (eids >= 0) & (eids < E) & (pos >= 0) & (pos < C)
    kept = int(keep.sum())
    # each kept row's slot read once, ids and positions read once, every
    # row of the gradient written once; no arithmetic
    name = str(dtype).split(".")[-1]
    b_ms, b_by = bound(_work().moe_dispatch_bwd(T, D, E, C, name, kept=kept))
    rec = {"phase": "kernels", "kernel": "moe_dispatch_bwd",
           "shape": {"T": T, "D": D, "E": E, "C": C},
           "positions": positions, "kept": kept, "dtype": name,
           "max_err": _max_err(torch, ((out, ref),)) if out.numel() else 0.0,
           "tol": 0.0, "bit_equal_repeat": repeats, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(
            lambda: md.moe_dispatch_bwd(dbuf, eids, pos), torch)
        rec["plain_ms"] = time_ms(
            lambda: md.moe_dispatch_bwd_plain(dbuf, eids, pos), torch)
        flat = dbuf.reshape(E * C, D)
        idx = torch.where(keep, eids.long() * C + pos.long(), 0)
        rec["library_ms"] = time_ms(lambda: torch.index_select(flat, 0, idx),
                                    torch)
        rec["library"] = ("torch.index_select of each row's slot (the "
                          "dropped rows' zeros not written)")
        rec["x_library"] = rec["kernel_ms"] / rec["library_ms"]
        # the two are close: six more rounds of each in turns (kernel,
        # library, library, kernel, ...), so that their spreads show
        # whether they differ
        fns = {"kernel": lambda: md.moe_dispatch_bwd(dbuf, eids, pos),
               "library": lambda: torch.index_select(flat, 0, idx)}
        turns = {"kernel": [], "library": []}
        for order in (("kernel", "library"), ("library", "kernel")) * 3:
            for who in order:
                turns[who].append(time_ms(fns[who], torch))
        rec["alternating_ms"] = turns
    emit(rec)
    require(ok, f"moe_dispatch_bwd is not equal to its plain version: {rec}")
    return rec


def check_linear_scan_bwd(torch, ls, B, T, D, N, seed=0, timed=True):
    """B6-bwd against its plain version at SSM_TOL (absolute and
    relative), the same bits on a second call."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(B, T, D, N, generator=g, device="cuda") * 0.5 + 0.5
    b, g_all = (torch.randn(B, T, D, N, generator=g, device="cuda")
                for _ in range(2))
    h0, g_last = (torch.randn(B, D, N, generator=g, device="cuda")
                  for _ in range(2))
    h_all, _ = ls.linear_scan(a, b, h0)
    got = ls.linear_scan_bwd(a, h0, h_all, g_all, g_last)
    again = ls.linear_scan_bwd(a, h0, h_all, g_all, g_last)
    torch.cuda.synchronize()
    ref = ls.linear_scan_bwd_plain(a, h0, h_all, g_all, g_last)
    repeats = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = repeats and all(torch.allclose(x, y, atol=SSM_TOL, rtol=SSM_TOL)
                         for x, y in zip(got, ref))
    # a, h_all and the gradient of h_all read once, da and db written once;
    # h0 and g_last read, dh0 written; an add and two multiplies an element
    # and step
    b_ms, b_by = bound(_work().linear_scan_bwd(B, T, D, N))
    rec = {"phase": "kernels", "kernel": "linear_scan_bwd",
           "shape": {"B": B, "T": T, "D": D, "N": N}, "dtype": "float32",
           "max_err": _max_err(torch, zip(got, ref)),
           "bit_equal": all(torch.equal(x, y) for x, y in zip(got, ref)),
           "bit_equal_repeat": repeats, "tol": SSM_TOL, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(lambda: ls.linear_scan_bwd(
            a, h0, h_all, g_all, g_last), torch)
        rec["plain_ms"] = time_ms(lambda: ls.linear_scan_bwd_plain(
            a, h0, h_all, g_all, g_last), torch)
        rec["library_ms"] = None
        rec["library"] = NO_SSM_LIBRARY
    emit(rec)
    require(ok, f"linear_scan_bwd disagrees with its plain version: {rec}")
    return rec


# B4-bwd against autograd through the chunked plain version: each gradient
# within these of its largest |value| (sums of up to S * hd terms in
# another order; dlogw through a carried difference), bf16 gradients to
# their rounding
WKV_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# B4-bwd's sweep lengths: one token, either side of one and two chunks of
# 32 (and of 16), a ragged tail and many chunks
WKV_BWD_SWEEP_S = (1, 31, 32, 33, 63, 64, 65, 70, 300)


def check_wkv6_bwd(torch, wk, B, S, H, hd, dtype, chunk=32, seed=0,
                   timed=True):
    """B4-bwd in chunks of ``chunk`` against its plain version
    (``torch.autograd.grad`` through ``wkv6_chunked_plain`` at the same
    chunk) on the same inputs, with a nonzero state0 and a gradient on the
    final state; two calls give the same bits."""
    r, k, v, logw, u, s0 = _wkv_inputs(torch, seed, B, S, H, hd, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(B, S, H, hd, generator=g, device="cuda")
    ds = torch.randn(B, H, hd, hd, generator=g, device="cuda")
    args = (r, k, v, logw, u, s0, dy, ds)
    got = wk.wkv6_chunked_bwd(*args, chunk=chunk)
    again = wk.wkv6_chunked_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    ref = wk.wkv6_chunked_bwd_plain(*args, chunk=chunk)
    names = ("dr", "dk", "dv", "dlogw", "du", "dstate0")
    errs = {n: float((x.float() - y.float()).abs().max())
            / max(float(y.float().abs().max()), 1e-30)
            for n, x, y in zip(names, got, ref)}
    tols = {n: WKV_BWD_TOL[str(x.dtype).split(".")[-1]]
            for n, x in zip(names, got)}
    repeats = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = repeats and all(errs[n] <= tols[n] for n in names)
    # what these inputs need: ~10 hd^2 flops a token and head (the
    # function's count, not the chunk form's larger one)
    name = str(dtype).split(".")[-1]
    b_ms, b_by = bound(_work().wkv6_chunked_bwd(B, S, H, hd, name))
    rec = {"phase": "kernels", "kernel": "wkv6_chunked_bwd",
           "shape": {"B": B, "S": S, "H": H, "hd": hd,
                     "chunk": min(chunk, S)}, "dtype": name,
           "max_err": max(errs.values()), "errs_of_leaf_max": errs,
           "tol": tols, "bit_equal_repeat": repeats, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["kernel_ms"] = time_ms(
            lambda: wk.wkv6_chunked_bwd(*args, chunk=chunk), torch)
        rec["plain_ms"] = time_ms(
            lambda: wk.wkv6_chunked_bwd_plain(*args, chunk=chunk), torch)
        rec["library_ms"] = None
        rec["library"] = NO_WKV_LIBRARY
    emit(rec)
    require(ok, f"wkv6_chunked_bwd disagrees with its plain version: {rec}")
    return rec


def phase_kernels_bwd(torch):
    """The training kernels' rows: B2-bwd at (192, 128), B7-bwd, B6-bwd
    and B4-bwd on their sweeps and at the train paths' shapes (moonshot's
    prefill dispatch, deepseek's MLA attention, jamba's scan chunk,
    rwkv6's prompt); returns the timed records by key."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import wkv6 as wk
    f32, bf16 = torch.float32, torch.bfloat16
    main = {}
    for dtype in (f32, bf16):
        for H, KV in ((4, 4), (8, 2)):
            for S in (1, 63, 65, 200, 1000):
                for window in (0, 48):
                    check_flash_bwd(torch, fa, 2, H, KV, S, 192, dtype,
                                    window=window, seed=S + H, timed=False,
                                    hd_v=128)
        for T, D, E, C in ((64, 32, 8, 12), (100, 16, 4, 40), (48, 7, 3, 5),
                           (64, 64, 8, 100), (0, 64, 4, 8),
                           (3000, 2048, 64, 60)):
            check_moe_dispatch_bwd(torch, md, T, D, E, C, dtype, seed=T + C,
                                   timed=False, positions="sparse")
        for S in WKV_BWD_SWEEP_S:
            for chunk in (32, 16):
                for hd in (6, 8, 64, 128):
                    check_wkv6_bwd(torch, wk, 2, S, 2, hd, dtype,
                                   chunk=chunk, seed=S + hd, timed=False)
    for B, T, D, N in ((2, 16, 8, 4), (1, 1, 16, 4), (3, 9, 32, 8),
                       (2, 33, 24, 16)):
        check_linear_scan_bwd(torch, ls, B, T, D, N, seed=T, timed=False)
    # the train paths' shapes: moonshot's 1900-token prefill dispatch (the
    # bwd of deepseek's is the same shape), deepseek's MLA attention (H =
    # KV = 16, q/k 192, v 128), jamba's 256-token scan chunk (D = d_inner
    # 8192, N 16), rwkv6's prompt (H 32, hd 64); timed in bf16 where the
    # model runs in it
    check_moe_dispatch_bwd(torch, md, 1900 * 6, 2048, 64, 223, f32,
                           timed=False)
    main[("moe_dispatch_bwd", "prefill")] = check_moe_dispatch_bwd(
        torch, md, 1900 * 6, 2048, 64, 223, bf16)
    for S in (1900, 4096):
        main[("flash_bwd_mla", S)] = check_flash_bwd(
            torch, fa, 1, 16, 16, S, 192, bf16, hd_v=128)
    main[("linear_scan_bwd", 256)] = check_linear_scan_bwd(
        torch, ls, 1, 256, 8192, 16)
    check_wkv6_bwd(torch, wk, 1, 1531, 32, 64, f32, timed=False)
    for S in (1531, 4096):
        main[("wkv6_bwd", S)] = check_wkv6_bwd(torch, wk, 1, S, 32, 64,
                                               bf16)
    return main


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
    # the (192, 128) instance (MLA: q/k 192 in three 64-column blocks, v
    # 128) on the same lengths, in both dtypes (fp32 on the FMA kernel)
    for dtype in (bf16, f32):
        for S in (1, 63, 64, 65, 200, 1531):
            for B, H, KV in ((2, 4, 4), (1, 8, 2)):
                check_flash(torch, fa, B, H, KV, S, 192, dtype, hd_v=128,
                            seed=S, timed=False)
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
        # and through it at the (192, 128) instance, unpadded
        for B, H, KV, S, hd, hd_v in ((1, 8, 2, 300, 120, 120),
                                      (2, 4, 1, 65, 120, 120),
                                      (1, 4, 4, 257, 48, 32),
                                      (2, 8, 8, 64, 48, 32),
                                      (1, 16, 16, 300, 192, 128)):
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
    # h2o-danube-3-4b's: H 32, KV 8, hd 120 through the padding to 128, a
    # window of 4096, on prompts past it (the serve phase's 4500 and 7000)
    for S in (4500, 7000):
        main[("flash_danube", S)] = check_flash_band(torch, fa, 1, 32, 8, S,
                                                     120, 4096, bf16)
    # nemotron-4-15b's: G = 6 (H 48, KV 8), hd 128; musicgen-large's: no
    # grouping (H = KV = 32) at hd 64
    for dtype in (f32, bf16):
        check_flash(torch, fa, 2, 48, 8, 333, 128, dtype, timed=False)
        check_flash(torch, fa, 2, 32, 32, 333, 64, dtype, timed=False)
        for H, KV, hd in ((48, 8, 128), (32, 32, 64)):
            check_paged(torch, pa, 7, H, KV, hd, 80, 16, 32, dtype,
                        timed=False, lengths=[0, 1, 16, 256, 257, 512, 600])
    main[("flash_nemotron", 1900)] = check_flash(torch, fa, 1, 48, 8, 1900,
                                                 128, bf16)
    main[("paged_nemotron", 128)] = check_paged(torch, pa, 4, 48, 8, 128,
                                                640, 16, 128, bf16)
    main[("paged_musicgen", 128)] = check_paged(torch, pa, 4, 32, 32, 64,
                                                640, 16, 128, bf16)
    # deepseek-v2-lite-16b's MLA prefill: H = KV = 16, q/k 192, v 128, in
    # both dtypes; the served path is bf16
    for S in (1000, 1900):
        main[("flash_mla", S)] = check_flash(torch, fa, 1, 16, 16, S, 192,
                                             bf16, hd_v=128)
        main[("flash_mla_fp32", S)] = check_flash(torch, fa, 1, 16, 16, S,
                                                  192, f32, hd_v=128)
    # B2's lse and B2-bwd (training) on the sweep: every square head dim,
    # G 1, 4 and 6, lengths ragged against the 64-row tiles, causal and a
    # window of 48; then at qwen3-8b's train shape
    for dtype in (f32, bf16):
        for hd in fa.HEAD_DIMS:
            for H, KV in ((4, 4), (8, 2), (6, 1)):
                for S in (1, 63, 65, 200, 1000):
                    for window in (0, 48):
                        check_flash_bwd(torch, fa, 2, H, KV, S, hd, dtype,
                                        window=window, seed=hd + S + H,
                                        timed=False)
    # the tensor-core (bf16) route at every instance, at its tile edges: a
    # tile, a ragged last tile, two tiles, windows of a tile and one past
    for hd, hd_v in fa.INSTANCES:
        for H, KV in ((4, 4), (8, 2), (6, 1)):
            for S in (64, 127, 128, 129):
                for window in (0, 48, 64, 65):
                    check_flash_bwd(torch, fa, 2, H, KV, S, hd, bf16,
                                    window=window,
                                    seed=hd + S + H + window, timed=False,
                                    hd_v=hd_v)
    main[("flash_bwd", 4096)] = check_flash_bwd_train(torch, fa)
    return main


def check_flash_bwd_train(torch, fa):
    """B2's lse and B2-bwd at qwen3-8b's train shape (B 1 per microbatch,
    H 32, KV 8, hd 128, S 4096): in bf16, the train path's type, timed
    beside SDPA's backward; and in fp32 within 4e-5, not the sweep's 2e-5
    (S <= 1000): the rounding of fp32 sums grows as the square root of
    their length, and 2e-5 * sqrt(4096 / 1000) is 4.05e-5. Returns the
    bf16 record."""
    rec = check_flash_bwd(torch, fa, 1, 32, 8, 4096, 128, torch.bfloat16)
    check_flash_bwd(torch, fa, 1, 32, 8, 4096, 128, torch.float32,
                    timed=False, tol=4e-5)
    return rec


# --------------------------------------------------------------------------
# phase 4: full-width model, card (kernels) against CPU (plain path)
# --------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _cpu_weights(torch, lm, cfg, seed, device):
    """fp32 weights from ``seed`` on the CPU, drawn by ``device``'s
    generator: the CPU's draws one value at a time on one core (~0.8 s
    for 1e8 values), which took most of the model and model_grads
    phases' time at full width."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return lm.init_params(cfg, gen, device="cpu", dtype=torch.float32)


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
    p_cpu = _cpu_weights(torch, lm, cfg, seed, device)
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

    # plain attention stacks decode through a page table, MLA stacks
    # through latent page pools; the others (RWKV, and jamba's attention +
    # Mamba) from per-slot slabs and carries, compared layer by layer
    # after prefill and each step
    paged = (tf.paged_stack_supported(cfg)
             or tf.latent_paged_stack_supported(cfg))

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
            want = lm.select_token(cpu["logits"][-1])[0]
            got = lm.select_token(card["logits"][-1])[0].cpu()
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
    chunked = (check_prefill_chunks(torch, cfg, runs, tokens[0],
                                    max_pages * page, tol)
               if tf.chunked_prefill_supported(cfg) else None)
    rec = {"phase": "model", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
           "layers": [list(k) for k in zip(cfg.layer_kinds(),
                                           cfg.mlp_kinds())],
           "state": ("latent page pools" if cfg.mla is not None
                     else "page pools" if paged
                     else "per-slot slabs and carries, compared"),
           "prompts": [n_prompt] * n_seq, "decode_steps": steps,
           "tol": tol, "max_abs_err": errs, "greedy_tokens": toks,
           "tokens_equal": True}
    if chunked is not None:
        rec["prefill_chunks"] = chunked
    if moe_layers:
        rec["moe_route_calls"] = len(routes["cpu"])
        rec["routing_flips"] = flips
        rec["route_tie"] = ROUTE_TIE
    emit(rec)
    return rec


def check_prefill_chunks(torch, cfg, runs, prompt, cache_len, tol,
                         chunk=64, mono_tol=1e-4):
    """``prompt`` chained through ``lm.prefill_chunk`` in ``chunk``-token
    chunks, on the card and on the CPU with ``phase_model``'s weights:
    each chunk's logits and the final caches within ``tol``. The tail
    chunk is padded past ``cache_len``, so its padding rows are dropped.
    Without MoE (whose capacity counts per chunk, not per prompt) the
    card's chained logits also equal its monolithic prefill's (B2) within
    ``mono_tol`` of the logit scale. The chain launches no B2 (chunks
    attend in plain PyTorch) and B7 once per MoE layer per chunk."""
    import numpy as np
    from repro_torch.models import lm
    wrappers = _wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    out = {}
    for name, r in runs.items():
        dev = r["state"]["lengths"].device
        caches = lm.init_serve_state(cfg, 1, cache_len, dtype=torch.float32,
                                     device=dev)["caches"]
        logits = []
        for pos in range(0, len(prompt), chunk):
            nv = min(chunk, len(prompt) - pos)
            x = np.zeros((1, chunk), np.int64)
            x[0, :nv] = prompt[pos:pos + nv]
            lg, caches = lm.prefill_chunk(r["params"],
                                          torch.as_tensor(x, device=dev),
                                          caches, pos, nv, cfg)
            logits.append(lg)
        out[name] = (torch.cat(logits).float().cpu(), caches)
    launched = {n: w.launches - before[n] for n, w in wrappers.items()}
    want = dict.fromkeys(launched, 0)
    want["moe_dispatch"] = (cfg.mlp_kinds().count("moe") if cfg.moe
                            else 0) * len(logits)
    require(launched == want,
            f"model phase: the chunk chain launched {launched}, not {want}")

    def err(a, b, what):
        a, b = a.float().cpu(), b.float().cpu()
        e = float((a - b).abs().max())
        require(bool(torch.allclose(a, b, atol=tol, rtol=tol)),
                f"model phase: chunked {what} differs beyond {tol} "
                f"(max abs {e})")
        return e
    rec = {"prompt_len": len(prompt), "chunk": chunk,
           "cache_len": cache_len, "tol": tol, "launches": launched,
           "logits_max_abs_err": err(out["card"][0], out["cpu"][0],
                                     "logits"),
           "cache_max_abs_err": max(
               err(a[k], b[k], f"cache {k}")
               for a, b in zip(out["card"][1], out["cpu"][1]) for k in a)}
    if cfg.moe is None:
        mono = runs["card"]["logits"][0][0].float().cpu()
        scale = float(mono.abs().max())
        e = float((out["card"][0][-1] - mono).abs().max())
        require(e <= mono_tol * scale,
                f"model phase: chunked logits on the card differ from "
                f"monolithic by {e}, beyond {mono_tol} x the logit scale "
                f"{scale}")
        rec.update(monolithic_max_abs_err=e, logit_scale=scale,
                   monolithic_tol=mono_tol * scale)
    return rec


# --------------------------------------------------------------------------
# phase 5: serve each slice at full width
# --------------------------------------------------------------------------

PROMPT_LENS = (37, 200, 333, 517, 1000, 1024, 1531, 1900)
# h2o-danube-3-4b (window 4096): 4080 + 32 new tokens wraps the ring in
# mid-span, 4096 fills it exactly, the last three prefill through B2's
# band and roll the ring
DANUBE_PROMPT_LENS = (37, 1000, 3000, 4080, 4096, 4500, 6000, 7000)
DANUBE_LONG = 7000      # the model phase's prompt past danube's window
# the configs of ROADMAP item A6, each in the model phase at 2 layers
DENSE_FAMILY = ("qwen1.5-4b", "nemotron-4-15b", "h2o-danube-3-4b",
                "chameleon-34b", "musicgen-large")


def _serve_once(torch, cfg, params, ecfg, prompts, max_new, device,
                sampling=None, req_ids=None, policy=None):
    """Serve ``prompts`` once (request i with ``sampling[i]``, default
    greedy, and id ``req_ids[i]``, default i) on an engine from
    ``make_engine`` under ``policy`` (None: NULL_POLICY). Returns (engine,
    completed, wall s, meas):
    ``meas`` holds the synchronized time spent in monolithic prefills
    and in prefill chunks (``prefill_s``), the number of monolithic
    prefills (``full_prefills``: the engine counts prefills and chunks,
    not which kind ran) and each request's time to first token from the
    start of the run (``ttft_s``), all from wrappers that only measure."""
    from repro_torch.core.timing import Timer
    from repro_torch.serve.api import Request, make_engine
    eng = make_engine(cfg, params, ecfg, device=device, policy=policy)
    meas = {"prefill_s": 0.0, "full_prefills": 0, "ttft_s": {}}
    run = [None]

    def timed(inner, full):                    # measurement only
        def call(*args):
            sync(torch, device)
            t = Timer()
            out = inner(*args)
            sync(torch, device)
            meas["prefill_s"] += t.elapsed()
            meas["full_prefills"] += full
            return out
        return call
    eng._prefill_full = timed(eng._prefill_full, 1)
    eng._process_chunk = timed(eng._process_chunk, 0)
    finish = eng._finish_prefill

    def first_token(slot, req, *rest):         # measurement only
        meas["ttft_s"][req.req_id] = run[0].elapsed()
        return finish(slot, req, *rest)
    eng._finish_prefill = first_token
    for i, p in enumerate(prompts):
        kw = {} if sampling is None else {"sampling": sampling[i]}
        eng.submit(Request(i if req_ids is None else req_ids[i], p.copy(),
                           max_new_tokens=max_new, **kw))
    sync(torch, device)
    run[0] = Timer()
    done = eng.run_until_done()
    sync(torch, device)
    return eng, done, run[0].elapsed(), meas


# the device kernels each wrapper launches per call: B1 a split and a
# reduce pass, B2 one kernel of its dtype, B2-bwd the two passes of its
# dtype, B4 and B4-bwd three passes, the rest one
WRAPPER_KERNELS = {
    "flash_attention": ((FLASH_MLA_KERNEL, "flash_fwd_bf16_kernel",
                         "flash_fwd_kernel"), 1),
    "flash_attention_bwd": (FLASH_BWD_KERNELS, 2),
    "paged_decode_attention": (("paged_decode_split_kernel",
                                "paged_decode_reduce_kernel"), 2),
    "wkv6_chunked": (WKV_CHUNKED_KERNELS, 3),
    "wkv6_decode": (("wkv6_decode_kernel",), 1),
    "ssm_decode_step": (("ssm_decode_kernel",), 1),
    "linear_scan": (("linear_scan_kernel",), 1),
    "moe_dispatch": (("moe_dispatch_kernel",), 1),
    "moe_dispatch_bwd": (("moe_dispatch_bwd_kernel",), 1),
    "linear_scan_bwd": (("linear_scan_bwd_kernel",), 1),
    "wkv6_chunked_bwd": (WKV_BWD_KERNELS, 3)}


def _kernel_name(key):
    """The port's __global__ name (or named template instance) in a
    profiler row's key, or None."""
    for name in PORT_KERNELS:
        if f"::{name}<" in key or f"::{name}(" in key:
            return name
    return None


def _traced(torch, win):
    """A profiler window's (``_profile``) device-side rows (kernels,
    copies, memsets; an op's row repeats the device time of the kernels
    it launched): summed device time and busy share, the top ten rows,
    and per port kernel its device ms, launches and µs a launch. Each
    wrapper called in the window must show exactly its device kernels per
    call: that the trace saw every launch, and that B7 runs as one
    kernel, B4 as three."""
    from torch.autograd import DeviceType
    wall, calls = win["wall_s"], win["calls"]
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in win["rows"]
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
                f"{per_call} a call (the trace lost {win['pad_dropped']} "
                f"of the {PAD_LAUNCHES} empty kernels ahead of the window)")
    return {"wall_s": wall, "device_kernel_s": busy,
            "device_busy_share": busy / wall,
            "device_ops": sum(n for _, _, n in events),
            "top_kernels_ms": [[k[:80], ms, n] for k, ms, n in events[:10]],
            "port_kernels": ours,
            "memsets": [[k[:80], ms, n] for k, ms, n in events
                        if k.startswith("Memset")],
            "wrapper_calls": calls, "pad_dropped": win["pad_dropped"]}


# torch.profiler loses the kernel records of the first launches of a
# session, as a rule more with every session the process has opened (on
# the H100: none in the first, 21 in the 40th; scripts/
# trace_completeness.py), once 443 in the sixth. Each window therefore
# opens with PAD_LAUNCHES empty kernels and a synchronize, ahead of the
# WORK annotation. The window's host events are read from the
# annotation's start on, its device records from the last empty kernel's
# end on: the two clocks drift apart within a session (on the H100 a
# kernel's record started up to 6.9 ms before its own launch, and in 6 of
# 112 sessions records of the window before the annotation's host start;
# scripts/trace_completeness.py --arch rwkv6-1.6b), while on the device's
# clock every record of the window follows the empty kernels.
PAD_LAUNCHES = 4096
WORK = "chip_smoke.work"


def _profile(torch, device, fn):
    """Run ``fn`` under torch.profiler (CPU and CUDA): the window's rows
    (the events from ``fn``'s start on, summed by key and device, as
    ``key_averages`` sums them), its wall
    time, each wrapper's calls in it, on the card how many of the
    PAD_LAUNCHES empty kernels launched ahead of it the trace lost, and the
    profiler itself (``scripts/trace_completeness.py`` reads its raw
    records). At least one empty kernel must show: the lost records are
    the session's first, so then none of ``fn``'s is lost. Host events
    count from the annotation's start, device records from the end of the
    last empty kernel, each on its own clock."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.timing import Timer
    wrappers = _wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    sync(torch, device)
    with profile(activities=acts) as prof:
        if cuda:
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(0)
            sync(torch, device)
        with record_function(WORK):
            t = Timer()
            fn()
            sync(torch, device)
            wall = t.elapsed()
    calls = {n: w.launches - before[n] for n, w in wrappers.items()
             if w.launches > before[n]}
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == WORK and e.device_type == DeviceType.CPU)
    pad = [e for e in events if e.device_type != DeviceType.CPU
           and "spin_kernel" in e.name]
    dropped = PAD_LAUNCHES - len(pad) if cuda else 0
    require(dropped < PAD_LAUNCHES,
            f"trace: the profiler lost all {PAD_LAUNCHES} empty kernels "
            f"ahead of the window, so it may have lost the window's own")
    device_start = max(e.time_range.end for e in pad) if cuda else start
    rows = {}
    for e in events:
        on_device = e.device_type != DeviceType.CPU
        if e.name != WORK and e.time_range.start >= (
                device_start if on_device else start):
            row = rows.setdefault((e.key, e.device_type), SimpleNamespace(
                key=e.key, device_type=e.device_type, count=0,
                self_device_time_total=0.0, self_cpu_time_total=0.0))
            row.count += 1
            row.self_device_time_total += e.self_device_time_total
            row.self_cpu_time_total += e.self_cpu_time_total
    return {"rows": list(rows.values()), "wall_s": wall, "calls": calls,
            "pad_dropped": dropped, "prof": prof}


# --------------------------------------------------------------------------
# training: gradients card vs CPU, the launcher's run, resume, FT recovery
# --------------------------------------------------------------------------

# qwen3-8b trained at full width and 14 of its 36 layers, the deepest that
# fits one 80 GB card: AdamW keeps 16 bytes a parameter (bf16 param and
# gradient, fp32 master, m, v) and gradient accumulation over microbatches
# 4 more (fp32); on the H100 (``--only train --train-layers N``) 12 and
# 14 layers peaked at 72.59 and 80.30 GB, ~3.86 GB a layer, so 16 would
# need ~88 GB. The other families at full width: deepseek-v2-lite-16b at
# 7 of 27 layers (its dense first layer and 6 MoE layers), the deepest
# that fits at seq 4096: on the H100 it peaked at 58.47, 70.17 and 81.87
# GB at 5, 6 and 7 layers, ~11.7 GB a MoE layer, so 8 would need ~93.6;
# rwkv6-1.6b at all 24 (~32 GB), jamba-v0.1-52b at 1 (a Mamba layer
# with a dense MLP: one of its MoE layers alone holds 2.82 B parameters,
# ~56 GB of state, so jamba's MoE trains on the card only through B7's
# rows and deepseek)
TRAIN_LAYERS = 14
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_MICROBATCH = 2
TRAIN_RUNS = {
    "qwen3-8b": {"layers": TRAIN_LAYERS, "seq": TRAIN_SEQ, "steps": 8},
    "deepseek-v2-lite-16b": {"layers": 7, "seq": TRAIN_SEQ, "steps": 4},
    "rwkv6-1.6b": {"layers": 24, "seq": TRAIN_SEQ, "steps": 4},
    "jamba-v0.1-52b": {"layers": 1, "seq": TRAIN_SEQ, "steps": 4}}
TRAIN_DIR = ROOT / "build" / "smoke_train"


def _train_args(arch, layers, steps, ckpt_dir, *more, seq=None):
    return ["--arch", arch, "--layers", str(layers), "--seq",
            str(seq or TRAIN_RUNS[arch]["seq"]), "--batch", str(TRAIN_BATCH),
            "--microbatch", str(TRAIN_MICROBATCH), "--steps", str(steps),
            "--ckpt-dir", str(ckpt_dir), *more]


def _reset_launches():
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def train_kernel_calls(cfg, seq, remat=True):
    """The wrapper calls of one gradient of ``cfg`` on ``seq`` tokens
    (tests/test_torch_train_families.py pins them on the CPU): attention
    layers B2 and B2-bwd, RWKV layers B4 and B4-bwd, MoE MLPs B7 and
    B7-bwd, once each a layer, the forward kernel once more in the replay
    of a rematerialised block (every block past the reference's prefix);
    Mamba layers B6 twice a 256-token chunk (the chunk's own checkpoint
    replays it), three times in a rematerialised block, and B6-bwd once a
    chunk."""
    from repro_torch.models import transformer as tf
    n_prefix = len(tf.plan_layers(cfg)[0])
    chunks = -(-seq // 256)
    calls = {}

    def add(name, n):
        calls[name] = calls.get(name, 0) + n
    for i, (kind, mlp) in enumerate(zip(cfg.layer_kinds(),
                                        cfg.mlp_kinds())):
        replay = int(remat and i >= n_prefix)
        fwd, bwd = {"attn": ("flash_attention", "flash_attention_bwd"),
                    "rwkv": ("wkv6_chunked", "wkv6_chunked_bwd"),
                    "mamba": ("linear_scan", "linear_scan_bwd")}[kind]
        per = chunks if kind == "mamba" else 1
        add(fwd, per * (1 + replay + (kind == "mamba")))
        add(bwd, per)
        if mlp == "moe" and cfg.moe is not None and kind != "rwkv":
            add("moe_dispatch", 1 + replay)
            add("moe_dispatch_bwd", 1)
    return calls


def _train_launches(label, wrappers, cfg, seq, grad_calls, remat=True):
    """Every kernel launched exactly ``train_kernel_calls`` x grad calls,
    every other kernel never; returns the record ``kernel_line`` reads."""
    per = train_kernel_calls(cfg, seq, remat)
    launches = {n: w.launches for n, w in wrappers.items()}
    want = {n: c * grad_calls for n, c in per.items()}
    require(all(launches[n] == want.get(n, 0) for n in launches)
            and grad_calls > 0,
            f"train {label}: launches {launches} != {want} "
            f"({per} x {grad_calls} gradient calls)")
    return {"label": label, "launches": launches, "mla": cfg.mla is not None,
            "launch_path": {n: {"grad_calls": c} for n, c in per.items()}}


def _record_routes(moe_mod):
    """Record every MoE layer's experts (``moe.route``'s top-k ids) until
    the returned ``undo`` is called."""
    routes, route = [], moe_mod.route

    def rec(*a):
        out = route(*a)
        routes.append(out[2])
        return out
    moe_mod.route = rec

    def undo():
        moe_mod.route = route
    return routes, undo


def phase_model_grads(torch, cfg, n_seq=2, n_tok=200, seed=0,
                      device="cuda"):
    """Loss and every gradient of ``cfg`` (fp32, TF32 off) on the card
    (every kernel of its path and their backwards, remat) against the CPU
    (the plain versions) on the same weights and tokens: the loss within
    1e-5 relative, each gradient within 1e-3 of its leaf's largest |g| on
    the CPU; for an MoE config the routed experts of the forward compared
    first, flips reported with the router's gap."""
    import numpy as np
    from repro_torch.core.tree import leaves
    from repro_torch.models import lm, moe
    from repro_torch.train.train_step import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p_cpu = _cpu_weights(torch, lm, cfg, seed, device)
    p_gpu = _to(p_cpu, device)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(n_seq, n_tok)).astype(np.int32)
    routes, undo = _record_routes(moe)
    try:
        (l_cpu, m_cpu), g_cpu = value_and_grad(p_cpu, torch.from_numpy(toks),
                                               cfg)
        n_cpu = len(routes)
        wrappers = _reset_launches()
        (l_gpu, m_gpu), g_gpu = value_and_grad(
            p_gpu, torch.as_tensor(toks, device=device), cfg)
        sync(torch, device)
    finally:
        undo()
    path = _train_launches(f"{cfg.name} grads", wrappers, cfg, n_tok, 1)
    n_moe = cfg.mlp_kinds().count("moe") if cfg.moe is not None else 0
    flips = sum(int((a.cpu() != b).any(-1).sum())
                for a, b in zip(routes[n_cpu:n_cpu + n_moe],
                                routes[:n_moe]))
    loss_err = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    worst, worst_leaf = 0.0, None
    for i, (a, b) in enumerate(zip(leaves(g_gpu), leaves(g_cpu))):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_leaf = err, i
    rec = {"phase": "model_grads", "config": cfg.name,
           "layers": cfg.n_layers, "tokens": [n_seq, n_tok],
           "loss_cpu": float(l_cpu), "loss_card": float(l_gpu),
           "loss_rel_err": loss_err, "grad_err_of_leaf_max": worst,
           "worst_leaf": worst_leaf,
           "stats": {k: [float(m_cpu[k]), float(m_gpu[k])] for k in m_cpu},
           "route_flips": flips, "launches": path["launches"],
           "ok": loss_err <= 1e-5 and worst <= 1e-3}
    emit(rec)
    require(rec["ok"], f"model grads: card vs CPU {rec}")
    return rec


# rwkv6-1.6b at the length it trains at (S 4096) and 8 of its 24 layers:
# all 24 took 70-77 s of the smoke; 8 still grow the output gradient
# layer by layer down the stack, and each layer's B4 and B4-bwd are judged
# at its own inputs
RWKV_DEEP_LAYERS, RWKV_DEEP_SEQ = 8, 4096
WKV_GRAD_NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")


def _leaf_names(tree, prefix=""):
    """Leaf paths of a params tree in ``leaves``' order (keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, x in enumerate(tree)
                for n in _leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


def _err_of_max(got, ref):
    """max |got - ref| over max |ref|."""
    return (float((got.double() - ref.double()).abs().max())
            / max(float(ref.abs().max()), 1e-300))


def phase_rwkv_deep_grads(torch, layers=RWKV_DEEP_LAYERS, seq=RWKV_DEEP_SEQ,
                          seed=0, device="cuda"):
    """B4 and B4-bwd at the inputs rwkv6-1.6b's training gives them. The
    fp32 model (full width, ``layers`` layers, TF32 off, weights from
    ``seed``) takes its gradient on the data pipeline's first batch of
    ``seq`` tokens through the kernels, recording each layer's (r, k, v,
    logw, u, state0) and the gradient of its output. At those inputs every
    layer's B4-bwd must lie within ``WKV_BWD_TOL`` of each gradient's
    largest |value| from the plain version in float64, and B4's y and
    final state within ``WKV_TOL``; the plain version in fp32 is reported
    beside them. The whole model's gradient is also taken with the WKV in
    three other forms: the plain version (fp32), B4's forward with the
    plain backward, and the plain version in float64 inside the fp32
    stack; their norms and worst leaves against the plain version's say
    where a difference of the whole gradient comes from."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data import DataConfig, SyntheticPackedDataset
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import lm, rwkv
    from repro_torch.train.train_step import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("rwkv6-1.6b").scaled(n_layers=layers, dtype="float32")
    params = lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    names = _leaf_names(params)
    toks = torch.as_tensor(SyntheticPackedDataset(DataConfig(
        seq_len=seq, global_batch=1,
        vocab_size=cfg.vocab_size)).next_batch()[0], device=device)
    kernel, calls = rwkv.wkv6_chunked, []

    def recorded(*args, chunk):
        y, s_out = kernel(*args, chunk=chunk)
        rec = [t.detach() for t in args]
        y.register_hook(rec.append)     # fires in the backward: dy
        calls.append(rec)
        return y, s_out

    class B4PlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return wk.wkv6_chunked(*args)       # grad off here: B4
        @staticmethod
        def backward(ctx, dy, ds_out):
            return wk.wkv6_chunked_bwd_plain(*ctx.saved_tensors, dy, ds_out)

    def wkv64(*args, chunk):
        y, s_out = wk.wkv6_chunked_plain(*(t.double() for t in args),
                                         chunk=chunk)
        return y.float(), s_out.float()

    whole, grads = {}, {}
    for mode, fn in (
            ("kernels", recorded),
            ("plain", lambda *a, chunk: wk.wkv6_chunked_plain(*a,
                                                              chunk=chunk)),
            ("b4_fwd_plain_bwd", lambda *a, chunk: B4PlainBwd.apply(*a)),
            ("plain_fp64_wkv", wkv64)):
        wrappers = _reset_launches()
        rwkv.wkv6_chunked = fn
        try:
            (loss, _), g = value_and_grad(params, toks, cfg)
            sync(torch, device)
        finally:
            rwkv.wkv6_chunked = kernel
        if mode == "kernels":
            path = _train_launches("rwkv6-1.6b deep grads", wrappers, cfg,
                                   seq, 1)
            # the first forward's calls (the remat replay's see no gradient)
            calls = [c for c in calls if len(c) == 7]
        norms = [float(x.norm()) for x in leaves(g)]
        whole[mode] = {"loss": float(loss),
                       "grad_norm": sum(n * n for n in norms) ** 0.5,
                       "largest_leaf": max(zip(norms, names))}
        grads[mode] = leaves(g)
        if mode != "plain" and "plain" in grads:
            whole[mode]["worst_leaf_vs_plain"] = max(
                (_err_of_max(x, y), n)
                for x, y, n in zip(grads[mode], grads["plain"], names))
            if mode != "kernels":
                del grads[mode]
    whole["kernels"]["worst_leaf_vs_plain"] = max(
        (_err_of_max(x, y), n)
        for x, y, n in zip(grads["kernels"], grads["plain"], names))
    del params, g, grads
    require(len(calls) == layers,
            f"rwkv deep grads: {len(calls)} recorded layers, not {layers}")
    rows = []
    for i, (r, k, v, logw, u, s0, dy) in enumerate(calls):
        fwd = (r, k, v, logw, u, s0)
        ins = (*fwd, dy, torch.zeros_like(s0))
        ref = wk.wkv6_chunked_bwd_plain(*(t.double() for t in ins))
        ref_fwd = wk.wkv6_chunked_plain(*(t.double() for t in fwd))
        rows.append({
            "layer": i, "dy_max": float(dy.abs().max()),
            "kernel": [_err_of_max(a, b) for a, b in
                       zip(wk.wkv6_chunked_bwd(*ins), ref)],
            "plain32": [_err_of_max(a, b) for a, b in
                        zip(wk.wkv6_chunked_bwd_plain(*ins), ref)],
            "kernel_fwd": [_err_of_max(a, b) for a, b in
                           zip(wk.wkv6_chunked(*fwd), ref_fwd)],
            "plain32_fwd": [_err_of_max(a, b) for a, b in
                            zip(wk.wkv6_chunked_plain(*fwd), ref_fwd)]})
        calls[i] = None
    worst = {src: {n: max((row[src][j], row["layer"]) for row in rows)
                   for j, n in enumerate(names_)}
             for src, names_ in (("kernel", WKV_GRAD_NAMES),
                                 ("plain32", WKV_GRAD_NAMES),
                                 ("kernel_fwd", ("y", "s_out")),
                                 ("plain32_fwd", ("y", "s_out")))}
    tol = {"bwd": WKV_BWD_TOL["float32"], "y": WKV_TOL["y"],
           "s_out": WKV_TOL["state"]}
    rec = {"phase": "model_grads", "config": "rwkv6-1.6b deep",
           "layers": layers, "seq": seq, "dtype": "float32",
           "whole_model": whole, "launches": path["launches"],
           "worst_vs_fp64": worst, "tol": tol, "per_layer": rows,
           "ok": all(max(row["kernel"]) <= tol["bwd"]
                     and row["kernel_fwd"][0] <= tol["y"]
                     and row["kernel_fwd"][1] <= tol["s_out"]
                     for row in rows)}
    emit(rec)
    require(rec["ok"], f"rwkv deep grads: B4 or B4-bwd off the float64 "
                       f"plain version at a layer's inputs: {worst}")
    return rec


# qwen3-8b's launcher run (TRAIN_RUNS' shape, seed 0) under NULL_POLICY, as
# every earlier run of this smoke on the H100 printed it: each step's loss and
# grad norm
QWEN3_TRAIN_RECORDED = {
    "loss": [12.425285339355469, 12.389644622802734, 12.334150314331055,
             12.34109115600586, 12.260810852050781, 12.313909530639648,
             12.363676071166992, 12.286863327026367],
    "grad_norm": [5.114385604858398, 5.342330455780029, 5.814235210418701,
                  5.501197338104248, 6.119911193847656, 5.212170600891113,
                  5.3128814697265625, 3.2933316230773926]}


def phase_train(torch, arch="qwen3-8b", layers=None, seq=None,
                device="cuda"):
    """``arch`` at full width, ``layers`` layers and ``seq`` tokens a row
    (``TRAIN_RUNS``' unless given) in
    bf16 through the train launcher's entry point: every step's loss,
    grad norm, lr and seconds; tokens/s; peak memory; the launches held
    to ``train_kernel_calls`` x microbatches x steps. The launcher trains
    under the one-rank cuda mesh's sharding policy, its params laid out
    on ``train_shardings``; at TRAIN_RUNS' shape qwen3-8b's losses and
    grad norms must be the ones recorded under NULL_POLICY. Then on one
    repeated batch the loss must fall, and one train step is traced.
    qwen3-8b's loss must also fall over its fresh batches; deepseek's
    gradient of one batch under NULL_POLICY and under the launcher's
    policy must give the same bits."""
    import shutil
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.launch import train as launcher
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import make_train_step, value_and_grad
    run = TRAIN_RUNS[arch]
    layers, seq = layers or run["layers"], seq or run["seq"]
    steps = run["steps"]
    full = get_config(arch)
    cfg = full.scaled(n_layers=layers)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = _reset_launches()
    out = launcher.main(_train_args(arch, layers, steps, TRAIN_DIR / "main",
                                    seq=seq))
    sync(torch, device)
    peak = torch.cuda.max_memory_allocated()
    path = _train_launches(f"{arch} train", wrappers, cfg, seq,
                           steps * TRAIN_MICROBATCH)
    losses = [r["loss"] for r in out["steps"]]
    tok_step = TRAIN_BATCH * seq
    steady = [r["seconds"] for r in out["steps"][1:]]
    rec = {"phase": "train", "config": arch, "layers": layers,
           "reduced": {"n_layers": [full.n_layers, layers]}, "seq": seq,
           "batch": TRAIN_BATCH, "microbatch": TRAIN_MICROBATCH,
           "remat": True, "dtype": "bfloat16", "steps": out["steps"],
           "tokens_per_s": out["tokens_per_s"],
           "steady_step_s": statistics.median(steady),
           "steady_tokens_per_s": tok_step / statistics.median(steady),
           "peak_gb": peak / 1e9, "launches": path["launches"]}
    require(all(np.isfinite(x) for x in losses)
            and all(np.isfinite(r["grad_norm"]) for r in out["steps"]),
            f"train {arch}: a loss or grad norm is not finite: "
            f"{out['steps']}")
    if arch == "qwen3-8b":
        require(losses[-1] < losses[0],
                f"train: the loss did not fall over {steps} steps: {losses}")
    if arch == "qwen3-8b" and (layers, seq) == (run["layers"], run["seq"]):
        got = {"loss": losses,
               "grad_norm": [r["grad_norm"] for r in out["steps"]]}
        rec["equals_null_policy_record"] = got == QWEN3_TRAIN_RECORDED
        require(rec["equals_null_policy_record"],
                f"train: under the smoke mesh's policy qwen3-8b gave "
                f"{got}, not the NULL_POLICY record {QWEN3_TRAIN_RECORDED}")
    # one batch, repeated: the loss falls at every step
    params, opt = out["params"], out["opt_state"]
    del out
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=0,
                                            total_steps=100),
                           microbatch=TRAIN_MICROBATCH)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(TRAIN_BATCH, seq)).astype(np.int32),
        device=device)
    rep = []
    for _ in range(4):
        params, opt, m = step(params, opt, toks)
        rep.append(float(m["loss"]))
    rec["repeated_batch_losses"] = rep
    require(all(b < a for a, b in zip(rep, rep[1:])),
            f"train {arch}: the loss on a repeated batch did not fall: "
            f"{rep}")
    if arch == "qwen3-8b":
        rec["walk_on_card"] = check_walk_on_card(torch, cfg, step, params,
                                                 opt, toks)
    win = _profile(torch, device, lambda: step(params, opt, toks))
    rec["trace"] = _traced(torch, win)
    bwd_calls = rec["trace"]["wrapper_calls"].get("flash_attention_bwd", 0)
    if bwd_calls:
        seen = {n: rec["trace"]["port_kernels"].get(n, {}).get("launches", 0)
                for n in FLASH_BWD_KERNELS}
        require(all(seen[n] == bwd_calls for n in FLASH_BWD_BF16_KERNELS)
                and sum(seen.values()) == 2 * bwd_calls,
                f"train {arch}: the traced step's {bwd_calls} B2-bwd calls "
                f"launched {seen}, not the tensor-core pair each")
    del opt, step
    if arch == "deepseek-v2-lite-16b":
        # no kernel of the path sums with atomics: two gradients of one
        # batch, bit for bit, the first under NULL_POLICY and the second
        # under the launcher's policy (the one-rank cuda mesh, sp, fsdp)
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.sharding import make_policy
        policy = make_policy(make_smoke_mesh(device), sp=True, fsdp=True)
        half = toks[:TRAIN_BATCH // TRAIN_MICROBATCH]
        _, g1 = value_and_grad(params, half, cfg)
        _, g2 = value_and_grad(params, half, cfg, policy=policy)
        rec["grads_bit_equal_twice"] = all(
            torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
        del g1, g2
        require(rec["grads_bit_equal_twice"],
                f"train {arch}: two gradients of one batch differ (NULL_"
                f"POLICY against the smoke mesh's policy)")
    emit(rec)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return path, rec


# the resume phase's config: rwkv6-1.6b at full width, whose 1-layer
# checkpoint (5 GB at 16 bytes a parameter) writes and reads in a quarter
# of the time of qwen3-8b's (23.0 GB, its 151936-token vocabulary: 95 of
# the smoke's seconds on the H100), through the same launcher and
# Checkpointer; its bit-equal resume also holds B4-bwd to the same bits
# on every call
RESUME_ARCH = "rwkv6-1.6b"


def phase_train_resume(torch, arch=RESUME_ARCH, layers=1, device="cuda"):
    """The launcher with ``arch`` at full width and ``layers`` layers: one
    run of 8 steps, and one stopped at its step-4 checkpoint and resumed
    with ``--resume``: the resumed losses against the uninterrupted run's,
    bit for bit or the first step and size of a difference. Eight steps
    stay inside the launcher's 10-step warmup, where the lr does not
    depend on ``--steps``."""
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.core.timing import Timer
    from repro_torch.launch import train as launcher
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    def run(*args):
        gc.collect()
        torch.cuda.empty_cache()
        t = Timer()
        out = launcher.main(_train_args(arch, layers, *args))
        out.pop("params")
        out.pop("opt_state")
        return out, t.elapsed()

    wrappers = _reset_launches()
    full, full_s = run(8, TRAIN_DIR / "full")
    first, first_s = run(4, TRAIN_DIR / "resume", "--ckpt-every", "4")
    rest, rest_s = run(8, TRAIN_DIR / "resume", "--resume")
    sync(torch, device)
    path = _train_launches(f"{arch} train resume", wrappers,
                           get_config(arch).scaled(n_layers=layers),
                           TRAIN_SEQ, 16 * TRAIN_MICROBATCH)
    want = [r["loss"] for r in full["steps"]]
    got = [r["loss"] for r in first["steps"] + rest["steps"]]
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    ckpt = TRAIN_DIR / "resume" / "step_00000004" / "shards.npz"
    rec = {"phase": "train_resume", "config": arch, "layers": layers,
           "resumed_from": rest["start"], "losses_uninterrupted": want,
           "losses_stopped_and_resumed": got, "bit_equal": not diff,
           "first_differing_step": diff[0] if diff else None,
           "max_abs_diff": max(abs(a - b) for a, b in zip(got, want)),
           "checkpoint_bytes": ckpt.stat().st_size if ckpt.exists() else None,
           "seconds": {"uninterrupted": full_s, "to_step_4_and_save": first_s,
                       "load_and_resume": rest_s},
           "launches": path["launches"]}
    emit(rec)
    require(rest["start"] == 4 and len(got) == len(want) == 8,
            f"train resume: {rec}")
    require(rec["max_abs_diff"] <= 1e-3 * abs(want[-1]),
            f"train resume: the resumed losses are not the run's: {rec}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return path, rec


def phase_train_ft(torch, steps=6, device="cuda"):
    """FaultTolerantTrainer on the trainer-demo model of
    examples/train_lm.py (dim 256, 4 layers, hd 64, vocab 4096, seq 256,
    batch 8, bf16) under the reference test's failures (rate 0.3, seed 5,
    2 workers, a checkpoint every 2 steps): SR within 5e-3 and GBN within
    1e-6 of the no-failure params (tests/test_substrate.py), GBN's bit
    equality reported; launches held to the gradient calls made."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.data import DataConfig, SyntheticPackedDataset
    from repro_torch.ft import FaultTolerantTrainer, FTConfig
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.train_step import value_and_grad
    cfg = ModelConfig(name="trainer-demo", family="dense", n_layers=4,
                      d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=1024, vocab_size=4096)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    calls = [0]

    def grad_fn(p, t):
        calls[0] += 1
        return value_and_grad(p, t, cfg)[1], {}

    def update_fn(g, o, p):
        return adamw_update(g, o, p, ocfg)

    def trainer(policy, rate, ck):
        data = SyntheticPackedDataset(DataConfig(seq_len=256, global_batch=8,
                                                 vocab_size=cfg.vocab_size))
        return FaultTolerantTrainer(
            grad_fn, update_fn, data, ck,
            FTConfig(policy=policy, failure_rate=rate, checkpoint_every=2,
                     seed=5), n_workers=2, device=device)

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    wrappers = _reset_launches()
    p = map_tree(lambda t: t.clone(), params)
    clean, _, _ = trainer("sr", 0.0, Checkpointer(str(TRAIN_DIR / "clean"))
                          ).run(p, adamw_init(p), steps)
    recs = []
    for policy, tol in (("sr", 5e-3), ("gbn", 1e-6)):
        ck = Checkpointer(str(TRAIN_DIR / policy))
        p = map_tree(lambda t: t.clone(), params)
        ck.save(0, (p, adamw_init(p)), blocking=True)
        got, _, st = trainer(policy, 0.3, ck).run(p, adamw_init(p), steps)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(leaves(got), leaves(clean)))
        bits = all(torch.equal(a, b) for a, b in zip(leaves(got),
                                                     leaves(clean)))
        rec = {"phase": "train_ft", "policy": policy, "steps": st.steps,
               "failures": st.failures,
               "microbatches_recomputed": st.microbatches_recomputed,
               "steps_replayed": st.steps_replayed,
               "checkpoints_restored": st.checkpoints_restored,
               "max_abs_diff_vs_no_failure": err, "tol": tol,
               "bit_equal": bits, "wall_s": st.wall_s}
        emit(rec)
        require(st.failures > 0 and err <= tol,
                f"train ft: {policy} did not reach the no-failure params: "
                f"{rec}")
        recs.append(rec)
    sync(torch, device)
    path = _train_launches("trainer-demo ft", wrappers, cfg, 256, calls[0])
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return path, recs


TRAIN_ARCHS = ("qwen3-8b", "deepseek-v2-lite-16b", "rwkv6-1.6b",
               "jamba-v0.1-52b")
# model_grads' depths: qwen3, rwkv6 and deepseek at 2 layers (deepseek's
# dense first layer and one MoE layer), jamba at 1 (a Mamba layer)
GRAD_LAYERS = {"qwen3-8b": 2, "deepseek-v2-lite-16b": 2, "rwkv6-1.6b": 2,
               "jamba-v0.1-52b": 1}


def train_phases(torch, archs=TRAIN_ARCHS, layers=None, seq=None):
    """The training phases in their order, as (phase, label, fn, args):
    each arch's loss and gradients in fp32, card against CPU (at
    ``GRAD_LAYERS``), and with rwkv6-1.6b B4-bwd at its
    ``RWKV_DEEP_LAYERS``-layer
    model's inputs against float64; each arch at full width and
    ``TRAIN_RUNS``' depth and length (or ``layers`` and ``seq``), alone on
    the card; with ``RESUME_ARCH`` also its resume at 1 layer (each
    checkpoint holds 16 bytes a parameter), and with qwen3-8b FT recovery
    on the trainer demo."""
    from repro_torch.configs.registry import get_config
    out = [("model_grads", a, phase_model_grads,
            (torch, get_config(a).scaled(n_layers=GRAD_LAYERS[a],
                                         dtype="float32")))
           for a in archs]
    if "rwkv6-1.6b" in archs:
        out.append(("model_grads", "rwkv6-1.6b deep", phase_rwkv_deep_grads,
                    (torch,)))
    out += [("train", a, phase_train,
             (torch, a, layers, seq)) for a in archs]
    if RESUME_ARCH in archs:
        out.append(("train", f"{RESUME_ARCH} resume", phase_train_resume,
                    (torch,)))
    if "qwen3-8b" in archs:
        out.append(("train", "trainer-demo ft", phase_train_ft, (torch,)))
    return out


def run_train_phases(torch, archs=TRAIN_ARCHS, layers=None, seq=None,
                     train_recs=None):
    """Run ``train_phases``, freeing the card between them; returns the
    train phases' launch records for ``kernel_line``, and puts each
    ``phase_train`` record into ``train_recs`` by arch."""
    paths = []
    for phase, label, fn, args in train_phases(torch, archs, layers, seq):
        out = seconds(phase, label, fn, *args)
        if phase == "train":
            paths.append(out[0])
        if fn is phase_train and train_recs is not None:
            train_recs[label] = out[1]
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def streams_digest(streams) -> str:
    """sha256 of a run's token streams ({req_id: tokens}), to compare runs
    of different code without printing every token."""
    import hashlib
    text = json.dumps({str(k): [int(t) for t in v]
                       for k, v in sorted(streams.items())})
    return hashlib.sha256(text.encode()).hexdigest()


def profile_decode_span(torch, cfg, params, ecfg, prompts, device,
                        sampling=None):
    """Where a decode span's time goes: admit and prefill the first
    `slots` prompts (request i with ``sampling[i]``, default greedy) with
    one engine step, then trace the next step (a pure decode span) with
    torch.profiler (``_traced``)."""
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, ecfg, device=device)
    for i, p in enumerate(prompts[:ecfg.slots]):
        kw = {} if sampling is None else {"sampling": sampling[i]}
        eng.submit(Request(i, p.copy(), max_new_tokens=1 << 20, **kw))
    eng.step()
    steps = eng.stats["decode_steps"]
    win = _profile(torch, device, eng.step)
    return {"decode_steps": eng.stats["decode_steps"] - steps,
            **_traced(torch, win)}


def profile_prefill(torch, cfg, params, ecfg, prompt, device):
    """Where one monolithic prefill's time goes: a fresh engine admits
    one request of ``prompt``, which prefills it, under torch.profiler
    (``_traced``)."""
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, ecfg, device=device)
    eng.submit(Request(0, prompt.copy(), max_new_tokens=1 << 20))
    win = _profile(torch, device, eng._admit)
    require(eng.stats["prefills"] == 1,
            f"traced prefill: {eng.stats['prefills']} prefills, not 1")
    return {"prompt_len": len(prompt), **_traced(torch, win)}


def _wrappers():
    """Every kernel wrapper of the port (B1-B7, B2-bwd, B4-bwd, B6-bwd and
    B7-bwd), by kernel name; each counts its launches in ``.launches``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_decode as sd
    from repro_torch.kernels import wkv6 as wk
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "paged_decode_attention": pa.paged_decode_attention,
            "wkv6_chunked": wk.wkv6_chunked,
            "wkv6_decode": wk.wkv6_decode,
            "ssm_decode_step": sd.ssm_decode_step,
            "linear_scan": ls.linear_scan,
            "moe_dispatch": md.moe_dispatch,
            "moe_dispatch_bwd": md.moe_dispatch_bwd,
            "linear_scan_bwd": ls.linear_scan_bwd,
            "wkv6_chunked_bwd": wk.wkv6_chunked_bwd}


def serve_path(cfg, layout, chunked=False):
    """The kernels a config's serving path on ``layout`` must launch,
    each mapped to the counters its launches follow and the number of
    layers that launch it once per count: attention layers run B2 once
    per monolithic prefill (``full_prefills``, counted by
    ``_serve_once``; a prefill chunk attends in plain PyTorch, as the
    reference does in jnp, so a ``chunked`` run launches no B2) and, on
    the paged layout only, B1 once per decode step (the dense layout
    decodes attention in plain PyTorch, as the reference does in jnp);
    RWKV layers B4 once per prefill (always monolithic) and B3 once per
    decode step; Mamba layers B6 once per 256-token scan chunk
    (``scan_chunks``, counted by ``phase_serve`` from the prompts) and B5
    once per decode step; MoE layers B7 once per monolithic prefill, once
    per prefill chunk (``prefill_chunks``) and once per decode step."""
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    path = {}
    for name, n, counters in (
            ("flash_attention", 0 if chunked else kinds.count("attn"),
             ("full_prefills",)),
            ("paged_decode_attention",
             kinds.count("attn") if layout == "paged" else 0,
             ("decode_steps",)),
            ("wkv6_chunked", kinds.count("rwkv"), ("full_prefills",)),
            ("wkv6_decode", kinds.count("rwkv"), ("decode_steps",)),
            ("linear_scan", kinds.count("mamba"), ("scan_chunks",)),
            ("ssm_decode_step", kinds.count("mamba"), ("decode_steps",)),
            ("moe_dispatch", mlps.count("moe") if cfg.moe else 0,
             ("full_prefills", "prefill_chunks", "decode_steps"))):
        if n:
            path[name] = {c: n for c in counters}
    return path


def check_launches(cfg, path, launches, counts):
    """Every kernel of ``path`` launched exactly (layers x count) summed
    over its counters, and at least once; every other kernel never."""
    for name, per in path.items():
        want = sum(n * counts[c] for c, n in per.items())
        terms = [f"{n} x {c} ({counts[c]})" for c, n in per.items()]
        require(launches[name] == want > 0,
                f"serve: {name} launches {launches[name]} != "
                f"{' + '.join(terms)}")
    require(all(v == 0 for n, v in launches.items() if n not in path),
            f"serve: a kernel off the {cfg.name} path launched: "
            f"{launches}")


def phase_serve(torch, cfg, ecfg, path, prompt_lens=PROMPT_LENS, max_new=32,
                seed=0, device="cuda", park_pages=None, trace_prefill=None,
                policy=None, want_digest=None):
    """Serve 8 requests with ``cfg`` (full width; the depth it gives).
    ``path`` (``serve_path``) maps each kernel the serving path must run
    to the counters its launches follow and the layers that launch it
    per count; every kernel's count is set to 0 just before the run and
    read just after, and must equal the sum over its counters of layers
    x count. The
    engine's counters stand beside ``full_prefills`` (``_serve_once``)
    and ``scan_chunks``, the 256-token chunks of Mamba prefill, which the
    prompts give once every prompt is prefilled exactly once (no
    preemption), as the run must. With
    ``park_pages`` a third run with that many pages must park, unpark and
    give the same streams. One decode span is traced, and with
    ``trace_prefill`` (a prompt length of ``prompt_lens``) that prompt's
    prefill too. With a sharding ``policy`` the main run's engine serves
    under it and the second run under NULL_POLICY: the same streams, and
    with ``want_digest`` the digest recorded under NULL_POLICY; the params
    laid out on ``serve_shardings`` by ``reshard_tree`` must keep their
    bits."""
    import dataclasses
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.models.mamba import CHUNK
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(cfg, gen, device=device)
    sync(torch, device)
    sharding = None if policy is None else check_serve_shardings(
        torch, cfg, params, policy, device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    eng, done, wall, meas = _serve_once(torch, cfg, params, ecfg, prompts,
                                        max_new, device, policy=policy)
    prefill_s = meas["prefill_s"]
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
    counts = dict(st, full_prefills=meas["full_prefills"],
                  scan_chunks=sum(-(-n // CHUNK) for n in prompt_lens))
    check_launches(cfg, path, launches, counts)
    eng2, done2, wall2, _ = _serve_once(torch, cfg, params, ecfg, prompts,
                                        max_new, device)
    streams2 = {r.req_id: list(r.tokens_out) for r in done2}
    require(streams2 == streams, "serve: a second run gave other streams"
            + ("" if policy is None else " (NULL_POLICY against the smoke "
               "mesh's policy)"))
    del eng2
    if want_digest is not None:
        require(streams_digest(streams) == want_digest,
                f"serve: digest {streams_digest(streams)[:8]} is not the "
                f"one recorded under NULL_POLICY, {want_digest[:8]}")
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
    if cfg.mla is not None and traced_prefill is not None:
        # every MLA layer's prefill attention ran the (192, 128) instance
        mla_rows = traced_prefill["port_kernels"].get(FLASH_MLA_KERNEL, {})
        require(mla_rows.get("launches") == cfg.layer_kinds().count("attn"),
                f"serve: the traced {cfg.name} prefill launched "
                f"{FLASH_MLA_KERNEL} {mla_rows.get('launches')} times, not "
                f"once per MLA layer")
    decode_s = wall - prefill_s
    rec = {"phase": "serve", "arch": cfg.name,
           "label": f"{cfg.name} {ecfg.kv_layout}", "n_layers": n_layers,
           "mla": cfg.mla is not None,
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
           "scan_chunks": counts["scan_chunks"], "stats": st,
           "completion_order": [r.req_id for r in done],
           "streams_sha256": streams_digest(streams),
           "streams_identical_across_runs": True,
           "parking_run": parking, "traced_decode_span": traced,
           "traced_prefill": traced_prefill, "sharding": sharding}
    if torch.device(device).type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(rec)
    del params, eng
    return rec


# qwen3-8b paged's streams (seed 0, PROMPT_LENS, 32 new tokens, 36
# layers) under NULL_POLICY, as every earlier run of this smoke on the H100
# printed them
QWEN3_PAGED_DIGEST = ("3a377b1bf4917aab3df352f6bfcff3d13f9952623d5a5cecd9"
                      "55aa4134cada91")


def check_serve_shardings(torch, cfg, params, policy, device="cuda"):
    """``params`` laid out on ``serve_shardings(cfg, policy)`` by
    ``reshard_tree``: every leaf on the mesh's device with its bits. The
    copy is freed before the serve runs."""
    import torch.distributed as dist
    from repro_torch.checkpoint import reshard_tree
    from repro_torch.core.timing import Timer
    from repro_torch.core.tree import leaves
    from repro_torch.train.train_step import serve_shardings
    t = Timer()
    (p_sh, _, _), _ = serve_shardings(cfg, policy)
    placed = reshard_tree(params, p_sh)
    sync(torch, device)
    seconds_ = t.elapsed()
    pairs = list(zip(leaves(params), leaves(placed)))
    equal = all(a.device == b.device and torch.equal(a, b)
                for a, b in pairs)
    rec = {"mesh": str(policy.mesh), "n_ranks": policy.n_ranks,
           "backend": str(dist.get_backend()),
           "leaves": len(pairs), "reshard_s": seconds_,
           "bytes": sum(a.numel() * a.element_size() for a, _ in pairs),
           "bit_equal": equal}
    del placed, pairs
    require(equal, f"serve: reshard_tree onto serve_shardings changed a "
                   f"leaf: {rec}")
    return rec


# chat requests under one system prompt: a shared 512-token prefix (32
# pages of 16) and a distinct tail each, 549 to 1900 tokens in all
SHARED_PREFIX = 512
PREFIX_TAILS = (37, 200, 333, 517, 1000, 1024, 1331, 1388)


def _run_summary(eng, done, wall, meas):
    """A serve run's streams and its end-to-end numbers."""
    st = eng.stats
    decode_s = wall - meas["prefill_s"]
    streams = {r.req_id: list(r.tokens_out) for r in done}
    return streams, {
        "wall_s": wall, "prefill_s": meas["prefill_s"], "decode_s": decode_s,
        "prefill_tok_per_s": st["prefill_tokens"] / meas["prefill_s"],
        "decode_tok_per_s": st["decode_tokens"] / decode_s,
        "ttft_s": [meas["ttft_s"][i] for i in sorted(meas["ttft_s"])],
        "pages_peak": st["pages_peak"], "stats": dict(st),
        "streams_sha256": streams_digest(streams)}


def phase_serve_prefix(torch, cfg, layout, max_new=32, seed=0,
                       device="cuda", chunk=256, entries=64):
    """Chunked prefill and the block prefix cache at full width: 8 chat
    requests under one system prompt (``SHARED_PREFIX`` tokens, then
    ``PREFIX_TAILS``), 256-token chunks, 64 cache entries. The first
    four prefill the prefix themselves; the four admitted after them
    must hit it, each reusing exactly the 512 prefix tokens. Checks:
    every request completes, ``host_syncs == prefills + decode_spans``,
    more chunks than prefills, every kernel's launches held to its
    counters (no B2: chunks attend in plain PyTorch), the pool empty once
    the cache is dropped, equal streams in a second run. The same
    prompts then run without the cache (``pages_peak`` beside the
    cached run's) and monolithically without it; whether their streams
    equal the cached run's is printed, not required (bf16 logits of
    random weights are near-flat, and the monolithic run attends through
    B2). One middle chunk of the longest prompt is traced, with the
    host's own time by operator beside the device's."""
    import dataclasses
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve.api import EngineConfig, Request
    from repro_torch.serve.engine import ServingEngine
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(cfg, gen, device=device)
    sync(torch, device)
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab_size, size=SHARED_PREFIX)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab_size,
                                                    size=n)]).astype(np.int32)
               for n in PREFIX_TAILS]
    ecfg = EngineConfig(slots=4, cache_len=2048, page_size=16, n_pages=640,
                        decode_span=8, eos_token=-1, kv_layout=layout,
                        prefill_chunk=chunk, prefix_cache_entries=entries)
    path = serve_path(cfg, layout, chunked=True)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    eng, done, wall, meas = _serve_once(torch, cfg, params, ecfg, prompts,
                                        max_new, device)
    launches = {n: w.launches for n, w in wrappers.items()}
    st = eng.stats
    streams, run = _run_summary(eng, done, wall, meas)
    require(len(done) == len(prompts)
            and all(len(v) == max_new for v in streams.values()),
            f"prefix serve: not every request completed with {max_new} "
            f"tokens: { {k: len(v) for k, v in streams.items()} }")
    require(st["prefills"] == len(prompts) and st["preempt_restarts"] == 0,
            f"prefix serve: {st['prefills']} prefills for {len(prompts)} "
            f"prompts, {st['preempt_restarts']} preempted")
    require(st["host_syncs"] == st["prefills"] + st["decode_spans"],
            f"prefix serve: host_syncs {st['host_syncs']} != prefills "
            f"{st['prefills']} + decode_spans {st['decode_spans']}")
    require(st["prefix_hits"] >= 4
            and st["prefix_tokens_reused"]
            == SHARED_PREFIX * st["prefix_hits"],
            f"prefix serve: {st['prefix_hits']} hits reused "
            f"{st['prefix_tokens_reused']} tokens, not >= 4 hits of "
            f"{SHARED_PREFIX}")
    require(st["prefill_chunks"] > st["prefills"],
            f"prefix serve: {st['prefill_chunks']} chunks for "
            f"{st['prefills']} prefills")
    check_launches(cfg, path, launches,
                   dict(st, full_prefills=meas["full_prefills"]))
    eng.prefix.clear()
    require(eng.pool.n_free == eng.pool.n_pages and not eng.pool.tables,
            f"prefix serve: {eng.pool.n_used} pages still held after the "
            f"run and the cache were released")
    del eng
    eng2, done2, wall2, _ = _serve_once(torch, cfg, params, ecfg, prompts,
                                        max_new, device)
    require({r.req_id: list(r.tokens_out) for r in done2} == streams,
            "prefix serve: a second run gave other streams")
    del eng2
    others = {}
    for name, change in (("no_cache", dict(prefix_cache_entries=0)),
                         ("monolithic", dict(prefill_chunk=0,
                                             prefix_cache_entries=0))):
        e, d, w, m = _serve_once(torch, cfg, params,
                                 dataclasses.replace(ecfg, **change),
                                 prompts, max_new, device)
        other_streams, others[name] = _run_summary(e, d, w, m)
        others[name]["streams_equal_to_cached_run"] = other_streams == streams
        del e
    # one 256-token chunk at position 256 of the longest prompt
    eng = ServingEngine(cfg, params, ecfg, device=device)
    eng.submit(Request(0, prompts[-1].copy(), max_new_tokens=max_new))
    eng.step()
    win = _profile(torch, device, eng._prefill_step)
    require(eng.stats["prefill_chunks"] == 2,
            f"traced chunk: {eng.stats['prefill_chunks']} chunks, not 2")
    from torch.autograd import DeviceType
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in win["rows"]
                   if e.device_type == DeviceType.CPU), key=lambda e: -e[1])
    traced = {"start": chunk, "width": chunk, **_traced(torch, win),
              "host_self_ms": sum(ms for _, ms, _ in host),
              "top_host_ops_ms": [[k[:80], ms, n] for k, ms, n in host[:12]]}
    del eng
    if layout != "paged":                      # footprint accounting only
        for r in (run, *others.values()):
            r.pop("pages_peak")
    rec = {"phase": "serve_prefix", "arch": cfg.name,
           "label": f"{cfg.name} {layout} chunked+prefix",
           "n_layers": cfg.n_layers,
           "dtype": str(lm.param_dtype(cfg)).split(".")[-1],
           "engine": {k: getattr(ecfg, k) for k in (
               "slots", "cache_len", "page_size", "n_pages", "decode_span",
               "eos_token", "kv_layout", "prefill_chunk",
               "prefix_cache_entries")},
           "shared_prefix": SHARED_PREFIX, "tails": list(PREFIX_TAILS),
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": max_new, **run, "wall_s_second_run": wall2,
           "launches": launches, "launch_path": path,
           "full_prefills": meas["full_prefills"],
           "completion_order": [r.req_id for r in done],
           "streams_identical_across_runs": True,
           "without_cache": others["no_cache"],
           "monolithic_without_cache": others["monolithic"],
           "traced_chunk": traced}
    if torch.device(device).type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(rec)
    del params
    return rec


# --------------------------------------------------------------------------
# phase 6: stochastic sampling, sampled serving, the live front end
# --------------------------------------------------------------------------

# the margin rule: a draw may differ from another device's only where the
# winner of the CPU's draw leads the runner-up by at most this much
DRAW_TIE = 1e-4
# (temperature, top_k, top_p) of the sampling phase's rows: greedy, pure
# temperature, top-k, top-p; then all four rows at k and p together
SAMPLE_ROWS = ((0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 50, 1.0), (0.8, 0, 0.9))
SAMPLE_ROWS_2 = ((1.3, 40, 0.95),) * 4


def _wrap_i32(v: int) -> int:
    """A Python int wrapped into int32, as the engine wraps seeds."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _sample_inputs(torch, rows, seed, V):
    """fp32 logits with a realistic spread (a standard normal body at
    scale 2 and a head of 20 entries 6-10 above it, so top-p 0.9 keeps a
    few dozen) and per-row (t, k, p), seeds, req ids and indices, seeds
    including 2^31 + 5 and a negative one."""
    import numpy as np
    rng = np.random.default_rng(seed)
    B = len(rows)
    lg = rng.standard_normal((B, V)) * 2.0
    for b in range(B):
        head = rng.choice(V, size=20, replace=False)
        lg[b, head] += rng.uniform(6.0, 10.0, size=20)
    t, k, p = zip(*rows)
    return {"logits": torch.from_numpy(lg.astype(np.float32)),
            "temperature": torch.tensor(t, dtype=torch.float32),
            "top_k": torch.tensor(k, dtype=torch.int32),
            "top_p": torch.tensor(p, dtype=torch.float32),
            "seeds": torch.tensor([_wrap_i32(2**31 + 5), -7, 0, 12345],
                                  dtype=torch.int32),
            "req_ids": torch.tensor([0, 1, 2**31 - 1, 9 + seed],
                                    dtype=torch.int32),
            "indices": torch.tensor([0, 17, 2**20, 3 + seed],
                                    dtype=torch.int32)}


def _sample_call(torch, ks, x):
    """Keys, bits (first 4096), noise, masked logits, tokens and logprobs
    of one draw on the inputs' device."""
    keys = ks.derive_keys(x["seeds"], x["req_ids"], x["indices"])
    V = x["logits"].shape[1]
    flt = (x["temperature"], x["top_k"], x["top_p"])
    tok = ks.sample_logits(x["logits"], keys, *flt)
    return {"keys": keys, "bits": ks.random_bits(keys, 4096),
            "gumbel": ks.gumbel(keys, V),
            "masked": ks.masked_logits(x["logits"], *flt),
            "tokens": tok, "logprobs": ks.token_logprob(x["logits"], tok)}


# B7's shape at moonshot-v1-16b-a3b's 1900-token prefill: 6 routed experts
# a token over 64, capacity 223 a queue
SUBSTRATE_ENQUEUE = {"T": 11400, "D": 2048, "E": 64, "C": 223}


def _mq_sequence(torch, device, ops_, n_q=4, cap=3, width=5):
    """Every (item, ok, sizes) of an MQState op sequence on ``device``,
    and the final state, on the host."""
    from repro_torch.core import multiqueue as mq
    st = mq.mq_init(n_q, cap, (width,), device=device)
    out = []
    for push, q, val in ops_:
        qt = torch.tensor(q, dtype=torch.int32, device=device)
        if push:
            st, ok = mq.mq_push(st, qt, torch.full((width,), float(val),
                                                   device=device))
            item = None
        else:
            st, item, ok = mq.mq_pop(st, qt)
        out.append((item, ok, mq.mq_sizes(st)))
    host = [tuple(None if t is None else t.cpu() for t in o) for o in out]
    return host, {n: getattr(st, n).cpu() for n in ("buf", "head", "tail")}


def phase_substrate(torch, smi, device="cuda", seed=0):
    """The JingZhao substrate on the card: (a) 2000 pushes and pops of an
    ``MQState`` (4 queues of 3 slots: the rings wrap hundreds of times
    and fill) bit for bit against the same sequence on the CPU; (b)
    ``batched_enqueue`` at moonshot's prefill shape, on routing skewed so
    that queues overflow, bit for bit against B7's kernel at its
    positions, buffers and kept rows both; (c) one ``measure_ppu`` reading
    of B2 at qwen3-8b's S 1000 (bf16), beside the H100 bound of a
    one-stage ``Pipeline`` with its bytes and operations, printed with the
    card's name and power limit; (d) ``simulate`` at the reference tests'
    configurations (no miss and 100 % miss, VoQ and blocking) with their
    claims: VoQ's bandwidth loss within 2.5 x the metadata ratio + 0.02,
    the blocking design below 0.6 x VoQ's bandwidth with a longer p99."""
    import numpy as np
    from repro_torch.core import multiqueue as mq
    from repro_torch.core.pipeline import PPU, Pipeline, Stage, measure_ppu
    from repro_torch.core.simulation import (SimConfig, miss_overhead_model,
                                             simulate)
    from repro_torch.core.timing import Timer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    t0 = Timer()
    rng = np.random.default_rng(seed)
    ops_ = [(bool(rng.random() < 0.55), int(rng.integers(0, 4)),
             int(rng.integers(-1000, 1000))) for _ in range(2000)]
    card, card_st = _mq_sequence(torch, device, ops_)
    cpu, cpu_st = _mq_sequence(torch, "cpu", ops_)
    same = all((a is None and b is None) or torch.equal(a, b)
               for x, y in zip(card, cpu) for a, b in zip(x, y))
    same = same and all(torch.equal(card_st[n], cpu_st[n]) for n in card_st)
    wraps = int(card_st["tail"].min()) // 3
    mq_rec = {"ops": len(ops_), "queues": 4, "capacity": 3,
              "pushes_ok": int(sum(bool(o[1]) for o, (p, _, _)
                                   in zip(card, ops_) if p)),
              "min_wraps": wraps, "bit_equal_to_cpu": same}
    require(same and wraps > 10, f"substrate: MQState on the card against "
                                 f"the CPU: {mq_rec}")
    T, D, E, C = (SUBSTRATE_ENQUEUE[k] for k in "TDEC")
    probs = 1.0 / np.arange(1, E + 1) ** 0.3
    ids = torch.from_numpy(rng.choice(E, size=T, p=probs / probs.sum())
                           .astype(np.int32)).to(device)
    items = torch.randn(T, D, generator=torch.Generator(device=device)
                        .manual_seed(seed), device=device,
                        dtype=torch.bfloat16)
    buf, pos, kept = mq.batched_enqueue(items, ids, E, C)
    b7 = md.moe_dispatch(items, ids, pos, E, C)
    sync(torch, device)
    enq_rec = {**SUBSTRATE_ENQUEUE, "dtype": "bfloat16",
               "dropped": int((~kept).sum()),
               "buffers_bit_equal_b7": bool(torch.equal(buf, b7)),
               "kept_equal": bool(torch.equal(kept, pos < C))}
    require(enq_rec["buffers_bit_equal_b7"] and enq_rec["kept_equal"]
            and enq_rec["dropped"] > 0,
            f"substrate: batched_enqueue against B7's kernel: {enq_rec}")
    del buf, b7, items
    B, H, KV, S, hd = 1, 32, 8, 1000, 128
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(B, h, S, hd, generator=g, device=device,
                           dtype=torch.bfloat16) for h in (H, KV, KV))
    n_bytes = 2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
    n_flops = 4 * B * H * (S * (S + 1) // 2) * hd
    pipe = Pipeline("prefill attention").add(Stage("B2", [PPU(
        "flash_attention", lambda x: fa.flash_attention(*x),
        bytes_per_call=lambda _: n_bytes,
        flops_per_call=lambda _: n_flops)]))
    run = pipe.jit()
    us = measure_ppu(lambda a, b, c: run((a, b, c)), q, k, v)
    stage, bound_s = pipe.bound_stage((q, k, v))
    ppu_rec = {"kernel": "B2 flash_attention", "shape": [B, H, KV, S, hd],
               "dtype": "bfloat16", "measure_ppu_us": us,
               "bound_stage": stage, "bound_us": bound_s * 1e6,
               "card": smi}
    print(f"substrate: measure_ppu B2 qwen3-8b S {S} bf16 {us:.3f} us a "
          f"call (bound_stage {stage} {bound_s * 1e6:.3f} us) on {smi}",
          flush=True)
    require(us > 0 and stage == "B2", f"substrate: {ppu_rec}")
    sims = {f"{p}-{m}": simulate(SimConfig(miss_rate=m, policy=p))
            for p in ("voq", "blocking") for m in (0.0, 1.0)}
    loss = 1 - sims["voq-1.0"]["bandwidth_Gbps"] / sims["voq-0.0"][
        "bandwidth_Gbps"]
    claims = {"voq_loss": loss,
              "voq_loss_ok": 0 < loss < 2.5 * miss_overhead_model(4096)
              + 0.02,
              "blocking_collapses": (
                  sims["blocking-1.0"]["bandwidth_Gbps"]
                  < 0.6 * sims["voq-1.0"]["bandwidth_Gbps"]
                  and sims["blocking-1.0"]["p99_latency_us"]
                  > sims["voq-1.0"]["p99_latency_us"])}
    require(claims["voq_loss_ok"] and claims["blocking_collapses"],
            f"substrate: simulate's claims: {claims} {sims}")
    rec = {"phase": "substrate", "mq": mq_rec, "batched_enqueue": enq_rec,
           "measure_ppu": ppu_rec, "simulate": sims, "claims": claims,
           "seconds": t0.elapsed()}
    emit(rec)
    return rec


def phase_sampling(torch, V=151936, device="cuda"):
    """``derive_keys``, ``sample_logits`` and ``token_logprob`` on the card
    against the port's CPU path, at B = 4 and qwen3's vocab: keys and
    random bits bit for bit, Gumbel noise within 4 ulp of max(|g|, 1),
    tokens equal wherever the CPU's winner leads by more than DRAW_TIE
    (flips counted), t = 0 rows the argmax exactly, logprobs within 1e-5;
    the card bit for bit across two calls, and each row's masked logits
    and token the same bits whatever its neighbours hold (the sort, the
    softmax and the cumsum per row). One call's device µs (CUDA events)
    and its device launches (torch.profiler)."""
    from repro_torch.core.timing import Timer
    from repro_torch.kernels import sampling as ks
    t0 = Timer()
    out = {"phase": "sampling", "V": V, "calls": []}
    for seed, rows in ((0, SAMPLE_ROWS), (1, SAMPLE_ROWS_2)):
        x = _sample_inputs(torch, rows, seed, V)
        xd = {k: v.to(device) for k, v in x.items()}
        cpu = _sample_call(torch, ks, x)
        card = _sample_call(torch, ks, xd)
        again = _sample_call(torch, ks, xd)
        card = {k: v.cpu() for k, v in card.items()}
        require(all(torch.equal(card[k], again[k].cpu()) for k in card),
                f"sampling: two calls on the card differ (rows {rows})")
        for k in ("keys", "bits"):
            require(torch.equal(card[k], cpu[k]),
                    f"sampling: {k} differ between the card and the CPU")
        g = cpu["gumbel"]
        ulp = torch.abs(torch.nextafter(torch.clamp_min(g.abs(), 1.0),
                                        torch.tensor(float("inf")))
                        - torch.clamp_min(g.abs(), 1.0))
        g_err = (card["gumbel"] - g).abs()
        require(bool((g_err <= 4 * ulp).all()),
                f"sampling: Gumbel noise beyond 4 ulp: {float(g_err.max())}")
        z = cpu["gumbel"] + cpu["masked"]
        top2 = torch.topk(z, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        greedy = x["temperature"] <= 0
        # entries one side's top-p filter keeps and the other's drops (a
        # prefix sum a few ulp from p); a draw may follow such an entry
        edge = torch.isfinite(card["masked"]) != torch.isfinite(cpu["masked"])
        flips = []
        for b in range(len(rows)):
            a, c = int(card["tokens"][b]), int(cpu["tokens"][b])
            if bool(greedy[b]):
                require(a == int(torch.argmax(x["logits"][b])),
                        f"sampling: t = 0 row {b} is not the argmax")
                continue
            if a != c:
                require(margin[b] <= DRAW_TIE or bool(edge[b, a])
                        or bool(edge[b, c]),
                        f"sampling: row {b} drew {a} on the card, {c} on "
                        f"the CPU, margin {margin[b]} > {DRAW_TIE}")
                flips.append(b)
        lp_err = float((card["logprobs"] - cpu["logprobs"]).abs().max())
        require(lp_err <= 1e-5, f"sampling: logprobs differ by {lp_err}")
        kept = torch.isfinite(cpu["masked"]).sum(-1).tolist()
        # neighbours: row 2 among other logits
        other = dict(xd)
        gen = torch.Generator(device=device).manual_seed(5 + seed)
        lg = torch.randn(xd["logits"].shape, generator=gen,
                         device=device) * 3.0
        lg[2] = xd["logits"][2]
        other["logits"] = lg
        nb = _sample_call(torch, ks, other)
        require(torch.equal(nb["masked"][2].cpu(), card["masked"][2])
                and int(nb["tokens"][2]) == int(card["tokens"][2]),
                "sampling: a row's draw depends on its neighbours")
        out["calls"].append({
            "rows": [list(r) for r in rows], "tokens": card["tokens"].tolist(),
            "cpu_tokens": cpu["tokens"].tolist(), "flips": flips,
            "draw_margins": margin, "kept": kept,
            "filter_edge_entries": int(edge.sum()),
            "gumbel_max_abs_err": float(g_err.max()),
            "gumbel_mismatches": int((g_err > 0).sum()),
            "logprob_max_abs_err": lp_err})
    # one call at the serving shape: CUDA-event device time and launches
    keys = ks.derive_keys(xd["seeds"], xd["req_ids"], xd["indices"])
    flt = (xd["temperature"], xd["top_k"], xd["top_p"])
    out["sample_logits_us"] = 1e3 * time_ms(
        lambda: ks.sample_logits(xd["logits"], keys, *flt), torch)
    out["derive_keys_us"] = 1e3 * time_ms(
        lambda: ks.derive_keys(xd["seeds"], xd["req_ids"], xd["indices"]),
        torch)
    tr = _traced(torch, _profile(torch, device, lambda: ks.sample_logits(
        xd["logits"], keys, *flt)))
    out["sample_logits_traced"] = {k: tr[k] for k in (
        "wall_s", "device_kernel_s", "device_ops", "top_kernels_ms")}
    tr = _traced(torch, _profile(torch, device, lambda: ks.derive_keys(
        xd["seeds"], xd["req_ids"], xd["indices"])))
    out["derive_keys_traced"] = {k: tr[k] for k in (
        "wall_s", "device_kernel_s", "device_ops")}
    out["seconds"] = t0.elapsed()
    emit(out)
    emit({"phase": "sampling", "seconds": out["seconds"]})
    return out


def _mixed_sampling(api, n, logprob_every=2):
    """Request i's SamplingParams: a cycle of greedy, pure temperature,
    top-k, top-p and both, seeds 1000 + i (one >= 2^31), logprobs on
    every other request."""
    kinds = ((0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 50, 1.0), (0.8, 0, 0.9),
             (1.3, 40, 0.95))
    out = []
    for i in range(n):
        t, k, p = kinds[i % len(kinds)]
        seed = 2**31 + 5 if i == 3 else 1000 + i
        out.append(api.SamplingParams(temperature=t, top_k=k, top_p=p,
                                      seed=seed,
                                      logprobs=i % logprob_every == 0))
    return out


def _sampled_streams(done):
    return ({r.req_id: list(r.tokens_out) for r in done},
            {r.req_id: list(r.logprobs_out) for r in done})


# the sampled runs' depth: the first SAMPLED_LAYERS of qwen3-8b's 36
# layers (their weights, the same tensors); 36 took 84-106 s of the smoke
SAMPLED_LAYERS = 9


def phase_serve_sampled(torch, cfg, greedy_digest, prompt_lens=PROMPT_LENS,
                        max_new=32, seed=0, device="cuda", park_pages=200,
                        layers=SAMPLED_LAYERS):
    """qwen3-8b on the paged engine with ``sampler="stochastic"``: the
    qwen3 paged serve phase's EngineConfig, seed and prompts with only
    the sampler changed. (a) every request at t = 0 gives that phase's
    greedy digest (all 36 layers, NULL_POLICY); then on the first
    ``layers`` layers, with mixed SamplingParams (logprobs on half), (b)
    two runs give the same streams and logprobs, (c) decode_span 1 and 8
    the same streams, (d) a run with ``park_pages`` pages parks and gives
    the same streams (pages count tokens, whatever the depth), (e) one
    request alone and among three others the same stream; (f) host_syncs
    == prefills + decode_spans in every run; (g) B2 launches ``layers``
    x prefills and B1 ``layers`` x decode steps in the main run, every
    count set to 0 just before it; (h) logprobs_out as long as
    tokens_out, finite and <= 0 where asked for, empty elsewhere. One
    decode span of sampled requests is traced beside one of greedy
    requests: the difference is the sampler's device time and launches a
    step. Returns (record, the 36-layer params) for the front-end
    phase."""
    import dataclasses
    import numpy as np
    from repro_torch.core.timing import Timer
    from repro_torch.models import lm
    from repro_torch.serve import api
    t0 = Timer()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(cfg, gen, device=device)
    sync(torch, device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    ecfg = api.EngineConfig(slots=4, cache_len=2048, page_size=16,
                            n_pages=640, decode_span=8, eos_token=-1,
                            kv_layout="paged", prefill_chunk=0,
                            prefix_cache_entries=0, sampler="stochastic")
    n = len(prompts)
    full_cfg, full_params = cfg, params
    cut_cfg = cfg.scaled(n_layers=layers)
    cut_params = dict(params, blocks=params["blocks"][:layers])

    def serve(e, sampling, ps=prompts, ids=None):
        eng, done, wall, meas = _serve_once(torch, cfg, params, e, ps,
                                            max_new, device, sampling, ids)
        st = eng.stats
        require(len(done) == len(ps)
                and all(len(r.tokens_out) == max_new for r in done),
                "serve_sampled: not every request completed")
        require(st["host_syncs"] == st["prefills"] + st["decode_spans"],
                f"serve_sampled: host_syncs {st['host_syncs']} != prefills "
                f"{st['prefills']} + decode_spans {st['decode_spans']}")
        return eng, done, wall, meas

    # (a) temperature 0 under the stochastic sampler is the greedy path
    zero = [api.SamplingParams(temperature=0.0, seed=7 + i,
                               logprobs=i % 2 == 0) for i in range(n)]
    _, done0, _, _ = serve(ecfg, zero)
    digest0 = streams_digest(_sampled_streams(done0)[0])
    require(digest0 == greedy_digest,
            f"serve_sampled: t = 0 under stochastic gave {digest0[:8]}, "
            f"not the greedy digest {greedy_digest[:8]}")
    # the rest at the cut depth; its own greedy streams at t = 0 first
    cfg, params = cut_cfg, cut_params
    _, done0, _, _ = serve(ecfg, zero)
    # the main run: mixed sampling, every count set to 0 just before it
    sp = _mixed_sampling(api, n)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    eng, done, wall, meas = serve(ecfg, sp)
    launches = {k: w.launches for k, w in wrappers.items()}
    st = dict(eng.stats)
    del eng
    path = serve_path(cfg, "paged")
    check_launches(cfg, path, launches,
                   dict(st, full_prefills=meas["full_prefills"]))
    streams, lps = _sampled_streams(done)
    for r in done:                                           # (h)
        if r.sampling.logprobs:
            require(len(r.logprobs_out) == len(r.tokens_out)
                    and all(np.isfinite(v) and v <= 0.0
                            for v in r.logprobs_out),
                    f"serve_sampled: request {r.req_id}'s logprobs "
                    f"{r.logprobs_out[:4]}... are not {max_new} finite "
                    f"values <= 0")
        else:
            require(r.logprobs_out == [],
                    f"serve_sampled: request {r.req_id} recorded logprobs "
                    f"it did not ask for")
    sampled = [i for i in range(n) if sp[i].temperature > 0]
    require(any(streams[i] != _sampled_streams(done0)[0][i]
                for i in sampled),
            "serve_sampled: every sampled stream equals the greedy one")
    _, done2, wall2, _ = serve(ecfg, sp)                     # (b)
    require(_sampled_streams(done2) == (streams, lps),
            "serve_sampled: a second run gave other streams or logprobs")
    _, done1, wall1, _ = serve(dataclasses.replace(ecfg, decode_span=1),
                               sp)                           # (c)
    require(_sampled_streams(done1)[0] == streams,
            "serve_sampled: decode_span 1 gave other streams than 8")
    eng_p, done_p, _, _ = serve(dataclasses.replace(ecfg,
                                                    n_pages=park_pages), sp)
    st_p = eng_p.stats                                       # (d)
    require(st_p["parked"] > 0 and st_p["unparked"] == st_p["parked"],
            f"serve_sampled: n_pages={park_pages} did not park: {st_p}")
    require(_sampled_streams(done_p)[0] == streams,
            "serve_sampled: the run that parks gave other streams")
    parking = {"n_pages": park_pages, "parked": st_p["parked"],
               "unparked": st_p["unparked"], "streams_identical": True}
    del eng_p
    # (e) request 3 (a top-p draw with a seed >= 2^31) alone, then among
    # three others (requests 0-2 of a 4-request run)
    solo = 3
    _, done_s, _, _ = serve(ecfg, [sp[solo]], [prompts[solo]], [solo])
    _, done_c, _, _ = serve(ecfg, [sp[i] for i in (0, 1, 2, solo)],
                            [prompts[i] for i in (0, 1, 2, solo)],
                            [0, 1, 2, solo])
    require(_sampled_streams(done_s)[0][solo] == streams[solo]
            == _sampled_streams(done_c)[0][solo],
            "serve_sampled: request 3 alone, among three others and among "
            "seven gave other streams")
    # the sampler's share of a decode span: sampled against greedy
    # requests, same prompts, one traced span each
    tr_s = profile_decode_span(torch, cfg, params, ecfg, prompts, device, sp)
    tr_g = profile_decode_span(torch, cfg, params,
                               dataclasses.replace(ecfg, sampler="greedy"),
                               prompts, device)
    steps = tr_s["decode_steps"]
    sampler_ms = 1e3 * (tr_s["device_kernel_s"] - tr_g["device_kernel_s"])
    decode_s = wall - meas["prefill_s"]
    rec = {"phase": "serve_sampled", "arch": cfg.name,
           "label": f"{cfg.name} paged stochastic", "n_layers": cfg.n_layers,
           "dtype": str(lm.param_dtype(cfg)).split(".")[-1],
           "engine": {k: getattr(ecfg, k) for k in (
               "slots", "cache_len", "page_size", "n_pages", "decode_span",
               "eos_token", "kv_layout", "sampler")},
           "sampling": [[s.temperature, s.top_k, s.top_p, s.seed,
                         s.logprobs] for s in sp],
           "prompt_lens": list(prompt_lens), "max_new_tokens": max_new,
           "temp0_digest": digest0, "greedy_digest": greedy_digest,
           "wall_s": wall, "wall_s_second_run": wall2,
           "wall_s_span1": wall1, "prefill_s": meas["prefill_s"],
           "decode_s": decode_s,
           "prefill_tok_per_s": st["prefill_tokens"] / meas["prefill_s"],
           "decode_tok_per_s": st["decode_tokens"] / decode_s,
           "launches": launches, "launch_path": path, "stats": st,
           "full_prefills": meas["full_prefills"],
           "streams_sha256": streams_digest(streams),
           "logprobs_first": {i: lps[i][:3] for i in sorted(lps)
                              if lps[i]},
           "streams_identical_across_runs_spans_neighbours": True,
           "parking_run": parking,
           "traced_decode_span": tr_s, "traced_greedy_span": tr_g,
           "sampler_device_ms_per_step": sampler_ms / steps,
           "sampler_device_share": sampler_ms
           / (1e3 * tr_s["device_kernel_s"]),
           "device_ops_per_step": tr_s["device_ops"] / steps,
           "greedy_device_ops_per_step": tr_g["device_ops"] / steps,
           "sampler_ops_per_step": (tr_s["device_ops"]
                                    - tr_g["device_ops"]) / steps}
    if torch.device(device).type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = t0.elapsed()
    rec["reduced"] = {"n_layers": [full_cfg.n_layers, layers],
                      "temp0_at_full_depth": True}
    emit(rec)
    emit({"phase": "serve_sampled", "seconds": rec["seconds"]})
    return rec, full_params


# the front end's engine (qwen3-8b paged, 36 layers): strict priority over
# two classes, a wait pool of 4, monolithic prefill, no prefix cache
FRONTEND_ECFG = dict(
    slots=4, cache_len=2048, page_size=16, n_pages=640, decode_span=8,
    eos_token=-1, kv_layout="paged", prefill_chunk=0,
    prefix_cache_entries=0, sampler="stochastic", scheduler="priority",
    qos_classes=2, admit_capacity=4, feed_depth=2)


def _frontend_trace(cfg, n_req=24, max_new=16, seed=0, rate=4.0):
    """(spec, events()): the front-end trace, 24 poisson arrivals at 4 a
    unit, prompts of 64-512 tokens, 16 new tokens, two QoS classes and
    mixed sampling; ``events(streamed)`` makes fresh ``(t, Request,
    on_token)`` events whose callbacks record (index, token) per request
    in ``streamed``."""
    from repro_torch.serve import api
    from repro_torch.serve.loadgen import TraceSpec, make_trace
    spec = TraceSpec(arrival="poisson", rate=rate,
                     prompt_lens=((0.7, 64, 256), (0.3, 256, 512)),
                     output_lens=((1.0, max_new, max_new),),
                     qos_weights=(1.0, 1.0), seed=seed)

    def events(streamed):
        out = []
        for (t, r), s in zip(make_trace(spec, n_req, cfg.vocab_size),
                             _mixed_sampling(api, n_req)):
            r.sampling = s
            out.append((t, r, lambda tok, idx, i=r.req_id:
                        streamed.setdefault(i, []).append((idx, tok))))
        return out
    return spec, events


def _handle_rows(handles):
    """What a front-end run must reproduce, per request: class, outcome,
    stream and stamps."""
    return [(h.req.req_id, h.req.qos, h.outcome, tuple(h.streamed),
             h.submitted_at, h.first_token_at, h.finished_at)
            for h in handles]


def phase_frontend(torch, cfg, params, n_req=24, max_new=16, seed=0,
                   rate=4.0, device="cuda"):
    """``LocalFrontend`` over ``make_trace`` on the 36-layer paged engine
    with a VirtualClock (one engine step = 1 time unit):
    ``_frontend_trace`` through ``FRONTEND_ECFG``, so that class 1 is
    shed or rejected (outcomes follow the step count alone: eos_token is
    -1). Checks: every request ends
    completed, rejected or shed; every completed stream equals its
    tokens_out; class 0 always completes and every drop is class 1 (a
    capacity drop only ever displaces a lower class than its arrival's);
    two runs give the same outcomes, streams and stamps; host_syncs ==
    prefills + decode_spans (streaming adds no sync). Returns the record
    with the run's rows (``_handle_rows``)."""
    from repro_torch.core.timing import Timer
    from repro_torch.serve import api
    from repro_torch.serve.frontend import VirtualClock
    t0 = Timer()
    spec, make_events = _frontend_trace(cfg, n_req, max_new, seed, rate)

    def run():
        clock = VirtualClock()
        ecfg = api.EngineConfig(clock=clock, **FRONTEND_ECFG)
        eng = api.make_engine(cfg, params, ecfg, device=device)
        fe = api.make_frontend("local", eng, step_dt=1.0)
        # measurement only: the classes on slots at each step boundary
        occupancy = {}
        fe.step_hooks.append(lambda step: occupancy.__setitem__(
            step, sorted(int(r.qos) for r in eng.slot_req if r is not None)))
        streamed = {}
        events = make_events(streamed)
        wall = Timer()
        handles = fe.run(events)
        sync(torch, device)
        wall_s = wall.elapsed()
        st = eng.stats
        require(st["host_syncs"] == st["prefills"] + st["decode_spans"],
                f"frontend: host_syncs {st['host_syncs']} != prefills "
                f"{st['prefills']} + decode_spans {st['decode_spans']}")
        require(all(h.outcome in ("completed", "rejected", "shed")
                    for h in handles) and len(handles) == n_req,
                "frontend: a request ended without a terminal outcome")
        for h in handles:
            if h.ok:
                require(h.streamed == h.req.tokens_out
                        == [tok for _, tok in streamed[h.req.req_id]],
                        f"frontend: request {h.req.req_id}'s stream is not "
                        f"its tokens_out")
        require(all(h.ok for h in handles if h.req.qos == 0),
                "frontend: a class-0 request did not complete")
        require(all(e["qos"] == 1 for e in fe.shed_log)
                and all(e["qos"] > e["trigger_qos"] for e in fe.shed_log
                        if e["reason"] == "capacity"),
                f"frontend: a drop cut upward: {fe.shed_log}")
        require(any(not h.ok for h in handles),
                "frontend: nothing was shed or rejected at this load")
        return fe, eng, handles, _handle_rows(handles), wall_s, occupancy

    fe, eng, handles, rows, wall_s, occupancy = run()
    fe2, eng2, _, rows2, wall_s2, _ = run()
    require(rows2 == rows and fe2.stats == fe.stats,
            "frontend: a second run gave other outcomes or streams")
    per_class = {}
    for c in (0, 1):
        mine = [h for h in handles if h.req.qos == c]
        ttft = sorted(h.ttft for h in mine if h.ttft is not None)
        tpot = sorted(h.tpot for h in mine if h.tpot is not None)
        per_class[c] = {
            "n": len(mine), "completed": sum(h.ok for h in mine),
            "shed": sum(h.outcome == "shed" for h in mine),
            "rejected": sum(h.outcome == "rejected" for h in mine),
            "ttft": ttft, "tpot": tpot}
    rec = {"phase": "frontend", "arch": cfg.name, "n_layers": cfg.n_layers,
           "trace": {"arrival": spec.arrival, "rate": spec.rate,
                     "n": n_req, "prompt_lens": spec.prompt_lens,
                     "max_new_tokens": max_new, "qos_classes": 2},
           "admit_capacity": 4, "steps": fe.steps, "fe_stats": fe.stats,
           "shed_log": fe.shed_log, "engine_stats": dict(eng.stats),
           "per_class_virtual": per_class, "wall_s": wall_s,
           "wall_s_second_run": wall_s2,
           "identical_across_runs": True}
    rec["seconds"] = t0.elapsed()
    emit(rec)
    emit({"phase": "frontend", "seconds": rec["seconds"]})
    rec["rows"], rec["occupancy"] = rows, occupancy
    return rec


# --------------------------------------------------------------------------
# crash and restore

# the engine counters the kernels' launches follow, summed over a run's
# incarnations (a crash discards the dying engine's stats, and a stale
# snapshot re-executes steps the launch counters already counted)
WORK_KEYS = ("prefills", "prefill_chunks", "decode_steps", "decode_spans")


def _drive_counted(torch, cfg, params, kw, events, path, label, device,
                   crash_at=(), snapshot_every=0, policy=(),
                   park_storm_at=(), watch=None):
    """One run of ``events`` built as ``ft.chaos.drive`` builds it: a
    stack from ``ft.build_stack``, a ServingFaultInjector for
    ``park_storm_at`` and a CrashInjector on the front end's step hooks
    (``watch(step, engine)``, when given, is a hook ahead of both). Every
    kernel count is set to 0 just before the run and read just after:
    each kernel of ``path`` launched (layers of its kind) x its counters
    summed over the run's engines, each counted from what it restored.
    Returns (handles, serve record); the record's ``tier_restored`` is,
    per crash, the parked payloads in the snapshot the successor
    restored."""
    from repro_torch import ft
    from repro_torch.checkpoint.checkpointer import pack_tree
    from repro_torch.core.timing import Timer
    fe, rebuild = ft.build_stack(cfg, params, kw, device=device)
    engines = [(fe.engine, dict.fromkeys(WORK_KEYS, 0))]
    tier_restored = []
    crash = None

    def successor():                          # measurement only
        eng = rebuild()
        snap = crash.snap
        engines.append((eng, {k: int(snap["stats"][k]) if snap else 0
                              for k in WORK_KEYS}))
        tier_restored.append(len(snap["transport"]["tier"]) if snap else 0)
        return eng

    if watch is not None:
        fe.step_hooks.append(lambda step: watch(step, fe.engine))
    storm = (ft.ServingFaultInjector(fe.engine, park_storm_at=park_storm_at)
             .attach(fe) if park_storm_at else None)
    if crash_at or snapshot_every:
        crash = ft.CrashInjector(fe, successor, crash_at=crash_at,
                                 snapshot_every=snapshot_every,
                                 policy=policy).attach()
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    sync(torch, device)
    t = Timer()
    handles = fe.run(events, max_steps=5000)
    sync(torch, device)
    wall = t.elapsed()
    launches = {n: w.launches for n, w in wrappers.items()}
    st = fe.engine.stats
    require(st["host_syncs"] == st["prefills"] + st["decode_spans"],
            f"crash ({label}): host_syncs off the contract: {st}")
    require(all(h.done for h in handles),
            f"crash ({label}): requests stranded without an outcome")
    require(st["prefix_hits"] == 0 and kw.get("prefill_chunk", 0) == 0,
            "crash: a drive prefilled other than monolithically")
    crash_log = list(crash.log) if crash else []
    work = {k: sum(int(e.stats[k]) - start[k] for e, start in engines)
            for k in WORK_KEYS}
    for k in ("prefills", "decode_spans"):
        logged = st[k] + sum(c["work_at_crash"][k] - c["work_restored"][k]
                             for c in crash_log)
        require(work[k] == logged,
                f"crash ({label}): {k} over {len(engines)} engines "
                f"{work[k]} != the crash log's {logged}")
    check_launches(cfg, path, launches,
                   dict(work, full_prefills=work["prefills"]))
    nbytes = 0
    if crash is not None and crash.snap is not None:
        leaves, _ = pack_tree(crash.snap)
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
    rec = {"label": label, "launches": launches, "launch_path": path,
           "mla": cfg.mla is not None, "work": work, "wall_s": wall,
           "steps": fe.steps, "engine_stats": dict(st),
           "crash_log": crash_log,
           "fault_log": list(storm.log) if storm else [],
           "tier_restored": tier_restored, "snapshot_bytes": nbytes,
           "incarnations": len(engines)}
    return handles, rec


def _snapshot_round_trip(torch, fe, rebuild, device, ckpt=None):
    """Snapshot the front end's engine where it stands and restore it onto
    a fresh engine (through ``ckpt``'s files when given), timed with the
    card synchronized; the front end goes on with the successor. Returns
    the timings and the snapshot's tensor bytes."""
    from repro_torch.checkpoint.checkpointer import pack_tree
    from repro_torch.core.timing import Timer
    eng = fe.engine
    sync(torch, device)
    t = Timer()
    snap = eng.snapshot()
    snap_s = t.elapsed()
    leaves, _ = pack_tree(snap)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    eng2 = rebuild()
    sync(torch, device)
    t = Timer()
    eng2.restore(snap)
    sync(torch, device)
    out = {"snapshot_s": snap_s, "restore_s": t.elapsed(),
           "snapshot_bytes": nbytes,
           "step": fe.steps}
    if ckpt is not None:
        del eng2
        t = Timer()
        eng.save_snapshot(ckpt, fe.steps, blocking=True)
        out["save_s"] = t.elapsed()
        eng2 = rebuild()
        t = Timer()
        eng2.load_snapshot(ckpt)
        sync(torch, device)
        out["load_restore_s"] = t.elapsed()
    fe.reattach(eng2)
    return out


def phase_crash_frontend(torch, cfg, params, clean, device="cuda"):
    """Crash and restore on the front end's run (qwen3-8b paged, 36
    layers, full width): the same trace through ``ft.chaos.drive`` with
    (a) a snapshot every step and crashes at three boundaries, one after
    the first prefills, one mid-decode and one on a park storm's boundary
    (the storm's hook runs before the snapshot's, so parked payloads are
    in the snapshot the successor restores), and (b) a snapshot every 4
    steps (stale at the crash), one crash, and class 1 replayed from zero
    (``policy=("snapshot", "replay")``). Both keep every outcome and
    stream of the clean front-end run ``clean``; (a) its stamps too ((b)
    re-executes the steps after its stale snapshot, which moves its
    stamps later in virtual time by design). Then once through the disk:
    mid-run, the engine is snapshotted, restored in memory onto a fresh
    engine (timed), saved through the Checkpointer and loaded onto
    another, which finishes the run with the clean rows."""
    import shutil
    from repro_torch import ft
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.timing import Timer
    t0 = Timer()
    _, make_events = _frontend_trace(cfg)
    path = serve_path(cfg, "paged")
    rows = clean["rows"]
    n = clean["steps"]
    early, mid, storm = 1, n // 2, (3 * n) // 4
    # (b)'s snapshot boundary: the last multiple of 4 before 3n/4 at which
    # the clean run had a class-1 request on a slot, so that the policy
    # replays one; the crash lands two steps later
    base = max((s for s, qos in clean["occupancy"].items()
                if s % 4 == 0 and 0 < s <= (3 * n) // 4 and 1 in qos),
               default=None)
    require(base is not None,
            "crash: no class-1 request held a slot at a boundary of 4")
    stale = base + 2
    recs = []

    def check(handles, label, stamps):
        got = _handle_rows(handles)
        require(len(got) == len(rows),
                f"crash ({label}): {len(got)} handles for {len(rows)}")
        for a, b in zip(got, rows):
            require((a if stamps else a[:4]) == (b if stamps else b[:4]),
                    f"crash ({label}): request {b[0]} differs from the "
                    f"clean run: {a} vs {b}")

    kw = dict(FRONTEND_ECFG)
    handles, rec = _drive_counted(
        torch, cfg, params, kw, make_events({}), path,
        f"{cfg.name} paged crash (a)", device,
        crash_at=(early, mid, storm), snapshot_every=1,
        park_storm_at=(storm,))
    check(handles, "a", stamps=True)
    require([c["step"] for c in rec["crash_log"]] == [early, mid, storm],
            f"crash (a): crashes landed at "
            f"{[c['step'] for c in rec['crash_log']]}")
    parked = [e for e in rec["fault_log"] if e["fault"] == "park_storm"]
    require(parked and parked[0]["slots"]
            and rec["tier_restored"][-1] >= len(parked[0]["slots"]),
            f"crash (a): the park storm at {storm} parked "
            f"{parked and parked[0]['slots']}, and the snapshot restored "
            f"at it held {rec['tier_restored'][-1]} parked payloads")
    recs.append(rec)

    handles, rec = _drive_counted(
        torch, cfg, params, kw, make_events({}), path,
        f"{cfg.name} paged crash (b)", device, crash_at=(stale,),
        snapshot_every=4, policy=("snapshot", "replay"))
    check(handles, "b", stamps=False)
    entry = rec["crash_log"][0]
    qos = {h.req.req_id: h.req.qos for h in handles}
    require(entry["restored_from"] == base and entry["replayed"]
            and all(qos[r] == 1 for r in entry["replayed"]),
            f"crash (b): {entry}")
    recs.append(rec)

    # the disk round trip, through the package's Checkpointer, in a
    # directory of the checkout that git ignores
    snap_dir = ROOT / "build" / "crash_snapshots"
    shutil.rmtree(snap_dir, ignore_errors=True)
    fe, rebuild = ft.build_stack(cfg, params, kw, device=device)
    handles = fe.run(make_events({}), drain=False)
    disk = _snapshot_round_trip(torch, fe, rebuild, device,
                                Checkpointer(snap_dir))
    fe.run()
    shutil.rmtree(snap_dir, ignore_errors=True)
    st = fe.engine.stats
    require(st["host_syncs"] == st["prefills"] + st["decode_spans"],
            f"crash (disk): host_syncs off the contract: {st}")
    check(handles, "disk", stamps=True)
    out = {"phase": "crash", "arch": cfg.name, "layout": "paged",
           "n_layers": cfg.n_layers, "clean_steps": n,
           "runs": recs, "disk": disk, "seconds": t0.elapsed()}
    emit(out)
    emit({"phase": "crash", "seconds": out["seconds"]})
    return recs


# the other layouts' crash runs: four of the serve prompts each, spans of
# 4 (so a run has several boundaries), no prefix cache. rwkv6 and deepseek
# finish request 1 after 8 tokens and crash on the first boundary after it
# completed: its slot's empty row then decodes over restored state (on
# latent, through the page a free slot's table row gives, and through the
# MoE layers' expert capacity). danube crashes on a boundary at which a
# request is parked: 700 pages, where 7000 + 16 and 6000 + 16 tokens (439 +
# 376 pages of the dense worst case) do not fit together
CRASH_LAYOUTS = (
    ("rwkv6-1.6b", "recurrent", 4, 2048, (200, 1000, 1531, 1900),
     (16, 8, 16, 16), "completed"),
    ("deepseek-v2-lite-16b", "latent", 640, 2048, (200, 1000, 1531, 1900),
     (16, 8, 16, 16), "completed"),
    ("h2o-danube-3-4b", "dense", 700, 8192, (37, 4500, 6000, 7000),
     (16, 16, 16, 16), "parked"))


def phase_crash_layout(torch, cfg, layout, n_pages, cache_len, lens,
                       max_new, crash_on, seed=0, device="cuda"):
    """A clean drive and one crashed (a snapshot every step) of four
    prompts (request i with ``max_new[i]`` new tokens) on ``layout``, at
    full width and the depth ``cfg`` gives: the same streams and
    outcomes, launches held to the counters over the engines. The crash
    lands on a boundary of the clean run picked by ``crash_on``:
    ``"completed"``, the first at which a request has completed and
    another still holds a slot; ``"parked"``, the middle one of those at
    which the host tier holds a parked request (the clean run must park
    and unpark, and the restored snapshot must hold the payload). Then
    the engine snapshotted two steps in and restored onto a fresh one,
    timed, and finished with the clean streams."""
    import numpy as np
    from repro_torch import ft
    from repro_torch.core.timing import Timer
    from repro_torch.models import lm
    from repro_torch.serve.api import Request
    t0 = Timer()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(cfg, gen, device=device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]

    def events():
        return [(0.0, Request(i, p.copy(), max_new_tokens=m))
                for i, (p, m) in enumerate(zip(prompts, max_new))]

    def streams(handles):
        return {h.req.req_id: tuple(h.streamed) for h in handles}

    kw = dict(slots=4, cache_len=cache_len, page_size=16, n_pages=n_pages,
              decode_span=4, eos_token=-1, kv_layout=layout,
              prefill_chunk=0, prefix_cache_entries=0)
    path = serve_path(cfg, layout)
    seen = {}                                   # step -> (done, held, tier)

    def watch(step, eng):                       # measurement only
        seen[step] = (len(eng.completed),
                      sum(r is not None for r in eng.slot_req),
                      eng.transport.in_flight)

    handles, rec_clean = _drive_counted(
        torch, cfg, params, kw, events(), path,
        f"{cfg.name} {layout} crash clean", device, watch=watch)
    clean = streams(handles)
    outcomes = [h.outcome for h in handles]
    require(all(o == "completed" for o in outcomes)
            and [len(clean[i]) for i in range(len(lens))] == list(max_new),
            f"crash ({cfg.name}): the clean drive did not complete: "
            f"{outcomes}, {[len(v) for v in clean.values()]}")
    st = rec_clean["engine_stats"]
    if crash_on == "parked":
        require(st["parked"] > 0 and st["unparked"] == st["parked"],
                f"crash ({cfg.name}): the clean drive did not park and "
                f"unpark: {st['parked']} parked, {st['unparked']} unparked")
        bounds = [s for s, (_, _, tier) in sorted(seen.items()) if tier]
        at = bounds[len(bounds) // 2] if bounds else None
    else:
        at = min((s for s, (done, held, _) in seen.items()
                  if done and held), default=None)
    require(at is not None,
            f"crash ({cfg.name}): no boundary of the clean run is "
            f"{crash_on}: {seen}")
    handles, rec = _drive_counted(
        torch, cfg, params, kw, events(), path,
        f"{cfg.name} {layout} crash at {at}", device, crash_at=(at,),
        snapshot_every=1)
    require(streams(handles) == clean
            and [h.outcome for h in handles] == outcomes,
            f"crash ({cfg.name} {layout}): a crash at {at} changed a "
            f"stream or an outcome")
    require(crash_on != "parked" or rec["tier_restored"][0] > 0,
            f"crash ({cfg.name}): the snapshot restored at {at} held no "
            f"parked payload")
    fe, rebuild = ft.build_stack(cfg, params, kw, device=device)
    handles = fe.run(events(), drain=False)
    for _ in range(2):
        fe.step()
    timing = _snapshot_round_trip(torch, fe, rebuild, device)
    fe.run()
    require(streams(handles) == clean,
            f"crash ({cfg.name} {layout}): the timed restore changed a "
            f"stream")
    out = {"phase": "crash", "arch": cfg.name, "layout": layout,
           "n_layers": cfg.n_layers, "prompt_lens": list(lens),
           "n_pages": n_pages, "max_new": list(max_new),
           "clean_steps": rec_clean["steps"], "crash_on": crash_on,
           "crash_at": at, "parked": st["parked"],
           "tier_restored": rec["tier_restored"],
           "streams_sha256": streams_digest(clean),
           "runs": [rec_clean, rec], "round_trip": timing,
           "seconds": t0.elapsed()}
    emit(out)
    emit({"phase": "crash", "arch": cfg.name, "seconds": out["seconds"]})
    del params
    return [rec_clean, rec]


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# the dry run (repro_torch.launch.dryrun) against the card
# --------------------------------------------------------------------------

# a predicted peak within this share of the measured one
DRYRUN_TOL = 0.05
DRYRUN_PREFILL = 1900       # tokens of the 36-layer qwen3-8b prefill
FIT_ARCHS = ("qwen3-8b", "deepseek-v2-lite-16b")


def _meta_walk(cfg, kind, batch, seq, microbatch=0):
    """The dry run's walk of ``cfg``'s train or prefill step on meta, at
    ``batch`` rows of ``seq`` tokens."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    step, args = dryrun.build_step(cfg, ShapeConfig(kind, kind, seq, batch),
                                   batch, microbatch)
    return dryrun.walk_step(step, args)


def check_walk_on_card(torch, cfg, step, params, opt, toks):
    """One real train step under the cost walk on the card counts the
    same kernel calls, with the same work, as the dry run's walk of that
    step on meta."""
    from repro_torch.launch import dryrun
    card = dryrun.walk_step(step, (params, opt, toks))
    meta = _meta_walk(cfg, "train", toks.shape[0], toks.shape[1],
                      TRAIN_MICROBATCH)
    rec = {"kernel_calls": card["kernel_calls"],
           "meta_kernel_calls": meta["kernel_calls"],
           "kernel_work_equal": card["kernel_work"] == meta["kernel_work"],
           "card_walk_peak_gb": card["memory"]["peak_bytes"] / 1e9,
           "meta_walk_peak_gb": meta["memory"]["peak_bytes"] / 1e9,
           "card_walk_flops": card["flops"], "meta_walk_flops": meta["flops"],
           "card_walk_hbm_bytes": card["hbm_bytes"],
           "meta_walk_hbm_bytes": meta["hbm_bytes"]}
    require(card["kernel_calls"] == meta["kernel_calls"]
            and rec["kernel_work_equal"] and card["kernel_calls"],
            f"the card's walk of a {cfg.name} train step and the meta "
            f"walk differ: {rec}")
    return rec


def _peak_row(label, meta, measured_bytes, step_s):
    pred = meta["memory"]["peak_bytes"]
    row = {"phase": "dryrun", "config": label,
           "predicted_peak_gb": pred / 1e9,
           "measured_peak_gb": measured_bytes / 1e9,
           "ratio": pred / measured_bytes,
           "walk_bound_s": meta["bound_s"], "walk_op_bound_s":
           meta["op_bound_s"], "measured_step_s": step_s,
           "walk_kernel_calls": meta["kernel_calls"],
           "walk_seconds": meta["walk_s"]}
    emit(row)
    require(abs(row["ratio"] - 1) <= DRYRUN_TOL,
            f"dryrun: {label}'s predicted peak is not within {DRYRUN_TOL} "
            f"of the measured one: {row}")
    return row


def _prefill_peak(torch, device="cuda"):
    """qwen3-8b at full depth prefills one ``DRYRUN_PREFILL``-token
    prompt for real: its peak (the params and tokens, as the walk counts
    its arguments, plus the allocator's high-water mark above them) and
    seconds, beside the dry run's walk of the same step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.timing import Timer
    from repro_torch.core.tree import leaves
    from repro_torch.models import lm
    cfg = get_config("qwen3-8b")
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(cfg, gen, device=device)
    toks = torch.randint(1, cfg.vocab_size, (1, DRYRUN_PREFILL),
                         generator=gen, device=device, dtype=torch.int32)
    args = sum(t.untyped_storage().nbytes() for t in leaves(params)) \
        + toks.untyped_storage().nbytes()
    sync(torch, device)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = Timer()
    out = lm.prefill(params, toks, cfg)
    sync(torch, device)
    secs = t.elapsed()
    measured = torch.cuda.max_memory_allocated() - base + args
    del out, params
    meta = _meta_walk(cfg, "prefill", 1, DRYRUN_PREFILL)
    return _peak_row(f"qwen3-8b prefill ({cfg.n_layers} layers, "
                     f"{DRYRUN_PREFILL} tokens)", meta, measured, secs)


def _outside_walk(torch):
    """What the walk leaves out: the CUDA context and the libraries'
    memory outside PyTorch's allocator (the card's used bytes less the
    allocator's reserved ones, with its cache emptied), and the cuBLAS
    workspace a first product on a new stream allocates."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    outside = total - free - torch.cuda.memory_reserved()
    stream = torch.cuda.Stream()
    x = torch.ones(256, 256, device="cuda", dtype=torch.bfloat16)
    base = torch.cuda.memory_allocated()
    with torch.cuda.stream(stream):
        y = x @ x
    stream.synchronize()
    ws = torch.cuda.memory_allocated() - base - y.untyped_storage().nbytes()
    del x, y
    return {"context_and_libraries_gb": outside / 1e9,
            "cublas_workspace_mb": ws / 1e6, "total_gb": total / 1e9}


def phase_dryrun(torch, train_recs):
    """The dry run beside the card: each train run's peak and step
    seconds (``train_recs``, from ``phase_train``) against the dry run's
    walk of the same step on meta, and the same for a 36-layer qwen3-8b
    prefill run here; then ``fit_depth`` of FIT_ARCHS at TRAIN_RUNS'
    shape against the card's free bytes, and what the walk leaves out."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    rows = []
    for arch, rec in train_recs.items():
        cfg = get_config(arch).scaled(n_layers=rec["layers"])
        meta = _meta_walk(cfg, "train", rec["batch"], rec["seq"],
                          rec["microbatch"])
        rows.append(_peak_row(f"{arch} train ({rec['layers']} layers, "
                              f"{rec['batch']} x {rec['seq']})", meta,
                              rec["peak_gb"] * 1e9, rec["steady_step_s"]))
    gc.collect()
    torch.cuda.empty_cache()
    rows.append(_prefill_peak(torch))
    gc.collect()
    torch.cuda.empty_cache()
    outside = _outside_walk(torch)
    emit({"phase": "dryrun", "outside_walk": outside})
    free = float(torch.cuda.mem_get_info()[0])
    for arch in FIT_ARCHS:
        if arch not in train_recs:
            continue
        rec = train_recs[arch]
        full = get_config(arch)
        fit = dryrun.fit_depth(
            full, ShapeConfig("train", "train", rec["seq"], rec["batch"]),
            rec["batch"], rec["microbatch"], free)
        emit({"phase": "dryrun", "fit": arch, "budget_gb": free / 1e9,
              "depth": fit["depth"], "of": full.n_layers,
              "trained_at": rec["layers"],
              "peaks_gb": {d: p / 1e9 for d, p in fit["peaks"].items()}})
    return rows


# --------------------------------------------------------------------------
# the examples phase: examples_torch/ on the card against the CPU
# --------------------------------------------------------------------------

EXAMPLES_DIR = ROOT / "examples_torch"
# the quickstart's train step, card against CPU in fp32 with TF32 off:
# the loss within this share of max(1, |loss|), the grad norm within the
# next (fp32 sums in another order over one step)
QS_LOSS_TOL = 1e-5
QS_GRAD_NORM_TOL = 1e-4
# the margin rule for greedy tokens: the card's may differ from the CPU's
# only where the CPU's top-1 logit leads its top-2 by less than this (a
# sampled draw by less than DRAW_TIE); the streams are compared up to the
# first such token
GREEDY_TIE = 1e-3
# the configs no train step had run for on the card before this phase:
# trained at full width in bf16 at the quickstart's shapes, at the
# deepest of up to QS_FULL_DEPTH layers that the dry run's walk fits
QS_FULL = ("qwen1.5-4b", "nemotron-4-15b", "h2o-danube-3-4b",
           "chameleon-34b", "musicgen-large", "moonshot-v1-16b-a3b")
QS_FULL_DEPTH = 2
# serve_kv's runs: (kv layout, scheduler, prefill chunk, temperature)
SERVE_KV_RUNS = tuple((layout, sched, chunk, temp)
                      for layout in ("paged", "dense")
                      for sched in ("fcfs", "priority", "round_robin")
                      for chunk in (0, 16) for temp in (0.0, 0.8))
EXAMPLE_CPU_WORKERS = 6
EXAMPLES_CKPT = ROOT / "build" / "smoke_examples"


def load_example(name):
    """``examples_torch/<name>.py`` as a module, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_tree(tree):
    """CPU tensors -> (float32 array, dtype name) leaves: numpy has no
    bfloat16, and float32 holds a bfloat16 exactly."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.float().numpy(), str(tree.dtype).split(".")[1]


def _torch_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(torch, v) for v in tree]
    array, dtype = tree
    return torch.from_numpy(array).to(getattr(torch, dtype))


def _cpu_worker_init():
    """A CPU worker of the examples phase: one torch thread (these
    SMOKE-sized runs only lose to more)."""
    import torch
    torch.set_num_threads(1)


def example_on_cpu(name, cfg, weights, inputs, opts):
    """``examples_torch/<name>.run`` on the CPU in a worker process, on
    ``weights`` (a numpy tree of fp32 CPU params)."""
    import torch
    params = _torch_tree(torch, weights)
    return load_example(name).run(cfg, params, inputs, "cpu", **opts)


class model_calls:
    """Count the model entry points' calls while open (measurement only):
    ``lm.prefill`` (``full_prefills``, and the 256-token scan chunks of
    its prompts), ``lm.prefill_chunk`` and ``lm.decode_step``, the
    counters ``serve_path``'s launches follow. The engine and
    ``lm.decode_span`` look these up in ``lm`` at each call."""

    NAMES = {"prefill": "full_prefills", "prefill_chunk": "prefill_chunks",
             "decode_step": "decode_steps"}

    def __enter__(self):
        from repro_torch.models import lm
        from repro_torch.models.mamba import CHUNK
        self.lm = lm
        self.inner = {n: getattr(lm, n) for n in self.NAMES}
        self.calls = dict.fromkeys((*self.NAMES.values(), "scan_chunks"), 0)

        def counted(name):
            def call(params, tokens, *a, **kw):
                self.calls[self.NAMES[name]] += 1
                if name == "prefill":
                    self.calls["scan_chunks"] += -(-tokens.shape[1] // CHUNK)
                return self.inner[name](params, tokens, *a, **kw)
            return call
        for name in self.NAMES:
            setattr(lm, name, counted(name))
        return self.calls

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.lm, name, fn)


def hold_example_launches(label, cfg, layout, wrappers, calls, grads=0,
                          grad_seq=0, forwards=0):
    """Every kernel launched exactly as ``serve_path(cfg, layout)`` x the
    model calls counted, plus ``train_kernel_calls(cfg, grad_seq)`` x
    ``grads`` gradients and B2 once an attention layer for each of
    ``forwards`` no-grad forwards; every other kernel never. Returns the
    record ``kernel_line`` reads."""
    launches = {n: w.launches for n, w in wrappers.items()}
    want = {n: sum(k * calls[c] for c, k in per.items())
            for n, per in serve_path(cfg, layout).items()}
    for n, c in (train_kernel_calls(cfg, grad_seq).items()
                 if grads else ()):
        want[n] = want.get(n, 0) + c * grads
    if forwards:
        want["flash_attention"] = (want.get("flash_attention", 0) + forwards
                                   * cfg.layer_kinds().count("attn"))
    want = {n: c for n, c in want.items() if c}
    # (a run may launch none: dense decode and prefill chunks attend in
    # plain PyTorch, as the reference does in jnp)
    require(all(launches[n] == want.get(n, 0) for n in launches),
            f"examples {label}: launches {launches} != {want} (model calls "
            f"{calls}, {grads} gradients on {grad_seq} tokens, {forwards} "
            f"forwards)")
    return {"label": f"examples {label}", "launches": launches,
            "launch_path": {n: {"calls": c} for n, c in want.items()},
            "mla": False}


def _rel_err(a, b):
    return abs(a - b) / max(1.0, abs(b))


def _first_difference(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None


def _cpu_margin(torch, cfg, params, prompt, stream, i, temperature=0.0,
                top_k=0, top_p=1.0, seed=0, req_id=0):
    """The CPU's lead of its token ``i`` over the runner-up, from the
    prompt and the stream before it prefilled at once: the raw logits'
    top-1 minus top-2 for a greedy token, for a sampled one the same of
    the Gumbel-perturbed masked logits the draw takes its argmax of
    (keys ``(seed, req_id, i)``). Returns (margin, the tie it must be
    under)."""
    import numpy as np
    from repro_torch.kernels import sampling as ks
    from repro_torch.models import lm
    toks = np.concatenate([prompt, np.asarray(stream[:i], np.int32)])
    logits, _ = lm.prefill(params, torch.as_tensor(toks)[None], cfg)
    if temperature <= 0:
        top = torch.topk(logits[0].float(), 2).values
        return float(top[0] - top[1]), GREEDY_TIE
    keys = ks.derive_keys(torch.tensor([seed]), torch.tensor([req_id]),
                          torch.tensor([i]))
    z = ks.gumbel(keys, logits.shape[1]) + ks.masked_logits(
        logits, torch.tensor([temperature]),
        torch.tensor([top_k], dtype=torch.int32), torch.tensor([top_p]))
    top = torch.topk(z[0], 2).values
    return float(top[0] - top[1]), DRAW_TIE


def streams_under_margin(torch, label, cfg, params, prompts, card, cpu,
                         **sampling):
    """Each request's card stream equals the CPU's up to its first
    differing token, where the CPU's margin must be under the tie;
    returns those flips as [req_id, index, margin]."""
    flips = []
    require(set(card) == set(cpu),
            f"examples {label}: other requests on the card")
    for rid in sorted(cpu):
        i = _first_difference(card[rid], cpu[rid])
        require(len(card[rid]) == len(cpu[rid]),
                f"examples {label}: request {rid}'s stream length differs")
        if i is None:
            continue
        margin, tie = _cpu_margin(torch, cfg, params, prompts[rid], cpu[rid],
                                  i, req_id=rid, **sampling)
        require(margin < tie,
                f"examples {label}: request {rid}'s token {i} is "
                f"{card[rid][i]} on the card, {cpu[rid][i]} on the CPU, "
                f"margin {margin} >= {tie}")
        flips.append([rid, i, margin])
    return flips


def _quickstart_smoke(torch, qs, arch, p_cpu, inputs, cpu):
    """The quickstart on SMOKE ``arch`` in fp32 on the card against the
    CPU's run (``cpu``) from the same weights and inputs."""
    from repro_torch.configs.registry import SMOKE_CONFIGS
    cfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    p_gpu = _to(p_cpu, "cuda")
    wrappers = _reset_launches()
    with model_calls() as calls:
        card = qs.run(cfg, p_gpu, inputs, "cuda")
    sync(torch, "cuda")
    path = hold_example_launches(f"quickstart {arch}", cfg, "dense",
                                 wrappers, calls, grads=1,
                                 grad_seq=qs.TRAIN_SHAPE[1])
    cpu = cpu.result()
    errs = {"loss": _rel_err(card["loss"], cpu["loss"]),
            "grad_norm": _rel_err(card["grad_norm"], cpu["grad_norm"])}
    require(errs["loss"] <= QS_LOSS_TOL
            and errs["grad_norm"] <= QS_GRAD_NORM_TOL,
            f"examples quickstart {arch}: card {card['loss']}, "
            f"{card['grad_norm']} against the CPU's {cpu['loss']}, "
            f"{cpu['grad_norm']}")
    i = _first_difference(card["tokens"], cpu["tokens"])
    require(i is None or cpu["margins"][i] < GREEDY_TIE,
            f"examples quickstart {arch}: token {i} differs at margin "
            f"{None if i is None else cpu['margins'][i]}: "
            f"{card['tokens']} against {cpu['tokens']}")
    require(card["params_m"] == cpu["params_m"],
            f"examples quickstart {arch}: parameter counts differ")
    emit({"phase": "examples", "example": "quickstart", "arch": arch,
          "dtype": "float32", "tf32": False, "card": {
              k: card[k] for k in ("loss", "grad_norm", "tokens")},
          "cpu": {k: cpu[k] for k in ("loss", "grad_norm", "tokens")},
          "rel_err": errs, "first_token_flip": i,
          "launches": path["launches"]})
    return path


def _quickstart_full(torch, qs, arch, smi):
    """The quickstart at full width in bf16 on the card: the depth (up to
    QS_FULL_DEPTH) whose peak the dry run's walk fits into the card's
    free bytes less DRYRUN_TOL, the walk's prediction made before the
    run and the measured peak within DRYRUN_TOL of it; a finite loss,
    launches exact, and 4 steps on the repeated train batch, the loss
    falling at each."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.timing import Timer
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    B, S = qs.TRAIN_SHAPE
    full = get_config(arch)
    budget = float(torch.cuda.mem_get_info()[0]) / (1 + DRYRUN_TOL)
    fit = dryrun.fit_depth(full.scaled(n_layers=min(QS_FULL_DEPTH,
                                                    full.n_layers)),
                           ShapeConfig("train", "train", S, B), B, 0, budget)
    require(fit["depth"] > 0, f"examples quickstart {arch}: one layer does "
            f"not fit {budget / 1e9} GB: {fit}")
    cfg = full.scaled(n_layers=fit["depth"])
    meta = _meta_walk(cfg, "train", B, S)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    inputs = qs.make_inputs(cfg.vocab_size)
    wrappers = _reset_launches()
    t = Timer()
    with model_calls() as calls:
        out = qs.run(cfg, params, inputs, "cuda")
    sync(torch, "cuda")
    run_s = t.elapsed()
    peak = torch.cuda.max_memory_allocated() - base
    path = hold_example_launches(f"quickstart {arch} full width", cfg,
                                 "dense", wrappers, calls, grads=1,
                                 grad_seq=S)
    require(np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"]),
            f"examples quickstart {arch}: not finite: {out}")
    # the quickstart's own lr at its first step (1e-3 over 100 warmup
    # steps), held: at 3e-4 nemotron-4-15b's loss fell from 11.2 to 0.09
    # in one step and rose after (NVIDIA H100 80GB HBM3, 700 W)
    step = make_train_step(cfg, AdamWConfig(lr=1e-5, warmup_steps=0,
                                            total_steps=100))
    opt = adamw_init(params)
    toks = torch.as_tensor(inputs["train_tokens"], device="cuda")
    wrappers = _reset_launches()
    losses, step_s = [], []
    for _ in range(4):
        t = Timer()
        params, opt, m = step(params, opt, toks)
        losses.append(float(m["loss"]))
        step_s.append(t.elapsed())
    sync(torch, "cuda")
    rep = hold_example_launches(f"quickstart {arch} repeated batch", cfg,
                                "dense", wrappers, dict.fromkeys(
                                    ("full_prefills", "prefill_chunks",
                                     "decode_steps", "scan_chunks"), 0),
                                grads=4, grad_seq=S)
    require(all(b < a for a, b in zip(losses, losses[1:])),
            f"examples quickstart {arch}: the loss on a repeated batch did "
            f"not fall: {losses}")
    del params, opt, step
    row = _peak_row(f"{arch} quickstart train ({cfg.n_layers} layers, "
                    f"{B} x {S})", meta, peak, statistics.median(step_s[1:]))
    emit({"phase": "examples", "example": "quickstart", "arch": arch,
          "dtype": "bfloat16", "layers": cfg.n_layers,
          "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
          "fit": {"budget_gb": budget / 1e9, "depth": fit["depth"],
                  "peaks_gb": {d: p / 1e9 for d, p in fit["peaks"].items()}},
          "loss": out["loss"], "grad_norm": out["grad_norm"],
          "tokens": out["tokens"], "run_s": run_s,
          "repeated_batch_losses": losses, "step_s": step_s,
          "predicted_peak_gb": row["predicted_peak_gb"],
          "measured_peak_gb": row["measured_peak_gb"],
          "launches": path["launches"], "nvidia_smi": smi})
    gc.collect()
    torch.cuda.empty_cache()
    return [path, rep]


def _serve_kv(torch, kv, cfg, p_cpu, p_gpu, prompts, run, cpu):
    layout, sched, chunk, temp = run
    opts = dict(kv_layout=layout, scheduler=sched, prefill_chunk=chunk,
                temperature=temp)
    label = f"serve_kv {layout} {sched} chunk {chunk} t {temp}"
    wrappers = _reset_launches()
    with model_calls() as calls:
        card = kv.run(cfg, p_gpu, prompts, "cuda", **opts)
    sync(torch, "cuda")
    path = hold_example_launches(label, cfg, layout, wrappers, calls)
    cpu = cpu.result()
    require(card["completed"] == cpu["completed"] == len(prompts),
            f"examples {label}: {card['completed']} completed")
    for key in ("stats", "order", "prefix_hit_rate", "shared_identical"):
        require(card[key] == cpu[key],
                f"examples {label}: {key} {card[key]} against the CPU's "
                f"{cpu[key]}")
    require(temp > 0 or card["shared_identical"],
            f"examples {label}: greedy shared-prompt outputs differ")
    flips = streams_under_margin(torch, label, cfg, p_cpu, prompts,
                                 card["streams"], cpu["streams"],
                                 temperature=temp)
    return path, {"run": list(run), "seconds": card["seconds"],
                  "cpu_seconds": cpu["seconds"], "stats": card["stats"],
                  "hit_rate": card["prefix_hit_rate"],
                  "shared_identical": card["shared_identical"],
                  "flips": flips, "streams_sha256": streams_digest(
                      card["streams"])}


def _serve_live(torch, live, cfg, p_cpu, p_gpu, inputs, cpu):
    wrappers = _reset_launches()
    with model_calls() as calls:
        card = live.run(cfg, p_gpu, inputs, "cuda")
    sync(torch, "cuda")
    path = hold_example_launches("serve_live", cfg, "paged", wrappers, calls)
    cpu = cpu.result()
    strip = [{k: v for k, v in h.items() if k != "streamed"}
             for h in card["handles"]]
    require(strip == [{k: v for k, v in h.items() if k != "streamed"}
                      for h in cpu["handles"]],
            f"examples serve_live: outcomes or TTFTs differ: {strip}")
    for key in ("steps", "shed", "premium_all_completed", "frontend_stats",
                "engine_stats"):
        require(card[key] == cpu[key], f"examples serve_live: {key} "
                f"{card[key]} against the CPU's {cpu[key]}")
    prompts = {rid: p for _, rid, p, _, _ in inputs}
    flips = streams_under_margin(
        torch, "serve_live", cfg, p_cpu, prompts,
        {h["req_id"]: h["streamed"] for h in card["handles"]},
        {h["req_id"]: h["streamed"] for h in cpu["handles"]})
    require(card["shed"] and card["premium_all_completed"],
            f"examples serve_live: {card['shed']} shed")
    return path, {"arrivals": card["arrivals"], "steps": card["steps"],
                  "shed": card["shed"], "flips": flips,
                  "outcomes": [h["outcome"] for h in card["handles"]]}


def _crash_recovery(torch, cr, cfg, p_cpu, p_gpu, inputs, cpu):
    wrappers = _reset_launches()
    with model_calls() as calls:
        card = cr.run(cfg, p_gpu, inputs, "cuda")
    sync(torch, "cuda")
    path = hold_example_launches("crash_recovery", cfg, "paged", wrappers,
                                 calls)
    cpu = cpu.result()
    for key in ("clean_steps", "outcomes", "boundaries", "snapshot_bytes",
                "sweep_crash_logs", "policies", "disk"):
        require(card[key] == cpu[key], f"examples crash_recovery: {key} "
                f"{card[key]} against the CPU's {cpu[key]}")
    prompts = {rid: p for _, rid, p, _, _ in inputs}
    flips = streams_under_margin(torch, "crash_recovery", cfg, p_cpu,
                                 prompts, card["streams"], cpu["streams"])
    return path, {"clean_steps": card["clean_steps"],
                  "boundaries": card["boundaries"],
                  "snapshot_bytes": card["snapshot_bytes"],
                  "policies": {k: {x: v[x] for x in ("restored_from",
                                                     "replayed",
                                                     "extra_steps")}
                               for k, v in card["policies"].items()},
                  "disk": card["disk"], "flips": flips}


FT_KEYS = ("steps", "failures", "microbatches_recomputed", "steps_replayed",
           "checkpoints_restored", "goodput", "grad_calls")


def _ft_demo(torch, ft, cfg, params, inputs, cpu):
    wrappers = _reset_launches()
    with model_calls() as calls:
        card = ft.run(cfg, params, inputs, "cuda")
    sync(torch, "cuda")
    grads = card["no_failure_grad_calls"] + sum(card[p]["grad_calls"]
                                                for p in ("sr", "gbn"))
    path = hold_example_launches("ft_demo", cfg, "dense", wrappers, calls,
                                 grads=grads, grad_seq=inputs["seq_len"])
    cpu = cpu.result()
    for pol in ("sr", "gbn"):
        got = {k: card[pol][k] for k in FT_KEYS}
        want = {k: cpu[pol][k] for k in FT_KEYS}
        require(got == want, f"examples ft_demo {pol}: {got} against the "
                f"CPU's {want}")
    # GBN replays the same steps from restored bits: no drift (the
    # reference test's 1e-6)
    require(card["gbn"]["param_drift_vs_no_failure"] <= 1e-6,
            f"examples ft_demo: GBN drifted {card['gbn']}")
    return path, {pol: {**card[pol], "cpu_param_drift_vs_no_failure":
                        cpu[pol]["param_drift_vs_no_failure"]}
                  for pol in ("sr", "gbn")}


def _train_lm(torch, tl, smi):
    """examples_torch/train_lm.py's main at its defaults on the card (its
    default device): 200 steps, the loss falling."""
    import shutil
    shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    wrappers = _reset_launches()
    with model_calls() as calls:
        out = tl.main(["--ckpt-dir", str(EXAMPLES_CKPT / "train_lm")])
    sync(torch, "cuda")
    shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    cfg = tl.model_config()
    path = hold_example_launches("train_lm", cfg, "dense", wrappers, calls,
                                 grads=out["grad_calls"], grad_seq=256,
                                 forwards=2)
    require(out["final_loss"] < out["initial_loss"],
            f"examples train_lm: the loss did not fall: {out}")
    return path, {**out, "nvidia_smi": smi}


def phase_examples(torch, smi):
    """The six scripts of examples_torch/ on the card, each through its
    ``run`` (train_lm and one quickstart through ``main``, on the card by
    default) and, except train_lm, against the same ``run`` on the CPU
    from the same weights and inputs, in worker processes while the card
    runs. Every kernel's count is set to 0 just before each card run and
    read just after (``hold_example_launches``)."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.configs.registry import ARCH_NAMES, SMOKE_CONFIGS
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {n: load_example(n) for n in (
        "quickstart", "serve_kv", "serve_live", "crash_recovery", "ft_demo",
        "train_lm")}
    qs, kv = mods["quickstart"], mods["serve_kv"]
    paths, recs = [], {}

    def weights(cfg):
        return _cpu_weights(torch, lm, cfg, 0, "cuda")

    qwen = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    cr_cfg = mods["crash_recovery"].model_config()
    ft_cfg = mods["ft_demo"].model_config()
    w = {"qwen3": weights(qwen), "crash": weights(cr_cfg)}
    # the demo's own bf16 weights, drawn on the CPU for both sides
    w["ft"] = lm.init_params(ft_cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    qs_cfgs = {a: SMOKE_CONFIGS[a].scaled(dtype="float32")
               for a in ARCH_NAMES}
    qs_w = {a: weights(c) for a, c in qs_cfgs.items()}
    qs_in = {a: qs.make_inputs(c.vocab_size) for a, c in qs_cfgs.items()}
    prompts = kv.make_inputs(qwen.vocab_size)
    live_in = mods["serve_live"].make_inputs(qwen.vocab_size)
    cr_in = mods["crash_recovery"].make_inputs(cr_cfg.vocab_size)
    ft_in = mods["ft_demo"].make_inputs(ft_cfg.vocab_size)
    with concurrent.futures.ProcessPoolExecutor(
            EXAMPLE_CPU_WORKERS, multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init) as pool:
        def on_cpu(name, cfg, params, inputs, **opts):
            return pool.submit(example_on_cpu, name, cfg,
                               _numpy_tree(_to(params, "cpu")), inputs, opts)
        # the slowest CPU runs first
        cpu = {"ft": on_cpu("ft_demo", ft_cfg, w["ft"], ft_in),
               "crash": on_cpu("crash_recovery", cr_cfg, w["crash"], cr_in),
               "live": on_cpu("serve_live", qwen, w["qwen3"], live_in)}
        cpu["qs"] = {a: on_cpu("quickstart", qs_cfgs[a], qs_w[a], qs_in[a])
                     for a in ARCH_NAMES}
        cpu["kv"] = {
            run: on_cpu("serve_kv", qwen, w["qwen3"], prompts,
                        kv_layout=run[0], scheduler=run[1],
                        prefill_chunk=run[2], temperature=run[3])
            for run in SERVE_KV_RUNS}
        # the card's runs with no CPU side first, while the workers start
        # and take their runs
        for arch in QS_FULL:
            paths += seconds("examples", f"quickstart {arch} full width",
                             _quickstart_full, torch, qs, arch, smi)
        # the quickstart's own main, on the card by default
        wrappers = _reset_launches()
        with model_calls() as calls:
            out = qs.main([])
        sync(torch, "cuda")
        paths.append(hold_example_launches(
            "quickstart main", SMOKE_CONFIGS["qwen3-8b"], "dense", wrappers,
            calls, grads=1, grad_seq=qs.TRAIN_SHAPE[1]))
        require(len(out["tokens"]) == qs.DECODE_STEPS + 1,
                f"examples quickstart main: {out}")
        for arch in ARCH_NAMES:
            paths.append(seconds("examples", f"quickstart {arch}",
                                 _quickstart_smoke, torch, qs, arch,
                                 qs_w[arch], qs_in[arch], cpu["qs"][arch]))
        p_gpu = _to(w["qwen3"], "cuda")
        kv_recs = []
        for run in SERVE_KV_RUNS:
            path, rec = _serve_kv(torch, kv, qwen, w["qwen3"], p_gpu, prompts,
                                  run, cpu["kv"][run])
            paths.append(path)
            kv_recs.append(rec)
        recs["serve_kv"] = kv_recs
        emit({"phase": "examples", "example": "serve_kv", "runs": kv_recs})
        path, recs["serve_live"] = seconds(
            "examples", "serve_live", _serve_live, torch,
            mods["serve_live"], qwen, w["qwen3"], p_gpu, live_in,
            cpu["live"])
        paths.append(path)
        del p_gpu
        path, recs["crash_recovery"] = seconds(
            "examples", "crash_recovery", _crash_recovery, torch,
            mods["crash_recovery"], cr_cfg, w["crash"],
            _to(w["crash"], "cuda"), cr_in, cpu["crash"])
        paths.append(path)
        path, recs["ft_demo"] = seconds(
            "examples", "ft_demo", _ft_demo, torch, mods["ft_demo"], ft_cfg,
            _to(w["ft"], "cuda"), ft_in, cpu["ft"])
        paths.append(path)
    for name in ("serve_live", "crash_recovery", "ft_demo"):
        emit({"phase": "examples", "example": name, **recs[name]})
    # host-bound (800 gradients of a 6M-parameter model): after the CPU
    # workers are gone
    path, rec = seconds("examples", "train_lm", _train_lm, torch,
                        mods["train_lm"], smi)
    paths.append(path)
    emit({"phase": "examples", "example": "train_lm", **rec})
    return paths


# --------------------------------------------------------------------------
# ranks: training on meshes of four ranks on the one card
# --------------------------------------------------------------------------

# four ranks share the card over gloo (NCCL takes one GPU per rank), on a
# (2, 2) ("data", "model") mesh and a (2, 1, 2) ("pod", "data", "model")
# mesh whose pod x data is as long as the other's data axis; the fp32
# SMOKE configs are held to one-rank runs on the card and to each other,
# the full-width bf16 ones train a few steps on a repeated batch
RANKS_MESH = (2, 2)
RANKS_POD_MESH = (2, 1, 2)
RANKS_BACKEND = "gloo"
RANKS_SMOKE = ("qwen3-8b", "qwen1.5-4b", "moonshot-v1-16b-a3b",
               "rwkv6-1.6b", "jamba-v0.1-52b")
# (mesh, sp, fsdp) of each fp32 SMOKE run of a config: each held to the
# one-rank runs; an SP run also to the run before it, the pod run to the
# (2, 2) SP run
RANKS_SMOKE_RUNS = ((RANKS_MESH, False, False), (RANKS_MESH, False, True),
                    (RANKS_MESH, True, True), (RANKS_POD_MESH, True, True))
# (arch, layers, steps) of each full-width run on the (2, 2) mesh under
# the launcher's production policy (SP, FSDP, ZeRO-1); the fp32 runs
# cover the path without SP. For time, qwen3-8b and moonshot take 2 steps
# (their 4-6 s steps follow the host). jamba at 1 layer (Mamba, dense
# MLP): its second carries the 16-expert MoE, ~2.8 B params, which at 20
# bytes a param over four ranks does not fit beside the rest of the card
RANKS_FULL = (("qwen3-8b", 2, 2), ("moonshot-v1-16b-a3b", 2, 2),
              ("rwkv6-1.6b", 2, 4), ("jamba-v0.1-52b", 1, 4))
RANKS_SMOKE_SHAPE = (4, 64)
# each fp32 SMOKE run's gradients against the one-rank card runs: within
# this of each leaf's largest |value|. rwkv6's fp32 gradient on one rank
# lies up to 1.7e-4 of a leaf's largest from its float64 value (PERF.md
# §6; scripts/rwkv6_fp32_spread.py, seeds 0-3), so two fp32 runs that sum
# in other orders are not that close to each other: its runs
# are held to the float64 witness instead (``_float64_spread``), no
# further from it on any leaf than the one-rank card run is, plus this
RANKS_GRAD_TOL = 1e-4
RANKS_FLOAT64 = ("rwkv6-1.6b",)
RANKS_FULL_SHAPE = (4, 1024)
RANKS_TIMEOUT = 600


def _ranks_axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def ranks_kernel_shapes():
    """What the train kernels take on one rank of the ranks phase, from
    the configs as ``ranks_main`` runs them (SMOKE whole, full width at
    its ``RANKS_FULL`` depth): B2 [b, H_eff/tp, KV_eff/tp, S, hd] on the
    rank's b = B/(pod x data) rows and local heads (``eff_heads``), the
    whole sequence with or without SP (it is gathered before a region);
    B4 [b, S, H/tp, hd] on the rank's heads; B6 [b, T, Di/tp, N] on its
    channels, T a chunk of min(256, S); B7 [T = b S K, d_model] into b
    E/tp queues of capacity(S) slots. Both meshes give the same. One row
    a config: arch, dtype, whether full width (``full``), and each
    kernel's shape, None where the config as run has no such layer, and
    the rank's rows b (``rows``)."""
    from repro_torch.configs.registry import SMOKE_CONFIGS, get_config
    from repro_torch.models.mamba import CHUNK
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import eff_heads
    rows = []
    for runs, (B, S), dtype, full in (
            ([(a, SMOKE_CONFIGS[a]) for a in RANKS_SMOKE],
             RANKS_SMOKE_SHAPE, "float32", False),
            ([(a, get_config(a).scaled(n_layers=n)) for a, n, _ in
              RANKS_FULL], RANKS_FULL_SHAPE, "bfloat16", True)):
        for arch, cfg in runs:
            kinds, shapes = set(cfg.layer_kinds()), set()
            for mesh in (RANKS_MESH, RANKS_POD_MESH):
                b, tp = B // math.prod(mesh[:-1]), mesh[-1]
                H, KV = eff_heads(cfg, tp)
                flash = "attn" in kinds and (b, H // tp, KV // tp, S,
                                             cfg.head_dim)
                moe = "moe" in cfg.mlp_kinds() and (
                    b * S * cfg.moe.top_k, cfg.d_model,
                    b * cfg.moe.n_experts // tp, capacity(S, cfg))
                wkv = "rwkv" in kinds and (
                    b, S, cfg.d_model // cfg.rwkv.head_dim // tp,
                    cfg.rwkv.head_dim)
                scan = "mamba" in kinds and (
                    b, min(CHUNK, S), cfg.mamba.expand * cfg.d_model // tp,
                    cfg.mamba.d_state)
                shapes.add((b,) + tuple(x or None for x in (flash, moe,
                                                            wkv, scan)))
            require(len(shapes) == 1, f"ranks {arch}: the meshes give "
                    f"ranks other shapes: {shapes}")
            (b, flash, moe, wkv, scan), = shapes
            rows.append({"arch": arch, "dtype": dtype, "full": full,
                         "rows": b, "flash": flash, "moe": moe, "wkv": wkv,
                         "scan": scan})
    return rows


def check_ranks_kernels(torch):
    """B2, B2-bwd, B4, B4-bwd, B6, B6-bwd, B7 and B7-bwd against their
    plain versions at one rank's shapes in the ranks phase
    (``ranks_kernel_shapes``; PERF.md's tolerances), the dispatch's rows
    placed as the expert-parallel path places them (``_dispatch_rows``'
    ``mesh``: half the rows another rank's); timed at the full-width
    shapes. Returns the timed records by key."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import wkv6 as wk
    tp = RANKS_MESH[1]
    main, seen = {}, set()
    for row in ranks_kernel_shapes():
        dtype, arch = getattr(torch, row["dtype"]), row["arch"]
        timed = row["full"]
        recs = {}

        def first(kind):
            new = row[kind] is not None and (kind, row[kind],
                                             dtype) not in seen
            seen.add((kind, row[kind], dtype))
            return new
        if first("flash"):
            recs["flash_ranks"] = check_flash(torch, fa, *row["flash"],
                                              dtype, timed=timed)
            recs["flash_bwd_ranks"] = check_flash_bwd(
                torch, fa, *row["flash"], dtype, timed=timed)
        if first("moe"):
            T, D, Q, C = row["moe"]
            recs["moe_dispatch_ranks"] = check_moe_dispatch(
                torch, md, T, D, Q, C, dtype, timed=timed,
                positions="mesh", groups=row["rows"], tp=tp)
            recs["moe_dispatch_bwd_ranks"] = check_moe_dispatch_bwd(
                torch, md, T, D, Q, C, dtype, timed=timed,
                positions="mesh", groups=row["rows"], tp=tp)
        if first("wkv"):
            recs["wkv6_ranks"] = check_wkv_chunked(torch, wk, *row["wkv"],
                                                   dtype, timed=timed)
            recs["wkv6_bwd_ranks"] = check_wkv6_bwd(torch, wk, *row["wkv"],
                                                    dtype, timed=timed)
        if first("scan"):
            recs["linear_scan_ranks"] = check_linear_scan(
                torch, ls, *row["scan"], timed=timed)
            recs["linear_scan_bwd_ranks"] = check_linear_scan_bwd(
                torch, ls, *row["scan"], timed=timed)
        if timed:
            main.update({(k, arch): r for k, r in recs.items()})
    return main


def _mesh_reference(torch, cfg, params, toks, dp, grads: bool):
    """What a ("data", "model") mesh with ``dp`` data ranks computes, on
    one rank: the mean over the data shards of each shard's one-rank
    loss, metrics (and gradients, fp32), since the mesh averages the MoE
    stats over the data shards and every shard has as many tokens."""
    from repro_torch.core.tree import leaves
    from repro_torch.models import lm
    from repro_torch.train.train_step import value_and_grad
    b = toks.shape[0] // dp
    loss, mets, acc = 0.0, {}, None
    for d in range(dp):
        rows = toks[d * b:(d + 1) * b]
        if grads:
            (l, m), g = value_and_grad(params, rows, cfg)
            g = [x.double() / dp for x in leaves(g)]
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
        else:
            with torch.no_grad():
                l, m = lm.forward_loss(params, rows, cfg, remat=False)
        loss += float(l) / dp
        for k, v in m.items():
            mets[k] = mets.get(k, 0.0) + float(v) / dp
    return loss, mets, acc


def _ranks_smoke(torch, mesh, arch, sp, fsdp, rank, seed=0, check=True):
    """SMOKE ``arch`` in fp32 (TF32 off) on the mesh, SP and FSDP as
    given: forward_loss's loss, stats and gathered gradients on the
    rank's shards, each rank's kernel launches held to one gradient
    call; on rank 0 against ``_mesh_reference`` on the card: loss and
    stats within 1e-5 relative, every gradient within ``RANKS_GRAD_TOL``
    of its leaf's largest |value| (``ranks_grads_ok``; for
    ``RANKS_FLOAT64`` against the float64 witness, ``float64``). Rank 0
    keeps the gradients, ``grads``, for ``_ranks_same``. ``check=False``
    records the comparisons without holding them."""
    from repro_torch.configs.registry import SMOKE_CONFIGS
    from repro_torch.core.tree import leaves
    from repro_torch.models import lm
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding import make_policy
    from repro_torch.train import train_step as ts
    cfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    shape = tuple(mesh.shape)
    pol = make_policy(mesh, multi_pod=len(shape) == 3, sp=sp, fsdp=fsdp)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    whole = lm.init_params(cfg, gen, device="cuda", tp=pol.tp_size)
    B, S = RANKS_SMOKE_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed + 1)
                         ).cuda()
    params, _ = ts.place_train_state(whole, cfg, pol)
    mg = col.MeshGroups.of(pol)
    d, b = mg.batch_rank, B // mg.batch_size
    wrappers = _reset_launches()
    (loss, mets), grads = ts.value_and_grad(params, toks[d * b:(d + 1) * b],
                                            cfg, policy=pol)
    torch.cuda.synchronize()
    label = f"ranks {arch} fp32 {shape} sp={sp} fsdp={fsdp}"
    path = _train_launches(label, wrappers, cfg, S, 1)
    grads = ts.gathered_grads(grads, cfg, pol)
    rec = {"arch": arch, "mesh": list(shape), "sp": sp, "fsdp": fsdp,
           "loss": float(loss), **{k: float(v) for k, v in mets.items()},
           "path": path}
    if rank == 0:
        ref_loss, ref_mets, ref_g = _mesh_reference(torch, cfg, whole, toks,
                                                    pol.dp_size, True)
        errs = {"loss": abs(float(loss) - ref_loss) / abs(ref_loss)}
        for k, v in ref_mets.items():
            errs[k] = abs(rec[k] - v) / max(abs(v), 1e-30) if v else \
                abs(rec[k])
        rec["grads"] = leaves(grads)
        g_errs = [_err_of_max(g, r) for g, r in zip(rec["grads"], ref_g)]
        names = _leaf_names(whole)
        worst = max(range(len(g_errs)), key=g_errs.__getitem__)
        rec.update(ref_loss=ref_loss, errors=errs,
                   grad_err=g_errs[worst], grad_worst=names[worst])
        if arch in RANKS_FLOAT64:
            rec["float64"] = _float64_spread(torch, cfg, whole, toks,
                                             pol.dp_size, rec["grads"],
                                             ref_g, names)
        if check:
            require(all(e <= 1e-5 for e in errs.values()),
                    f"{label}: loss or stats off the one-rank card run: "
                    f"{errs}")
            require(ranks_grads_ok(rec),
                    f"{label}: gradient {names[worst]} off by "
                    f"{g_errs[worst]} of its largest; against float64: "
                    f"{rec.get('float64')}")
    return rec


def ranks_grads_ok(rec) -> bool:
    """An fp32 SMOKE run's gradients (``_ranks_smoke``'s record) within
    ``RANKS_GRAD_TOL`` of each leaf's largest |value| of the one-rank
    card runs; where there is a float64 witness, no further from it on
    any leaf than the one-rank card runs are, plus ``RANKS_GRAD_TOL``."""
    if "float64" in rec:
        return rec["float64"]["excess"] <= RANKS_GRAD_TOL
    return rec["grad_err"] <= RANKS_GRAD_TOL


def _float64_spread(torch, cfg, whole, toks, dp, grads, one_rank, names):
    """The one-rank gradient of ``_mesh_reference`` in float64 on the CPU
    (the port's fp32 casts keep float64, ``Tensor.float`` the identity on
    a float64 tensor while it runs, and the WKV takes its plain version:
    its wrapper takes float32 and bfloat16), and each leaf's max
    |difference| from it over its largest |value| of the run's gradients
    (``grads``) and of the one-rank card run's (``one_rank``): the worst
    of each, and the largest excess of the run's over the one-rank run's
    on a leaf."""
    from repro_torch.core.tree import map_tree
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import rwkv
    cast, kernel = torch.Tensor.float, rwkv.wkv6_chunked
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else cast(t)
    rwkv.wkv6_chunked = lambda *a, chunk: wk.wkv6_chunked_plain(*a,
                                                                chunk=chunk)
    try:
        exact = _mesh_reference(torch, cfg,
                                map_tree(lambda x: x.cpu().double(), whole),
                                toks.cpu(), dp, True)[2]
    finally:
        torch.Tensor.float, rwkv.wkv6_chunked = cast, kernel
    run = [_err_of_max(g.cpu(), e) for g, e in zip(grads, exact)]
    one = [_err_of_max(g.cpu(), e) for g, e in zip(one_rank, exact)]
    excess = [a - b for a, b in zip(run, one)]
    w = max(range(len(excess)), key=excess.__getitem__)
    return {"run": max(run), "one_rank": max(one), "excess": excess[w],
            "excess_leaf": names[w]}


def _ranks_same(rec, base):
    """Rank 0: an fp32 run against another on the same weights and tokens
    (SP against none, the pod mesh against the (2, 2) one): loss and
    stats within 1e-5 relative, every gradient within 1e-4 of its leaf's
    largest |value|."""
    errs = {k: abs(rec[k] - base[k]) / max(abs(base[k]), 1e-30)
            for k in ("loss", "ce", "moe_aux", "moe_dropped")}
    g = max(_err_of_max(a, b) for a, b in zip(rec["grads"], base["grads"]))
    rec["vs"] = {"mesh": base["mesh"], "sp": base["sp"], "errors": errs,
                 "grad_err": g}
    require(max(errs.values()) <= 1e-5 and g <= 1e-4,
            f"{rec['path']['label']}: off {base['path']['label']}: "
            f"{errs}, gradients {g}")


def _ranks_full(torch, mesh, arch, rank, layers, steps, seed=0, lr=3e-4):
    """``arch`` at full width and ``layers`` layers in bf16 on the mesh
    under the launcher's production policy (SP, FSDP, ZeRO-1), ``steps``
    steps on one repeated RANKS_FULL_SHAPE batch: each step's loss and
    seconds, the rank's peak memory, its kernels' launches held to one
    gradient call a step, one step's collectives and bytes; on rank 0 the
    losses finite and falling, step 1's within 2e-2 of
    ``_mesh_reference`` on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.timing import Timer
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding import make_policy
    from repro_torch.train import train_step as ts
    cfg = get_config(arch).scaled(n_layers=layers)
    pol = make_policy(mesh, sp=True, fsdp=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    whole = lm.init_params(cfg, gen, device="cuda", tp=pol.tp_size)
    B, S = RANKS_FULL_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed + 1)
                         ).cuda()
    ref = None
    if rank == 0:
        ref = _mesh_reference(torch, cfg, whole, toks, pol.dp_size,
                              False)[0]
    params, opt = ts.place_train_state(whole, cfg, pol)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    step = ts.make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=1,
                                               total_steps=100), policy=pol)
    wrappers = _reset_launches()
    losses, secs, colls = [], [], None
    for _ in range(steps):
        torch.cuda.synchronize()
        col.reset_counts()
        t = Timer()
        params, opt, m = step(params, opt, toks)
        losses.append(float(m["loss"]))
        secs.append(t.elapsed())
        colls = col.counts()
    label = f"ranks {arch} bf16 sp=True"
    path = _train_launches(label, wrappers, cfg, S, steps)
    rec = {"arch": arch, "sp": True, "layers": layers, "batch": B, "seq": S,
           "losses": losses, "step_s": secs,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "collectives_a_step": colls, "path": path}
    if rank == 0:
        rec["ref_loss"] = ref
        require(all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0],
                f"{label}: losses {losses} not finite and falling")
        require(abs(losses[0] - ref) <= 2e-2 * abs(ref),
                f"{label}: step 1's loss {losses[0]} against the one-rank "
                f"card run's {ref}")
    return rec


def ranks_main(rank, store, smoke=RANKS_SMOKE, full=RANKS_FULL):
    """One rank of the ranks phase: the two meshes over ``cuda`` (rank r
    on card r % count: all on the one card here), then the fp32 SMOKE
    comparisons (``RANKS_SMOKE_RUNS``) and the full-width bf16 runs
    (``RANKS_FULL``)."""
    import torch
    from repro_torch.core.timing import Timer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import collectives as col
    torch.backends.cuda.matmul.allow_tf32 = False
    t = Timer()
    meshes = {shape: make_mesh(shape, _ranks_axes(shape), device="cuda",
                               backend=RANKS_BACKEND, store=store,
                               rank=rank)
              for shape in (RANKS_MESH, RANKS_POD_MESH)}
    out = {"rank": rank, "torch": torch.__version__, "smoke": [],
           "full": [], "ops": {}, "mesh_s": t.elapsed(),
           "device": f"cuda:{torch.cuda.current_device()}"}

    def tally(calls):
        for k, v in calls.items():
            out["ops"][k] = out["ops"].get(k, 0) + v["calls"]
    for arch in smoke:
        runs = []
        for shape, sp, fsdp in RANKS_SMOKE_RUNS:
            col.reset_counts()
            t = Timer()
            rec = _ranks_smoke(torch, meshes[shape], arch, sp, fsdp, rank)
            if rank == 0 and sp:
                _ranks_same(rec, runs[-1])
            rec["seconds"] = t.elapsed()
            tally(col.counts())
            runs.append(rec)
        for rec in runs:
            rec.pop("grads", None)
        out["smoke"] += runs
    for arch, layers, steps in full:
        t = Timer()
        out["full"].append(_ranks_full(torch, meshes[RANKS_MESH], arch,
                                       rank, layers, steps))
        out["full"][-1]["seconds"] = t.elapsed()
        tally(out["full"][-1]["collectives_a_step"])
    return out


def phase_ranks(torch, smi, smoke=RANKS_SMOKE, full=RANKS_FULL):
    """Four processes sharing the card over gloo on a (2, 2) ("data",
    "model") mesh and a (2, 1, 2) ("pod", "data", "model") mesh
    (``launch.mesh.spawn``; the kernels built by the build phase, loaded
    from its directory): the fp32 SMOKE comparisons and the full-width
    bf16 training of ``ranks_main``. A rank that fails fails the phase.
    Returns the ranks' paths, with their launches summed, for the
    kernels line."""
    from repro_torch.launch.mesh import spawn
    world = math.prod(RANKS_MESH)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        recs = spawn(ranks_main, world, smoke, full, timeout=RANKS_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        raise Check(f"ranks: {e}") from e
    emit({"phase": "ranks", "world": world,
          "meshes": {str(m): _ranks_axes(m)
                     for m in (RANKS_MESH, RANKS_POD_MESH)},
          "backend": RANKS_BACKEND,
          "devices": sorted({r["device"] for r in recs}),
          "torch": recs[0]["torch"],
          "mesh_s_by_rank": [r["mesh_s"] for r in recs],
          "gloo_ops_on_cuda_tensors": sorted(recs[0]["ops"]),
          "ops_calls_by_rank": [r["ops"] for r in recs]})
    paths = {}
    for kind in ("smoke", "full"):
        for i, first in enumerate(recs[0][kind]):
            row = {k: v for k, v in first.items() if k != "path"}
            if kind == "full":
                for k in ("losses", "step_s", "peak_gb"):
                    row[k + "_by_rank"] = [r[kind][i][k] for r in recs]
                row["nvidia_smi"] = smi
            emit({"phase": "ranks", "run": kind, **row})
            label = first["path"]["label"]
            launches = {}
            for r in recs:
                for n, c in r[kind][i]["path"]["launches"].items():
                    launches[n] = launches.get(n, 0) + c
            paths[label] = dict(first["path"], launches=launches)
    return list(paths.values())


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


def require_no_spill(log: str, names) -> None:
    """Fail when nvcc's ``-Xptxas -v`` output ``log`` shows a kernel whose
    name holds one of ``names`` spilling to local memory, or shows none
    of them."""
    seen, cur = set(), None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((n for n in names if n in ln), None)
            seen.update([cur] if cur else [])
        elif cur is not None and "spill" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            require(m is not None and m.groups() == ("0", "0"),
                    f"build: {cur} spills: {ln.strip()}")
    require(seen == set(names), f"build: no ptxas record of "
                                f"{sorted(set(names) - seen)}")


def _kernel_row(name, rec, src, replaces, by_path, main, more):
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
    if "fwd_lse_ms" in rec:     # B2 at the same shape, without and with lse
        row["b2_with_lse"] = {k: rec.get(k) for k in (
            "fwd_ms", "fwd_lse_ms", "fwd_plain_ms", "fwd_library_ms",
            "fwd_bound_ms", "fwd_bound_by")}
    if more:
        row["also_at"] = [{k: main[m].get(k) for k in (
            "shape", "dtype", "max_err", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "x_library", "fwd_ms", "fwd_lse_ms")
            if k in main[m]} for m in more]
    return row


RANKS_KEYS = {"flash_attention": "flash_ranks",
              "flash_attention_bwd": "flash_bwd_ranks",
              "moe_dispatch": "moe_dispatch_ranks",
              "moe_dispatch_bwd": "moe_dispatch_bwd_ranks",
              "wkv6_chunked": "wkv6_ranks",
              "wkv6_chunked_bwd": "wkv6_bwd_ranks",
              "linear_scan": "linear_scan_ranks",
              "linear_scan_bwd": "linear_scan_bwd_ranks"}


def kernel_line(main, serves):
    """One row per kernel: its times at the main serving (or training)
    shape, its launches summed over the serve and train runs of the paths
    that run it (each path's own count in ``launches_by_path``). Every
    kernel must have run on exactly the paths that declare it, and on at
    least one. B2's and B2-bwd's (192, 128) instances have rows of their
    own, at deepseek-v2-lite-16b's shape, with the launches of the MLA
    paths."""
    rows = []
    for name, key, src, replaces, more in (
            ("flash_attention", ("flash", 1531), "flash_attention.cu",
             FLASH_REPLACES, (("flash", 200), ("flash", 1000),
                              ("flash_moonshot", 1000),
                              ("flash_moonshot", 1900),
                              ("flash_jamba", 1900), ("flash_danube", 4500),
                              ("flash_danube", 7000),
                              ("flash_nemotron", 1900), ("flash_mla", 1000),
                              ("flash_mla", 1900))),
            ("paged_decode_attention", ("paged", 128), "paged_attention.cu",
             PAGED_REPLACES, (("paged", 16), ("paged_moonshot", 128),
                              ("paged_nemotron", 128),
                              ("paged_musicgen", 128))),
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
                            ("moe_dispatch_jamba", "decode"))),
            ("flash_attention_bwd", ("flash_bwd", 4096),
             "flash_attention_bwd.cu", FLASH_BWD_REPLACES, ()),
            ("moe_dispatch_bwd", ("moe_dispatch_bwd", "prefill"),
             "moe_dispatch.cu", MOE_BWD_REPLACES, ()),
            ("linear_scan_bwd", ("linear_scan_bwd", 256), "linear_scan.cu",
             SCAN_BWD_REPLACES, ()),
            ("wkv6_chunked_bwd", ("wkv6_bwd", 4096), "wkv6_bwd.cu",
             WKV_BWD_REPLACES, (("wkv6_bwd", 1531),))):
        rec = main[key]
        # the same kernel at one rank's shapes of the ranks phase
        more = more + tuple(k for k in main
                            if k[0] == RANKS_KEYS.get(name))
        by_path = {s["label"]: s["launches"][name] for s in serves
                   if s["launches"][name]}
        declared = {s["label"] for s in serves if name in s["launch_path"]}
        require(by_path and set(by_path) == declared,
                f"{name} ran on the paths {sorted(by_path)}, not on "
                f"{sorted(declared)}")
        rows.append(_kernel_row(name, rec, src, replaces, by_path, main,
                                more))
    by_path = {s["label"]: s["launches"]["flash_attention"] for s in serves
               if s.get("mla")}
    require(by_path and all(by_path.values()),
            f"{FLASH_MLA_KERNEL} ran on no MLA serve path: {by_path}")
    rows.append(_kernel_row(
        FLASH_MLA_KERNEL, main[("flash_mla", 1900)], "flash_attention.cu",
        FLASH_REPLACES, by_path, main, (("flash_mla", 1000),
                                        ("flash_mla_fp32", 1000),
                                        ("flash_mla_fp32", 1900))))
    # B2-bwd's (192, 128) instance: the launches of the MLA train path
    by_path = {s["label"]: s["launches"]["flash_attention_bwd"]
               for s in serves if s.get("mla")
               and s["launches"]["flash_attention_bwd"]}
    require(by_path, "B2-bwd at (192, 128) ran on no MLA train path")
    rows.append(_kernel_row(
        "flash_attention_bwd<192, 128>", main[("flash_bwd_mla", 4096)],
        "flash_attention_bwd.cu", FLASH_BWD_REPLACES, by_path, main,
        (("flash_bwd_mla", 1900),)))
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--only", choices=("train", "examples", "ranks"),
                    help="build, then run only these phases (train: the "
                         "backward kernels' rows and the training phases "
                         "of the --arch configs; examples: the examples "
                         "phase; ranks: the ranks phase); prints no "
                         "result line")
    ap.add_argument("--train-layers", type=int,
                    help="with --only train: the depth of every --arch "
                         "config in the train phase (default: TRAIN_RUNS')")
    ap.add_argument("--train-seq", type=int,
                    help="with --only train: the tokens a row of every "
                         "--arch config in the train phase (default: "
                         "TRAIN_RUNS')")
    ap.add_argument("--arch", action="append", choices=TRAIN_ARCHS,
                    help="with --only train: the configs to train (each "
                         "once; all four if not given)")
    args = ap.parse_args(argv)
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
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.serve.api import EngineConfig
        from repro_torch.sharding import make_policy
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
        # B2-bwd's tensor-core kernels hold dK, dV and two score tiles in
        # registers: any spill is a regression
        require_no_spill(_build.build_log("flash_attention_bwd"),
                         FLASH_BWD_BF16_KERNELS)
        if args.only == "ranks":
            seconds("kernels", "ranks", check_ranks_kernels, torch)
            seconds("ranks", "", phase_ranks, torch, smi)
            emit({"phase": "total", "seconds": total.elapsed()})
            print(smi, flush=True)
            return 0
        if args.only == "examples":
            seconds("examples", "", phase_examples, torch, smi)
            emit({"phase": "total", "seconds": total.elapsed()})
            print(smi, flush=True)
            return 0
        if args.only == "train":
            from repro_torch.kernels import flash_attention as fa
            archs = tuple(dict.fromkeys(args.arch or TRAIN_ARCHS))
            if "qwen3-8b" in archs:
                seconds("kernels", "flash_bwd", check_flash_bwd_train,
                        torch, fa)
            if set(archs) - {"qwen3-8b"}:
                seconds("kernels", "bwd", phase_kernels_bwd, torch)
            train_recs = {}
            run_train_phases(torch, archs, args.train_layers,
                             args.train_seq, train_recs)
            seconds("dryrun", "", phase_dryrun, torch, train_recs)
            emit({"phase": "total", "seconds": total.elapsed()})
            print(smi, flush=True)
            return 0
        main_shapes = seconds("kernels", "all", phase_kernels, torch)
        main_shapes.update(seconds("kernels", "bwd", phase_kernels_bwd,
                                   torch))
        main_shapes.update(seconds("kernels", "ranks", check_ranks_kernels,
                                   torch))
        cfg = get_config("qwen3-8b")
        rcfg = get_config("rwkv6-1.6b")
        mcfg = get_config("moonshot-v1-16b-a3b")
        # jamba at full width and half depth: 16 of 32 layers, two whole
        # periods of its 8-layer pattern (14 Mamba, 2 attention, 8 MoE
        # MLPs), 52.1 GB of bf16 weights; the whole model's 103 GB does
        # not fit one 80 GB card
        jcfg = get_config("jamba-v0.1-52b").scaled(n_layers=16)
        for c in (cfg, rcfg, mcfg):
            seconds("model", c.name, phase_model, torch,
                    c.scaled(n_layers=2, dtype="float32"))
            gc.collect()
        # jamba's first two layers are both Mamba: the 2-layer model takes
        # an attention layer (dense MLP, first_dense) and a Mamba layer
        # (MoE MLP), ~14.5 GB of fp32 weights on each side
        seconds("model", jcfg.name, phase_model, torch,
                jcfg.scaled(n_layers=2, dtype="float32",
                            layer_pattern=("attn", "mamba")))
        gc.collect()
        # the rest of the dense family; h2o-danube-3-4b also on a prompt
        # past its 4096-token window (B2's band, the rolled ring) and 8
        # decode steps around the ring
        dcfg = get_config("h2o-danube-3-4b")
        ncfg = get_config("nemotron-4-15b")
        # (nemotron-4-15b and chameleon-34b at one layer, for time: their
        # CPU side is the slowest of the 2-layer runs)
        for name in DENSE_FAMILY:
            depth = 1 if name in ("nemotron-4-15b", "chameleon-34b") else 2
            seconds("model", name, phase_model, torch,
                    get_config(name).scaled(n_layers=depth,
                                            dtype="float32"))
            gc.collect()
        # one prompt past the window, at one layer (the CPU's banded
        # attention dominates): B2's band, the rolled ring, 8 decode steps
        # around it, and the rotary angles at long positions (since the
        # frequencies carry the reference's bits, the card's K slab stays
        # within 2e-3 of the CPU's); 7000 tokens, danube's longest served
        # prompt, where a 4500- and an 8100-token run took 63-66 s
        seconds("model", f"{dcfg.name} {DANUBE_LONG}", phase_model, torch,
                dcfg.scaled(n_layers=1, dtype="float32"),
                n_prompt=DANUBE_LONG, n_seq=1, steps=8)
        gc.collect()
        # deepseek-v2-lite-16b: its dense first layer and an MoE layer, MLA
        # prefill through B2's (192, 128) instance, decode through the
        # latent pools
        scfg = get_config("deepseek-v2-lite-16b")
        seconds("model", scfg.name, phase_model, torch,
                scfg.scaled(n_layers=2, dtype="float32"))
        gc.collect()
        serves = []
        # moonshot and jamba last, each alone on the card after the
        # others' weights are freed: moonshot's 56.7 GB of bf16 weights and
        # 640-page pool (4.0 GB), jamba's 52.1 GB; 200 pages make either
        # park (moonshot's largest request needs 121 pages, jamba's two
        # largest worst-case footprints 121 + 98 on the dense layout)
        # rwkv6's 1531-token prefill (B4) and moonshot's 1900-token one
        # (B7) are traced as well. h2o-danube-3-4b serves prompts around
        # and past its window at cache_len 8192 (4096-row ring slabs); its
        # two largest worst-case footprints, 440 + 377 pages, do not fit
        # 700 together, so that run parks; its 7000-token prefill and
        # nemotron-4-15b's 1900-token one are traced (B2 in its band, B2
        # at G 6). deepseek-v2-lite-16b serves on the latent layout; 200
        # pages make it park; its 1900-token prefill is traced (B2's (192,
        # 128) instance in each layer). For time, beside the train phases,
        # moonshot serves at 6 of its 48 layers, deepseek at 4 of its 27,
        # danube at 6 of 24, nemotron at 8 of 32 and jamba at 8 (one
        # whole period of its pattern: 7 Mamba layers, 1 attention, 4 MoE
        # MLPs); pages count tokens, so the runs that parked still park
        for c, layout, n_pages, park, traced, cache_len, lens in (
                (cfg, "paged", 640, None, None, 2048, PROMPT_LENS),
                (rcfg, "recurrent", 4, 3, 1531, 2048, PROMPT_LENS),
                (dcfg.scaled(n_layers=6), "dense", 2048, 700, 7000, 8192,
                 DANUBE_PROMPT_LENS),
                (ncfg.scaled(n_layers=8), "paged", 640, None, 1900, 2048,
                 PROMPT_LENS),
                (mcfg.scaled(n_layers=6), "paged", 640, 200, 1900, 2048,
                 PROMPT_LENS),
                (scfg.scaled(n_layers=4), "latent", 640, 200, 1900, 2048,
                 PROMPT_LENS),
                (jcfg.scaled(n_layers=8), "dense", 640, 200, None, 2048,
                 PROMPT_LENS)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ecfg = EngineConfig(slots=4, cache_len=cache_len, page_size=16,
                                n_pages=n_pages, decode_span=8, eos_token=-1,
                                kv_layout=layout, prefill_chunk=0,
                                prefix_cache_entries=0)
            # qwen3-8b paged serves under the one-rank cuda mesh's
            # sharding policy, its second run under NULL_POLICY
            main = c is cfg and layout == "paged"
            serves.append(seconds(
                "serve", f"{c.name} {layout}", phase_serve, torch, c, ecfg,
                serve_path(c, layout), prompt_lens=lens, park_pages=park,
                trace_prefill=traced,
                policy=make_policy(make_smoke_mesh("cuda")) if main else None,
                want_digest=QWEN3_PAGED_DIGEST if main else None))
        # chunked prefill and the prefix cache: qwen3-8b on paged at 5 and
        # on dense at 4 of its 36 layers (for time)
        for c, layout in ((cfg.scaled(n_layers=5), "paged"),
                          (cfg.scaled(n_layers=4), "dense")):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            serves.append(seconds("serve_prefix", f"{c.name} {layout}",
                                  phase_serve_prefix, torch, c, layout))
        # stochastic sampling, then sampled serving and the live front
        # end on qwen3-8b paged at full depth
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        phase_sampling(torch)
        seconds("substrate", "", phase_substrate, torch, smi)
        gc.collect()
        torch.cuda.empty_cache()
        sampled, params = phase_serve_sampled(
            torch, cfg, serves[0]["streams_sha256"])
        serves.append(sampled)
        fe_rec = phase_frontend(torch, cfg, params)
        # crash and restore: the front end's run on qwen3-8b paged, then
        # the other three layouts at full width, each alone on the card
        serves += phase_crash_frontend(torch, cfg, params, fe_rec)
        del params
        for name, layout, *rest in CRASH_LAYOUTS:
            gc.collect()
            torch.cuda.empty_cache()
            serves += phase_crash_layout(torch, get_config(name), layout,
                                         *rest)
        gc.collect()
        torch.cuda.empty_cache()
        train_recs = {}
        serves += run_train_phases(torch, train_recs=train_recs)
        seconds("dryrun", "", phase_dryrun, torch, train_recs)
        gc.collect()
        torch.cuda.empty_cache()
        serves += seconds("ranks", "", phase_ranks, torch, smi)
        gc.collect()
        torch.cuda.empty_cache()
        serves += seconds("examples", "", phase_examples, torch, smi)
        emit(kernel_line(main_shapes, serves))
        emit({"phase": "total", "seconds": total.elapsed()})
    except Check as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        # the one-rank group the smoke mesh started (serve and train)
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
