"""First-order linear recurrence h_t = a_t * h_{t-1} + b_t (kernel B6).

``linear_scan`` is the wrapper of the hand-written CUDA kernel in
``csrc/linear_scan.cu``, which replaces the Pallas TPU kernel
``repro.kernels.linear_scan.linear_scan``. ``linear_scan_plain`` is the
sequential loop of the ``ref.linear_scan_ref`` oracle in plain PyTorch:
the wrapper takes it only for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it; ``meta`` tensors get the
kernel's outputs as shapes alone, for the dry run.

Contract (the TPU kernel's): a, b [B, T, D, N] and h0 [B, D, N], float32
-> (h_all [B, T, D, N], h_last [B, D, N]), float32. The Mamba layer
(``models/mamba.py``) runs it once per prefill chunk, with
a = exp(dt * A) and b = (dt * x) B.

Training: with grad on and an input that requires it, the wrapper goes
through ``_LinearScan``, whose backward is ``linear_scan_bwd``, the
wrapper of the hand-written B6-bwd kernel (``csrc/linear_scan.cu``): the
adjoint recurrence run from the last step down, as ``jax.grad`` of the
reference's ``_chunk_scan`` computes it. ``linear_scan_bwd_plain`` is
that loop in plain PyTorch; the CPU takes it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, work


def linear_scan_plain(a, b, h0):
    """The recurrence step by step: each step one multiply and one add,
    each rounding, as the kernel does."""
    T = a.shape[1]
    h_all = torch.empty_like(a)
    h = h0
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        h_all[:, t] = h
    return h_all, h


def _check(a, b, h0):
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"linear_scan: want a, b [B,T,D,N]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    Bt, _, D, N = a.shape
    if tuple(h0.shape) != (Bt, D, N):
        raise ValueError(f"linear_scan: want h0 [{Bt},{D},{N}]; got "
                         f"{tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise TypeError(f"linear_scan takes float32 a, b and h0; got "
                        f"{[t.dtype for t in (a, b, h0)]}")
    devs = {t.device for t in (a, b, h0)}
    if len(devs) != 1:
        raise ValueError(f"linear_scan: all inputs must be on one device; "
                         f"got {devs}")


def linear_scan_bwd_plain(a, h0, h_all, g_all, g_last):
    """(da, db, dh0) from the gradients g_all of h_all and g_last of
    h_last: lam_t = g_t + a_{t+1} lam_{t+1} (lam_T = g_T + g_last),
    db_t = lam_t, da_t = lam_t h_{t-1}, dh0 = a_1 lam_1, step by step
    from the last, each op rounding as the kernel's."""
    T = a.shape[1]
    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = g_last
    for t in range(T - 1, -1, -1):
        lam = g_all[:, t] + carry
        db[:, t] = lam
        da[:, t] = lam * (h_all[:, t - 1] if t > 0 else h0)
        carry = a[:, t] * lam
    return da, db, carry


class _LinearScan(torch.autograd.Function):
    """B6 under autograd: the forward saves a, h0 and h_all; the backward
    is B6-bwd (``linear_scan_bwd``)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h_all, h_last = _scan(a, b, h0)
        ctx.save_for_backward(a, h0, h_all)
        return h_all, h_last

    @staticmethod
    def backward(ctx, g_all, g_last):
        a, h0, h_all = ctx.saved_tensors
        g_all = torch.zeros_like(h_all) if g_all is None else g_all
        g_last = torch.zeros_like(h0) if g_last is None else g_last
        return linear_scan_bwd(a, h0, h_all, g_all.contiguous(),
                               g_last.contiguous())


def linear_scan(a, b, h0):
    """h_all, h_last of the recurrence. CUDA tensors launch the B6 kernel
    (one thread per (b, d, n) element, looping over t); CPU tensors take
    ``linear_scan_plain``; meta tensors give (h_all, h_last) as shapes
    and compute nothing (the dry run). With grad on and an input that
    requires it, the call goes through ``_LinearScan``."""
    _check(a, b, h0)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or h0.requires_grad):
        return _LinearScan.apply(a, b, h0)
    return _scan(a, b, h0)


def _scan(a, b, h0):
    where = _build.route("linear_scan", a, b, h0)
    if where == "cpu":
        return linear_scan_plain(a, b, h0)
    Bt, T, D, N = a.shape
    work.report("linear_scan", work.linear_scan(Bt, T, D, N))
    h_all = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if where == "meta":
        return h_all, h_last
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.linear_scan(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                              h_all.data_ptr(), h_last.data_ptr(), Bt, T, D,
                              N, stream)
    _build.check(lib, err, "linear_scan")
    linear_scan.launches += 1
    return h_all, h_last


linear_scan.launches = 0


def linear_scan_bwd(a, h0, h_all, g_all, g_last):
    """(da, db, dh0) of the recurrence from the saved a, h0, h_all and the
    gradients g_all [B,T,D,N] and g_last [B,D,N], all float32. CUDA
    tensors launch the B6-bwd kernel (one thread per (b, d, n) element,
    t looping downwards); CPU tensors take ``linear_scan_bwd_plain``;
    meta tensors give (da, db, dh0) as shapes and compute nothing."""
    _check(a, g_all, h0)
    if h_all.shape != a.shape or g_last.shape != h0.shape \
            or h_all.dtype != torch.float32 or g_last.dtype != torch.float32:
        raise ValueError(f"linear_scan_bwd: want h_all {tuple(a.shape)} and "
                         f"g_last {tuple(h0.shape)} float32; got "
                         f"{tuple(h_all.shape)} {h_all.dtype}, "
                         f"{tuple(g_last.shape)} {g_last.dtype}")
    ts = (a, h0, h_all, g_all, g_last)
    if len({t.device for t in ts}) != 1:
        raise ValueError("linear_scan_bwd: all inputs must be on one device")
    where = _build.route("linear_scan_bwd", *ts)
    if where == "cpu":
        return linear_scan_bwd_plain(*ts)
    Bt, T, D, N = a.shape
    work.report("linear_scan_bwd", work.linear_scan_bwd(Bt, T, D, N))
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), \
        torch.empty_like(h0)
    if where == "meta":
        return da, db, dh0
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.linear_scan_bwd(*(t.data_ptr() for t in ts),
                                  da.data_ptr(), db.data_ptr(),
                                  dh0.data_ptr(), Bt, T, D, N, stream)
    _build.check(lib, err, "linear_scan_bwd")
    linear_scan_bwd.launches += 1
    return da, db, dh0


linear_scan_bwd.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("linear_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.linear_scan.argtypes = [P] * 5 + [I] * 4 + [P]
    lib.linear_scan.restype = I
    lib.linear_scan_bwd.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.linear_scan_bwd.restype = I
    return lib
