"""First-order linear recurrence h_t = a_t * h_{t-1} + b_t (kernel B6).

``linear_scan`` is the wrapper of the hand-written CUDA kernel in
``csrc/linear_scan.cu``, which replaces the Pallas TPU kernel
``repro.kernels.linear_scan.linear_scan``. ``linear_scan_plain`` is the
sequential loop of the ``ref.linear_scan_ref`` oracle in plain PyTorch:
the wrapper takes it only for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it.

Contract (the TPU kernel's): a, b [B, T, D, N] and h0 [B, D, N], float32
-> (h_all [B, T, D, N], h_last [B, D, N]), float32. The Mamba layer
(``models/mamba.py``) runs it once per prefill chunk, with
a = exp(dt * A) and b = (dt * x) B.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


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


def linear_scan(a, b, h0):
    """h_all, h_last of the recurrence. CUDA tensors launch the B6 kernel
    (one thread per (b, d, n) element, looping over t); CPU tensors take
    ``linear_scan_plain``."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return linear_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cuda or cpu, not {a.device}")
    if not all(t.is_contiguous() for t in (a, b, h0)):
        raise ValueError("linear_scan needs contiguous inputs")
    Bt, T, D, N = a.shape
    h_all = torch.empty_like(a)
    h_last = torch.empty_like(h0)
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("linear_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.linear_scan.argtypes = [P] * 5 + [I] * 4 + [P]
    lib.linear_scan.restype = I
    return lib
