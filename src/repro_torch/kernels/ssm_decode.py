"""One Mamba (S6) decode token: the state update and its C contraction
(kernel B5).

``ssm_decode_step`` is the wrapper of the hand-written CUDA kernel in
``csrc/ssm_decode.cu``, which replaces the Pallas TPU kernel
``repro.kernels.ssm_decode.ssm_decode_step``. ``ssm_decode_step_plain``
is the ``ref.ssm_decode_step_ref`` oracle in plain PyTorch: the wrapper
takes it only for CPU tensors, and the tests and ``chip_smoke.py`` hold
the kernel against it; ``meta`` tensors get the kernel's outputs as
shapes alone, for the dry run.

Contract (the TPU kernel's): h, dA [B, Di, N]; dtx (dt * x_conv) [B, Di];
B_ssm, C_ssm [B, N], all float32 -> (y [B, Di], h' [B, Di, N]) float32
with ``h' = dA * h + dtx (x) B_ssm`` and ``y = h' C_ssm^T``. The kernel
reduces over N within a warp, so N must divide 32; it indexes in 32 bits
with the batch on the grid's second axis, so B * Di * N < 2^31 and
B <= 65535 (``kernel_sizes_fit``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, work


def ssm_decode_step_plain(h, dA, dtx, B_ssm, C_ssm):
    """The oracle's two lines: the update, then the contraction."""
    h_new = dA * h + dtx[..., None] * B_ssm[:, None, :]
    return torch.einsum("bdn,bn->bd", h_new, C_ssm), h_new


def _check(h, dA, dtx, B_ssm, C_ssm):
    if h.dim() != 3 or dA.shape != h.shape:
        raise ValueError(f"ssm_decode_step: want h, dA [B,Di,N]; got "
                         f"{tuple(h.shape)}, {tuple(dA.shape)}")
    B, Di, N = h.shape
    if (tuple(dtx.shape) != (B, Di) or tuple(B_ssm.shape) != (B, N)
            or tuple(C_ssm.shape) != (B, N)):
        raise ValueError(f"ssm_decode_step: want dtx [{B},{Di}] and B_ssm, "
                         f"C_ssm [{B},{N}]; got {tuple(dtx.shape)}, "
                         f"{tuple(B_ssm.shape)}, {tuple(C_ssm.shape)}")
    ts = (h, dA, dtx, B_ssm, C_ssm)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssm_decode_step takes float32 inputs; got "
                        f"{[t.dtype for t in ts]}")
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"ssm_decode_step: all inputs must be on one "
                         f"device; got {devs}")


MAX_ELEMENTS = 1 << 31     # B * Di * N below this: 32-bit indices
MAX_BATCH = 65535          # the grid's second axis


def kernel_sizes_fit(B: int, Di: int, N: int) -> None:
    """Raise ValueError for sizes the B5 kernel does not take."""
    if N < 1 or 32 % N:
        raise ValueError(f"ssm_decode_step: the kernel reduces over N "
                         f"within a warp, so N must divide 32; got N={N}")
    if B > MAX_BATCH or B * Di * N >= MAX_ELEMENTS:
        raise ValueError(f"ssm_decode_step: the kernel takes B <= "
                         f"{MAX_BATCH} and B * Di * N < 2^31; got B={B}, "
                         f"Di={Di}, N={N}")


def ssm_decode_step(h, dA, dtx, B_ssm, C_ssm):
    """(y, h') of one token. CUDA tensors launch the B5 kernel (four n of
    one (b, d) a thread, or one where N < 4 or a pointer is not 16-byte
    aligned; y reduced over N with warp shuffles), which writes h' to a
    fresh tensor; CPU tensors take ``ssm_decode_step_plain``; meta
    tensors give (y, h') as shapes and compute nothing (the dry run)."""
    _check(h, dA, dtx, B_ssm, C_ssm)
    ts = (h, dA, dtx, B_ssm, C_ssm)
    where = _build.route("ssm_decode_step", *ts)
    if where == "cpu":
        return ssm_decode_step_plain(h, dA, dtx, B_ssm, C_ssm)
    B, Di, N = h.shape
    kernel_sizes_fit(B, Di, N)
    work.report("ssm_decode_step", work.ssm_decode_step(B, Di, N))
    y = torch.empty(B, Di, dtype=torch.float32, device=h.device)
    h_out = torch.empty_like(h)
    if where == "meta":
        return y, h_out
    lib = _lib()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = lib.ssm_decode(*(t.data_ptr() for t in ts), y.data_ptr(),
                             h_out.data_ptr(), B, Di, N, stream)
    _build.check(lib, err, "ssm_decode_step")
    ssm_decode_step.launches += 1
    return y, h_out


ssm_decode_step.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_decode")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssm_decode.argtypes = [P] * 7 + [I] * 3 + [P]
    lib.ssm_decode.restype = I
    return lib
