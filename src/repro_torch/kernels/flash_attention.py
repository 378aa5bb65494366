"""Causal flash attention (kernel B2) and its backward, GQA-native,
optional SWA.

``flash_attention`` is the wrapper of the hand-written CUDA kernel in
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``; with ``return_lse`` it
also returns each row's log-sum-exp, which training saves.
``flash_attention_bwd`` wraps ``csrc/flash_attention_bwd.cu``, which
replaces the reference model's jnp custom VJP ``_flash_bwd``
(``repro.models.attention``): dq, dk and dv from the forward's out and
lse, at every (hd, hd_v) of ``INSTANCES``, bf16 on the tensor cores and
fp32 on the CUDA cores. With grad on and an input
that requires it, ``flash_attention`` goes through ``FlashAttention``,
the autograd Function of B2 with its lse and B2-bwd.
``flash_attention_plain`` and ``flash_attention_bwd_plain`` are the
same functions in plain PyTorch (O(S^2) masked softmaxes, the
``ref.flash_attention_ref`` oracle and the VJP's formulas): each wrapper
takes its plain version only for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernels against them. On ``meta`` tensors
each wrapper returns its kernel's outputs as shapes alone, for the dry
run; each call's work (``kernels/work.py``) goes to the cost walk.

Layouts follow the JAX package: q [B,H,S,hd], k [B,KV,S,hd], v
[B,KV,S,hd_v] -> [B,H,S,hd_v]. The TPU kernel takes one hd for all four;
the port's kernel computes what the reference model's prefill attention
computes, which lets v carry its own head dim (MLA: q/k 192, v 128).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, work

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims of the instances with hd_v == hd
HEAD_DIMS = (16, 32, 64, 128)
# every (hd, hd_v) instance: the square ones and MLA's q/k 192 with v 128
INSTANCES = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)


def _visible(S: int, window: int, device) -> torch.Tensor:
    """[S, S] mask: key j visible from query i (causal, +SWA)."""
    pos = torch.arange(S, device=device)
    m = pos[None, :] <= pos[:, None]
    if window > 0:
        m &= pos[None, :] > pos[:, None] - window
    return m


def flash_attention_plain(q, k, v, *, window: int = 0,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """O(S^2) reference: repeat KV heads, masked fp32 softmax. The
    probabilities are cast to the value dtype before normalisation, as
    the JAX model's attention scan casts them, so bf16 results round at
    the same points. ``return_lse`` also gives each row's natural-log
    log-sum-exp [B,H,S] float32, ``max + log(sum)`` as the reference's
    scan forms it."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.repeat_interleave(G, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    s = torch.where(_visible(S, window, q.device), s,
                    torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    l = e.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(e.to(v.dtype).float(), vf.float())
    out = (out / l_safe).to(q.dtype)
    if return_lse:
        return out, (mx + torch.log(l_safe))[..., 0]
    return out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, window: int = 0,
                              scale: Optional[float] = None):
    """dq, dk, dv of ``flash_attention`` in plain PyTorch, as the
    reference's ``_flash_bwd`` forms them: p recomputed from lse,
    delta = rowsum(dout * out), ds = p (dout v^T - delta) scale, all in
    fp32, dk and dv summed over each KV head's G query heads, cast to the
    input dtype at the end."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf, of, dof = q.float(), out.float(), dout.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(_visible(S, window, q.device),
                    torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)

    def group_sum(t):                    # [B,H,S,d] -> [B,KV,S,d]
        return t.reshape(B, KV, G, S, t.shape[-1]).sum(2)
    return (dq.to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"want q [B,H,S,hd], k [B,KV,S,hd], v "
                         f"[B,KV,S,hd_v]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != hd \
            or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if (hd, v.shape[3]) not in INSTANCES:
        raise ValueError(f"head dims (q/k, v) ({hd}, {v.shape[3]}) must be "
                         f"one of {INSTANCES}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _aligned(*ts):
    """The bf16 kernels copy 16-byte chunks: a view at an odd offset (a
    one-token prompt's slice of a projection) is copied first."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


class FlashAttention(torch.autograd.Function):
    """B2 as the reference's ``_flash`` custom VJP: the forward writes out
    and lse and saves ``(q, k, v, out, lse)``; the backward recomputes p
    from lse in kernel B2-bwd (``flash_attention_bwd``). q, k, v are
    [B,n,S,d] at an (hd, hd_v) of ``INSTANCES``."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, scale: float):
        out, lse = _flash_fwd(q, k, v, window, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.scale = window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), window=ctx.window,
            scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, window: int = 0,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Causal (+SWA) attention. CUDA tensors launch the B2 kernel (bf16 on
    the tensor cores, fp32 on the CUDA cores); CPU tensors take
    ``flash_attention_plain``. Anything else raises. ``return_lse``
    returns ``(out, lse)``, lse [B,H,S] float32 written by the same
    launch; without it the kernel writes out alone. With grad on and an
    input that requires it the call goes through ``FlashAttention``
    (its lse is saved, not returned: asking for it then raises). Meta
    tensors give out (and lse) with the kernel's shapes and dtypes and
    compute nothing: the dry run's path, never a fallback."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if return_lse:
            raise ValueError("flash_attention: the lse of a differentiated "
                             "call is saved for the backward, not returned")
        return FlashAttention.apply(q, k, v, int(window), float(scale))
    return _flash_fwd(q, k, v, window, scale, return_lse)


def _flash_fwd(q, k, v, window, scale, return_lse):
    where = _build.route("flash_attention", q, k, v)
    if where == "cpu":
        return flash_attention_plain(q, k, v, window=window, scale=scale,
                                     return_lse=return_lse)
    B, H, S, hd = q.shape
    hd_v = v.shape[3]
    work.report("flash_attention", work.flash_attention(
        B, H, k.shape[1], S, hd, hd_v, int(window), work.dtype_name(q),
        lse=return_lse))
    if where == "cuda":
        q, k, v = _aligned(q, k, v)
    out = q.new_empty((B, H, S, hd_v))
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if where == "meta":
        return (out, lse) if return_lse else out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(),
                            lse.data_ptr() if return_lse else None,
                            B, H, k.shape[1], S, hd, hd_v, int(window),
                            float(scale), _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, window: int = 0,
                        scale: Optional[float] = None):
    """dq, dk, dv of causal (+SWA) attention from the forward's ``out``
    and ``lse`` (``flash_attention(..., return_lse=True)``) and the
    output's gradient ``dout``, each in q's dtype, at every (hd, hd_v) of
    ``INSTANCES`` (MLA's q/k 192 with v 128 included). CUDA tensors
    launch the B2-bwd kernels, a dk/dv pass and a dq pass with no
    atomics (the same bits on every call): bf16 on the tensor cores (P
    and dS rounded to bf16 before their products, fp32 sums), fp32 on
    the CUDA cores; CPU tensors take ``flash_attention_bwd_plain``; meta
    tensors give dq, dk, dv (and allocate delta) with the kernels' shapes
    and compute nothing (the dry run). Anything else raises."""
    _check(q, k, v)
    B, H, S, hd = q.shape
    hd_v = v.shape[3]
    o_shape = (B, H, S, hd_v)
    if out.shape != o_shape or dout.shape != o_shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {o_shape} {q.dtype}; "
                         f"got {tuple(out.shape)} {out.dtype}, "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [{B},{H},{S}] float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    where = _build.route("flash_attention_bwd", q, k, v, out, lse, dout)
    if where == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         window=window, scale=scale)
    work.report("flash_attention_bwd", work.flash_attention_bwd(
        B, H, k.shape[1], S, hd, hd_v, int(window), work.dtype_name(q)))
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if where == "cuda":
        q, k, v, dout = _aligned(q, k, v, dout)
    # D_i = rowsum(dout * out) over the hd_v columns, one elementwise
    # reduction beside the kernels
    delta = (dout.float() * out.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if where == "meta":
        return dq, dk, dv
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            dout.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), B, H, k.shape[1], S, hd, hd_v,
                            int(window), float(scale), _DTYPES[q.dtype],
                            stream)
    _build.check(lib, err, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I,
                              ctypes.c_float, I, P]
    lib.flash_fwd.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_bwd.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                              I, ctypes.c_float, I, P]
    lib.flash_bwd.restype = I
    return lib
