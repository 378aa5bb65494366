"""Causal flash attention forward (kernel B2), GQA-native, optional SWA.

``flash_attention`` is the wrapper of the hand-written CUDA kernel in
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``. ``flash_attention_plain``
is the same function in plain PyTorch (an O(S^2) masked softmax, the
``ref.flash_attention_ref`` oracle): the wrapper takes it only for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel against it.

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

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims of the instances with hd_v == hd
HEAD_DIMS = (16, 32, 64, 128)
# every (hd, hd_v) instance: the square ones and MLA's q/k 192 with v 128
INSTANCES = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)


def flash_attention_plain(q, k, v, *, window: int = 0,
                          scale: Optional[float] = None):
    """O(S^2) reference: repeat KV heads, masked fp32 softmax. The
    probabilities are cast to the value dtype before normalisation, as
    the JAX model's attention scan casts them, so bf16 results round at
    the same points."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.repeat_interleave(G, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    pos = torch.arange(S, device=q.device)
    m = pos[None, :] <= pos[:, None]
    if window > 0:
        m &= pos[None, :] > pos[:, None] - window
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e.to(v.dtype).float(), vf.float())
    return (out / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)


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


def flash_attention(q, k, v, *, window: int = 0,
                    scale: Optional[float] = None):
    """Causal (+SWA) attention. CUDA tensors launch the B2 kernel (bf16 on
    the tensor cores, fp32 on the CUDA cores); CPU tensors take
    ``flash_attention_plain``. Anything else raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    # the bf16 kernel copies 16-byte chunks: a view at an odd offset (a
    # one-token prompt's slice of a projection) is copied first
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    B, H, S, hd = q.shape
    hd_v = v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = q.new_empty((B, H, S, hd_v))
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), B, H, k.shape[1], S, hd, hd_v,
                            int(window), float(scale), _DTYPES[q.dtype],
                            stream)
    _build.check(lib, err, "flash_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [P, P, P, P, I, I, I, I, I, I, I,
                              ctypes.c_float, I, P]
    lib.flash_fwd.restype = I
    return lib
