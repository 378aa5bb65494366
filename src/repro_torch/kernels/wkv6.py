"""RWKV-6 WKV recurrence: chunked prefill (kernel B4) and single-token
decode (kernel B3).

``wkv6_chunked`` and ``wkv6_decode`` are the wrappers of the hand-written
CUDA kernels in ``csrc/wkv6.cu``, which replace the Pallas TPU kernels
``repro.kernels.wkv6.wkv6_chunked`` and ``repro.kernels.wkv6.wkv6_decode``.
``wkv6_chunked_plain`` is the chunk math of the JAX model's
``wkv_chunked`` (zero padding of the ragged tail included) and
``wkv6_decode_plain`` the einsums of its decode step (the
``ref.wkv6_decode_ref`` oracle), in plain PyTorch: the wrappers take them
only for CPU tensors, and the tests and ``chip_smoke.py`` hold the
kernels against them. ``wkv6_chunked_passes_plain`` is the B4 kernel's
own chunk-parallel algorithm (every chunk's state increment, a scan of
the carry over the chunks, every chunk's output) in plain PyTorch, which
the CPU tests hold against the chunk-serial version and the JAX package.

Layouts follow the JAX package. Chunked: r, k, v, logw [B,S,H,hd] (logw
fp32 < 0), u [H,hd], state0 [B,H,hd,hd] -> y [B,S,H,hd] f32, state f32.
Decode: r, k, v, w [B,H,hd] (w the decay multiplier exp(logw)), u
[H,hd], state [B,H,hd,hd] -> y [B,H,hd] f32, a new state f32. r, k and v
are float32 or bfloat16 (upcast at load); everything else is float32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128      # B4 keeps a chunk's tiles and S_c on chip
MAX_CHUNK = 32


def wkv6_chunked_plain(r, k, v, logw, u, state0, chunk: int = 32):
    """Chunked WKV-6 in plain PyTorch, step for step the JAX model's
    ``wkv_chunked``: the tail is zero-padded to a whole chunk, and each
    chunk works from the cumulative log-decay."""
    B, S, H, hd = r.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    nc = (S + pad) // chunk

    def chunks(t):                                  # [nc, B, H, C, hd]
        return t.reshape(B, nc, chunk, H, hd).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, lw = (chunks(t) for t in (r, k, v, logw))
    causal_strict = torch.tril(torch.ones(chunk, chunk, device=r.device),
                               -1)
    u = u.float()
    state = state0.float()
    ys = []
    for ri, ki, vi, lwi in zip(rc, kc, vc, lw):
        cum = torch.cumsum(lwi, dim=2)              # inclusive
        cum_excl = cum - lwi
        r_dec = ri * torch.exp(cum_excl)
        A = torch.einsum("bhcd,bhxd->bhcx", r_dec, ki * torch.exp(-cum))
        A = A * causal_strict
        diag = torch.einsum("bhcd,bhcd->bhc", ri, u[None, :, None] * ki)
        y = torch.einsum("bhcx,bhxe->bhce", A, vi) + diag[..., None] * vi
        y = y + torch.einsum("bhcd,bhde->bhce", r_dec, state)
        w_last = torch.exp(cum[:, :, -1])           # [B,H,hd]
        k_carry = ki * torch.exp(cum[:, :, -1][:, :, None] - cum)
        state = w_last[..., None] * state + torch.einsum(
            "bhxd,bhxe->bhde", k_carry, vi)
        ys.append(y)
    y = torch.stack(ys)                             # [nc,B,H,C,hd]
    y = y.permute(1, 0, 3, 2, 4).reshape(B, nc * chunk, H, hd)[:, :S]
    return y, state


def wkv6_chunked_passes_plain(r, k, v, logw, u, state0, chunk: int = 32):
    """Chunked WKV-6 as the B4 kernel computes it, in three passes over
    all chunks at once: (a) each chunk's state increment dS_c = k_carry^T
    v and decay w_c = exp(cum_last); (b) the carry S_{c+1} = w_c * S_c +
    dS_c, the one step that runs chunk after chunk, giving the state S_c
    entering every chunk; (c) each chunk's output A v + diag v + r_dec
    S_c. The ragged tail is zero (k = v = 0, logw = 0), as the kernel
    masks it at load."""
    B, S, H, hd = r.shape
    C = min(chunk, S)
    nc = -(-S // C)
    pad = nc * C - S

    def chunks(t):                                  # [B, H, nc, C, hd]
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nc, C, H, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lw = (chunks(t) for t in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=3)
    # (a) chunk-parallel: increments and decays
    w = torch.exp(cum[..., -1, :])                  # [B, H, nc, hd]
    k_carry = kc * torch.exp(cum[..., -1:, :] - cum)
    dS = torch.einsum("bhncd,bhnce->bhnde", k_carry, vc)
    # (b) the carry, chunk after chunk, elementwise in (d, e)
    s_in = torch.empty_like(dS)
    state = state0.float()
    for c in range(nc):
        s_in[:, :, c] = state
        state = w[:, :, c, :, None] * state + dS[:, :, c]
    # (c) chunk-parallel: outputs
    r_dec = rc * torch.exp(cum - lw)
    A = torch.einsum("bhntd,bhnsd->bhnts", r_dec, kc * torch.exp(-cum))
    A = A * torch.tril(torch.ones(C, C, device=r.device), -1)
    diag = torch.einsum("bhntd,bhntd->bhnt", rc, u.float()[None, :, None,
                                                           None] * kc)
    y = torch.einsum("bhnts,bhnse->bhnte", A, vc) + diag[..., None] * vc
    y = y + torch.einsum("bhntd,bhnde->bhnte", r_dec, s_in)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, nc * C, H, hd)[:, :S]
    return y, state


def wkv6_decode_plain(r, k, v, w, u, state):
    """One WKV-6 token per (batch, head), as ``ref.wkv6_decode_ref``."""
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    y = torch.einsum("bhd,bhde->bhe", r, state + u[None, ..., None] * kv)
    return y, w[..., None] * state + kv


def _check_common(name, rkv, f32s, u, state):
    r = rkv[0]
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in rkv):
        raise TypeError(f"{name}: r, k, v must be one dtype, float32 or "
                        f"bfloat16; got {[t.dtype for t in rkv]}")
    if any(t.dtype != torch.float32 for t in (*f32s, u, state)):
        raise TypeError(f"{name}: the decay, u and the state must be "
                        f"float32; got {[t.dtype for t in (*f32s, u, state)]}")
    devs = {t.device for t in (*rkv, *f32s, u, state)}
    if len(devs) != 1:
        raise ValueError(f"{name}: all inputs must be on one device; got "
                         f"{devs}")


def _launch_checks(name, ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous inputs")


def wkv6_chunked(r, k, v, logw, u, state0, *, chunk: int = 32):
    """Chunked WKV-6 over a whole sequence. CUDA tensors launch the B4
    kernel, three device kernels a call in the passes of
    ``wkv6_chunked_passes_plain`` (the ragged tail is masked in the
    kernel, no padded copy; ``launches`` counts calls); CPU tensors take
    ``wkv6_chunked_plain``."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"wkv6_chunked: want r, k, v, logw [B,S,H,hd]; "
                         f"got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, S, H, hd = r.shape
    if tuple(u.shape) != (H, hd) or tuple(state0.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv6_chunked: want u [{H},{hd}] and state0 "
                         f"[{B},{H},{hd},{hd}]; got {tuple(u.shape)}, "
                         f"{tuple(state0.shape)}")
    if S < 1 or chunk < 1:
        raise ValueError(f"wkv6_chunked: need S >= 1 and chunk >= 1; got "
                         f"S={S}, chunk={chunk}")
    _check_common("wkv6_chunked", (r, k, v), (logw,), u, state0)
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, logw, u, state0, chunk=chunk)
    ts = (r, k, v, logw, u, state0)
    _launch_checks("wkv6_chunked", ts)
    C = min(chunk, S)
    if hd > MAX_HEAD_DIM or C > MAX_CHUNK:
        raise ValueError(f"wkv6_chunked: the kernel takes hd <= "
                         f"{MAX_HEAD_DIM} and chunks <= {MAX_CHUNK}; got "
                         f"hd={hd}, chunk={C}")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state0)
    # the kernel's workspace: each chunk's state increment, overwritten by
    # the state entering it, and each chunk's decay; rows padded to 4
    n_chunks, hdp = -(-S // C), -(-hd // 4) * 4
    ws = torch.empty(B * H * n_chunks * hdp * hdp, dtype=torch.float32,
                     device=r.device)
    wl = torch.empty(B * H * n_chunks * hdp, dtype=torch.float32,
                     device=r.device)
    lib = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = lib.wkv6_chunked(*(t.data_ptr() for t in ts), y.data_ptr(),
                               s_out.data_ptr(), ws.data_ptr(),
                               wl.data_ptr(), B, S, H, hd, C,
                               _DTYPES[r.dtype], stream)
    _build.check(lib, err, "wkv6_chunked")
    wkv6_chunked.launches += 1
    return y, s_out


wkv6_chunked.launches = 0


def wkv6_decode(r, k, v, w, u, state):
    """One WKV-6 token per (batch, head). CUDA tensors launch the B3
    kernel (a block per 16 value columns of one (batch, head)), which
    writes the new state to a fresh tensor; CPU tensors take
    ``wkv6_decode_plain``."""
    if r.dim() != 3 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6_decode: want r, k, v, w [B,H,hd]; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, hd = r.shape
    if tuple(u.shape) != (H, hd) or tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv6_decode: want u [{H},{hd}] and state "
                         f"[{B},{H},{hd},{hd}]; got {tuple(u.shape)}, "
                         f"{tuple(state.shape)}")
    _check_common("wkv6_decode", (r, k, v), (w,), u, state)
    if r.device.type == "cpu":
        return wkv6_decode_plain(r, k, v, w, u, state)
    ts = (r, k, v, w, u, state)
    _launch_checks("wkv6_decode", ts)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"wkv6_decode: the kernel takes hd <= "
                         f"{MAX_HEAD_DIM}; got {hd}")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state)
    lib = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = lib.wkv6_decode(*(t.data_ptr() for t in ts), y.data_ptr(),
                              s_out.data_ptr(), B, H, hd, _DTYPES[r.dtype],
                              stream)
    _build.check(lib, err, "wkv6_decode")
    wkv6_decode.launches += 1
    return y, s_out


wkv6_decode.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_chunked.argtypes = [P] * 10 + [I] * 6 + [P]
    lib.wkv6_chunked.restype = I
    lib.wkv6_decode.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.wkv6_decode.restype = I
    return lib
