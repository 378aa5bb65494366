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
kernels against them; ``meta`` tensors get the kernels' outputs as
shapes alone, for the dry run. ``wkv6_chunked_passes_plain`` is the B4 kernel's
own chunk-parallel algorithm (every chunk's state increment, a scan of
the carry over the chunks, every chunk's output) in plain PyTorch, which
the CPU tests hold against the chunk-serial version and the JAX package.

Training: with grad on and an input that requires it, ``wkv6_chunked``
goes through ``_Wkv6Chunked``, whose backward is ``wkv6_chunked_bwd``,
the wrapper of the hand-written B4-bwd kernels (``csrc/wkv6_bwd.cu``):
the gradients of (y, s_out) with respect to r, k, v, logw, u and state0,
with the gradient of s_out as the starting adjoint.
``wkv6_chunked_bwd_plain`` is ``torch.autograd.grad`` through
``wkv6_chunked_plain``, the reference's ``wkv_chunked`` step for step;
the CPU takes it. ``wkv6_chunked_bwd_passes_plain`` is the B4-bwd
kernels' own chunk-parallel algorithm in plain PyTorch, and
``wkv6_chunked_bwd_walk_plain`` the same function token by token; the
CPU tests hold both against autograd, each other in float64 and the
passes against the JAX package.

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

from repro_torch.kernels import _build, work

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128      # B4 keeps a chunk's tiles and S_c on chip
MAX_CHUNK = 32


def wkv6_chunked_plain(r, k, v, logw, u, state0, chunk: int = 32):
    """Chunked WKV-6 in plain PyTorch, step for step the JAX model's
    ``wkv_chunked``: the tail is zero-padded to a whole chunk, and each
    chunk works from the cumulative log-decay. It computes in float32, or
    in float64 where r is float64 (a reference for the fp32 paths)."""
    B, S, H, hd = r.shape
    ct = torch.promote_types(r.dtype, torch.float32)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    nc = (S + pad) // chunk

    def chunks(t):                                  # [nc, B, H, C, hd]
        return t.reshape(B, nc, chunk, H, hd).permute(1, 0, 3, 2, 4).to(ct)

    rc, kc, vc, lw = (chunks(t) for t in (r, k, v, logw))
    causal_strict = torch.tril(torch.ones(chunk, chunk, device=r.device),
                               -1)
    u = u.to(ct)
    state = state0.to(ct)
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


def wkv6_chunked_bwd_plain(r, k, v, logw, u, state0, dy, ds_out,
                           chunk: int = 32):
    """(dr, dk, dv, dlogw, du, dstate0): ``torch.autograd.grad`` of
    ``wkv6_chunked_plain``'s (y, s_out) against (dy, ds_out), each
    gradient in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in
               (r, k, v, logw, u, state0)]
        y, s_out = wkv6_chunked_plain(*ins, chunk=chunk)
        return torch.autograd.grad((y, s_out), ins, (dy, ds_out))


def wkv6_chunked_bwd_walk_plain(r, k, v, logw, u, state0, dy, ds_out):
    """The B4-bwd kernels' own algorithm in plain PyTorch, token by token:
    a forward walk of the state S gives dr, b_t = r_t * (S_{t-1} dy_t),
    du and Q_T = sum_e ds_out * S_T; a backward walk of the adjoint lam
    gives dk, dv, dstate0 = lam_0 and dlogw_t = Q_t - a_t with a_t = k_t *
    (lam_t v_t), carrying Q_{t-1} = Q_t - a_t + b_t. No state of any step
    is kept. It computes in float32, or in float64 where r is float64. The
    CPU tests hold it against ``wkv6_chunked_bwd_plain`` and, in float64,
    against ``wkv6_chunked_bwd_passes_plain``."""
    ct = torch.promote_types(r.dtype, torch.float32)
    f = [t.to(ct) for t in (r, k, v, logw)]
    r_, k_, v_, lw = (t.permute(1, 0, 2, 3) for t in f)    # [S,B,H,hd]
    w = torch.exp(lw)
    u = u.to(ct)[None]
    dyt = dy.to(ct).permute(1, 0, 2, 3)
    S = r_.shape[0]
    vdy = (v_ * dyt).sum(-1, keepdim=True)                  # [S,B,H,1]
    st = state0.to(ct)
    dr, b = torch.empty_like(r_), torch.empty_like(r_)
    for t in range(S):
        sdy = torch.einsum("bhde,bhe->bhd", st, dyt[t])
        dr[t] = sdy + u * k_[t] * vdy[t]
        b[t] = r_[t] * sdy
        st = w[t][..., None] * st + k_[t][..., None] * v_[t][..., None, :]
    du = (r_ * k_ * vdy).sum((0, 1))
    lam = ds_out.to(ct)
    q = (lam * st).sum(-1)
    dk, dv, dlw = (torch.empty_like(r_) for _ in range(3))
    for t in range(S - 1, -1, -1):
        lv = torch.einsum("bhde,bhe->bhd", lam, v_[t])
        dk[t] = lv + r_[t] * u * vdy[t]
        dv[t] = (torch.einsum("bhde,bhd->bhe", lam, k_[t])
                 + (r_[t] * u * k_[t]).sum(-1, keepdim=True) * dyt[t])
        a = k_[t] * lv
        dlw[t] = q - a
        q = q - a + b[t]
        lam = w[t][..., None] * lam + r_[t][..., None] * dyt[t][..., None, :]

    def back(x, like):
        return x.permute(1, 0, 2, 3).to(like.dtype)
    return (back(dr, r), back(dk, k), back(dv, v), back(dlw, logw), du, lam)


def wkv6_chunked_bwd_passes_plain(r, k, v, logw, u, state0, dy, ds_out,
                                  chunk: int = 32):
    """The B4-bwd kernels' own algorithm in plain PyTorch, B4's passes run
    backwards over chunks of C = min(chunk, S) tokens: (1) each chunk's
    state increment dS_c = k_carry^T v, decay w_c and adjoint increment
    G_c = r_dec^T dy_c; (2) the two carries, elementwise in (d, e): the
    adjoint lam_c = w_c * lam_{c+1} + G_c from lam_nc = ds_out down
    (dstate0 = lam_0), then the state S_{c+1} = w_c * S_c + dS_c from
    state0 up, with Q_c = sum_e lam_{c+1} * S_{c+1} per row; (3) each
    chunk's gradients from S_c and lam_{c+1} alone, with M =
    strictly_lower(dy v^T) and A B4's scores:
    dr' = exp(cum_excl) (dy S_c^T + M k_inv),
    dk' = exp(-cum) (M^T r_dec) + exp(cum_last - cum) (v lam_{c+1}^T),
    dv = A^T dy + diag(r . (u k)) dy + k_carry lam_{c+1}, u's bonus added
    to dr' and dk'; (4) dlogw_t = Q_t - a_t down the chunk from Q_c,
    carrying Q_{t-1} = Q_t - a_t + b_t with a_t = k_t dk'_t and b_t = r_t
    dr'_t. The ragged tail is zero (k = v = r = dy = 0, logw = 0), as the
    kernels mask it at load. It computes in float32, or in float64 where
    r is float64."""
    B, S, H, hd = r.shape
    ct = torch.promote_types(r.dtype, torch.float32)
    C = min(chunk, S)
    nc = -(-S // C)
    pad = nc * C - S

    def chunks(t):                                  # [B, H, nc, C, hd]
        t = torch.nn.functional.pad(t.to(ct), (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nc, C, H, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lw, gy = (chunks(t) for t in (r, k, v, logw, dy))
    cum = torch.cumsum(lw, dim=3)
    cum_excl = torch.nn.functional.pad(cum[..., :-1, :], (0, 0, 1, 0))
    e_excl, e_inv = torch.exp(cum_excl), torch.exp(-cum)
    e_carry = torch.exp(cum[..., -1:, :] - cum)
    r_dec, k_inv, k_carry = rc * e_excl, kc * e_inv, kc * e_carry
    # (1) chunk-parallel: increments and decays
    w = torch.exp(cum[..., -1, :, None])            # [B, H, nc, hd, 1]
    dS = torch.einsum("bhncd,bhnce->bhnde", k_carry, vc)
    G = torch.einsum("bhncd,bhnce->bhnde", r_dec, gy)
    # (2) the carries, chunk after chunk, elementwise in (d, e)
    lam_next = torch.empty_like(G)                  # lam_{c+1}
    lam = ds_out.to(ct)
    for c in range(nc - 1, -1, -1):
        lam_next[:, :, c] = lam
        lam = w[:, :, c] * lam + G[:, :, c]
    s_in = torch.empty_like(dS)
    q = torch.empty_like(w[..., 0])                 # Q at each chunk's end
    st = state0.to(ct)
    for c in range(nc):
        s_in[:, :, c] = st
        st = w[:, :, c] * st + dS[:, :, c]
        q[:, :, c] = (lam_next[:, :, c] * st).sum(-1)
    # (3) chunk-parallel: gradients
    strict = torch.tril(torch.ones(C, C, dtype=ct, device=r.device), -1)
    A = torch.einsum("bhntd,bhnsd->bhnts", r_dec, k_inv) * strict
    M = torch.einsum("bhnte,bhnse->bhnts", gy, vc) * strict
    vdy = (vc * gy).sum(-1, keepdim=True)           # [B, H, nc, C, 1]
    uk = u.to(ct)[None, :, None, None] * kc
    bonus = (rc * uk).sum(-1, keepdim=True)
    drp = e_excl * (torch.einsum("bhnte,bhnde->bhntd", gy, s_in)
                    + torch.einsum("bhnts,bhnsd->bhntd", M, k_inv))
    dkp = (e_inv * torch.einsum("bhnts,bhntd->bhnsd", M, r_dec)
           + e_carry * torch.einsum("bhnte,bhnde->bhntd", vc, lam_next))
    dv = (torch.einsum("bhnst,bhnse->bhnte", A, gy) + bonus * gy
          + torch.einsum("bhntd,bhnde->bhnte", k_carry, lam_next))
    dr = drp + uk * vdy
    dk = dkp + rc * u.to(ct)[None, :, None, None] * vdy
    du = (rc * kc * vdy).sum((0, 2, 3))
    # (4) dlogw within each chunk, from the carried Q
    a, b = kc * dkp, rc * drp
    dlw = torch.empty_like(a)
    for t in range(C - 1, -1, -1):
        dlw[..., t, :] = q - a[..., t, :]
        q = q - a[..., t, :] + b[..., t, :]

    def back(x, like):
        x = x.permute(0, 2, 3, 1, 4).reshape(B, nc * C, H, hd)[:, :S]
        return x.to(like.dtype)
    return (back(dr, r), back(dk, k), back(dv, v), back(dlw, logw),
            du.to(u.dtype), lam.to(state0.dtype))


class _Wkv6Chunked(torch.autograd.Function):
    """B4 under autograd: the forward saves its inputs; the backward is
    B4-bwd (``wkv6_chunked_bwd``) from the gradients of y and s_out (zero
    where unused)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0, chunk):
        ctx.save_for_backward(r, k, v, logw, u, state0)
        ctx.chunk = chunk
        return _chunked(r, k, v, logw, u, state0, chunk)

    @staticmethod
    def backward(ctx, dy, ds_out):
        r, k, v, logw, u, state0 = ctx.saved_tensors
        dy = (torch.zeros(r.shape, dtype=torch.float32, device=r.device)
              if dy is None else dy.contiguous())
        ds_out = torch.zeros_like(state0) if ds_out is None \
            else ds_out.contiguous()
        return (*wkv6_chunked_bwd(r, k, v, logw, u, state0, dy, ds_out,
                                  chunk=ctx.chunk), None)


def _check_chunked(r, k, v, logw, u, state0, chunk):
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


def wkv6_chunked(r, k, v, logw, u, state0, *, chunk: int = 32):
    """Chunked WKV-6 over a whole sequence. CUDA tensors launch the B4
    kernel, three device kernels a call in the passes of
    ``wkv6_chunked_passes_plain`` (the ragged tail is masked in the
    kernel, no padded copy; ``launches`` counts calls); CPU tensors take
    ``wkv6_chunked_plain``; meta tensors give (y, s_out) as shapes (and
    allocate the workspace) and compute nothing (the dry run). With grad
    on and an input that requires it, the call goes through
    ``_Wkv6Chunked``."""
    _check_chunked(r, k, v, logw, u, state0, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state0)):
        return _Wkv6Chunked.apply(r, k, v, logw, u, state0, chunk)
    return _chunked(r, k, v, logw, u, state0, chunk)


def _chunked(r, k, v, logw, u, state0, chunk):
    B, S, H, hd = r.shape
    ts = (r, k, v, logw, u, state0)
    where = _build.route("wkv6_chunked", *ts)
    if where == "cpu":
        return wkv6_chunked_plain(r, k, v, logw, u, state0, chunk=chunk)
    C = min(chunk, S)
    if hd > MAX_HEAD_DIM or C > MAX_CHUNK:
        raise ValueError(f"wkv6_chunked: the kernel takes hd <= "
                         f"{MAX_HEAD_DIM} and chunks <= {MAX_CHUNK}; got "
                         f"hd={hd}, chunk={C}")
    work.report("wkv6_chunked", work.wkv6_chunked(B, S, H, hd, C,
                                                  work.dtype_name(r)))
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state0)
    # the kernel's workspace: each chunk's state increment, overwritten by
    # the state entering it, and each chunk's decay; rows padded to 4
    n_chunks, hdp = -(-S // C), -(-hd // 4) * 4
    ws = torch.empty(B * H * n_chunks * hdp * hdp, dtype=torch.float32,
                     device=r.device)
    wl = torch.empty(B * H * n_chunks * hdp, dtype=torch.float32,
                     device=r.device)
    if where == "meta":
        return y, s_out
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


def wkv6_chunked_bwd(r, k, v, logw, u, state0, dy, ds_out, *,
                     chunk: int = 32):
    """(dr, dk, dv, dlogw, du, dstate0) of ``wkv6_chunked``'s (y, s_out)
    from their gradients dy [B,S,H,hd] and ds_out [B,H,hd,hd] (float32).
    CUDA tensors launch the B4-bwd kernels in chunks of C = min(chunk, S)
    tokens, three device kernels a call in the passes of
    ``wkv6_chunked_bwd_passes_plain``: every chunk's state and adjoint
    increments, the two carries over the chunks (the adjoint down, the
    state up), every chunk's gradients (no atomics, the same bits on every
    call; ``launches`` counts calls), with du's per-chunk sums added over
    the batch and the chunks beside them; CPU tensors take
    ``wkv6_chunked_bwd_plain``; meta tensors give the gradients as shapes
    (and allocate the workspace) and compute nothing. The kernels take hd
    and C up to ``MAX_HEAD_DIM`` and ``MAX_CHUNK``, as B4's."""
    _check_chunked(r, k, v, logw, u, state0, chunk)
    if dy.shape != r.shape or ds_out.shape != state0.shape \
            or dy.dtype != torch.float32 or ds_out.dtype != torch.float32:
        raise ValueError(f"wkv6_chunked_bwd: want dy {tuple(r.shape)} and "
                         f"ds_out {tuple(state0.shape)} float32; got "
                         f"{tuple(dy.shape)} {dy.dtype}, "
                         f"{tuple(ds_out.shape)} {ds_out.dtype}")
    ts = (r, k, v, logw, u, state0, dy, ds_out)
    if len({t.device for t in ts}) != 1:
        raise ValueError("wkv6_chunked_bwd: all inputs must be on one "
                         "device")
    where = _build.route("wkv6_chunked_bwd", *ts)
    if where == "cpu":
        return wkv6_chunked_bwd_plain(r, k, v, logw, u, state0, dy, ds_out,
                                      chunk=chunk)
    B, S, H, hd = r.shape
    C = min(chunk, S)
    if hd > MAX_HEAD_DIM or C > MAX_CHUNK:
        raise ValueError(f"wkv6_chunked_bwd: the kernels take hd <= "
                         f"{MAX_HEAD_DIM} and chunks <= {MAX_CHUNK}; got "
                         f"hd={hd}, chunk={C}")
    work.report("wkv6_chunked_bwd", work.wkv6_chunked_bwd(
        B, S, H, hd, work.dtype_name(r)))
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlogw = torch.empty_like(logw)
    ds0 = torch.empty_like(state0)
    # the kernels' workspace: each chunk's state increment, overwritten by
    # the state entering it, and its adjoint increment, overwritten by the
    # adjoint leaving it; each chunk's decay and Q row; rows padded to 4
    n_chunks, hdp = -(-S // C), -(-hd // 4) * 4
    du_part = torch.empty(B, H, n_chunks, hd, dtype=torch.float32,
                          device=r.device)
    ws_s, ws_l = (torch.empty(B * H * n_chunks * hdp * hdp,
                              dtype=torch.float32, device=r.device)
                  for _ in range(2))
    wl, wq = (torch.empty(B * H * n_chunks * hdp, dtype=torch.float32,
                          device=r.device) for _ in range(2))
    if where == "meta":
        # the bonus's gradient, summed as on the card
        return dr, dk, dv, dlogw, du_part.sum((0, 2)), ds0
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = lib.wkv6_chunked_bwd(
            *(t.data_ptr() for t in ts),
            *(t.data_ptr() for t in (dr, dk, dv, dlogw, du_part, ds0, ws_s,
                                     ws_l, wl, wq)),
            B, S, H, hd, C, _DTYPES[r.dtype], stream)
    _build.check(lib, err, "wkv6_chunked_bwd")
    wkv6_chunked_bwd.launches += 1
    # the bonus's gradient, summed over the batch rows and the chunks
    return dr, dk, dv, dlogw, du_part.sum((0, 2)), ds0


wkv6_chunked_bwd.launches = 0


def wkv6_decode(r, k, v, w, u, state):
    """One WKV-6 token per (batch, head). CUDA tensors launch the B3
    kernel (a block per 16 value columns of one (batch, head)), which
    writes the new state to a fresh tensor; CPU tensors take
    ``wkv6_decode_plain``; meta tensors give (y, state) as shapes and
    compute nothing (the dry run)."""
    if r.dim() != 3 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6_decode: want r, k, v, w [B,H,hd]; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, hd = r.shape
    if tuple(u.shape) != (H, hd) or tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv6_decode: want u [{H},{hd}] and state "
                         f"[{B},{H},{hd},{hd}]; got {tuple(u.shape)}, "
                         f"{tuple(state.shape)}")
    _check_common("wkv6_decode", (r, k, v), (w,), u, state)
    where = _build.route("wkv6_decode", r, k, v, w, u, state)
    if where == "cpu":
        return wkv6_decode_plain(r, k, v, w, u, state)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"wkv6_decode: the kernel takes hd <= "
                         f"{MAX_HEAD_DIM}; got {hd}")
    work.report("wkv6_decode", work.wkv6_decode(B, H, hd,
                                                work.dtype_name(r)))
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state)
    if where == "meta":
        return y, s_out
    ts = (r, k, v, w, u, state)
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


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("wkv6_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_chunked_bwd.argtypes = [P] * 18 + [I] * 6 + [P]
    lib.wkv6_chunked_bwd.restype = I
    return lib
