"""Mamba (S6) block: chunked selective scan in prefill, one token in
decode.

The JAX model's math (``repro.models.mamba``) with the recurrence on the
port's kernels: prefill runs each chunk of 256 tokens through kernel B6
(``kernels.linear_scan``) where the JAX model has an associative scan,
and decode runs one token through kernel B5 (``kernels.ssm_decode``)
where it writes the step in jnp. The state carried between chunks and
between tokens is ``{conv: [B, K-1, Di] model dtype, ssm: [B, Di, N]
fp32}``.

The reference pads the last chunk with dt = 0 (a = 1, b = 0), which
leaves the state at S unchanged; the port runs a ragged last chunk
instead, with the same final state. The per-chunk fp32 tensors
([B, C, Di, N], 134 MB each at jamba's width) live one chunk at a time.
When autograd records, each chunk's body runs under
``torch.utils.checkpoint``, as the reference's ``@jax.checkpoint`` body:
the backward replays the chunk (B6 again) and runs B6-bwd, so no
chunk's [B, C, Di, N] tensors are kept past it.

Ops round where the JAX model's do: the prefill conv is K shifted adds
from the bias, each rounding in the model dtype; the decode conv is one
contraction accumulated in fp32; softplus is ``jax.nn.softplus``'s
``logaddexp(x, 0)``; silu rounds each op (``layers.silu``).

On a mesh of ranks (``mamba_forward``'s ``mg``) prefill runs on the
rank's Di/tp channels, as ``mamba_specs`` place the leaves: ``in_proj``
column-parallel, its output moved to the rank's channels of xm and z
(``_rank_halves``); the conv, ``dt_proj``, ``dt_bias``, ``A_log``,
``D_skip`` and B6 on its channels; ``x_proj`` row-parallel, its partial
sums summed both ways (``collectives.psum_inside``); ``out_proj``
row-parallel, left for the caller to sum. The conv runs on the whole
sequence the region sees.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.kernels.ssm_decode import ssm_decode_step
from repro_torch.models.layers import silu
from repro_torch.sharding import collectives as col

CHUNK = 256


def init_mamba(cfg: ModelConfig, normal, uniform, dtype, device) -> dict:
    """One block's params with the JAX ``init_mamba`` shapes, dtypes and
    scales. ``normal(shape, scale, dtype)`` and ``uniform(shape, lo, hi)``
    draw the random leaves; ``dt_bias``, ``A_log`` and ``D_skip`` are
    fp32 whatever the model dtype."""
    m = cfg.mamba
    d = cfg.d_model
    di = m.expand * d
    dtr = m.resolved_dt_rank(d)
    f32 = torch.float32
    A = torch.arange(1, m.d_state + 1, dtype=f32, device=device)[None]
    dt = torch.exp(uniform((di,), math.log(1e-3), math.log(1e-1)))
    return {
        "in_proj": normal((d, 2 * di), 1.0 / math.sqrt(d), dtype),
        "conv_w": normal((m.d_conv, di), 0.5, dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=device),
        "x_proj": normal((di, dtr + 2 * m.d_state), 1.0 / math.sqrt(di),
                         dtype),
        "dt_proj": normal((dtr, di), 1.0 / math.sqrt(dtr), dtype),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(A.expand(di, m.d_state).contiguous()),
        "D_skip": torch.ones(di, dtype=f32, device=device),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di), dtype),
    }


def mamba_specs(cfg: ModelConfig) -> dict:
    """Logical sharding axes of ``init_mamba``'s leaves."""
    return {"in_proj": (None, "inner"), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "x_proj": ("inner", None),
            "dt_proj": (None, "inner"), "dt_bias": ("inner",),
            "A_log": ("inner", None), "D_skip": ("inner",),
            "out_proj": ("inner", None)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)) (``F.softplus`` thresholds and differs by an ulp)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(xm, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv as K shifted adds from the bias, each
    rounding in the input dtype. xm: [B,S,Di]; conv_w: [K,Di]. Returns
    (out [B,S,Di], the last K-1 inputs [B,K-1,Di])."""
    K = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros(xm.shape[0], K - 1, xm.shape[2], dtype=xm.dtype,
                          device=xm.device)
    else:
        pad = conv_state.to(xm.dtype)
    xp = torch.cat([pad, xm], dim=1)                  # [B,S+K-1,Di]
    S = xm.shape[1]
    out = conv_b[None, None]
    for k in range(K):
        out = out + conv_w[k][None, None] * xp[:, k:k + S]
    # a copy, so the [B, S+K-1, Di] input does not outlive the prefill
    return out, (xp[:, xp.shape[1] - (K - 1):].clone() if K > 1 else None)


def _ssm_inputs(xc, p, cfg: ModelConfig, tp=None):
    """dt [..., Di], B_ssm and C_ssm [..., N], all fp32, from the
    activated conv output. With ``tp`` xc is a rank's channels and
    ``x_proj`` its rows: the product is a partial sum, and so is its
    cotangent, since dt and the scan use only the rank's channels."""
    m = cfg.mamba
    dtr = m.resolved_dt_rank(cfg.d_model)
    xdbl = xc @ p["x_proj"]
    if tp is not None:
        xdbl = col.psum_inside(xdbl, tp)
    dt_r = xdbl[..., :dtr]
    B_ssm = xdbl[..., dtr:dtr + m.d_state].float().contiguous()
    C_ssm = xdbl[..., dtr + m.d_state:].float().contiguous()
    dt = softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()
    return dt, B_ssm, C_ssm


def _chunk_body(h, dt_i, x_i, B_i, C_i, A):
    """One chunk: the scan on B6 from h, then y = h_all . C. Returns
    (h_last, y [B,C,Di])."""
    a = torch.exp(dt_i[..., None] * A)                # [B,C,Di,N]
    b = (dt_i * x_i)[..., None] * B_i[:, :, None, :]
    h_all, h_last = linear_scan(a, b, h)
    del a, b
    return h_last, torch.einsum("bcdn,bcn->bcd", h_all, C_i)


def _rank_halves(xz, mg):
    """This rank's channels of xm and z, [b, S, 2 Di/tp], from its
    columns of x @ in_proj. ``reshard_tree`` cuts in_proj's 2 Di columns
    over ``model`` contiguously, as GSPMD does, so rank q holds blocks 2q
    and 2q + 1 of 2 tp blocks of Di/tp columns, block j being xm's
    (j < tp) or z's (j >= tp) slice of rank j mod tp: at tp 2 rank 0
    holds all of xm and rank 1 all of z. One all_to_all sends each block
    to its rank, which receives its xm slice from rank r // 2 and its z
    slice from rank (tp + r) // 2, in that order."""
    n, r, w = mg.tp_size, mg.tp_rank, xz.shape[-1] // 2
    if n == 1:
        return xz
    dest = [(2 * r) % n, (2 * r + 1) % n]
    if dest[0] > dest[1]:       # an odd tp's last rank: its second block
        xz = torch.cat([xz[..., w:], xz[..., :w]], dim=-1)  # goes to 0
    send = [w * dest.count(d) for d in range(n)]
    recv = [w * (s in (r // 2, (n + r) // 2)) for s in range(n)]
    return col.all_to_all(xz, mg.tp, -1, send, recv)


def mamba_forward(x, p, cfg: ModelConfig, chunk: int = CHUNK,
                  state: Optional[dict] = None, want_state: bool = False,
                  mg=None):
    """Prefill over x [B,S,D] from an optional carried state, the scan of
    each chunk on kernel B6. Returns (out [B,S,D], {conv, ssm} or
    None). With ``mg`` (a ``collectives.MeshGroups``) x is the whole
    input of a region parallel over ``model`` and ``p`` the rank's
    shards: the result is the rank's partial sum of out."""
    B, S, D = x.shape
    di = p["D_skip"].shape[0]       # the rank's channels on a mesh
    xz = x @ p["in_proj"]
    if mg is not None:
        xz = _rank_halves(xz, mg)
    xm, z = torch.chunk(xz, 2, dim=-1)
    xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"],
                                state["conv"] if state is not None else None)
    xc = silu(xc)
    dt, B_ssm, C_ssm = _ssm_inputs(xc, p, cfg,
                                   mg.tp if mg is not None else None)
    A = -torch.exp(p["A_log"])                        # [Di,N] fp32
    xcf = xc.float()
    h = (state["ssm"].float().contiguous() if state is not None
         else torch.zeros(B, di, cfg.mamba.d_state, dtype=torch.float32,
                          device=x.device))
    chunk = min(chunk, S)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dt, xcf, B_ssm, C_ssm, A, h))
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        args = (h, dt[:, sl], xcf[:, sl], B_ssm[:, sl], C_ssm[:, sl], A)
        if remat:
            h, y_i = torch.utils.checkpoint.checkpoint(
                _chunk_body, *args, use_reentrant=False)
        else:
            h, y_i = _chunk_body(*args)
        ys.append(y_i)
    y = torch.cat(ys, dim=1) + xcf * p["D_skip"]
    out = (y.to(x.dtype) * silu(z)) @ p["out_proj"]
    new_state = {"conv": new_conv, "ssm": h} if want_state else None
    return out, new_state


def mamba_decode(x, p, cfg: ModelConfig, state: dict):
    """One token x [B,D] from the state {conv [B,K-1,Di], ssm [B,Di,N]},
    the step on kernel B5. Returns (out [B,D], the new state); the caller
    commits it under the active mask."""
    xm, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    window = torch.cat([state["conv"].to(xm.dtype), xm[:, None]], dim=1)
    xc = torch.einsum("bkd,kd->bd", window.float(),
                      p["conv_w"].float()).to(x.dtype) + p["conv_b"][None]
    xc = silu(xc)
    dt, B_ssm, C_ssm = _ssm_inputs(xc, p, cfg)
    A = -torch.exp(p["A_log"])
    xcf = xc.float()
    dA = torch.exp(dt[..., None] * A)                 # [B,Di,N]
    y, h = ssm_decode_step(state["ssm"], dA, dt * xcf, B_ssm, C_ssm)
    y = y + xcf * p["D_skip"]
    out = (y.to(x.dtype) * silu(z)) @ p["out_proj"]
    return out, {"conv": window[:, 1:], "ssm": h}
