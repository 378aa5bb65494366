"""Training in the port against the JAX package: the attention backward,
``forward_loss`` and its gradients, remat, the refusals, the train step
and the launcher.

Weights are bridged from ``repro.models.lm.init_params`` (fp32) with
``params_from_numpy``, and gradients, params and AdamW's state come back
through ``params_to_numpy`` and ``opt_state_to_numpy``, so every leaf is
compared in the reference's layout. The port runs on the CPU (the plain
kernel versions). Tolerances: the attention backward's dq, dk, dv within
1e-5 and lse within 1e-6 (fp32 sums in another order); the loss within
1e-5 and each gradient within 1e-4 of max(1, |g|), for the same reason
over a deeper graph; the train step's as its test says.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.grad_compress import init_residuals as j_init_res  # noqa
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.data import DataConfig, SyntheticPackedDataset  # noqa
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.attention import chunked_causal_attention  # noqa
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        opt_state_to_numpy,
                                        params_from_numpy, params_to_numpy)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.grad_compress import init_residuals  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DENSE_ARCHS = ("qwen3-8b", "qwen1.5-4b", "nemotron-4-15b", "h2o-danube-3-4b",
               "chameleon-34b", "musicgen-large")


def _rnd(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tree_err(a, b, rel_floor=1.0):
    """max over leaves of |a - b| / max(rel_floor, |b|)."""
    if isinstance(b, dict):
        return max((_tree_err(a[k], b[k], rel_floor) for k in b), default=0)
    if isinstance(b, (list, tuple)):
        return max((_tree_err(x, y, rel_floor) for x, y in zip(a, b)),
                   default=0)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float((np.abs(a - b) / np.maximum(rel_floor, np.abs(b))).max(
        initial=0.0))


def _assert_tree_close(a, b, tol, rel_floor=1.0, path=""):
    """|a - b| <= tol * max(rel_floor, |b|) leaf by leaf."""
    if isinstance(b, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in b:
            _assert_tree_close(a[k], b[k], tol, rel_floor, f"{path}/{k}")
        return
    if isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_close(x, y, tol, rel_floor, f"{path}/{i}")
        return
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    err = np.abs(a - b) / np.maximum(rel_floor, np.abs(b))
    assert float(err.max(initial=0.0)) <= tol, (path, float(err.max()))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


# --------------------------------------------------------------------------
# the attention backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("window", [0, 24])
def test_attention_backward_matches_reference(hd, window):
    """B 2, S 70, H 4, KV 2; the reference at chunk 32, so that several
    chunk pairs (and, with the window, a banded pair list) run."""
    B, S, H, KV, chunk = 2, 70, 4, 2, 32
    q, k, v = (_rnd(0, B, S, H, hd), _rnd(1, B, S, KV, hd),
               _rnd(2, B, S, KV, hd))
    dout = _rnd(3, B, S, H, hd)
    out_j, vjp = jax.vjp(lambda a, b, c: jattn.chunked_causal_attention(
        a, b, c, chunk=chunk, window=window), q, k, v)
    dq_j, dk_j, dv_j = vjp(jnp.asarray(dout))
    # the reference's lse, from its forward scan in chunked layout
    n = -(-S // chunk)
    pad = n * chunk - S

    def chunked(x, heads):
        x = np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
        return jnp.asarray(x.reshape(B, n, chunk, *heads).swapaxes(0, 1))
    G = H // KV
    _, lse_j = jattn._fwd_scan(
        chunked(q, (KV, G, hd)), chunked(k, (KV, hd)), chunked(v, (KV, hd)),
        *jattn._pair_list(n, jattn._wc(window, chunk)), chunk, S, window,
        1.0 / np.sqrt(hd))
    lse_j = np.asarray(lse_j).transpose(1, 2, 3, 0, 4).reshape(
        B, H, n * chunk)[:, :, :S]

    heads = [torch.from_numpy(x).transpose(1, 2).contiguous()
             for x in (q, k, v, dout)]
    out, lse = fa.flash_attention(*heads[:3], window=window, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(),
                               np.asarray(out_j), atol=1e-5, rtol=1e-5)
    grads = fa.flash_attention_bwd(*heads[:3], out, lse, heads[3],
                                   window=window)
    for got, want in zip(grads, (dq_j, dk_j, dv_j)):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)
    # the model's differentiable path: the autograd Function
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    chunked_causal_attention(qt, kt, vt, window=window).backward(
        torch.from_numpy(dout))
    for got, want in zip((qt.grad, kt.grad, vt.grad), (dq_j, dk_j, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def _bf16_route(q, k, v, out, lse, dout, window, scale):
    """B2-bwd's bf16 route in plain torch: bf16-valued inputs and forward
    output, dS rounded to bf16 before the dK and dQ products, P given to
    the dV product as two bf16 parts (hi = bf16(P), lo = bf16(P - hi)),
    fp32 sums, the gradients rounded to bf16. [B,n,S,d] layouts."""
    B, H, S, _ = q.shape
    KV = k.shape[1]
    G = H // KV
    kf = k.repeat_interleave(G, dim=1)
    vf = v.repeat_interleave(G, dim=1)
    s = torch.matmul(q, kf.transpose(-1, -2)) * scale
    p = torch.where(fa._visible(S, window, q.device),
                    torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(dout, vf.transpose(-1, -2))
    delta = (dout * out).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).bfloat16().float()
    hi = p.bfloat16().float()
    p = hi + (p - hi).bfloat16().float()

    def group_sum(t):
        return t.reshape(B, KV, G, S, t.shape[-1]).sum(2)
    grads = (torch.matmul(ds, kf),
             group_sum(torch.matmul(ds.transpose(-1, -2), q)),
             group_sum(torch.matmul(p.transpose(-1, -2), dout)))
    return tuple(g.bfloat16().float() for g in grads)


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("hd,hd_v", [(128, 128), (192, 128)])
def test_attention_backward_bf16_rounding_within_tolerance(hd, hd_v, window):
    """The card's bf16 route rounds dS to bf16 and carries P in two bf16
    parts where the reference keeps both fp32: a model of that route on
    bf16-valued inputs (B 1, H 4, KV 2, S 300) within the card's bf16
    tolerance, 2e-2 of max(1, |ref|), of ``jax.vjp`` of the reference's
    attention on the same inputs. The margin is printed."""
    B, S, H, KV = 1, 300, 4, 2

    def bf16_valued(seed, *shape):
        x = torch.from_numpy(_rnd(seed, *shape)).bfloat16().float()
        return x.numpy()
    q, k = bf16_valued(20, B, S, H, hd), bf16_valued(21, B, S, KV, hd)
    v, dout = bf16_valued(22, B, S, KV, hd_v), bf16_valued(23, B, S, H, hd_v)
    _, vjp = jax.vjp(lambda a, b, c: jattn.chunked_causal_attention(
        a, b, c, window=window), q, k, v)
    want = vjp(jnp.asarray(dout))
    heads = [torch.from_numpy(x).transpose(1, 2).contiguous()
             for x in (q, k, v, dout)]
    out, lse = fa.flash_attention(*heads[:3], window=window, return_lse=True)
    got = _bf16_route(*heads[:3], out.bfloat16().float(), lse, heads[3],
                      window, 1.0 / np.sqrt(hd))
    errs = [_tree_err(g.transpose(1, 2).numpy(), np.asarray(w))
            for g, w in zip(got, want)]
    print(f"bf16 route (hd {hd}, hd_v {hd_v}, window {window}): dq, dk, dv "
          f"within {[round(e, 5) for e in errs]} of max(1, |ref|); the "
          f"tolerance 2e-2 leaves a margin of {2e-2 - max(errs):.5f}")
    assert max(errs) <= 2e-2


def test_attention_backward_through_padded_head_dim():
    """hd 120 (danube's) pads to 128 outside the Function: the gradients
    come back through the slice and equal the reference's unpadded
    ones."""
    B, S, H, KV, hd = 1, 40, 2, 1, 120
    q, k, v = (_rnd(4, B, S, H, hd), _rnd(5, B, S, KV, hd),
               _rnd(6, B, S, KV, hd))
    dout = _rnd(7, B, S, H, hd)
    _, vjp = jax.vjp(lambda a, b, c: jattn.chunked_causal_attention(
        a, b, c, chunk=16), q, k, v)
    want = vjp(jnp.asarray(dout))
    ts_ = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    chunked_causal_attention(*ts_).backward(torch.from_numpy(dout))
    for t, w in zip(ts_, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


def test_attention_backward_refusals():
    """Head dims outside B2's instances and a malformed lse raise; MLA's
    (192, 128) is an instance and runs (its gradients are held to the
    reference below)."""
    q, k = torch.zeros(1, 2, 8, 192), torch.zeros(1, 1, 8, 192)
    with pytest.raises(ValueError, match="must be one of"):
        fa.flash_attention_bwd(q, k, torch.zeros(1, 1, 8, 96), q[..., :96],
                               torch.zeros(1, 2, 8), q[..., :96])
    o = torch.zeros(1, 2, 8, 128)
    dq, dk, dv = fa.flash_attention_bwd(q, k, torch.zeros(1, 1, 8, 128), o,
                                        torch.zeros(1, 2, 8), o)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape,
                                              (1, 1, 8, 128))
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q[:, :1], q[:, :1], q, torch.zeros(1, 2, 7),
                               q)


# --------------------------------------------------------------------------
# the other kernels' backwards (B7, B6, B4) and B2's at MLA's head dims,
# each against jax.grad of the reference's jnp form
# --------------------------------------------------------------------------

def _allclose(got, want):
    """The kernel backwards' check, as the attention backward's above:
    within 1e-5 absolute plus 1e-5 relative."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("T,D,E,C", [(40, 8, 4, 6), (33, 5, 3, 20)])
def test_moe_dispatch_backward_matches_reference(T, D, E, C):
    """B7-bwd against the transpose of ``_moe_mlp_local``'s
    ``.at[].set(mode="drop")`` scatter: rows past a full queue (C 6 for 40
    rows over 4 experts) and ids out of range take zero."""
    rng = np.random.default_rng(T)
    x = _rnd(1, T, D)
    ids = rng.integers(0, E + 1, size=T).astype(np.int32)   # E: dropped
    onehot = ids[:, None] == np.arange(E + 1)
    pos = (np.cumsum(onehot, 0)[np.arange(T), ids] - 1).astype(np.int32)
    g = _rnd(2, E, C, D)

    def ref(xj):
        keep = (pos < C) & (ids < E)
        buf = jnp.zeros((E, C + 1, D), xj.dtype).at[
            jnp.where(keep, ids, 0), jnp.where(keep, pos, C)].set(
                xj, mode="drop")
        return jnp.sum(buf[:, :C] * g)
    want = jax.jit(jax.grad(ref))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    buf = md.moe_dispatch(xt, torch.from_numpy(ids), torch.from_numpy(pos),
                          E, C)
    (buf * torch.from_numpy(g)).sum().backward()
    _allclose(xt.grad.numpy(), want)
    dropped = torch.from_numpy((pos >= C) | (ids >= E))
    assert bool(dropped.any())
    assert float(xt.grad[dropped].abs().sum()) == 0.0


@pytest.mark.parametrize("window", [0, 16])
def test_flash_backward_at_mla_head_dims_matches_reference(window):
    """B2-bwd at q/k 192 with v 128 (deepseek-v2-lite-16b's MLA), through
    the model's ``chunked_causal_attention`` and the kernel wrapper alone,
    against ``jax.vjp`` of the reference's ``_flash``."""
    B, S, H, KV = 1, 40, 2, 2
    q, k, v = (_rnd(3, B, S, H, 192), _rnd(4, B, S, KV, 192),
               _rnd(5, B, S, KV, 128))
    dout = _rnd(6, B, S, H, 128)
    _, vjp = jax.vjp(lambda a, b, c: jattn.chunked_causal_attention(
        a, b, c, chunk=16, window=window), q, k, v)
    want = vjp(jnp.asarray(dout))
    ts_ = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = chunked_causal_attention(*ts_, window=window)
    assert out.shape == (B, S, H, 128)
    out.backward(torch.from_numpy(dout))
    for t, w in zip(ts_, want):
        _allclose(t.grad.numpy(), w)
    heads = [torch.from_numpy(x).transpose(1, 2).contiguous()
             for x in (q, k, v, dout)]
    o, lse = fa.flash_attention(*heads[:3], window=window, return_lse=True)
    got = fa.flash_attention_bwd(*heads[:3], o, lse, heads[3], window=window)
    for t, w in zip(got, want):
        _allclose(t.transpose(1, 2).numpy(), w)


def test_linear_scan_backward_matches_reference():
    """B6-bwd through ``linear_scan`` (a = exp(dA_log)) against
    ``jax.grad`` of ``_chunk_scan``: the gradients of dA_log, dBx and h0
    under a loss on every h_t and on h_last."""
    B, T, D, N = 2, 37, 6, 4
    dA_log = -np.abs(_rnd(7, B, T, D, N) * 0.5)
    dBx, h0 = _rnd(8, B, T, D, N), _rnd(9, B, D, N)
    G, GL = _rnd(10, B, T, D, N), _rnd(11, B, D, N)

    def ref(la, bx, h):
        h_all, h_last = jmamba._chunk_scan(la, bx, h)
        return jnp.sum(h_all * G) + jnp.sum(h_last * GL)
    want = jax.jit(jax.grad(ref, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (dA_log, dBx, h0)))
    ins = [torch.from_numpy(x).requires_grad_() for x in (dA_log, dBx, h0)]
    h_all, h_last = ls.linear_scan(torch.exp(ins[0]), ins[1], ins[2])
    assert type(h_all.grad_fn).__name__ == "_LinearScanBackward"
    ((h_all * torch.from_numpy(G)).sum()
     + (h_last * torch.from_numpy(GL)).sum()).backward()
    for t, w in zip(ins, want):
        _allclose(t.grad.numpy(), w)


def _wkv_inputs(seed, B, S, H, hd):
    r, k, v = (_rnd(seed + i, B, S, H, hd) for i in range(3))
    logw = -np.exp(np.clip(_rnd(seed + 3, B, S, H, hd), -8, 0.5))
    return (r, k, v, logw.astype(np.float32), _rnd(seed + 4, H, hd) * 0.1,
            _rnd(seed + 5, B, H, hd, hd) * 0.3)


@pytest.mark.parametrize("S,chunk", [(70, 32), (9, 4)])
def test_wkv6_backward_matches_reference(S, chunk):
    """B4-bwd's plain version (the CPU path of ``_Wkv6Chunked``) against
    ``jax.grad`` of the reference's ``wkv_chunked``: a ragged tail, a
    nonzero state0 and a gradient on the final state as well as on y."""
    B, H, hd = 2, 2, 8
    ins = _wkv_inputs(20, B, S, H, hd)
    dy, ds = _rnd(30, B, S, H, hd), _rnd(31, B, H, hd, hd)

    def ref(*a):
        y, s = jrwkv.wkv_chunked(*a, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(s * ds)
    want = jax.jit(jax.grad(ref, argnums=tuple(range(6))))(
        *map(jnp.asarray, ins))
    ts_ = [torch.from_numpy(x).requires_grad_() for x in ins]
    y, s = wk.wkv6_chunked(*ts_, chunk=chunk)
    assert type(y.grad_fn).__name__ == "_Wkv6ChunkedBackward"
    ((y * torch.from_numpy(dy)).sum()
     + (s * torch.from_numpy(ds)).sum()).backward()
    for t, w in zip(ts_, want):
        _allclose(t.grad.numpy(), w)


def test_wkv6_backward_walk_equals_autograd():
    """The B4-bwd kernels' algorithm (``wkv6_chunked_bwd_walk_plain``: the
    state walked forwards, its adjoint backwards, dlogw from the carried
    Q) against autograd through the chunked form, within 1e-5 of each
    gradient's largest |value| (measured 1.4e-6)."""
    ins = [torch.from_numpy(x) for x in _wkv_inputs(40, 2, 70, 2, 8)]
    dy, ds = (torch.from_numpy(_rnd(50, 2, 70, 2, 8)),
              torch.from_numpy(_rnd(51, 2, 2, 8, 8)))
    want = wk.wkv6_chunked_bwd_plain(*ins, dy, ds)
    got = wk.wkv6_chunked_bwd_walk_plain(*ins, dy, ds)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("chunk", [32, 16, 7])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 70, 130])
def test_wkv6_backward_passes_match_autograd_reference_and_walk(S, chunk):
    """The B4-bwd kernels' chunk-parallel algorithm
    (``wkv6_chunked_bwd_passes_plain``), with a nonzero state0 and a
    gradient on the final state, a ragged tail and S under the chunk
    (C = min(chunk, S), as the reference takes): in fp32 within 1e-5 of
    each gradient's largest |value| of autograd through the chunked form
    (``wkv6_chunked_bwd_plain``) and of ``jax.grad`` of the reference's
    ``wkv_chunked`` (fp32 sums in another order: on these inputs the
    reference's own gradients lie up to 2.9e-6 of their largest from
    float64, and gradients reach |30|, so an elementwise 1e-5 does not
    hold for either); in float64 within 1e-12 of each gradient's largest
    |value| of the token walk (``wkv6_chunked_bwd_walk_plain``, dlogw
    through the carried Q)."""
    B, H, hd = 2, 2, 8
    ins = _wkv_inputs(S + chunk, B, S, H, hd)
    dy, ds = _rnd(S + 90, B, S, H, hd), _rnd(S + 91, B, H, hd, hd)
    args = [torch.from_numpy(x) for x in (*ins, dy, ds)]
    got = wk.wkv6_chunked_bwd_passes_plain(*args, chunk=chunk)
    auto = wk.wkv6_chunked_bwd_plain(*args, chunk=chunk)
    for a, b in zip(got, auto):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())

    def ref(*a):
        y, s = jrwkv.wkv_chunked(*a, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(s * ds)
    want = jax.jit(jax.grad(ref, argnums=tuple(range(6))))(
        *map(jnp.asarray, ins))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    got64 = wk.wkv6_chunked_bwd_passes_plain(
        *(t.double() for t in args), chunk=chunk)
    walk64 = wk.wkv6_chunked_bwd_walk_plain(*(t.double() for t in args))
    for a, b in zip(got64, walk64):
        assert a.dtype == b.dtype == torch.float64
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_wkv6_plain_in_float64_is_the_recurrence():
    """Given float64 inputs, ``wkv6_chunked_plain`` computes in float64
    (the reference chip_smoke.py holds B4 and B4-bwd to at a model's
    inputs): y and the final state equal the token-by-token recurrence in
    numpy float64 within 1e-12 of their largest |value|."""
    r, k, v, logw, u, s0 = _wkv_inputs(70, 2, 45, 2, 8)
    y, s = wk.wkv6_chunked_plain(*(torch.from_numpy(x).double()
                                   for x in (r, k, v, logw, u, s0)))
    assert y.dtype == s.dtype == torch.float64
    r, k, v, logw, u, st = (x.astype(np.float64)
                            for x in (r, k, v, logw, u, s0))
    want = np.empty_like(r)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # [B,H,hd,hd]
        want[:, t] = np.einsum("bhd,bhde->bhe", r[:, t],
                               st + u[None, :, :, None] * kv)
        st = np.exp(logw[:, t])[..., None] * st + kv
    for got, ref in ((y.numpy(), want), (s.numpy(), st)):
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("which", ["flash_attention", "moe_dispatch",
                                   "linear_scan", "wkv6_chunked"])
def test_wrappers_go_through_their_functions_under_grad(which):
    """With grad on and an input that requires it, each kernel wrapper
    returns through its autograd Function; under ``torch.no_grad`` or
    with no input requiring grad it returns a plain tensor."""
    rg = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=rg)
    if which == "flash_attention":
        args = [rnd(1, 2, 8, 16), rnd(1, 2, 8, 16), rnd(1, 2, 8, 16)]
        call, name = fa.flash_attention, "FlashAttentionBackward"
    elif which == "moe_dispatch":
        ids = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
        args = [rnd(4, 8), ids, torch.tensor([0, 0, 1, 1],
                                             dtype=torch.int32), 2, 2]
        call, name = md.moe_dispatch, "_MoeDispatchBackward"
    elif which == "linear_scan":
        args = [torch.rand(1, 5, 2, 2), rnd(1, 5, 2, 2), rnd(1, 2, 2)]
        call, name = ls.linear_scan, "_LinearScanBackward"
    else:
        args = [torch.from_numpy(x) for x in _wkv_inputs(60, 1, 5, 1, 4)]
        call, name = wk.wkv6_chunked, "_Wkv6ChunkedBackward"

    def first(out):
        return out[0] if isinstance(out, tuple) else out
    assert first(call(*args)).grad_fn is None
    args[0].requires_grad_()
    with torch.no_grad():
        assert first(call(*args)).grad_fn is None
    assert type(first(call(*args)).grad_fn).__name__ == name


# --------------------------------------------------------------------------
# forward_loss and its gradients
# --------------------------------------------------------------------------

def _bridge(arch):
    jcfg = J_SMOKE[arch].scaled(dtype="float32")
    tcfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    return jcfg, tcfg, tree


def _tokens(B, S, V, seed=0):
    return np.random.default_rng(seed).integers(0, V, size=(B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    """S 80: past danube's SMOKE window of 64."""
    jcfg, tcfg, tree = _bridge(arch)
    toks = _tokens(2, 80, tcfg.vocab_size)
    (loss_j, met_j), g_j = jax.value_and_grad(
        lambda p: jlm.forward_loss(p, jnp.asarray(toks), jcfg, NULL_POLICY),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree, tcfg, device="cpu")
    (loss, met), g = ts.value_and_grad(params, torch.from_numpy(toks), tcfg)
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * max(
        1, abs(float(loss_j)))
    assert abs(float(met["ce"]) - float(met_j["ce"])) <= 1e-5 * max(
        1, abs(float(met_j["ce"])))
    assert set(met) == {"ce", "moe_aux", "moe_dropped"} == set(met_j)
    _assert_tree_close(params_to_numpy(g, tcfg), _np_tree(g_j), 1e-4)


def test_remat_gives_the_same_gradients():
    _, tcfg, tree = _bridge("qwen3-8b")
    params = params_from_numpy(tree, tcfg, device="cpu")
    toks = torch.from_numpy(_tokens(2, 48, tcfg.vocab_size, seed=1))
    (l1, _), g1 = ts.value_and_grad(params, toks, tcfg, remat=True)
    (l0, _), g0 = ts.value_and_grad(params, toks, tcfg, remat=False)
    assert torch.equal(l0, l1)
    for a, b in zip(params_to_numpy(g1, tcfg)["stack"]["groups"]["b0"]
                    ["attn"].values(),
                    params_to_numpy(g0, tcfg)["stack"]["groups"]["b0"]
                    ["attn"].values()):
        np.testing.assert_array_equal(a, b)
    _assert_tree_close(params_to_numpy(g1, tcfg), params_to_numpy(g0, tcfg),
                       0.0)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_ce_loss_in_chunks_equals_one_pass(chunk):
    """The port forms the per-token CE ``chunk`` tokens at a time; the
    mean is over all of them at once, so any chunk gives the one-pass
    value within 1e-6."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 40, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 50)).astype(np.float32))
    tg = torch.from_numpy(rng.integers(0, 50, size=(2, 40)))
    mask = torch.ones(2, 40)
    mask[:, -1] = 0
    whole = lm.ce_loss(x, w, tg, mask, chunk=80)
    logits = (x @ w).float()
    want = ((torch.logsumexp(logits, -1)
             - torch.gather(logits, -1, tg[..., None])[..., 0]) * mask).sum() \
        / mask.sum()
    assert abs(float(whole) - float(want)) <= 1e-6 * float(want)
    assert abs(float(lm.ce_loss(x, w, tg, mask, chunk=chunk))
               - float(whole)) <= 1e-6 * float(whole)


def _count_attention_calls(monkeypatch):
    """Count the B2 and B2-bwd wrapper calls (their CPU path here)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention, fa.flash_attention_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    monkeypatch.setattr(fa, "flash_attention", count_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", count_bwd)
    return calls


def _three_layers():
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32", n_layers=3)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


@pytest.mark.parametrize("remat", [True, False])
def test_gradient_attention_calls(remat, monkeypatch):
    """One gradient calls B2 once a layer, twice with remat (the backward
    replays each block), and B2-bwd once a layer."""
    cfg, params = _three_layers()
    calls = _count_attention_calls(monkeypatch)
    ts.value_and_grad(params, torch.from_numpy(_tokens(2, 24,
                                                       cfg.vocab_size)),
                      cfg, remat=remat)
    assert calls == {"fwd": 3 * (2 if remat else 1), "bwd": 3}


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_step_attention_calls(microbatch, monkeypatch):
    """A train step calls B2 layers x microbatches x 2 (remat) and B2-bwd
    layers x microbatches times: the counts chip_smoke.py holds the
    card's launches to."""
    cfg, params = _three_layers()
    calls = _count_attention_calls(monkeypatch)
    step = ts.make_train_step(cfg, microbatch=microbatch)
    step(params, adamw_init(params),
         torch.from_numpy(_tokens(2, 24, cfg.vocab_size)))
    mbs = max(microbatch, 1)
    assert calls == {"fwd": 3 * mbs * 2, "bwd": 3 * mbs}


def test_weight_and_state_bridges_round_trip():
    _, tcfg, tree = _bridge("nemotron-4-15b")
    params = params_from_numpy(tree, tcfg, device="cpu")
    _assert_tree_close(params_to_numpy(params, tcfg), tree, 0.0)
    opt = adamw_init(params)
    back = opt_state_from_numpy(opt_state_to_numpy(opt, tcfg), tcfg,
                                device="cpu")
    _assert_tree_close(opt_state_to_numpy(back, tcfg)["master"], tree, 0.0)
    assert int(back["step"]) == 0


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _assert_rare_flips(a, b, tol, rel_floor, frac, cap, path=""):
    """All but a fraction ``frac`` of the elements (over the whole tree)
    within tol * max(rel_floor, |b|), and every element within
    ``cap(leaf of b)``."""
    pairs = [(np.asarray(x, np.float32), np.asarray(y, np.float32))
             for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))]
    assert len(pairs) == len(jax.tree.leaves(b)), path
    far = sum(int((np.abs(x - y) > tol * np.maximum(rel_floor, np.abs(y)))
                  .sum()) for x, y in pairs)
    total = sum(y.size for _, y in pairs)
    assert far <= frac * total, (path, far, total)
    for x, y in pairs:
        assert float(np.abs(x - y).max(initial=0.0)) <= cap(y), path


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference(microbatch, compress):
    """Three steps of qwen3-8b SMOKE in fp32 against the reference's jitted
    step: loss, ce, grad_norm and lr each step, then params, master, m
    and v, and that the params moved: every leaf's largest move exceeds
    20 times the params' tolerance (measured 2.05e-3, 41 times), so a
    step that left them alone fails.

    Without compression the metrics agree within 1e-6 (measured 1.5e-7).
    The params and master agree within 5e-5 (measured 2.0e-5): AdamW's
    update m / sqrt(v) is ill-conditioned where a gradient is near zero,
    so a 1e-7 relative gradient difference there moves the update by a
    fraction of lr (1e-3); m within 1e-4 and v within 1e-5 of max(1e-3,
    |ref|) (measured 3.6e-8 and 6.4e-10 absolute).

    With the int8 compression each gradient is rounded to a multiple of
    its scale (one per reference leaf: the stacked layers share it), so a
    gradient 1e-7 from the reference's can land a quantum away near a
    half. The losses agree within 1e-6 (measured 1.5e-7) and the grad
    norms, of the compressed gradients, within 2e-5 (measured 5.0e-6).
    The params, master, m and v are held to the tolerances above, except
    for the flipped elements: at most 1e-4 of the params and master
    (measured 1.2e-5: 6 of 508608), each within 1 lr (a flip moves an
    update by at most about lr a step; measured 0.44 lr), and at most
    1e-3 of m and v (measured 1.4e-4), each within 2e-2 of its leaf's
    largest |value| (a flip moves m by (1 - b1) of one quantum, amax /
    127; measured 7.3e-3 for m and 6.8e-3 for v). The compression itself
    is held to the reference's bit for bit on equal inputs
    (tests/test_torch_optim.py)."""
    lr = 1e-3
    jcfg, tcfg, tree = _bridge("qwen3-8b")
    jopt = JAdamWConfig(lr=lr, warmup_steps=2, total_steps=4)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=2, total_steps=4)
    jstep = jax.jit(jts.make_train_step(jcfg, NULL_POLICY, jopt,
                                        grad_compression=compress,
                                        microbatch=microbatch))
    step = ts.make_train_step(tcfg, opt_cfg, grad_compression=compress,
                              microbatch=microbatch)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = j_adamw_init(jp)
    params = params_from_numpy(tree, tcfg, device="cpu")
    opt = adamw_init(params)
    jres, res = j_init_res(jp), init_residuals(params)
    for i in range(3):
        toks = _tokens(4, 32, tcfg.vocab_size, seed=10 + i)
        if compress:
            jp, jo, jm, jres = jstep(jp, jo, jnp.asarray(toks), jres)
            params, opt, m, res = step(params, opt, torch.from_numpy(toks),
                                       res)
        else:
            jp, jo, jm = jstep(jp, jo, jnp.asarray(toks))
            params, opt, m = step(params, opt, torch.from_numpy(toks))
        for key in ("loss", "ce", "grad_norm", "lr"):
            tol = 2e-5 if compress and key == "grad_norm" else 1e-6
            err = abs(float(m[key]) - float(jm[key])) / max(
                1, abs(float(jm[key])))
            assert err <= tol, (i, key, float(m[key]), float(jm[key]))
    got = opt_state_to_numpy(opt, tcfg)
    assert int(got["step"]) == int(jo["step"]) == 3
    mine = {"params": params_to_numpy(params, tcfg), **got}
    ref = {"params": _np_tree(jp), **{k: _np_tree(jo[k])
                                      for k in ("master", "m", "v")}}
    for x, x0 in zip(jax.tree.leaves(mine["params"]), jax.tree.leaves(tree)):
        assert float(np.abs(x - x0).max()) > 20 * 5e-5
    for key, tol, floor in (("params", 5e-5, 1.0), ("master", 5e-5, 1.0),
                            ("m", 1e-4, 1e-3), ("v", 1e-5, 1e-3)):
        if not compress:
            _assert_tree_close(mine[key], ref[key], tol, floor, key)
        elif key in ("params", "master"):
            _assert_rare_flips(mine[key], ref[key], tol, floor, 1e-4,
                               lambda y: lr, key)
        else:
            _assert_rare_flips(mine[key], ref[key], tol, floor, 1e-3,
                               lambda y: 2e-2 * float(np.abs(y).max()), key)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

LAUNCH = ["--smoke", "--device", "cpu", "--seq", "32", "--batch", "2"]


def _launch(args):
    with redirect_stdout(io.StringIO()) as buf:
        out = launcher.main(LAUNCH + args)
    return out, buf.getvalue()


def test_launcher_equals_make_train_step(tmp_path):
    """The launcher's losses are make_train_step's on the same weights,
    data and schedule, bit for bit."""
    out, text = _launch(["--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert "done: 3 steps" in text
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    step = ts.make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=10,
                                               total_steps=3))
    data = SyntheticPackedDataset(DataConfig(seq_len=32, global_batch=2,
                                             vocab_size=cfg.vocab_size))
    for rec in out["steps"]:
        params, opt, m = step(params, opt,
                              torch.from_numpy(data.next_batch()[0]))
        assert rec["loss"] == float(m["loss"])
        assert rec["grad_norm"] == float(m["grad_norm"])
        assert rec["lr"] == float(m["lr"])


def test_launcher_resume_continues_the_run(tmp_path):
    """A run stopped at step 2 (its checkpoint) and resumed gives the
    uninterrupted run's losses bit for bit. Four steps stay inside the
    10-step warmup, where the schedule does not depend on --steps."""
    full, _ = _launch(["--steps", "4", "--microbatch", "2",
                       "--ckpt-dir", str(tmp_path / "full")])
    ck = str(tmp_path / "ck")
    first, _ = _launch(["--steps", "2", "--microbatch", "2", "--ckpt-every",
                        "2", "--ckpt-dir", ck])
    rest, text = _launch(["--steps", "4", "--microbatch", "2", "--resume",
                          "--ckpt-dir", ck])
    assert "resumed from step 2" in text
    assert rest["start"] == 2
    losses = [r["loss"] for r in first["steps"] + rest["steps"]]
    assert losses == [r["loss"] for r in full["steps"]]


def test_launcher_refuses_multipod():
    with pytest.raises(NotImplementedError, match="A13b"):
        launcher.main(LAUNCH + ["--multipod"])
