"""The port's model path against the JAX model on the same weights.

SMOKE qwen3-8b with fp32 weights from ``repro.models.lm.init_params``,
carried across by ``repro_torch.models.convert.params_from_numpy``; the
port runs on the CPU (plain kernel versions). fp32 comparisons hold to
atol/rtol 1e-4; the bf16 prefill to 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = 1e-4
L = 64          # cache_len
PS = 8          # page size


def _bridge(dtype_name):
    jcfg = J_SMOKE["qwen3-8b"].scaled(dtype=dtype_name)
    tcfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype=dtype_name)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0),
                         dtype=jnp.dtype(dtype_name))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=getattr(torch, dtype_name))
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def fp32():
    return _bridge("float32")


def _np(t):
    return t.detach().float().numpy()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _prompt(n, seed, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(
        np.int32)


def test_bridge_unstacks_groups_in_layer_order(fp32):
    jcfg, jp, tcfg, tp = fp32
    _, unit, n_groups = jtf.plan_layers(jcfg)
    assert (len(unit), n_groups) == (1, tcfg.n_layers)
    assert len(tp["blocks"]) == tcfg.n_layers
    for i, blk in enumerate(tp["blocks"]):
        np.testing.assert_array_equal(
            _np(blk["attn"]["wq"]),
            np.asarray(jp["stack"]["groups"]["b0"]["attn"]["wq"][i]))
    assert tf.plan_layers(tcfg) == jtf.plan_layers(jcfg)


def test_prefill_logits_and_caches(fp32):
    jcfg, jp, tcfg, tp = fp32
    toks = np.stack([_prompt(21, 1, tcfg.vocab_size),
                     _prompt(21, 2, tcfg.vocab_size)])
    jl, jst = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                          cache_len=L)
    tl, tst = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    _close(tl, jl)
    groups = jst["caches"]["groups"]["b0"]
    for i, layer in enumerate(tst["caches"]):
        assert layer["k"].shape == (2, L, tcfg.n_kv_heads, tcfg.head_dim)
        _close(layer["k"], groups["k"][i])
        _close(layer["v"], groups["v"][i])
    np.testing.assert_array_equal(tst["lengths"].numpy(),
                                  np.asarray(jst["lengths"]))


def _paged_states(jcfg, jp, tcfg, tp, prompts, tables, max_pages,
                  n_pages=24):
    """Both frameworks' paged states, built the way the engine builds
    them: ``init_paged_serve_state``, then each prompt's prefill pages
    scattered into the pool at its table's page ids."""
    B = len(prompts)
    js = jlm.init_paged_serve_state(jcfg, B, n_pages, PS, max_pages,
                                    dtype=jnp.float32)
    ts = lm.init_paged_serve_state(tcfg, B, n_pages, PS, max_pages,
                                   dtype=torch.float32, device="cpu")
    lengths = np.zeros(B, np.int32)
    table = np.zeros((B, max_pages), np.int32)
    for b, (p, pages) in enumerate(zip(prompts, tables)):
        if p is None:
            continue
        _, jst = jlm.prefill(jp, jnp.asarray(p[None]), jcfg, NULL_POLICY,
                             cache_len=L)
        _, tst = lm.prefill(tp, torch.from_numpy(p[None]), tcfg,
                            cache_len=L)
        js["caches"] = jtf.scatter_pages(
            js["caches"], jtf.dense_to_pages(jst["caches"], len(pages), PS),
            pages)
        tf.scatter_pages(ts["caches"],
                         tf.dense_to_pages(tst["caches"], len(pages), PS),
                         pages)
        lengths[b] = len(p)
        table[b, :len(pages)] = pages
    for st, conv in ((js, jnp.asarray), (ts, torch.from_numpy)):
        st["lengths"] = conv(lengths.copy())
        st["positions"] = conv(lengths.copy())
        st["page_table"] = conv(table.copy())
    return js, ts


def _close_pools(ts, js):
    groups = js["caches"]["groups"]["b0"]
    for i, layer in enumerate(ts["caches"]):
        _close(layer["k"], groups["k"][i])
        _close(layer["v"], groups["v"][i])


def test_paged_decode_step_logits_and_pools(fp32):
    jcfg, jp, tcfg, tp = fp32
    V = tcfg.vocab_size
    prompts = [_prompt(11, 3, V), _prompt(17, 4, V)]
    js, ts = _paged_states(jcfg, jp, tcfg, tp, prompts,
                           tables=[[5, 2], [7, 1, 9]], max_pages=4)
    step = jax.jit(lambda p, t, s, a: jlm.decode_step(
        p, t, s, jcfg, NULL_POLICY, active=a))
    toks = np.array([3, 8], np.int32)
    for active in ([True, True], [True, False], [True, True]):
        jl, js = step(jp, jnp.asarray(toks), js, jnp.asarray(active))
        tl, ts = lm.decode_step(tp, torch.from_numpy(toks), ts, tcfg,
                                active=torch.tensor(active))
        _close(tl, jl)
        _close_pools(ts, js)
        np.testing.assert_array_equal(ts["positions"].numpy(),
                                      np.asarray(js["positions"]))
        toks = np.array(jnp.argmax(jl, axis=-1), np.int32)


def test_decode_span_matches_scan(fp32):
    """Span 8, slot 1 parked (its table row is zeros and narrower than
    its length), slot 2 with a budget of 3: tokens, emission masks,
    counters and pools all match the JAX scan."""
    jcfg, jp, tcfg, tp = fp32
    V = tcfg.vocab_size
    prompts = [_prompt(5, 5, V), _prompt(30, 6, V), _prompt(7, 7, V)]
    js, ts = _paged_states(jcfg, jp, tcfg, tp, prompts,
                           tables=[[4, 11], [], [8, 3]], max_pages=2)
    active = np.array([True, False, True])
    budgets = np.array([8, 8, 3], np.int32)
    toks = np.array([17, 2, 40], np.int32)
    jt, je, js = jlm.decode_span(jp, jnp.asarray(toks), js, jcfg,
                                 NULL_POLICY, jnp.asarray(active),
                                 jnp.asarray(budgets), span=8, eos_token=-1,
                                 cache_len=L)
    tt, te, ts = lm.decode_span(tp, torch.from_numpy(toks), ts, tcfg,
                                torch.from_numpy(active),
                                torch.from_numpy(budgets), span=8,
                                eos_token=-1, cache_len=L)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te.numpy().sum(axis=0).tolist() == [8, 0, 3]
    for key in ("positions", "lengths"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    _close_pools(ts, js)


def test_prefill_bf16_logits():
    """bf16 prefill against the JAX model in bf16, at 2e-2 of the logit
    scale. An elementwise 2e-2 would sit inside bf16's own rounding
    noise: the JAX bf16 run alone lies 0.025-0.055 from the same weights'
    fp32 math on such prompts, and the two CPU backends' bf16 matrix
    products round a few sums one ulp apart. So the test also holds the
    port's bf16 error against the fp32 math to at most twice the
    reference's own."""
    jcfg, jp, tcfg, tp = _bridge("bfloat16")
    toks = _prompt(33, 8, tcfg.vocab_size)[None]
    jl, _ = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                        cache_len=L)
    tl, _ = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    assert tl.dtype == torch.bfloat16
    ref = np.asarray(jl, np.float32)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(_np(tl), ref, atol=2e-2 * scale, rtol=2e-2)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    exact, _ = jlm.prefill(jp32, jnp.asarray(toks),
                           jcfg.scaled(dtype="float32"), NULL_POLICY,
                           cache_len=L)
    exact = np.asarray(exact)
    err_ref = np.abs(ref - exact).max()
    err_port = np.abs(_np(tl) - exact).max()
    assert err_port <= 2 * err_ref, (err_port, err_ref)


# ---------------------------------------------------------------------------
# prefill attention at head dims B2 is not built for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KV,hd,hd_v", [
    (2, 40, 8, 2, 120, 120),        # h2o-danube-3-4b's head dim, GQA 4:1
    (1, 33, 4, 4, 48, 32),          # MLA at SMOKE size: q/k 48, v 32
    (2, 17, 4, 1, 20, 20),
])
def test_chunked_attention_pads_head_dims_like_reference(B, S, H, KV, hd,
                                                         hd_v):
    """The port zero-pads q, k and v to the next head dim B2 is built
    for and slices the output back; it computes what the reference's
    ``chunked_causal_attention`` does, with the unpadded q's scale."""
    from repro.models import attention as jattn
    from repro_torch.models import attention
    rng = np.random.default_rng(hd + hd_v + S)
    q, k, v = [rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd_v))]
    out = attention.chunked_causal_attention(
        *[torch.from_numpy(x) for x in (q, k, v)])
    assert out.shape == (B, S, H, hd_v)
    want = jattn.chunked_causal_attention(*[jnp.asarray(x)
                                            for x in (q, k, v)])
    _close(out, want)


def test_chunked_attention_past_b2_head_dims_names_a8():
    """Past B2's instances (q/k 192 with v 128, MLA's full width, and the
    square head dims up to 128) it raises and names what is built."""
    from repro_torch.models import attention
    q = torch.zeros(1, 4, 2, 256)
    with pytest.raises(ValueError, match="built for"):
        attention.chunked_causal_attention(q, q, torch.zeros(1, 4, 2, 128))
    q = torch.zeros(1, 4, 2, 192)
    with pytest.raises(ValueError, match="built for"):
        attention.chunked_causal_attention(q, q, q)
