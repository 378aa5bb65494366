"""The port's MLA path against the JAX package: kernel B2's plain version
at MLA's head dims, the MLA module, the SMOKE deepseek-v2-lite-16b model
and the serving engine on the ``latent`` and ``dense`` backends.

Every input is made with numpy from a seed, and the JAX weights are
carried across by ``repro_torch.models.convert.params_from_numpy``. The
port runs on the CPU, where the B2 wrapper takes its plain version; the
kernel itself, with its (192, 128) instance, is held against that on the
card (tests/test_torch_cuda.py, ``python3 chip_smoke.py``). Tolerances:
B2 fp32 2e-5 and bf16 2e-2 (tests/test_kernels.py); the MLA module, the
model's logits and its latent pools in fp32 1e-4 (as the other model
tests); greedy streams equal on requests whose top-1/top-2 margin is at
least 1e-3 at every step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MLAConfig as J_MLAConfig  # noqa: E402
from repro.configs.base import ModelConfig as J_ModelConfig  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.base import MLAConfig, ModelConfig  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention, lm, mla  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import rope_angles  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-4
B2_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
L, PS = 64, 8           # cache_len, page size


def _np(t):
    return t.detach().float().numpy()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _bridge(dtype_name="float32"):
    jcfg = J_SMOKE[ARCH].scaled(dtype=dtype_name)
    tcfg = SMOKE_CONFIGS[ARCH].scaled(dtype=dtype_name)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0),
                         dtype=jnp.dtype(dtype_name))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=getattr(torch, dtype_name))
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def fp32():
    return _bridge("float32")


def _prompt(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(
        np.int32)


# ---------------------------------------------------------------------------
# (a) B2's plain version at MLA's head dims
# ---------------------------------------------------------------------------

def _split_inputs(B, H, KV, S, hd, hd_v, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd_v))]


@pytest.mark.parametrize("B,H,KV,S,hd,hd_v", [
    (1, 4, 4, 130, 192, 128),       # MLA at full width: no grouping
    (2, 4, 2, 65, 192, 128),
    (1, 4, 4, 97, 48, 32),          # MLA at SMOKE size
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_split_head_dims_match_ref(B, H, KV, S, hd, hd_v, dtype):
    """``flash_attention_plain`` (what the wrapper runs on the CPU) with a
    v head dim of its own, against the ``ref`` oracle and the reference
    model's ``chunked_causal_attention`` in 64-row chunks."""
    tdt = getattr(torch, dtype)
    xs = _split_inputs(B, H, KV, S, hd, hd_v, seed=S + hd)
    tq, tk, tv = [torch.from_numpy(x).to(tdt) for x in xs]
    out = fa.flash_attention_plain(tq, tk, tv)
    assert out.dtype == tdt and out.shape == (B, H, S, hd_v)
    exact = [jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)]
    _close(out, ref.flash_attention_ref(*exact), B2_TOL[dtype])
    model = jattn.chunked_causal_attention(
        *[x.transpose(0, 2, 1, 3).astype(jnp.dtype(dtype)) for x in exact],
        chunk=64)
    _close(out.transpose(1, 2), model, B2_TOL[dtype])


def test_flash_wrapper_takes_the_192_128_instance():
    """The wrapper accepts q/k 192 with v 128 and returns v's width; it
    still refuses pairs it has no instance for."""
    xs = _split_inputs(1, 2, 2, 40, 192, 128, seed=0)
    out = fa.flash_attention(*[torch.from_numpy(x) for x in xs])
    assert out.shape == (1, 2, 40, 128)
    assert (192, 128) in fa.INSTANCES
    q = torch.zeros(1, 2, 8, 192)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, torch.zeros(1, 2, 8, 64))
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q[..., :96], q[..., :96], q[..., :96])


@pytest.mark.parametrize("hd,hd_v,padded", [(192, 128, False),
                                            (48, 32, True)])
def test_model_attention_routes_mla_head_dims(monkeypatch, hd, hd_v, padded):
    """``chunked_causal_attention`` hands q/k 192 with v 128 to B2 as they
    are, and zero-pads SMOKE's 48/32 to 64 (C1)."""
    seen = []
    inner = fa.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return inner(q, k, v, **kw)
    monkeypatch.setattr(fa, "flash_attention", spy)
    rng = np.random.default_rng(hd)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 33, 4, hd), (1, 33, 4, hd), (1, 33, 4, hd_v))]
    out = attention.chunked_causal_attention(q, k, v)
    assert out.shape == (1, 33, 4, hd_v)
    assert seen == [(64, 64, 64)] if padded else seen == [(hd, hd, hd_v)]
    want = jattn.chunked_causal_attention(
        *[jnp.asarray(t.numpy()) for t in (q, k, v)])
    _close(out, want, B2_TOL["float32"])


# ---------------------------------------------------------------------------
# (b) the MLA module
# ---------------------------------------------------------------------------

def _mla_cfgs():
    kw = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab_size=64, dtype="float32")
    mk = dict(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    return (J_ModelConfig(**kw, mla=J_MLAConfig(**mk)),
            ModelConfig(**kw, mla=MLAConfig(**mk)))


def _mla_params(jcfg):
    jp = jmla.init_mla(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_init_mla_shapes_match_reference():
    jcfg, tcfg = _mla_cfgs()
    jp, _ = _mla_params(jcfg)
    g = torch.Generator().manual_seed(0)

    def normal(shape, scale, dt):
        return torch.randn(shape, generator=g, dtype=dt) * scale
    tp = mla.init_mla(tcfg, normal, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert bool((tp["kv_norm"] == 1).all())


def test_mla_prefill_and_decode_match_reference():
    """Prefill's output and latent cache, then each token decoded against
    the cache in order (the reference's tests/test_models.py check),
    equal the reference's; decode equals prefill."""
    jcfg, tcfg = _mla_cfgs()
    jp, tp = _mla_params(jcfg)
    B, S = 2, 12
    x = (np.random.default_rng(1).standard_normal((B, S, 64)) * 0.5).astype(
        np.float32)
    jang = jlayers.rope_angles(jnp.arange(S), 8, jcfg.rope_theta)
    j_out, j_cache = jmla.mla_prefill(jnp.asarray(x), jp, jcfg, jang, None,
                                      want_cache=True)
    ang = rope_angles(torch.arange(S), 8, tcfg.rope_theta)
    t_out, t_cache = mla.mla_prefill(torch.from_numpy(x), tp, tcfg, ang,
                                     want_cache=True)
    _close(t_out, j_out)
    for n in ("c_kv", "k_rope"):
        _close(t_cache[n], j_cache[n])
    cache = {"c_kv": torch.zeros(B, S, 32), "k_rope": torch.zeros(B, S, 8)}
    outs = []
    for t in range(S):
        pos = torch.full((B,), t, dtype=torch.int32)
        outs.append(mla.mla_decode(torch.from_numpy(x[:, t]), tp, tcfg,
                                   cache, pos, pos))
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(t_out),
                               atol=5e-5)
    for n in ("c_kv", "k_rope"):
        _close(cache[n], j_cache[n])


def test_mla_decode_past_the_cache_writes_nothing():
    """A position past Smax writes no row (the reference's scatter drops
    it) and attends over every row, as the reference does."""
    jcfg, tcfg = _mla_cfgs()
    jp, tp = _mla_params(jcfg)
    rng = np.random.default_rng(2)
    c = rng.standard_normal((2, 6, 32)).astype(np.float32)
    r = rng.standard_normal((2, 6, 8)).astype(np.float32)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    pos = np.array([3, 6], np.int32)
    lengths = np.array([3, 6], np.int32)
    j_out, j_new = jmla.mla_decode(
        jnp.asarray(x), jp, jcfg, {"c_kv": jnp.asarray(c),
                                   "k_rope": jnp.asarray(r),
                                   "length": jnp.asarray(lengths)},
        jnp.asarray(pos), None)
    cache = {"c_kv": torch.from_numpy(c.copy()),
             "k_rope": torch.from_numpy(r.copy())}
    t_out = mla.mla_decode(torch.from_numpy(x), tp, tcfg, cache,
                           torch.from_numpy(pos), torch.from_numpy(lengths))
    _close(t_out, j_out)
    for n in ("c_kv", "k_rope"):
        _close(cache[n], j_new[n])
    np.testing.assert_array_equal(cache["c_kv"][1].numpy(), c[1])


# ---------------------------------------------------------------------------
# (c) the SMOKE model: logits, latent pools, decode on both layouts
# ---------------------------------------------------------------------------

def test_prefill_logits_and_latent_caches(fp32):
    jcfg, jp, tcfg, tp = fp32
    toks = np.stack([_prompt(37, 1), _prompt(37, 2)])
    jl, jst = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                          cache_len=L)
    tl, tst = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    _close(tl, jl)
    groups = jst["caches"]["groups"]
    for i, layer in enumerate(tst["caches"]):
        assert set(layer) == {"c_kv", "k_rope"}
        assert layer["c_kv"].shape == (2, L, 64)
        for n in ("c_kv", "k_rope"):
            _close(layer[n], groups[f"b{i}"][n][0])


def test_init_params_shapes_match_reference():
    jcfg = J_SMOKE[ARCH]
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm.init_params(SMOKE_CONFIGS[ARCH], torch.Generator().manual_seed(0),
                        device="cpu")
    prefix, unit, n_groups = tf.plan_layers(SMOKE_CONFIGS[ARCH])
    assert (prefix, n_groups) == ([], 1)
    for j, blk in enumerate(tp["blocks"]):
        want = jax.tree.map(lambda a: tuple(a.shape[1:]),
                            jp["stack"]["groups"][f"b{j}"])
        got = {k: tuple(v.shape) for k, v in blk["attn"].items()}
        assert got == want["attn"]
        assert blk["attn"]["wq"].dtype == torch.bfloat16


def _latent_states(jcfg, jp, tcfg, tp, prompts, tables, max_pages,
                   n_pages=24):
    """Both frameworks' latent paged states, each prompt's prefill rows
    scattered into the pools at its table's page ids."""
    B = len(prompts)
    js = jlm.init_paged_serve_state(jcfg, B, n_pages, PS, max_pages,
                                    dtype=jnp.float32)
    ts = lm.init_paged_serve_state(tcfg, B, n_pages, PS, max_pages,
                                   dtype=torch.float32, device="cpu")
    lengths = np.array([len(p) for p in prompts], np.int32)
    table = np.zeros((B, max_pages), np.int32)
    for b, (p, pages) in enumerate(zip(prompts, tables)):
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
        table[b, :len(pages)] = pages
    for st, conv in ((js, jnp.asarray), (ts, torch.from_numpy)):
        st["lengths"] = conv(lengths.copy())
        st["positions"] = conv(lengths.copy())
        st["page_table"] = conv(table.copy())
    return js, ts


def _pools_close(ts, js):
    groups = js["caches"]["groups"]
    for i, layer in enumerate(ts["caches"]):
        for n in ("c_kv", "k_rope"):
            _close(layer[n], groups[f"b{i}"][n][0])


def test_latent_paged_decode_step_logits_and_pools(fp32):
    """Three decode steps of three slots through the latent pools, one
    slot parked in the second: logits, positions and the pools equal
    the reference's (the parked slot's write dropped)."""
    jcfg, jp, tcfg, tp = fp32
    prompts = [_prompt(11, 3), _prompt(17, 4), _prompt(6, 5)]
    js, ts = _latent_states(jcfg, jp, tcfg, tp, prompts,
                            tables=[[5, 2], [7, 1, 9], [3]], max_pages=4)
    assert set(ts["caches"][0]) == {"c_kv", "k_rope"}
    assert ts["caches"][0]["c_kv"].shape == (24, PS, 64)
    step = jax.jit(lambda p, t, s, a: jlm.decode_step(
        p, t, s, jcfg, NULL_POLICY, active=a))
    toks = np.array([3, 8, 100], np.int32)
    for active in ([True, True, True], [True, False, True],
                   [True, True, True]):
        jl, js = step(jp, jnp.asarray(toks), js, jnp.asarray(active))
        tl, ts = lm.decode_step(tp, torch.from_numpy(toks), ts, tcfg,
                                active=torch.tensor(active))
        _close(tl, jl)
        np.testing.assert_array_equal(ts["positions"].numpy(),
                                      np.asarray(js["positions"]))
        _pools_close(ts, js)
        toks = np.array(jnp.argmax(jl, axis=-1), np.int32)


def test_dense_decode_step_logits_and_slabs(fp32):
    """The same on per-slot latent slabs (the dense layout): the parked
    slot's rows are left as they were."""
    jcfg, jp, tcfg, tp = fp32
    toks = np.stack([_prompt(9, 6), _prompt(9, 7)])
    jl, js = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                         cache_len=L)
    tl, ts = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    step = jax.jit(lambda p, t, s, a: jlm.decode_step(
        p, t, s, jcfg, NULL_POLICY, active=a))
    for active in ([True, True], [False, True], [True, True]):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        before = ts["caches"][0]["c_kv"][0].clone()
        jl, js = step(jp, jnp.asarray(nxt), js, jnp.asarray(active))
        tl, ts = lm.decode_step(tp, torch.from_numpy(nxt), ts, tcfg,
                                active=torch.tensor(active))
        _close(tl, jl)
        _pools_close(ts, js)
        if not active[0]:
            assert torch.equal(ts["caches"][0]["c_kv"][0], before)


def test_paged_and_latent_layouts_hold_latent_pools(fp32):
    """As in the reference, an MLA stack's paged state holds latent
    pools, and so does the latent backend's."""
    _, _, tcfg, _ = fp32
    st = lm.init_paged_serve_state(tcfg, 2, 8, PS, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in st["caches"][1].items()} == {
        "c_kv": (8, PS, 64), "k_rope": (8, PS, 16)}
    assert tf.latent_paged_stack_supported(tcfg)
    assert not tf.paged_stack_supported(tcfg)
    assert not tf.latent_paged_stack_supported(SMOKE_CONFIGS["qwen3-8b"])


# ---------------------------------------------------------------------------
# (d) the engine against the JAX engine on latent and dense
# ---------------------------------------------------------------------------

MAX_NEW = 12
MARGIN = 1e-3
# request seed -> prompt length; each keeps a top-1/top-2 margin >= 1e-3
# over its MAX_NEW greedy tokens
SEEDS = {0: 30, 2: 22, 3: 25, 5: 18, 7: 14}
# 10 pages of 8 tokens: the latent backend runs out of pages as the
# slots grow and parks; the dense one holds two worst-case footprints,
# not three, and parks a running slot
SETTINGS = {"span1": dict(n_pages=64, decode_span=1),
            "span8": dict(n_pages=64, decode_span=8),
            "park1": dict(n_pages=10, decode_span=1),
            "park8": dict(n_pages=10, decode_span=8)}
LAYOUTS = ("latent", "dense")


class StepClock:
    """A clock the test advances once per engine step."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _greedy(cfg, params, prompts):
    """Model-level greedy stream and smallest top-1/top-2 margin of each
    prompt (batch 1, dense cache), from the port's model: its logits lie
    within 1e-4 of the reference's (the model tests above), so a margin
    of 1e-3 here leaves the reference's top-1 the same token."""
    out = []
    for prompt in prompts:
        lg, st = lm.prefill(params, torch.from_numpy(prompt[None]), cfg,
                            cache_len=L)
        toks, margin = [], np.inf
        for i in range(MAX_NEW):
            top = np.sort(_np(lg[0]))[-2:]
            margin = min(margin, float(top[1] - top[0]))
            toks.append(int(torch.argmax(lg[0])))
            if i < MAX_NEW - 1:
                lg, st = lm.decode_step(
                    params, torch.tensor([toks[-1]], dtype=torch.int32), st,
                    cfg)
        out.append((toks, margin))
    return out


def _drive(eng, clock, max_steps=500):
    for _ in range(max_steps):
        if not (eng.active.any() or eng.sched.pending
                or eng.transport.in_flight):
            return eng.completed
        clock.t += 1.0
        eng.step()
    raise AssertionError("engine did not drain")


def _engine_run(make, req_cls, prompts):
    clock = StepClock()
    eng = make(clock)
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, p.copy(), max_new_tokens=MAX_NEW))
    done = _drive(eng, clock)
    return eng, [(r.req_id, r.tokens_out) for r in done]


def _common(layout, setting, **kw):
    return dict(dict(slots=3, cache_len=L, page_size=PS, eos_token=-1,
                     kv_layout=layout, scheduler="fcfs", sampler="greedy",
                     prefill_chunk=0, prefix_cache_entries=0,
                     **SETTINGS[setting]), **kw)


def _prompts():
    return [_prompt(n, s) for s, n in SEEDS.items()]


@pytest.fixture(scope="module")
def reference(fp32):
    """The model-level greedy streams and margins, and the JAX engine's
    stats and streams for every layout and setting, computed once."""
    jcfg, jp, tcfg, tp = fp32
    prompts = _prompts()
    runs = {}
    for layout in LAYOUTS:
        for name in SETTINGS:
            eng, streams = _engine_run(lambda c, n=name, lo=layout: JEngine(
                jcfg, jp, japi.EngineConfig(clock=c, **_common(lo, n))),
                japi.Request, prompts)
            runs[layout, name] = (dict(eng.stats), streams)
    return _greedy(tcfg, tp, prompts), runs


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_engine_streams_match_reference(fp32, reference, layout, setting):
    """Same streams, completion order and counters as the JAX engine on
    the same layout, at span 1 and 8, with room for everyone and under
    page pressure (both backends park and unpark); the pool is empty
    afterwards."""
    _, _, tcfg, tp = fp32
    greedy, runs = reference
    for toks, margin in greedy:
        assert margin >= MARGIN, margin
    ref_stats, ref_streams = runs[layout, setting]
    eng, streams = _engine_run(lambda c: ServingEngine(
        tcfg, tp, api.EngineConfig(clock=c, **_common(layout, setting)),
        device="cpu"), api.Request, _prompts())
    stats = eng.stats
    assert eng.kv.name == layout
    assert streams == ref_streams
    for req_id, toks in streams:
        assert toks == greedy[req_id][0]
    for key in ("parked", "unparked", "decode_steps", "decode_spans",
                "prefills", "span_shrinks", "page_allocs",
                "preempt_restarts", "pages_peak"):
        assert stats[key] == ref_stats[key], key
    if setting.startswith("park"):
        assert stats["parked"] > 0
        assert stats["unparked"] == stats["parked"]
    assert stats["host_syncs"] == stats["prefills"] + stats["decode_spans"]
    assert eng.pool.n_free == eng.pool.n_pages


# ---------------------------------------------------------------------------
# (e) refusals and declined capabilities
# ---------------------------------------------------------------------------

def _latent_refusal(make, cfg, ecfg):
    with pytest.raises(ValueError) as info:
        make("latent", cfg, ecfg)
    return str(info.value)


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_latent_refuses_non_mla_configs_with_the_reference_message(arch):
    msg = _latent_refusal(lambda n, c, e: api.make_state_backend(
        n, c, e, "cpu"), SMOKE_CONFIGS[arch], api.EngineConfig(
            kv_layout="latent"))
    want = _latent_refusal(japi.make_state_backend, J_SMOKE[arch],
                           japi.EngineConfig(kv_layout="latent"))
    assert msg == want
    assert "latent-paged serving needs every layer to be MLA" in msg


def test_latent_declines_chunked_prefill_and_the_prefix_cache(fp32):
    """The backend's flags are off, so the engine prefills monolithically
    with the prefix cache inert, as the reference's engine does; the
    model's ``prefill_chunk`` refuses MLA with the reference's message."""
    jcfg, jp, tcfg, tp = fp32
    kw = dict(prefill_chunk=16, prefix_cache_entries=32)
    eng, streams = _engine_run(lambda c: ServingEngine(
        tcfg, tp, api.EngineConfig(clock=c, **_common("latent", "span8",
                                                      **kw)),
        device="cpu"), api.Request, _prompts())
    assert not eng.kv.supports_chunked_prefill
    assert not eng.kv.supports_prefix_share
    assert eng.stats["prefill_chunks"] == 0
    assert eng.stats["prefix_hits"] == 0
    j_eng, j_streams = _engine_run(lambda c: JEngine(
        jcfg, jp, japi.EngineConfig(clock=c, **_common("latent", "span8",
                                                       **kw))),
        japi.Request, _prompts())
    assert streams == j_streams
    assert eng.stats["prefills"] == j_eng.stats["prefills"]
    caches = lm.init_serve_state(tcfg, 1, L, device="cpu")["caches"]
    with pytest.raises(ValueError) as t_info:
        lm.prefill_chunk(tp, torch.zeros(1, 8, dtype=torch.int64), caches,
                         0, 8, tcfg)
    with pytest.raises(ValueError) as j_info:
        jlm.prefill_chunk(jp, jnp.zeros((1, 8), jnp.int32), None, 0, 8,
                          jcfg, NULL_POLICY)
    assert str(t_info.value) == str(j_info.value)
