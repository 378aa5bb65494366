"""The port's jamba path against the JAX package: the plain versions of
kernels B6 (linear scan) and B5 (SSM decode step), the Mamba layer, the
SMOKE jamba-v0.1-52b model (Mamba, attention, dense and MoE MLPs) and the
serving engine on the ``dense`` backend, for jamba and for qwen3-8b.

Every input is made with numpy from a seed, and the JAX weights are
carried across by ``repro_torch.models.convert.params_from_numpy``. The
port runs on the CPU, where the B5/B6 wrappers take their plain
versions; the kernels themselves are held against those on the card
(tests/test_torch_cuda.py, ``python3 chip_smoke.py``). Tolerances: the
kernel sweeps of tests/test_kernels.py at 1e-5 in fp32; the Mamba layer
(output and state) in fp32 1e-5; model logits in fp32 1e-4 and in bf16
as tests/test_torch_model.py; greedy streams equal on requests whose
reference top-1/top-2 margin is at least 1e-3. The reference engine's
dense streams are compared with the port's at the same span and layout
only: the reference's own bf16 dense streams change between spans
(tests/test_frontend.py), so nothing here compares across spans.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS as J_CONFIGS  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.registry import CONFIGS, SMOKE_CONFIGS  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import ssm_decode as sd  # noqa: E402
from repro_torch.models import lm, mamba  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL = 1e-4
KTOL = 1e-5             # kernels and the Mamba layer, fp32
L, PS = 64, 8           # cache_len, page size


def _np(t):
    return t.detach().float().numpy()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _bridge(arch, dtype_name, **overrides):
    jcfg = J_SMOKE[arch].scaled(dtype=dtype_name, **overrides)
    tcfg = SMOKE_CONFIGS[arch].scaled(dtype=dtype_name, **overrides)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0),
                         dtype=jnp.dtype(dtype_name))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=getattr(torch, dtype_name))
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def fp32():
    return _bridge(ARCH, "float32")


# ---------------------------------------------------------------------------
# (a) B6 and (b) B5: the plain versions against the oracles and Pallas
# ---------------------------------------------------------------------------

def _scan_inputs(B, T, D, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, T, D, N)).astype(np.float32)
    b = rng.standard_normal((B, T, D, N)).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("B,T,D,N,bd", [(2, 16, 8, 4, 8), (1, 32, 16, 4, 16),
                                        (3, 8, 32, 8, 8), (2, 13, 16, 8, 8)])
def test_linear_scan_plain_matches_ref_and_pallas(B, T, D, N, bd):
    """The sweep of tests/test_kernels.py and a ragged T = 13."""
    a, b, h0 = _scan_inputs(B, T, D, N, seed=B * T + D)
    hs, hl = ls.linear_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert hs.shape == (B, T, D, N) and hl.shape == (B, D, N)
    assert hs.dtype == hl.dtype == torch.float32
    rhs, rhl = ref.linear_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0))
    phs, phl = ops.linear_scan(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(h0), block_d=bd, interpret=True)
    for got, want in ((hs, rhs), (hl, rhl), (hs, phs), (hl, phl)):
        _close(got, want, KTOL)


def test_linear_scan_refuses_bad_inputs():
    a = torch.zeros(1, 4, 8, 4)
    with pytest.raises(TypeError):
        ls.linear_scan(a.double(), a.double(), torch.zeros(1, 8, 4).double())
    with pytest.raises(ValueError):
        ls.linear_scan(a, a[:, :3], torch.zeros(1, 8, 4))
    with pytest.raises(ValueError):
        ls.linear_scan(a, a, torch.zeros(1, 8, 2))


@pytest.mark.parametrize("B,Di,N,bd", [(2, 8, 4, 8), (1, 32, 8, 16),
                                       (3, 16, 4, 16), (2, 8, 1, 8),
                                       (1, 16, 2, 16), (2, 8, 32, 8)])
def test_ssm_decode_plain_matches_ref_pallas_and_scan(B, Di, N, bd):
    """The sweep of tests/test_kernels.py and the N that B5 runs one n a
    thread (1, 2) or eight threads a channel (32); h' is also the T = 1
    slice of the linear scan."""
    rng = np.random.default_rng(B * Di * N)
    h = rng.standard_normal((B, Di, N)).astype(np.float32)
    dA = rng.uniform(0.5, 1.0, (B, Di, N)).astype(np.float32)
    dtx = rng.standard_normal((B, Di)).astype(np.float32)
    Bs = rng.standard_normal((B, N)).astype(np.float32)
    Cs = rng.standard_normal((B, N)).astype(np.float32)
    xs = (h, dA, dtx, Bs, Cs)
    y, hn = sd.ssm_decode_step(*(torch.from_numpy(x) for x in xs))
    assert y.shape == (B, Di) and hn.shape == (B, Di, N)
    ry, rhn = ref.ssm_decode_step_ref(*(jnp.asarray(x) for x in xs))
    py, phn = ops.ssm_decode_step(*(jnp.asarray(x) for x in xs),
                                  block_d=bd, interpret=True)
    for got, want in ((y, ry), (hn, rhn), (y, py), (hn, phn)):
        _close(got, want, KTOL)
    _, sl = ls.linear_scan_plain(
        torch.from_numpy(dA)[:, None],
        torch.from_numpy(dtx[..., None] * Bs[:, None, :])[:, None],
        torch.from_numpy(h))
    _close(sl, _np(hn), KTOL)


def test_ssm_decode_refuses_bad_inputs():
    h = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError):
        sd.ssm_decode_step(h, h, torch.zeros(2, 8), torch.zeros(2, 3),
                           torch.zeros(2, 4))
    with pytest.raises(TypeError):
        sd.ssm_decode_step(h, h, torch.zeros(2, 8), torch.zeros(2, 4),
                           torch.zeros(2, 4).bfloat16())
    # what the B5 kernel does not take: N that does not divide 32, B * Di
    # * N past 32-bit indexing, B past the grid's second axis
    for B, Di, N in ((2, 8, 3), (2, 8, 64), (1, 1 << 27, 16), (65536, 8, 4)):
        with pytest.raises(ValueError):
            sd.kernel_sizes_fit(B, Di, N)
    sd.kernel_sizes_fit(4, 8192, 16)            # jamba's decode fits


# ---------------------------------------------------------------------------
# (c) the Mamba layer against repro.models.mamba
# ---------------------------------------------------------------------------

def _mamba_params(fp32, layer=0):
    _, jp, _, tp = fp32
    jm = jax.tree.map(lambda a: a[0],
                      jp["stack"]["groups"][f"b{layer}"]["mamba"])
    return jm, tp["blocks"][layer]["mamba"]


def _mamba_state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    di = cfg.mamba.expand * cfg.d_model
    return {"conv": rng.standard_normal(
                (B, cfg.mamba.d_conv - 1, di)).astype(np.float32),
            "ssm": rng.standard_normal(
                (B, di, cfg.mamba.d_state)).astype(np.float32)}


@pytest.mark.parametrize("S,chunk,carried", [(300, 256, True),
                                             (150, 64, True),
                                             (40, 256, False),
                                             (1, 256, True)])
def test_mamba_forward_matches_reference(fp32, S, chunk, carried):
    """Output and final state at 1e-5, with a state carried in or not,
    S a multiple of the chunk or not (the reference pads the tail chunk,
    the port runs it ragged)."""
    jcfg, _, tcfg, _ = fp32
    jm, tm = _mamba_params(fp32)
    x = np.random.default_rng(S).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    st = _mamba_state(tcfg, 2, seed=S + 1) if carried else None
    jy, js = jmamba.mamba_forward(
        jnp.asarray(x), jm, jcfg, None, chunk=chunk,
        state=jax.tree.map(jnp.asarray, st) if carried else None,
        want_state=True)
    ty, ts = mamba.mamba_forward(
        torch.from_numpy(x), tm, tcfg, chunk=chunk,
        state=({k: torch.from_numpy(v) for k, v in st.items()}
               if carried else None), want_state=True)
    _close(ty, jy, KTOL)
    for key in ("conv", "ssm"):
        assert ts[key].shape == js[key].shape
        _close(ts[key], js[key], KTOL)
    assert ts["ssm"].dtype == torch.float32


def test_mamba_decode_matches_reference(fp32):
    jcfg, _, tcfg, _ = fp32
    jm, tm = _mamba_params(fp32, layer=1)
    x = np.random.default_rng(7).standard_normal(
        (3, tcfg.d_model)).astype(np.float32)
    st = _mamba_state(tcfg, 3, seed=8)
    jy, js = jmamba.mamba_decode(jnp.asarray(x), jm, jcfg,
                                 jax.tree.map(jnp.asarray, st), None)
    ty, ts = mamba.mamba_decode(torch.from_numpy(x), tm, tcfg,
                                {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    _close(ty, jy, KTOL)
    for key in ("conv", "ssm"):
        _close(ts[key], js[key], KTOL)


def test_softplus_matches_jax_softplus():
    """logaddexp(x, 0) as JAX writes it, to within one fp32 ulp (the two
    frameworks' exp and log1p differ in the last bit), over the range
    where ``F.softplus`` switches to its x > 20 branch."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [0.0, 20.0, 20.5, -1e-7]]).astype(np.float32)
    np.testing.assert_allclose(
        mamba.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2.4e-7, atol=0)


# ---------------------------------------------------------------------------
# (d) the model: prefill and dense decode logits
# ---------------------------------------------------------------------------

def _prompt(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(
        np.int32)


def test_configs_are_the_reference_configs():
    """The port's copies of CONFIG and SMOKE carry the reference's fields;
    SMOKE mixes every layer kind of the full model."""
    for port, jax_cfg in ((CONFIGS[ARCH], J_CONFIGS[ARCH]),
                          (SMOKE_CONFIGS[ARCH], J_SMOKE[ARCH])):
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    cfg = SMOKE_CONFIGS[ARCH]
    assert set(zip(cfg.layer_kinds(), cfg.mlp_kinds())) == {
        ("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")}
    assert cfg.layer_kinds().count("attn") == 1


def test_prefill_logits_and_caches(fp32):
    """Prefill of two 37-token prompts: logits, the attention layer's
    slabs and every Mamba layer's carry."""
    jcfg, jp, tcfg, tp = fp32
    toks = np.stack([_prompt(37, 1), _prompt(37, 2)])
    jl, jst = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                          cache_len=L)
    tl, tst = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    _close(tl, jl)
    groups = jst["caches"]["groups"]
    for i, layer in enumerate(tst["caches"]):
        want = groups[f"b{i}"]
        assert set(layer) == set(want)
        for key, t in layer.items():
            assert t.shape == want[key].shape[1:]
            _close(t, want[key][0])


def test_dense_decode_step_logits_and_caches(fp32):
    """Three decode steps of three slots on the dense state, one slot
    parked in the second: logits, positions, every layer's state, and the
    parked slot's slab and carries left as they were. Both frameworks
    start from the port's prefill caches (prefill parity is tested
    above), carried into the reference's grouped layout."""
    jcfg, jp, tcfg, tp = fp32
    prompts = [_prompt(11, 3), _prompt(17, 4), _prompt(6, 5)]
    ts = lm.init_serve_state(tcfg, 3, L, dtype=torch.float32, device="cpu")
    for b, p in enumerate(prompts):
        _, tst = lm.prefill(tp, torch.from_numpy(p[None]), tcfg,
                            cache_len=L)
        for layer, one in zip(ts["caches"], tst["caches"]):
            for key, t in layer.items():
                t[b].copy_(one[key][0])
    lengths = np.array([len(p) for p in prompts], np.int32)
    ts["lengths"] = torch.from_numpy(lengths.copy())
    ts["positions"] = torch.from_numpy(lengths.copy())
    js = jlm.init_serve_state(jcfg, 3, L, filled=False, dtype=jnp.float32)
    assert js["caches"]["prefix"] == []
    js["caches"]["groups"] = {
        f"b{i}": {k: jnp.asarray(t.numpy())[None] for k, t in layer.items()}
        for i, layer in enumerate(ts["caches"])}
    js["lengths"] = js["positions"] = jnp.asarray(lengths)
    step = jax.jit(lambda p, t, s, a: jlm.decode_step(
        p, t, s, jcfg, NULL_POLICY, active=a))
    toks = np.array([3, 8, 100], np.int32)
    for active in ([True, True, True], [True, False, True],
                   [True, True, True]):
        frozen = [{k: t[1].clone() for k, t in layer.items()}
                  for layer in ts["caches"]]
        jl, js = step(jp, jnp.asarray(toks), js, jnp.asarray(active))
        tl, ts = lm.decode_step(tp, torch.from_numpy(toks), ts, tcfg,
                                active=torch.tensor(active))
        _close(tl, jl)
        np.testing.assert_array_equal(ts["positions"].numpy(),
                                      np.asarray(js["positions"]))
        groups = js["caches"]["groups"]
        for i, layer in enumerate(ts["caches"]):
            for key, t in layer.items():
                _close(t, groups[f"b{i}"][key][0])
                if not active[1]:
                    assert torch.equal(t[1], frozen[i][key]), (i, key)
        toks = np.array(jnp.argmax(jl, axis=-1), np.int32)


def test_prefill_bf16_logits():
    """bf16 prefill against the JAX model in bf16 at 2e-2 of the logit
    scale, and the port's bf16 error against the fp32 math at most twice
    the reference's own (tests/test_torch_model.py says why)."""
    jcfg, jp, tcfg, tp = _bridge(ARCH, "bfloat16")
    toks = _prompt(33, 8)[None]
    jl, _ = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                        cache_len=L)
    tl, _ = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    assert tl.dtype == torch.bfloat16
    refl = np.asarray(jl, np.float32)
    scale = float(np.abs(refl).max())
    np.testing.assert_allclose(_np(tl), refl, atol=2e-2 * scale, rtol=2e-2)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    exact, _ = jlm.prefill(jp32, jnp.asarray(toks),
                           jcfg.scaled(dtype="float32"), NULL_POLICY,
                           cache_len=L)
    exact = np.asarray(exact)
    err_ref = np.abs(refl - exact).max()
    err_port = np.abs(_np(tl) - exact).max()
    assert err_port <= 2 * err_ref, (err_port, err_ref)


# ---------------------------------------------------------------------------
# (h) params: init and the weight bridge
# ---------------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_init_params_shapes_and_dtypes_match_reference():
    """SMOKE (bf16): eight blocks of every kind, the Mamba vectors and the
    router in fp32, the matrices in bf16."""
    jp = jlm.init_params(J_SMOKE[ARCH], jax.random.PRNGKey(0))
    tp = lm.init_params(SMOKE_CONFIGS[ARCH], torch.Generator().manual_seed(0),
                        device="cpu")
    jb = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                      jp["stack"]["groups"])
    assert [_shapes(b) for b in tp["blocks"]] == [jb[f"b{j}"]
                                                  for j in range(8)]
    m = tp["blocks"][0]["mamba"]
    for key in ("dt_bias", "A_log", "D_skip"):
        assert m[key].dtype == torch.float32
    assert m["in_proj"].dtype == torch.bfloat16
    assert tp["blocks"][1]["moe"]["router"].dtype == torch.float32
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    np.testing.assert_allclose(_np(-torch.exp(m["A_log"][0])),
                               -np.arange(1, 9, dtype=np.float32))


def test_layer_plan_and_bridge_keep_fp32_leaves():
    """jamba groups as one unit of eight mixed (kind, mlp) pairs and no
    prefix: 4 groups at 32 layers, 2 at the 16 the card runs, 1 in SMOKE,
    as the reference does. A bf16 bridge of two groups keeps the fp32
    leaves fp32 and unstacks them in layer order."""
    full = CONFIGS[ARCH]
    for n, groups in ((32, 4), (16, 2), (8, 1)):
        cfg = full.scaled(n_layers=n)
        plan = tf.plan_layers(cfg)
        assert plan == jtf.plan_layers(J_CONFIGS[ARCH].scaled(n_layers=n))
        assert plan[0] == [] and len(plan[1]) == 8 and plan[2] == groups
    assert tf.plan_layers(SMOKE_CONFIGS[ARCH])[2] == 1
    jcfg, jp, tcfg, tp = _bridge(ARCH, "bfloat16", n_layers=16)
    assert len(tp["blocks"]) == 16
    g = jp["stack"]["groups"]
    for i, blk in enumerate(tp["blocks"]):
        src = g[f"b{i % 8}"]
        if "mamba" in blk:
            for key in ("dt_bias", "A_log", "D_skip"):
                assert blk["mamba"][key].dtype == torch.float32
                np.testing.assert_array_equal(
                    _np(blk["mamba"][key]),
                    np.asarray(src["mamba"][key][i // 8]))
            assert blk["mamba"]["x_proj"].dtype == torch.bfloat16
        if "moe" in blk:
            assert blk["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# (e) the engine against the JAX engine on the dense backend; (f) qwen3-8b
# on dense; (g) no host read in a jamba decode span
# ---------------------------------------------------------------------------

MAX_NEW = 12
MARGIN = 1e-3
# request seed -> prompt length; each keeps a reference top-1/top-2
# margin >= 1e-3 over its MAX_NEW greedy tokens
SEEDS = {0: 30, 2: 22, 3: 25, 5: 18, 7: 14}
# 10 pages of 8 tokens hold two worst-case footprints, not three: the
# third admission parks a running slot
SETTINGS = {"span1": dict(n_pages=64, decode_span=1),
            "span8": dict(n_pages=64, decode_span=8),
            "park1": dict(n_pages=10, decode_span=1),
            "park8": dict(n_pages=10, decode_span=8)}
# qwen3-8b: the request seeds and prompts of tests/test_torch_serving.py
QWEN_SEEDS = {0: 13, 1: 31, 2: 23, 3: 15, 8: 17}


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
    return eng.stats, [(r.req_id, r.tokens_out) for r in done]


def _common(setting):
    return dict(slots=3, cache_len=L, page_size=PS, eos_token=-1,
                kv_layout="dense", scheduler="fcfs", sampler="greedy",
                prefill_chunk=0, prefix_cache_entries=0, **SETTINGS[setting])


def _prompts(seeds):
    return [_prompt(n, s) for s, n in seeds.items()]


@pytest.fixture(scope="module")
def reference(fp32):
    """The model-level greedy streams and margins, and the JAX engine's
    stats and streams for every setting, computed once for the module."""
    jcfg, jp, tcfg, tp = fp32
    prompts = _prompts(SEEDS)
    runs = {name: _engine_run(lambda c, n=name: JEngine(
                jcfg, jp, japi.EngineConfig(clock=c, **_common(n))),
                japi.Request, prompts)
            for name in SETTINGS}
    return _greedy(tcfg, tp, prompts), runs


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_engine_streams_match_reference(fp32, reference, setting):
    """Same streams, completion order and counters as the JAX engine on
    the dense backend, at span 1 and 8, with room for everyone and under
    page pressure (the dense backend parks and unparks a slot's rows)."""
    _, _, tcfg, tp = fp32
    greedy, runs = reference
    for toks, margin in greedy:
        assert margin >= MARGIN, margin
    ref_stats, ref_streams = runs[setting]
    stats, streams = _engine_run(lambda c: ServingEngine(
        tcfg, tp, api.EngineConfig(clock=c, **_common(setting)),
        device="cpu"), api.Request, _prompts(SEEDS))
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


@pytest.mark.parametrize("span", [1, 8])
def test_qwen_dense_streams_match_reference(span):
    """SMOKE qwen3-8b on the dense backend (attention slabs, no Mamba):
    streams, completion order and counters equal the JAX engine's on
    dense, and every stream is the model-level greedy one."""
    jcfg, jp, tcfg, tp = _bridge("qwen3-8b", "float32")
    prompts = _prompts(QWEN_SEEDS)
    common = dict(slots=3, cache_len=L, page_size=PS, eos_token=-1,
                  kv_layout="dense", n_pages=64, decode_span=span)
    ref_stats, ref_streams = _engine_run(lambda c: JEngine(
        jcfg, jp, japi.EngineConfig(clock=c, **common)), japi.Request,
        prompts)
    stats, streams = _engine_run(lambda c: ServingEngine(
        tcfg, tp, api.EngineConfig(clock=c, **common), device="cpu"),
        api.Request, prompts)
    assert streams == ref_streams
    if span == 1:
        for (toks, margin), (_, got) in zip(_greedy(tcfg, tp, prompts),
                                            streams):
            assert margin >= MARGIN and got == toks
    for key in ("decode_steps", "decode_spans", "prefills", "pages_peak"):
        assert stats[key] == ref_stats[key], key


def test_dense_decode_span_reads_nothing_back(fp32):
    """A pure decode span through jamba's Mamba, attention and MoE layers
    on the dense backend makes no scalar device read: the only transfer
    is the accounted ``_host_sync``."""
    from torch.profiler import ProfilerActivity, profile
    _, _, tcfg, tp = fp32
    eng = ServingEngine(tcfg, tp, api.EngineConfig(
        slots=3, cache_len=L, page_size=PS, n_pages=24, eos_token=-1,
        kv_layout="dense"), device="cpu")
    for i, s in enumerate([0, 3, 5]):
        eng.submit(api.Request(i, _prompt(SEEDS[s], s), max_new_tokens=40))
    eng.step()                                   # admit + prefill + span
    before = dict(eng.stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    assert eng.stats["prefills"] == before["prefills"]
    assert eng.stats["decode_spans"] == before["decode_spans"] + 1
    assert eng.stats["host_syncs"] == before["host_syncs"] + 1
    keys = {e.key for e in prof.events()}
    assert "aten::index_put_" in keys          # the slab writes ran
    reads = [k for k in keys
             if k in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


def test_dense_backend_capabilities(fp32):
    _, _, tcfg, tp = fp32
    eng = ServingEngine(tcfg, tp, api.EngineConfig(
        kv_layout="dense", cache_len=L, page_size=PS, n_pages=16),
        device="cpu")
    kv = eng.kv
    assert (kv.needs_growth, kv.supports_chunked_prefill,
            kv.supports_prefix_share) == (False, False, False)
    assert kv.footprint(api.Request(0, _prompt(20, 0),
                                    max_new_tokens=12)) == 32
    assert kv.footprint(api.Request(1, _prompt(20, 0),
                                    max_new_tokens=500)) == L
    attn = eng.state["caches"][tcfg.layer_kinds().index("attn")]
    assert attn["k"].shape == (4, L, tcfg.n_kv_heads, tcfg.head_dim)
    ssm = eng.state["caches"][0]
    assert ssm["ssm"].dtype == torch.float32
    assert ssm["conv"].shape == (4, 3, 2 * tcfg.d_model)
    assert api.EngineConfig().kv_layout == "dense"
    with pytest.raises(ValueError, match="per-token cache blocks"):
        ServingEngine(tcfg, tp, api.EngineConfig(kv_layout="paged"),
                      device="cpu")
    with pytest.raises(ValueError, match="constant-size recurrence"):
        ServingEngine(tcfg, tp, api.EngineConfig(kv_layout="recurrent"),
                      device="cpu")
