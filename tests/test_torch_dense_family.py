"""The rest of the dense family in the port against the JAX package:
qwen1.5-4b (QKV biases), nemotron-4-15b (squared ReLU), h2o-danube-3-4b
(a sliding window over ring slabs), chameleon-34b (qk-norm over a token
stream) and musicgen-large (GELU, MHA at head dim 32 in SMOKE).

Weights are bridged from ``repro.models.lm.init_params`` (fp32) by
``repro_torch.models.convert.params_from_numpy``; the port runs on the
CPU (plain kernel versions). Tolerances: the activations bit for bit in
bf16, in fp32 squared ReLU exact and GELU within 1e-6 (relative, and
absolute near 0: torch's and XLA's ``tanh`` differ by an ulp); logits
and ring slabs in fp32 1e-4; greedy streams equal on requests whose
top-1/top-2 margin is at least 1e-3 at every step.

The reference's dense backend cannot take a sliding-window prompt
shorter than the window when ``cache_len`` exceeds it (its prefill pads
K/V to ``cache_len``, its slab holds ``min(W, cache_len)`` rows: ROADMAP
C3). The port pads such a prompt to the slab; its streams are held to the
reference engine where that serves (prompts >= W) and to a per-request
greedy loop of the reference's ``lm.prefill(cache_len=W)`` and
``decode_step`` everywhere.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS as J_CONFIGS  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.registry import (ARCH_NAMES, CONFIGS,  # noqa: E402
                                          SMOKE_CONFIGS)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import activation  # noqa: E402
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

NEW_ARCHS = ("qwen1.5-4b", "nemotron-4-15b", "h2o-danube-3-4b",
             "chameleon-34b", "musicgen-large")
SWA = "h2o-danube-3-4b"
TOL = 1e-4
MARGIN = 1e-3
W = SMOKE_CONFIGS[SWA].swa_window            # 64
CACHE_LEN = 160                              # > W: the reference's fault
PS = 8


def _np(t):
    return t.detach().float().numpy()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _prompt(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(
        np.int32)


def _bridge(arch, bias_seed=1):
    """fp32 SMOKE weights from the JAX ``init_params``, as one numpy tree
    that both sides take; QKV biases (zero at init) drawn non-zero, so
    the bias path computes something."""
    jcfg = J_SMOKE[arch].scaled(dtype="float32")
    tcfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(bias_seed)
        attn = tree["stack"]["groups"]["b0"]["attn"]
        for key in ("bq", "bk", "bv"):
            attn[key] = (0.5 * rng.standard_normal(attn[key].shape)).astype(
                np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _jdecode(jcfg):
    """The reference's ``decode_step`` under ``jax.jit`` (eager, each step
    dispatches op by op)."""
    return jax.jit(lambda p, t, s: jlm.decode_step(p, t, s, jcfg,
                                                   NULL_POLICY))


@pytest.fixture(scope="module")
def models():
    """``models(arch)``: the bridged SMOKE model and the reference's
    jitted decode step, made once a module."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = _bridge(arch) + (_jdecode(J_SMOKE[arch].scaled(
                dtype="float32")),)
        return made[arch]
    return get


# ---------------------------------------------------------------------------
# configs, the registry, the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_are_the_reference_configs(arch):
    for port, ref in ((CONFIGS[arch], J_CONFIGS[arch]),
                      (SMOKE_CONFIGS[arch], J_SMOKE[arch])):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_registry_lists_every_config_but_mla():
    """All ten archs in the reference's order, deepseek-v2-lite-16b (MLA)
    now among them, each config field for field the reference's, and
    each SMOKE config's params made on the CPU."""
    assert ARCH_NAMES == tuple(J_CONFIGS)
    assert "deepseek-v2-lite-16b" in ARCH_NAMES
    for name, cfg in J_CONFIGS.items():
        assert dataclasses.asdict(CONFIGS[name]) == dataclasses.asdict(cfg)
        params = lm.init_params(SMOKE_CONFIGS[name],
                                torch.Generator().manual_seed(0),
                                device="cpu")
        assert len(params["blocks"]) == SMOKE_CONFIGS[name].n_layers


# ---------------------------------------------------------------------------
# activations and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["gelu", "sq_relu"])
def test_activations_round_as_jax(name, dtype):
    """bf16 bit for bit; fp32 squared ReLU exact and GELU within 1e-6."""
    from repro.models.layers import activation as jactivation
    x = (np.random.default_rng(0).standard_normal(200_000) * 4).astype(
        np.float32)
    x[:4] = (0.0, -0.0, 30.0, -30.0)
    want = np.asarray(jactivation(name)(jnp.asarray(x, dtype)).astype(
        jnp.float32))
    got = _np(activation(name)(torch.from_numpy(x).to(getattr(torch,
                                                               dtype))))
    if dtype == "bfloat16" or name == "sq_relu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_shapes_match_reference(arch):
    """Every block's leaves, shapes and dtypes as the JAX ``init_params``
    makes them: the MLP holds w_gate for SwiGLU only, the attention its
    biases where the config has them."""
    jp = jlm.init_params(J_SMOKE[arch], jax.random.PRNGKey(0))
    tp = lm.init_params(SMOKE_CONFIGS[arch],
                        torch.Generator().manual_seed(0), device="cpu")
    jb = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                      jp["stack"]["groups"]["b0"])
    assert all(_shapes(b) == jb for b in tp["blocks"])
    assert ("w_gate" in tp["blocks"][0]["mlp"]) == (
        SMOKE_CONFIGS[arch].act == "swiglu")


# ---------------------------------------------------------------------------
# the model: prefill and decode logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_logits(models, arch):
    """Two 37-token prompts, then 6 greedy decode steps from the dense
    slabs (a ring for danube), fp32 1e-4 at every step."""
    jcfg, jp, tcfg, tp, jdec = models(arch)
    toks = np.stack([_prompt(37, 1, tcfg.vocab_size),
                     _prompt(37, 2, tcfg.vocab_size)])
    jl, jst = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                          cache_len=96)
    tl, tst = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=96)
    _close(tl, jl)
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jst = jdec(jp, jnp.asarray(nxt), jst)
        tl, tst = lm.decode_step(tp, torch.from_numpy(nxt), tst, tcfg)
        _close(tl, jl)


# ---------------------------------------------------------------------------
# h2o-danube: ring slabs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,steps", [(40, 30), (150, 8)])
def test_ring_slabs_and_decode_across_the_wrap(models, n, steps):
    """The port's slabs equal the reference's ``prefill(cache_len=W)``
    rings: the prompt zero-padded to W rows below the window, the last W
    rows rolled by n % W above it. With ``cache_len`` past the window
    the port's slab is the same W rows (the reference's own prefill pads
    to ``cache_len`` there). Decode then runs across the ring's wrap
    (slot t % W) within 1e-4 of the reference."""
    jcfg, jp, tcfg, tp, jdec = models(SWA)
    toks = _prompt(n, 3, tcfg.vocab_size)[None]
    jl, jst = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                          cache_len=W)
    tl, tst = lm.prefill(tp, torch.from_numpy(toks), tcfg,
                         cache_len=CACHE_LEN)
    _close(tl, jl)
    groups = jst["caches"]["groups"]["b0"]
    for i, layer in enumerate(tst["caches"]):
        for key in ("k", "v"):
            assert layer[key].shape == (1, W, tcfg.n_kv_heads,
                                        tcfg.head_dim)
            _close(layer[key], groups[key][i])
            if n < W:
                assert not layer[key][0, n:].any()
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jst = jdec(jp, jnp.asarray(nxt), jst)
        tl, tst = lm.decode_step(tp, torch.from_numpy(nxt), tst, tcfg)
        _close(tl, jl)
    assert n + steps > W
    groups = jst["caches"]["groups"]["b0"]
    for i, layer in enumerate(tst["caches"]):
        _close(layer["k"], groups["k"][i])


# ---------------------------------------------------------------------------
# the engine on dense (danube) and paged (nemotron)
# ---------------------------------------------------------------------------

MAX_NEW = 24
# request seed -> prompt length: three below the window (two of them
# decode across the wrap), one at it, two past it
DANUBE_SEEDS = {0: 20, 1: 45, 2: 60, 3: 64, 4: 70, 5: 100}
NEMOTRON_SEEDS = {0: 13, 1: 31, 2: 23, 3: 15, 4: 40}


class StepClock:
    """A clock the test advances once per engine step."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


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
    for i, p in prompts.items():
        eng.submit(req_cls(i, p.copy(), max_new_tokens=MAX_NEW))
    done = _drive(eng, clock)
    return eng.stats, {r.req_id: list(r.tokens_out) for r in done}


def _reference_greedy(jcfg, jp, jdec, prompt, cache_len):
    """The reference model's greedy stream of one prompt (batch 1) and
    its smallest top-1/top-2 margin."""
    lg, st = jlm.prefill(jp, jnp.asarray(prompt[None]), jcfg, NULL_POLICY,
                         cache_len=cache_len)
    toks, margin = [], np.inf
    for i in range(MAX_NEW):
        top = np.sort(np.asarray(lg[0]))[-2:]
        margin = min(margin, float(top[1] - top[0]))
        toks.append(int(jnp.argmax(lg[0])))
        if i < MAX_NEW - 1:
            lg, st = jdec(jp, jnp.asarray([toks[-1]], jnp.int32), st)
    return toks, margin


ENGINE_SETTINGS = {"span1": dict(n_pages=80, decode_span=1),
                   "span8": dict(n_pages=80, decode_span=8),
                   "park8": dict(n_pages=28, decode_span=8),
                   "chunked": dict(n_pages=80, decode_span=8,
                                   prefill_chunk=16,
                                   prefix_cache_entries=32)}


def _danube_common(setting):
    common = dict(slots=3, cache_len=CACHE_LEN, page_size=PS, eos_token=-1,
                  kv_layout="dense", scheduler="fcfs", sampler="greedy",
                  prefill_chunk=0, prefix_cache_entries=0)
    common.update(ENGINE_SETTINGS[setting])
    return common


@pytest.fixture(scope="module")
def danube_reference(models):
    """The reference's greedy loop for every prompt (its prefill at
    ``cache_len=W``, which the ring then serves) and its engine's
    streams and stats for the prompts it can serve (>= W), per setting."""
    jcfg, jp, _, _, jdec = models(SWA)
    prompts = {s: _prompt(n, s) for s, n in DANUBE_SEEDS.items()}
    greedy = {s: _reference_greedy(jcfg, jp, jdec, p, W)
              for s, p in prompts.items()}
    long = {s: p for s, p in prompts.items() if len(p) >= W}
    runs = {name: _engine_run(lambda c, n=name: JEngine(
                jcfg, jp, japi.EngineConfig(clock=c, **_danube_common(n))),
                japi.Request, long)
            for name in ENGINE_SETTINGS}
    return prompts, greedy, runs


@pytest.mark.parametrize("setting", sorted(ENGINE_SETTINGS))
def test_danube_engine_on_dense_across_the_window(models, danube_reference,
                                                  setting):
    """SMOKE danube (W 64) on the dense backend at cache_len 160, prompts
    shorter and longer than the window in one batch: every stream is the
    reference's greedy loop, and the prompts >= W give the reference
    engine's streams too; at span 1 and 8, under page pressure that
    parks and unparks ring slabs, and with chunked prefill and the prefix
    cache asked for, which the backend declines (the engine prefills
    monolithically, as the reference's does)."""
    _, _, tcfg, tp, _ = models(SWA)
    prompts, greedy, runs = danube_reference
    for toks, margin in greedy.values():
        assert margin >= MARGIN, margin
    stats, streams = _engine_run(lambda c: ServingEngine(
        tcfg, tp, api.EngineConfig(clock=c, **_danube_common(setting)),
        device="cpu"), api.Request, prompts)
    assert streams == {s: toks for s, (toks, _) in greedy.items()}
    ref_stats, ref_streams = runs[setting]
    assert ref_streams == {s: streams[s] for s in ref_streams}
    assert ref_stats["prefill_chunks"] == stats["prefill_chunks"] == 0
    assert stats["prefix_hits"] == 0
    assert stats["prefills"] == len(prompts)
    assert stats["host_syncs"] == stats["prefills"] + stats["decode_spans"]
    if setting == "park8":
        assert stats["parked"] > 0 and stats["unparked"] == stats["parked"]
    kv = ServingEngine(tcfg, tp, api.EngineConfig(
        **_danube_common(setting)), device="cpu").kv
    assert (kv.supports_chunked_prefill, kv.supports_prefix_share) == (
        False, False)


@pytest.mark.parametrize("span", [1, 8])
def test_nemotron_paged_streams_match_reference(models, span):
    """SMOKE nemotron (squared ReLU, GQA 4:1) on the paged backend:
    streams and counters equal the JAX engine's, with a page budget that
    parks."""
    jcfg, jp, tcfg, tp, jdec = models("nemotron-4-15b")
    prompts = {s: _prompt(n, s) for s, n in NEMOTRON_SEEDS.items()}
    for s, p in prompts.items():
        assert _reference_greedy(jcfg, jp, jdec, p, 64)[1] >= MARGIN
    common = dict(slots=3, cache_len=64, page_size=PS, eos_token=-1,
                  kv_layout="paged", n_pages=14, decode_span=span,
                  prefix_cache_entries=0)
    ref_stats, ref_streams = _engine_run(lambda c: JEngine(
        jcfg, jp, japi.EngineConfig(clock=c, **common)), japi.Request,
        prompts)
    stats, streams = _engine_run(lambda c: ServingEngine(
        tcfg, tp, api.EngineConfig(clock=c, **common), device="cpu"),
        api.Request, prompts)
    assert streams == ref_streams
    for key in ("parked", "unparked", "decode_steps", "decode_spans",
                "prefills", "pages_peak"):
        assert stats[key] == ref_stats[key], key
    assert stats["parked"] > 0
    assert stats["host_syncs"] == stats["prefills"] + stats["decode_spans"]


def test_danube_paged_and_chunks_refused_like_reference(models):
    """The paged layout and ``prefill_chunk`` refuse a sliding-window
    stack with the reference's messages."""
    jcfg, jp, tcfg, tp, jdec = models(SWA)
    with pytest.raises(ValueError) as ref:
        JEngine(jcfg, jp, japi.EngineConfig(kv_layout="paged"))
    with pytest.raises(ValueError) as port:
        ServingEngine(tcfg, tp, api.EngineConfig(kv_layout="paged"),
                      device="cpu")
    assert str(port.value) == str(ref.value)
    assert "SWA ring" in str(port.value)
    tok = np.ones((1, 8), np.int32)
    with pytest.raises(ValueError) as ref:
        jlm.prefill_chunk(None, jnp.asarray(tok), None, 0, 8, jcfg,
                          NULL_POLICY)
    with pytest.raises(ValueError) as port:
        lm.prefill_chunk(None, torch.from_numpy(tok), None, 0, 8, tcfg)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layout", [("h2o-danube-3-4b", "dense"),
                                         ("nemotron-4-15b", "paged"),
                                         ("musicgen-large", "paged")])
def test_launcher_serves_smoke_archs_on_cpu(arch, layout):
    """``python -m repro_torch.launch.serve --arch <a> --kv-layout <l>
    --smoke --device cpu``: every request completes (danube's decode runs
    past its 64-row ring)."""
    out = io.StringIO()
    with redirect_stdout(out):
        launcher.main(["--arch", arch, "--kv-layout", layout, "--smoke",
                       "--device", "cpu", "--requests", "4",
                       "--max-new", "40"])
    assert "completed 4/4" in out.getvalue()
