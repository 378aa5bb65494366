"""The port's MoE path against the JAX package: kernel B7's plain
version, the MoE layer, the SMOKE moonshot-v1-16b-a3b model and the
serving engine on the ``paged`` backend.

Every input is made with numpy from a seed, and the JAX weights are
carried across by ``repro_torch.models.convert.params_from_numpy``. The
port runs on the CPU, where the B7 wrapper takes its plain version; the
kernel itself is held against that on the card (tests/test_torch_cuda.py,
``python3 chip_smoke.py``). Tolerances: dispatch exact (as
tests/test_kernels.py); the MoE layer and its stats in fp32 1e-5; model
logits in fp32 1e-4 and in bf16 as tests/test_torch_model.py; greedy
streams equal on requests whose reference top-1/top-2 margin is at least
1e-3. Routing is a discontinuity: where the two frameworks' fp32 routers
pick different top-k sets the layer tests report the token and the gap
between the k-th and (k+1)-th probability.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS as J_CONFIGS  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.registry import CONFIGS, SMOKE_CONFIGS  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
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

ARCH = "moonshot-v1-16b-a3b"
TOL = 1e-4
MOE_TOL = 1e-5
L, PS = 64, 8           # cache_len, page size


def _np(t):
    return t.detach().float().numpy()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _bridge(dtype_name, **overrides):
    jcfg = J_SMOKE[ARCH].scaled(dtype=dtype_name, **overrides)
    tcfg = SMOKE_CONFIGS[ARCH].scaled(dtype=dtype_name, **overrides)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0),
                         dtype=jnp.dtype(dtype_name))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=getattr(torch, dtype_name))
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def fp32():
    return _bridge("float32")


# ---------------------------------------------------------------------------
# (a) B7: the plain dispatch against the oracle and the Pallas kernel
# ---------------------------------------------------------------------------

def _dispatch_inputs(T, D, E, seed):
    """Token rows, expert ids and their queue positions (a cumsum of
    one-hots, as the router's dispatch computes them)."""
    rng = np.random.default_rng(seed)
    toks = rng.standard_normal((T, D)).astype(np.float32)
    eids = rng.integers(0, E, size=T).astype(np.int32)
    pos = np.zeros(T, np.int32)
    for e in range(E):
        at = np.nonzero(eids == e)[0]
        pos[at] = np.arange(len(at))
    return toks, eids, pos


@pytest.mark.parametrize("T,D,E,C", [(64, 32, 8, 12), (100, 16, 4, 40),
                                     (32, 8, 2, 4), (128, 64, 16, 8),
                                     (48, 7, 3, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_plain_equals_ref_and_pallas(T, D, E, C, dtype):
    """The sweep of tests/test_kernels.py, and a case with D = 7 (rows of
    an odd width) where most rows overflow their queues."""
    toks, eids, pos = _dispatch_inputs(T, D, E, seed=T + E)
    jdt = jnp.dtype(dtype)
    j_toks = jnp.asarray(toks).astype(jdt)
    t_toks = torch.from_numpy(toks).to(getattr(torch, dtype))
    out = md.moe_dispatch(t_toks, torch.from_numpy(eids),
                          torch.from_numpy(pos), E, C)
    assert out.shape == (E, C, D) and out.dtype == t_toks.dtype
    want = np.asarray(ref.moe_dispatch_ref(j_toks, jnp.asarray(eids),
                                           jnp.asarray(pos), E, C),
                      np.float32)
    pallas = np.asarray(ops.moe_dispatch(j_toks, jnp.asarray(eids),
                                         jnp.asarray(pos), E, C,
                                         interpret=True), np.float32)
    np.testing.assert_array_equal(_np(out), want)
    np.testing.assert_array_equal(pallas, want)
    if (T, D) == (48, 7):
        assert (pos >= C).sum() > T // 2


def _sparse_dispatch_inputs(T, D, E, C, seed):
    """Rows with ids over E + 2 values (the last two out of range), each
    expert's rows at distinct positions drawn from [0, max(2 C, rows)):
    not dense from 0, in no order, some past C."""
    rng = np.random.default_rng(seed)
    toks = rng.standard_normal((T, D)).astype(np.float32)
    eids = rng.integers(0, E + 2, size=T).astype(np.int32)
    pos = np.zeros(T, np.int32)
    for e in range(E + 2):
        at = np.nonzero(eids == e)[0]
        pos[at] = rng.permutation(max(2 * C, len(at)))[:len(at)]
    return toks, eids, pos


@pytest.mark.parametrize("T,D,E,C,tile", [
    (64, 32, 8, 12, 32), (100, 16, 4, 40, 32), (48, 7, 3, 5, 32),
    (64, 8, 4, 100, 32), (200, 8, 3, 70, 8), (0, 8, 3, 5, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_tiles_plain_equals_plain_and_ref(T, D, E, C, tile, dtype):
    """B7's gather by slot tiles is exactly the scatter: on permuted,
    non-dense positions, rows past C, ids out of range, tiles that no
    row fills (C 100 for 64 rows; tiles of 8 at C 70) and T = 0, against
    the plain version the wrapper takes on the CPU and the JAX oracle."""
    toks, eids, pos = _sparse_dispatch_inputs(T, D, E, C, seed=T + C)
    t_toks = torch.from_numpy(toks).to(getattr(torch, dtype))
    t_ids, t_pos = torch.from_numpy(eids), torch.from_numpy(pos)
    out = md.moe_dispatch_tiles_plain(t_toks, t_ids, t_pos, E, C,
                                      tile_slots=tile)
    assert out.shape == (E, C, D) and out.dtype == t_toks.dtype
    assert torch.equal(out, md.moe_dispatch(t_toks, t_ids, t_pos, E, C))
    want = ref.moe_dispatch_ref(jnp.asarray(toks).astype(jnp.dtype(dtype)),
                                jnp.asarray(eids), jnp.asarray(pos), E, C)
    np.testing.assert_array_equal(_np(out), np.asarray(want, np.float32))
    if T:
        kept = (eids < E) & (pos < C)
        assert 0 < kept.sum() < T
        assert int((out != 0).any(-1).sum()) == kept.sum()


def test_dispatch_refuses_bad_inputs():
    toks = torch.zeros(4, 8)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        md.moe_dispatch(toks.half(), ids, ids, 2, 4)
    with pytest.raises(TypeError):
        md.moe_dispatch(toks, ids.long(), ids, 2, 4)
    with pytest.raises(ValueError):
        md.moe_dispatch(toks, ids[:3], ids[:3], 2, 4)
    with pytest.raises(ValueError):
        md.moe_dispatch(toks, ids, ids, 2, 0)


# ---------------------------------------------------------------------------
# (b) the MoE layer against _moe_mlp_local
# ---------------------------------------------------------------------------

def _routing_flips(x, router, K):
    """Tokens whose top-K expert set differs between the two frameworks'
    fp32 routers, each with the gap between its K-th and (K+1)-th
    probability (the reference's)."""
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, j_top = jax.lax.top_k(jprobs, K)
    _, _, t_top = moe.route(torch.from_numpy(x),
                           torch.from_numpy(np.array(router)), K)
    j_set = np.sort(np.asarray(j_top), -1)
    t_set = np.sort(t_top.numpy(), -1)
    srt = -np.sort(-np.asarray(jprobs), -1)
    return [(idx, float(srt[idx][K - 1] - srt[idx][K]))
            for idx in zip(*np.nonzero((j_set != t_set).any(-1)))]


@pytest.mark.parametrize("G,S,cf", [(2, 40, None), (3, 64, None),
                                    (1, 5, 2.0), (1, 3, 2.0)])
def test_moe_mlp_matches_reference(fp32, G, S, cf):
    """Prefill groups (one per sequence, the config's capacity factor
    1.25, tokens dropped) and one decode group at capacity factor 2.0:
    output and both stats at 1e-5, after the same routing."""
    jcfg, jp, tcfg, tp = fp32
    jm = jax.tree.map(lambda a: a[0], jp["stack"]["groups"]["b1"]["moe"])
    tm = tp["blocks"][1]["moe"]
    x = np.random.default_rng(G * S).standard_normal(
        (G, S, tcfg.d_model)).astype(np.float32)
    flips = _routing_flips(x, np.asarray(jm["router"]), tcfg.moe.top_k)
    assert not flips, f"top-k sets differ (token, k-th gap): {flips}"
    jo, js = jmoe._moe_mlp_local(jnp.asarray(x), jm, jcfg, None, cf)
    to, ts = moe.moe_mlp(torch.from_numpy(x), tm, tcfg, cf)
    _close(to, jo, MOE_TOL)
    for key in ("moe_aux", "moe_dropped"):
        assert ts[key].shape == () and ts[key].dtype == torch.float32
        _close(ts[key], js[key], MOE_TOL)
    if cf is None:
        assert float(ts["moe_dropped"]) > 0      # queues overflowed
    else:
        assert float(ts["moe_dropped"]) == 0.0


def test_capacity_matches_reference():
    cfg, jcfg = CONFIGS[ARCH], J_CONFIGS[ARCH]
    for S, cf in ((1900, None), (4, 2.0), (1, 2.0), (333, None)):
        assert moe.capacity(S, cfg, cf) == jmoe._capacity(S, jcfg, cf)
    assert moe.capacity(1900, cfg) == 223
    assert moe.capacity(4, cfg, 2.0) == 4


# ---------------------------------------------------------------------------
# (c) the model: prefill and paged decode logits
# ---------------------------------------------------------------------------

def _prompt(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(
        np.int32)


def test_prefill_logits_and_caches(fp32):
    jcfg, jp, tcfg, tp = fp32
    toks = np.stack([_prompt(37, 1), _prompt(37, 2)])
    jl, jst = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                          cache_len=L)
    tl, tst = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    _close(tl, jl)
    groups = jst["caches"]["groups"]
    for i, layer in enumerate(tst["caches"]):
        _close(layer["k"], groups[f"b{i}"]["k"][0])
        _close(layer["v"], groups[f"b{i}"]["v"][0])


def _paged_states(jcfg, jp, tcfg, tp, prompts, tables, max_pages,
                  n_pages=24):
    """Both frameworks' paged states, each prompt's prefill pages
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


def test_paged_decode_step_logits(fp32):
    """Three decode steps of three slots, one of them parked in the
    second: the batch is one MoE group at capacity factor 2.0."""
    jcfg, jp, tcfg, tp = fp32
    prompts = [_prompt(11, 3), _prompt(17, 4), _prompt(6, 5)]
    js, ts = _paged_states(jcfg, jp, tcfg, tp, prompts,
                           tables=[[5, 2], [7, 1, 9], [3]], max_pages=4)
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
        toks = np.array(jnp.argmax(jl, axis=-1), np.int32)


def test_prefill_bf16_logits():
    """bf16 prefill against the JAX model in bf16 at 2e-2 of the logit
    scale, and the port's bf16 error against the fp32 math at most twice
    the reference's own (tests/test_torch_model.py says why)."""
    jcfg, jp, tcfg, tp = _bridge("bfloat16")
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
# (f) params: init and the weight bridge
# ---------------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_init_params_shapes_and_dtypes_match_reference():
    """SMOKE (bf16): layer 0 dense, layer 1 MoE with an fp32 router."""
    jp = jlm.init_params(J_SMOKE[ARCH], jax.random.PRNGKey(0))
    tp = lm.init_params(SMOKE_CONFIGS[ARCH], torch.Generator().manual_seed(0),
                        device="cpu")
    jb = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                      jp["stack"]["groups"])
    assert [_shapes(b) for b in tp["blocks"]] == [jb["b0"], jb["b1"]]
    assert tp["blocks"][1]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"][1]["moe"]["w_gate"].dtype == torch.bfloat16
    assert set(tp) == {"embed", "blocks", "final_norm", "head"}


def test_layer_plan_and_bridge_of_prefix_and_groups():
    """The full config groups as the reference does: one dense prefix
    block and 47 MoE groups. A 5-layer bf16 cut of the same shape (prefix
    1, 4 groups) unstacks into layer order, the fp32 router kept fp32."""
    plan = tf.plan_layers(CONFIGS[ARCH])
    assert plan == jtf.plan_layers(J_CONFIGS[ARCH])
    assert plan == ([("attn", "dense")], [("attn", "moe")], 47)
    jcfg, jp, tcfg, tp = _bridge("bfloat16", n_layers=5)
    assert tf.plan_layers(tcfg) == ([("attn", "dense")], [("attn", "moe")],
                                    4)
    assert "mlp" in tp["blocks"][0] and "moe" not in tp["blocks"][0]
    np.testing.assert_array_equal(
        _np(tp["blocks"][0]["mlp"]["w_up"]),
        np.asarray(jp["stack"]["prefix"][0]["mlp"]["w_up"], np.float32))
    g = jp["stack"]["groups"]["b0"]["moe"]
    for i, blk in enumerate(tp["blocks"][1:]):
        assert blk["moe"]["router"].dtype == torch.float32
        assert blk["moe"]["w_down"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(blk["moe"]["router"]),
                                      np.asarray(g["router"][i]))
        np.testing.assert_array_equal(
            _np(blk["moe"]["shared"]["w_gate"]),
            np.asarray(g["shared"]["w_gate"][i], np.float32))


# ---------------------------------------------------------------------------
# (d) the engine against the JAX engine; (e) no host read in a span
# ---------------------------------------------------------------------------

MAX_NEW = 12
# request seed -> prompt length; each keeps a reference top-1/top-2
# margin >= 1e-3 over its MAX_NEW greedy tokens
SEEDS = {0: 15, 1: 33, 2: 25, 3: 17, 4: 28, 5: 21}
MARGIN = 1e-3
ENGINE_SEEDS = [0, 1, 2, 3, 4]
SETTINGS = {"span1": dict(n_pages=64, decode_span=1),
            "span8": dict(n_pages=64, decode_span=8),
            "park1": dict(n_pages=9, decode_span=1),
            "park8": dict(n_pages=9, decode_span=8)}


class StepClock:
    """A clock the driver advances once per engine step."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _req_prompt(seed):
    return _prompt(SEEDS[seed], seed)


@pytest.fixture(scope="module")
def reference_greedy(fp32):
    """Model-level greedy stream and smallest top-1/top-2 margin of each
    request, from the JAX model (batch 1)."""
    jcfg, jp, _, _ = fp32
    step = jax.jit(lambda p, t, s: jlm.decode_step(p, t, s, jcfg,
                                                   NULL_POLICY))
    out = {}
    for seed in SEEDS:
        lg, st = jlm.prefill(jp, jnp.asarray(_req_prompt(seed)[None]), jcfg,
                             NULL_POLICY, cache_len=L)
        toks, margin = [], np.inf
        for i in range(MAX_NEW):
            top = np.sort(np.asarray(lg[0]))[-2:]
            margin = min(margin, float(top[1] - top[0]))
            toks.append(int(jnp.argmax(lg[0])))
            if i < MAX_NEW - 1:
                lg, st = step(jp, jnp.asarray([toks[-1]], jnp.int32), st)
        out[seed] = (toks, margin)
    return out


def _drive(eng, clock, max_steps=500):
    for _ in range(max_steps):
        if not (eng.active.any() or eng.sched.pending
                or eng.transport.in_flight):
            return eng.completed
        clock.t += 1.0
        eng.step()
    raise AssertionError("engine did not drain")


def _engine_run(make, req_cls):
    clock = StepClock()
    eng = make(clock)
    for i, s in enumerate(ENGINE_SEEDS):
        eng.submit(req_cls(i, _req_prompt(s), max_new_tokens=MAX_NEW))
    done = _drive(eng, clock)
    return eng.stats, [(r.req_id, r.tokens_out) for r in done]


def _common(setting):
    return dict(slots=3, cache_len=L, page_size=PS, eos_token=-1,
                kv_layout="paged", scheduler="fcfs", sampler="greedy",
                prefill_chunk=0, prefix_cache_entries=0, **SETTINGS[setting])


@pytest.fixture(scope="module")
def reference_runs(fp32):
    """The JAX engine's stats and streams for every setting, computed
    once for the module."""
    jcfg, jp, _, _ = fp32
    return {name: _engine_run(lambda c, n=name: JEngine(
                jcfg, jp, japi.EngineConfig(clock=c, **_common(n))),
                japi.Request)
            for name in SETTINGS}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_engine_streams_match_reference(fp32, reference_greedy,
                                        reference_runs, setting):
    """Same streams, completion order and counters as the JAX engine, at
    span 1 and 8, with room for everyone and under page pressure (9
    pages for 3 slots: the paged backend parks and unparks)."""
    _, _, tcfg, tp = fp32
    for s in ENGINE_SEEDS:
        assert reference_greedy[s][1] >= MARGIN, (s, reference_greedy[s][1])
    ref_stats, ref_streams = reference_runs[setting]
    stats, streams = _engine_run(lambda c: ServingEngine(
        tcfg, tp, api.EngineConfig(clock=c, **_common(setting)),
        device="cpu"), api.Request)
    assert streams == ref_streams
    for req_id, toks in streams:
        assert toks == reference_greedy[ENGINE_SEEDS[req_id]][0]
    for key in ("parked", "unparked", "decode_steps", "decode_spans",
                "prefills", "span_shrinks", "page_allocs",
                "preempt_restarts"):
        assert stats[key] == ref_stats[key], key
    if setting.startswith("park"):
        assert stats["parked"] > 0
        assert stats["unparked"] == stats["parked"]
    assert stats["host_syncs"] == stats["prefills"] + stats["decode_spans"]


def test_moe_decode_span_reads_nothing_back(fp32):
    """A pure decode span through MoE layers makes no scalar device read:
    the only transfer is the accounted ``_host_sync``."""
    from torch.profiler import ProfilerActivity, profile
    _, _, tcfg, tp = fp32
    eng = ServingEngine(tcfg, tp, api.EngineConfig(
        slots=3, cache_len=L, page_size=PS, n_pages=24, eos_token=-1,
        kv_layout="paged"), device="cpu")
    for i, s in enumerate([0, 3, 5]):
        eng.submit(api.Request(i, _req_prompt(s), max_new_tokens=40))
    eng.step()                                   # admit + prefill + span
    before = dict(eng.stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    assert eng.stats["prefills"] == before["prefills"]
    assert eng.stats["decode_spans"] == before["decode_spans"] + 1
    assert eng.stats["host_syncs"] == before["host_syncs"] + 1
    keys = {e.key for e in prof.events()}
    assert "aten::index_put_" in keys          # the dispatch ran
    reads = [k for k in keys
             if k in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads
