"""The port's RWKV-6 path against the JAX package: the WKV kernels' plain
versions, the model at SMOKE size, and the serving engine on the
``recurrent`` backend.

Every input is made with numpy from a seed. The port runs on the CPU,
where the B3/B4 wrappers take their plain versions; the kernels
themselves are held against those on the card (tests/test_torch_cuda.py,
``python3 chip_smoke.py``). Tolerances: the kernel sweeps of
tests/test_kernels.py (chunked y 2e-4 and state 2e-5, decode 1e-5);
fp32 model logits and per-layer state 1e-4; greedy streams equal on
requests whose reference top-1/top-2 margin is at least 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RWKVConfig as JRWKVConfig  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.base import RWKVConfig  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.kernels import wkv6  # noqa: E402
from repro_torch.models import lm  # noqa: E402
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

TOL = 1e-4
L = 64                      # cache_len
ARCH = "rwkv6-1.6b"


def _np(t):
    return t.detach().float().numpy()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# B4 / B3 plain versions against the oracles and the Pallas kernels
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, B, S, H, hd, rkv_dtype):
    """r, k, v rounded to `rkv_dtype` (the port gets that dtype, JAX the
    same values in fp32); logw from the model's clamp range."""
    def rkv():
        x = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(
            np.float32)).to(rkv_dtype)
        return x, x.float().numpy()
    (tr, r), (tk, k), (tv, v) = rkv(), rkv(), rkv()
    logw = -np.exp(np.clip(rng.standard_normal((B, S, H, hd)), -8, 0.5)
                   ).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    port = (tr, tk, tv) + tuple(torch.from_numpy(a) for a in (logw, u, s0))
    return port, (r, k, v, logw, u, s0)


@pytest.mark.parametrize("rkv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,chunk", [(2, 64, 2, 8, 16),
                                            (1, 50, 3, 16, 32),
                                            (2, 33, 1, 8, 8),
                                            (2, 1, 2, 8, 32)])
def test_wkv6_chunked_plain_matches_ref_and_pallas(B, S, H, hd, chunk,
                                                   rkv_dtype):
    rng = np.random.default_rng(B * S * H + hd)
    port, xs = _wkv_inputs(rng, B, S, H, hd, rkv_dtype)
    y, s = wkv6.wkv6_chunked(*port, chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, S, H, hd) and s.shape == (B, H, hd, hd)
    jxs = [jnp.asarray(a) for a in xs]
    ry, rs = ref.wkv6_ref(*jxs)
    py, ps = ops.wkv6_chunked(*jxs, chunk=chunk, interpret=True)
    for jy, js in ((ry, rs), (py, ps)):
        _close(y, jy, 2e-4)
        _close(s, js, 2e-5)


@pytest.mark.parametrize("chunk", [1, 8, 32])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 200])
def test_wkv6_chunked_passes_plain_matches_serial_and_jax(S, chunk):
    """B4's chunk-parallel algorithm (chunk states, the scan of the
    carry, chunk outputs) against the chunk-serial plain version, the JAX
    model's ``wkv_chunked`` and the Pallas kernel in interpret mode, with
    a non-zero state0: y within 2e-4, the state within 2e-5. S = 1, a
    chunk less one, a chunk, a chunk and one, and a ragged prefill."""
    rng = np.random.default_rng(S * 41 + chunk)
    port, xs = _wkv_inputs(rng, 2, S, 2, 8, torch.float32)
    y, s = wkv6.wkv6_chunked_passes_plain(*port, chunk=chunk)
    assert y.shape == (2, S, 2, 8) and s.shape == (2, 2, 8, 8)
    assert float(port[-1].abs().max()) > 0
    sy, ss = wkv6.wkv6_chunked_plain(*port, chunk=chunk)
    _close(y, _np(sy), 2e-4)
    _close(s, _np(ss), 2e-5)
    jxs = [jnp.asarray(a) for a in xs]
    jy, js = jrwkv.wkv_chunked(*jxs, chunk=chunk)
    py, ps = ops.wkv6_chunked(*jxs, chunk=chunk, interpret=True)
    for ey, es in ((jy, js), (py, ps)):
        _close(y, ey, 2e-4)
        _close(s, es, 2e-5)


@pytest.mark.parametrize("rkv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,hd", [(2, 2, 8), (1, 3, 16), (4, 1, 8),
                                   (2, 2, 6), (1, 2, 128)])
def test_wkv6_decode_plain_matches_ref_and_pallas(B, H, hd, rkv_dtype):
    """The sweep of tests/test_kernels.py and the edges of B3's column
    tiles: hd 6 (element by element) and 128 (eight tiles)."""
    rng = np.random.default_rng(B * H * hd)
    port, xs = _wkv_inputs(rng, B, 1, H, hd, rkv_dtype)
    tr, tk, tv, tlogw, tu, ts0 = port
    tw = torch.exp(tlogw)
    r, k, v, logw, u, s0 = xs
    w = np.exp(logw)
    tr, tk, tv, tw = (t[:, 0] for t in (tr, tk, tv, tw))
    y, s = wkv6.wkv6_decode(tr, tk, tv, tw, tu, ts0)
    jxs = [jnp.asarray(a) for a in (r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                    u, s0)]
    ry, rs = ref.wkv6_decode_ref(*jxs)
    py, ps = ops.wkv6_decode(*jxs, interpret=True)
    for jy, js in ((ry, rs), (py, ps)):
        _close(y, jy, 1e-5)
        _close(s, js, 1e-5)
    # one decode step == the t = 1 column of the chunked scan
    cy, cs = wkv6.wkv6_chunked(tr[:, None], tk[:, None], tv[:, None],
                               torch.log(tw)[:, None], tu, ts0, chunk=1)
    _close(cy[:, 0], _np(y), 2e-4)
    _close(cs, _np(s), 2e-5)


def test_wkv6_wrappers_refuse_bad_inputs():
    z = torch.zeros
    with pytest.raises(TypeError):              # state must be fp32
        wkv6.wkv6_decode(z(1, 2, 8), z(1, 2, 8), z(1, 2, 8), z(1, 2, 8),
                         z(2, 8), z(1, 2, 8, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):             # u of the wrong shape
        wkv6.wkv6_chunked(z(1, 4, 2, 8), z(1, 4, 2, 8), z(1, 4, 2, 8),
                          z(1, 4, 2, 8), z(3, 8), z(1, 2, 8, 8))


# ---------------------------------------------------------------------------
# the model at SMOKE size, fp32, JAX weights bridged
# ---------------------------------------------------------------------------

def _bridge(dtype_name):
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


def _prompts(B, S, seed, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=(B, S)
                                                ).astype(np.int32)


def _close_states(ts, js, tol=TOL):
    groups = js["caches"]["groups"]["b0"]
    for i, layer in enumerate(ts["caches"]):
        for key in ("wkv", "shift_tm", "shift_cm"):
            _close(layer[key], groups[key][i], tol)
    for key in ("lengths", "positions"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))


def test_prefill_logits_and_state(fp32):
    """37 tokens: one whole chunk of 32 and a ragged tail of 5."""
    jcfg, jp, tcfg, tp = fp32
    toks = _prompts(2, 37, 1, tcfg.vocab_size)
    jl, jst = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                          cache_len=L)
    tl, tst = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    _close(tl, jl)
    hd = tcfg.rwkv.head_dim
    H = tcfg.d_model // hd
    assert tst["caches"][0]["wkv"].shape == (2, H, hd, hd)
    assert tst["caches"][0]["wkv"].dtype == torch.float32
    _close_states(tst, jst)


def test_decode_step_logits_and_state(fp32):
    jcfg, jp, tcfg, tp = fp32
    toks = _prompts(2, 21, 2, tcfg.vocab_size)
    _, js = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                        cache_len=L)
    _, ts = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    step = jax.jit(lambda p, t, s, a: jlm.decode_step(
        p, t, s, jcfg, NULL_POLICY, active=a))
    nxt = np.array([3, 8], np.int32)
    for active in ([True, True], [True, False], [True, True]):
        jl, js = step(jp, jnp.asarray(nxt), js, jnp.asarray(active))
        tl, ts = lm.decode_step(tp, torch.from_numpy(nxt), ts, tcfg,
                                active=torch.tensor(active))
        _close(tl, jl)
        _close_states(ts, js)
        assert "page_table" not in ts
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)


def test_inactive_slot_carry_is_frozen_bit_for_bit(fp32):
    """A decode step leaves a parked / finished / free slot's carry as it
    was, bit for bit, and writes the active slots' new carry in place."""
    _, _, tcfg, tp = fp32
    toks = _prompts(3, 9, 3, tcfg.vocab_size)
    _, st = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    before = [{k: t.clone() for k, t in layer.items()}
              for layer in st["caches"]]
    ids = [[id(t) for t in layer.values()] for layer in st["caches"]]
    active = torch.tensor([True, False, True])
    _, st = lm.decode_step(tp, torch.tensor([5, 6, 7], dtype=torch.int32),
                           st, tcfg, active=active)
    assert [[id(t) for t in layer.values()]
            for layer in st["caches"]] == ids
    for old, new in zip(before, st["caches"]):
        for key in old:
            assert torch.equal(new[key][1], old[key][1]), key
            assert not torch.equal(new[key][0], old[key][0]), key
    assert st["positions"].tolist() == [10, 9, 10]


def test_decode_span_matches_scan(fp32):
    """Span 8, slot 1 parked, slot 2 with a budget of 3: tokens, emission
    masks, counters and every layer's carry match the JAX scan."""
    jcfg, jp, tcfg, tp = fp32
    toks = _prompts(3, 13, 4, tcfg.vocab_size)
    _, js = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                        cache_len=L)
    _, ts = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    active = np.array([True, False, True])
    budgets = np.array([8, 8, 3], np.int32)
    first = np.array([17, 2, 40], np.int32)
    jt, je, js = jlm.decode_span(jp, jnp.asarray(first), js, jcfg,
                                 NULL_POLICY, jnp.asarray(active),
                                 jnp.asarray(budgets), span=8, eos_token=-1,
                                 cache_len=L)
    tt, te, ts = lm.decode_span(tp, torch.from_numpy(first), ts, tcfg,
                                torch.from_numpy(active),
                                torch.from_numpy(budgets), span=8,
                                eos_token=-1, cache_len=L)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te.numpy().sum(axis=0).tolist() == [8, 0, 3]
    _close_states(ts, js)


def test_prefill_bf16_logits():
    """bf16 prefill against the JAX model in bf16, at 2e-2 of the logit
    scale, and the port's bf16 error against the fp32 math at most twice
    the reference's own (as test_torch_model.test_prefill_bf16_logits).
    The bridge keeps the leaves the JAX model holds in fp32 in fp32."""
    jcfg, jp, tcfg, tp = _bridge("bfloat16")
    blk = tp["blocks"][0]["rwkv"]
    assert blk["wr"].dtype == torch.bfloat16
    assert all(blk[k].dtype == torch.float32
               for k in ("mu", "w_base", "u", "ln_x", "mu_cm"))
    toks = _prompts(1, 33, 8, tcfg.vocab_size)
    jl, _ = jlm.prefill(jp, jnp.asarray(toks), jcfg, NULL_POLICY,
                        cache_len=L)
    tl, _ = lm.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=L)
    assert tl.dtype == torch.bfloat16
    ref_l = np.asarray(jl, np.float32)
    scale = float(np.abs(ref_l).max())
    np.testing.assert_allclose(_np(tl), ref_l, atol=2e-2 * scale, rtol=2e-2)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    exact, _ = jlm.prefill(jp32, jnp.asarray(toks),
                           jcfg.scaled(dtype="float32"), NULL_POLICY,
                           cache_len=L)
    exact = np.asarray(exact)
    err_ref = np.abs(ref_l - exact).max()
    err_port = np.abs(_np(tl) - exact).max()
    assert err_port <= 2 * err_ref, (err_port, err_ref)


def test_init_params_shapes_and_dtypes_match_reference():
    """The port's random init builds the JAX tree's leaves, shapes and
    dtypes (bf16 model, fp32 mixing/decay/norm vectors)."""
    tcfg = SMOKE_CONFIGS[ARCH]
    jp = jlm.init_params(J_SMOKE[ARCH], jax.random.PRNGKey(0))
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    jb = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                      jp["stack"]["groups"]["b0"])
    for blk in tp["blocks"]:
        tb = {"norm1": blk["norm1"], "norm2": blk["norm2"],
              "rwkv": blk["rwkv"]}
        got = {k: ({n: (tuple(t.shape), str(t.dtype).split(".")[-1])
                    for n, t in v.items()} if isinstance(v, dict)
                   else (tuple(v.shape), str(v.dtype).split(".")[-1]))
               for k, v in tb.items()}
        assert got == jb
    assert set(tp) == {"embed", "blocks", "final_norm", "head"}


# ---------------------------------------------------------------------------
# the engine on the recurrent backend against the JAX engine
# ---------------------------------------------------------------------------

MAX_NEW = 12
# request seed -> prompt length; each keeps a reference top-1/top-2
# margin >= 1e-3 over its MAX_NEW greedy tokens
SEEDS = {0: 12, 1: 36, 2: 26, 3: 15, 4: 30, 5: 20}
MARGIN = 1e-3


class StepClock:
    """A clock the driver advances once per engine step."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def tiny():
    """The tiny fp32 RWKV-6 config of tests/test_state_backends.py."""
    kw = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
              d_ff=128, vocab_size=256, dtype="float32")
    jcfg = J_SMOKE[ARCH].scaled(rwkv=JRWKVConfig(head_dim=32), **kw)
    tcfg = SMOKE_CONFIGS[ARCH].scaled(rwkv=RWKVConfig(head_dim=32), **kw)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompt(seed):
    return np.random.default_rng(seed).integers(
        1, 256, size=SEEDS[seed]).astype(np.int32)


@pytest.fixture(scope="module")
def reference_greedy(tiny):
    """Model-level greedy stream and smallest top-1/top-2 margin of each
    request, from the JAX model (batch 1)."""
    jcfg, jp, _, _ = tiny
    step = jax.jit(lambda p, t, s: jlm.decode_step(p, t, s, jcfg,
                                                   NULL_POLICY))
    out = {}
    for seed in SEEDS:
        lg, st = jlm.prefill(jp, jnp.asarray(_prompt(seed)[None]), jcfg,
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


def _run_both(tiny, seeds, **kw):
    jcfg, jp, tcfg, tp = tiny
    common = dict(slots=3, cache_len=L, page_size=8, eos_token=-1,
                  kv_layout="recurrent", scheduler="fcfs",
                  sampler="greedy", prefill_chunk=0, prefix_cache_entries=0,
                  **kw)
    out = {}
    for name, make, req_cls in (
            ("ref", lambda c: JEngine(jcfg, jp, japi.EngineConfig(
                clock=c, **common)), japi.Request),
            ("port", lambda c: ServingEngine(tcfg, tp, api.EngineConfig(
                clock=c, **common), device="cpu"), api.Request)):
        clock = StepClock()
        eng = make(clock)
        for i, s in enumerate(seeds):
            eng.submit(req_cls(i, _prompt(s), max_new_tokens=MAX_NEW))
        done = _drive(eng, clock)
        out[name] = (eng, [(r.req_id, r.tokens_out) for r in done])
    return out


def _assert_margins(reference_greedy, seeds):
    for s in seeds:
        assert reference_greedy[s][1] >= MARGIN, (s, reference_greedy[s][1])


@pytest.mark.parametrize("span", [1, 8])
@pytest.mark.parametrize("n_pages", [24, 2])
def test_engine_streams_match_reference(tiny, reference_greedy, span,
                                        n_pages):
    """Same streams, completion order and counters as the JAX engine; at
    n_pages 2 < slots 3 the recurrent backend parks (a footprint of one
    page per resident request) and unparks."""
    seeds = [0, 1, 2, 3, 4]
    _assert_margins(reference_greedy, seeds)
    runs = _run_both(tiny, seeds, n_pages=n_pages, decode_span=span)
    ref_eng, eng = runs["ref"][0], runs["port"][0]
    assert runs["port"][1] == runs["ref"][1]
    for req_id, toks in runs["port"][1]:
        assert toks == reference_greedy[seeds[req_id]][0]
    for key in ("parked", "unparked", "decode_steps", "decode_spans",
                "prefills", "span_shrinks", "page_allocs",
                "preempt_restarts"):
        assert eng.stats[key] == ref_eng.stats[key], key
    if n_pages < 3:
        assert eng.stats["parked"] > 0
        assert eng.stats["unparked"] == eng.stats["parked"]
    assert eng.stats["host_syncs"] == (eng.stats["prefills"]
                                       + eng.stats["decode_spans"])
    assert eng.pool.n_free == eng.pool.n_pages


def test_admission_is_backend_defined(tiny):
    """A request larger than the whole page pool: the paged backend
    refuses it at submit, the recurrent backend (footprint 1) admits and
    completes it."""
    _, _, tcfg, tp = tiny
    qcfg = SMOKE_CONFIGS["qwen3-8b"].scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, dtype="float32")
    qp = lm.init_params(qcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    kw = dict(slots=2, cache_len=64, page_size=8, n_pages=4, decode_span=4,
              eos_token=-1)
    big = np.arange(1, 30, dtype=np.int32)
    eng = ServingEngine(qcfg, qp, api.EngineConfig(kv_layout="paged", **kw),
                        device="cpu")
    with pytest.raises(ValueError, match="pool holds only"):
        eng.try_submit(api.Request(0, big, max_new_tokens=30))
    eng = ServingEngine(tcfg, tp, api.EngineConfig(kv_layout="recurrent",
                                                   **kw), device="cpu")
    assert eng.try_submit(api.Request(0, big, max_new_tokens=30))
    done = eng.run_until_done()
    assert len(done) == 1 and len(done[0].tokens_out) == 30
    assert eng.stats["host_syncs"] == (eng.stats["prefills"]
                                       + eng.stats["decode_spans"])


def test_recurrent_decode_span_reads_nothing_back(tiny):
    """A pure decode span on the recurrent backend makes no scalar device
    read: the only transfer is the accounted ``_host_sync``."""
    from torch.profiler import ProfilerActivity, profile
    _, _, tcfg, tp = tiny
    eng = ServingEngine(tcfg, tp, api.EngineConfig(
        slots=3, cache_len=L, page_size=8, n_pages=8, eos_token=-1,
        kv_layout="recurrent"), device="cpu")
    for i, s in enumerate([0, 3, 5]):
        eng.submit(api.Request(i, _prompt(s), max_new_tokens=40))
    eng.step()                                   # admit + prefill + span
    before = dict(eng.stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    assert eng.stats["prefills"] == before["prefills"]
    assert eng.stats["decode_spans"] == before["decode_spans"] + 1
    assert eng.stats["host_syncs"] == before["host_syncs"] + 1
    reads = [e.key for e in prof.events()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


def test_backend_capabilities(tiny):
    _, _, tcfg, tp = tiny
    eng = ServingEngine(tcfg, tp, api.EngineConfig(
        kv_layout="recurrent", cache_len=L, page_size=8, n_pages=4),
        device="cpu")
    kv = eng.kv
    assert (kv.needs_growth, kv.supports_chunked_prefill,
            kv.supports_prefix_share) == (False, False, False)
    req = api.Request(0, _prompt(0), max_new_tokens=500)
    assert kv.footprint(req) == 1 and kv.admission_error(req) is None
    for call in (lambda: kv.slot_caches(eng.state, 0, 0),
                 lambda: kv.store_chunk(eng.state, 0, 0, None, 0, 8),
                 lambda: kv.share_prefix(eng.state, 0, 0, [], 8),
                 lambda: kv.block_payload(eng.state, 0, 0, 0)):
        with pytest.raises(NotImplementedError):
            call()


# ---------------------------------------------------------------------------
# construction refusals
# ---------------------------------------------------------------------------

def test_recurrent_refuses_attention_config():
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="constant-size recurrence"):
        ServingEngine(cfg, p, api.EngineConfig(kv_layout="recurrent"),
                      device="cpu")


def test_paged_refuses_rwkv_config(tiny):
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError, match="per-token cache blocks"):
        ServingEngine(tcfg, tp, api.EngineConfig(kv_layout="paged"),
                      device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-8b", ARCH])
def test_dense_layout_refused(arch):
    """What the dense layout refuses, now that it is registered (before,
    the port refused the layout itself): a request whose worst case,
    ``min(len(prompt) + max_new_tokens, cache_len)``, exceeds the whole
    page budget is refused at submit, for attention and RWKV configs
    alike, while one that fits completes; the config still refuses the
    'latent' layout with the backend's message, and the registry any
    unknown name."""
    cfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, p, api.EngineConfig(
        kv_layout="dense", slots=2, cache_len=64, page_size=8, n_pages=4,
        decode_span=4, eos_token=-1), device="cpu")
    assert eng.kv.name == "dense" and not eng.kv.needs_growth
    big = np.arange(1, 30, dtype=np.int32)
    with pytest.raises(ValueError, match="pool holds only"):
        eng.try_submit(api.Request(0, big, max_new_tokens=30))
    assert eng.try_submit(api.Request(1, big[:20], max_new_tokens=12))
    done = eng.run_until_done()
    assert [len(r.tokens_out) for r in done] == [12]
    with pytest.raises(ValueError, match="needs every layer to be MLA"):
        api.make_state_backend("latent", cfg,
                               api.EngineConfig(kv_layout="latent"), "cpu")
    with pytest.raises(ValueError, match="unknown kv layout"):
        api.make_state_backend("ring", cfg, api.EngineConfig(), "cpu")


def test_smoke_float64_witness_of_the_ranks_gate():
    """chip_smoke.py's float64 witness of rwkv6's fp32 ranks runs
    (``_float64_spread``, ``ranks_grads_ok``) on the CPU, SMOKE at the
    ranks phase's 4 rows of 64 tokens over two data shards: the fp32
    one-rank gradient lies within 1e-4 of each leaf's largest of the
    float64 one, ``Tensor.float`` is itself again after the witness, a
    run equal to the one-rank run passes with no excess, and one whose
    ``w_base`` gradients are off by half (as where a rank's partial
    gradient of a replicated leaf is not summed) fails on that leaf."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = SMOKE_CONFIGS[ARCH].scaled(dtype="float32")
    whole = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", tp=2)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    one = [g.float() for g in smoke._mesh_reference(torch, cfg, whole, toks,
                                                    2, True)[2]]
    names = smoke._leaf_names(whole)
    cast = torch.Tensor.float
    rec = smoke._float64_spread(torch, cfg, whole, toks, 2, one, one, names)
    assert torch.Tensor.float is cast
    assert rec["one_rank"] <= 1e-4 and rec["excess"] == 0
    assert smoke.ranks_grads_ok({"float64": rec})
    off = [g * 0.5 if n.endswith("/w_base") else g
           for g, n in zip(one, names)]
    rec = smoke._float64_spread(torch, cfg, whole, toks, 2, off, one, names)
    assert rec["excess_leaf"].endswith("/w_base") and rec["excess"] > 0.4
    assert not smoke.ranks_grads_ok({"float64": rec})
