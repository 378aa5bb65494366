"""Chunked prefill and the block prefix cache of the port against the JAX
package: ``lm.prefill_chunk``, the ``dense`` and ``paged`` backends'
chunk staging and block sharing, and the engine's streaming prefill,
prefix matching and donation (the port's mirror of
tests/test_chunked_prefill.py and tests/test_prefix_cache.py).

SMOKE qwen3-8b (and moonshot-v1-16b-a3b) with fp32 weights from
``repro.models.lm.init_params``, bridged by ``params_from_numpy``; the
port on the CPU. Logits and caches hold to atol/rtol 1e-4 against the
reference and against the port's monolithic prefill. Greedy streams of
two frameworks agree only where the top-1/top-2 logit gap exceeds their
rounding difference, so the prompts were chosen for a reference margin
of at least 1e-3 at every step, and the tests assert it first. Engines
run on a step clock so that park/unpark timing is deterministic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.models import lm  # noqa: E402
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

TOL = 1e-4
L, PS, MAX_NEW = 64, 8, 12
MARGIN = 1e-3
VOCAB = 512


def _bridge(arch):
    jcfg = J_SMOKE[arch].scaled(dtype="float32")
    tcfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def model():
    return _bridge("qwen3-8b")


@pytest.fixture(scope="module")
def moonshot():
    return _bridge("moonshot-v1-16b-a3b")


def _toks(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, size=n).astype(
        np.int32)


# one shared 24-token (3-page) prefix under three tails, a prompt of its
# own and a repeat of the first: the prefix cache hits on the later ones
SHARED = _toks(24, 100)
PROMPTS = [np.concatenate([SHARED, _toks(13, 1100)]),
           np.concatenate([SHARED, _toks(7, 2100)]),
           _toks(19, 3100),
           np.concatenate([SHARED, _toks(21, 4100)]),
           np.concatenate([SHARED, _toks(13, 1100)])]


def _np(t):
    return t.detach().float().numpy()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _chunk(prompt, pos, width):
    n_valid = min(width, len(prompt) - pos)
    chunk = np.zeros(width, np.int32)
    chunk[:n_valid] = prompt[pos:pos + n_valid]
    return chunk[None], n_valid


def _port_chain(tcfg, tp, prompt, width, cache_len):
    caches = lm.init_serve_state(tcfg, 1, cache_len, device="cpu")["caches"]
    pos = 0
    while pos < len(prompt):
        chunk, nv = _chunk(prompt, pos, width)
        logits, caches = lm.prefill_chunk(tp, torch.from_numpy(chunk),
                                          caches, pos, nv, tcfg)
        pos += nv
    return logits, caches


def _ref_chain(jcfg, jp, prompt, width, cache_len):
    fn = jax.jit(lambda p, t, c, s, nv: jlm.prefill_chunk(
        p, t, c, s, nv, jcfg, NULL_POLICY))
    caches = jlm.init_serve_state(jcfg, 1, cache_len, filled=False)["caches"]
    pos = 0
    while pos < len(prompt):
        chunk, nv = _chunk(prompt, pos, width)
        logits, caches = fn(jp, jnp.asarray(chunk), caches, jnp.int32(pos),
                            jnp.int32(nv))
        pos += nv
    return logits, caches


def _close_caches(t_caches, j_caches, tol=TOL):
    groups = j_caches["groups"]["b0"]
    for i, layer in enumerate(t_caches):
        _close(layer["k"], groups["k"][i], tol)
        _close(layer["v"], groups["v"][i], tol)


# ---------------------------------------------------------------------------
# the model: chained chunks against the reference and monolithic prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [8, 16, 10, 37, 64])
def test_prefill_chunk_chain_matches_reference_and_monolithic(model, width):
    """Any chunking of a prompt (ragged, padded tails included) gives the
    reference chain's logits and caches, and the port's monolithic
    logits and caches, within 1e-4."""
    jcfg, jp, tcfg, tp = model
    prompt = _toks(37, 0)
    tl, tc = _port_chain(tcfg, tp, prompt, width, L)
    jl, jc = _ref_chain(jcfg, jp, prompt, width, L)
    _close(tl, jl)
    _close_caches(tc, jc)
    mono, st = lm.prefill(tp, torch.from_numpy(prompt[None]), tcfg,
                          cache_len=L)
    torch.testing.assert_close(tl, mono, atol=TOL, rtol=TOL)
    for a, b in zip(tc, st["caches"]):
        for key in ("k", "v"):
            torch.testing.assert_close(a[key][:, :len(prompt)],
                                       b[key][:, :len(prompt)], atol=TOL,
                                       rtol=TOL)


def test_padded_tail_chunk_straddling_cache_len(model):
    """A padded tail chunk whose width reaches past cache_len writes each
    token at its own position and drops the rows past the cache: the
    valid rows are not shifted, as a clamped slice would shift them."""
    jcfg, jp, tcfg, tp = model
    cache_len, width = 40, 16
    prompt = _toks(39, 20)                      # last chunk: [32, 48) > 40
    tl, tc = _port_chain(tcfg, tp, prompt, width, cache_len)
    jl, jc = _ref_chain(jcfg, jp, prompt, width, cache_len)
    _close(tl, jl)
    _close_caches(tc, jc)
    mono, st = lm.prefill(tp, torch.from_numpy(prompt[None]), tcfg,
                          cache_len=cache_len)
    torch.testing.assert_close(tl, mono, atol=TOL, rtol=TOL)
    for a, b in zip(tc, st["caches"]):
        assert a["k"].shape[1] == cache_len
        torch.testing.assert_close(a["k"][:, :39], b["k"][:, :39],
                                   atol=TOL, rtol=TOL)


def test_prefill_chunk_reads_nothing_back(model):
    """A chunk makes no scalar device read: start and n_valid are host
    ints, and a device tensor in their place is refused."""
    from torch.profiler import ProfilerActivity, profile
    _, _, tcfg, tp = model
    prompt = _toks(37, 0)
    caches = lm.init_serve_state(tcfg, 1, L, device="cpu")["caches"]
    chunk, nv = _chunk(prompt, 16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lm.prefill_chunk(tp, torch.from_numpy(chunk), caches, 16, nv, tcfg)
    reads = [e.key for e in prof.events()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads
    with pytest.raises(TypeError, match="host ints"):
        lm.prefill_chunk(tp, torch.from_numpy(chunk), caches,
                         torch.tensor(16), nv, tcfg)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_prefill_chunk_refuses_like_reference(arch):
    """Stacks without per-token attention rows fail the gate, with the
    reference's message."""
    jcfg, tcfg = J_SMOKE[arch], SMOKE_CONFIGS[arch]
    assert not tf.chunked_prefill_supported(tcfg)
    assert jtf.chunked_prefill_supported(jcfg) is False
    tok = np.ones((1, 8), np.int32)
    with pytest.raises(ValueError) as ref:
        jlm.prefill_chunk(None, jnp.asarray(tok), None, 0, 8, jcfg,
                          NULL_POLICY)
    with pytest.raises(ValueError) as port:
        lm.prefill_chunk(None, torch.from_numpy(tok), None, 0, 8, tcfg)
    assert str(port.value) == str(ref.value)


def test_pages_to_dense_matches_reference():
    rng = np.random.default_rng(3)
    pages = rng.standard_normal((3, PS, 2, 16)).astype(np.float32)
    ref = jtf.pages_to_dense({"prefix": [{"k": jnp.asarray(pages)}],
                              "groups": None}, L, PS)["prefix"][0]["k"]
    out = tf.pages_to_dense([{"k": torch.from_numpy(pages)}], L, PS)[0]["k"]
    assert out.shape == (1, L, 2, 16)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


# ---------------------------------------------------------------------------
# the backends: chunk staging against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_backend_chunked_prefill_matches_reference(model, layout):
    """slot_caches -> prefill_chunk -> store_chunk into slot 1, chunk by
    chunk: each chunk's logits and then the whole decode state (dense
    slabs, or the page pool with the tail page's padding rows) equal the
    reference's. On dense the rows past the valid length stay zero and
    the other slot is untouched, as after a monolithic prefill."""
    jcfg, jp, tcfg, tp = model
    common = dict(slots=2, cache_len=L, page_size=PS, n_pages=16,
                  kv_layout=layout)
    jkv = japi.make_state_backend(layout, jcfg, japi.EngineConfig(**common))
    tkv = api.make_state_backend(layout, tcfg, api.EngineConfig(**common),
                                 "cpu")
    assert tkv.supports_chunked_prefill and tkv.supports_prefix_share
    fn = jax.jit(lambda p, t, c, s, nv: jlm.prefill_chunk(
        p, t, c, s, nv, jcfg, NULL_POLICY))
    jst, tst = jkv.init_state(), tkv.init_state()
    prompt, slot, rid = _toks(37, 5), 1, 7
    for kv in (jkv, tkv):
        kv.pool.alloc(-1, 3)                     # non-trivial page ids
        assert kv.append(rid, len(prompt) + 1)
    pos = 0
    while pos < len(prompt):
        chunk, nv = _chunk(prompt, pos, 16)
        jc = jkv.slot_caches(jst, slot, rid)
        jl, jc = fn(jp, jnp.asarray(chunk), jc, jnp.int32(pos),
                    jnp.int32(nv))
        jst = jkv.store_chunk(jst, slot, rid, jc, pos, nv)
        tc = tkv.slot_caches(tst, slot, rid)
        tl, tc = lm.prefill_chunk(tp, torch.from_numpy(chunk), tc, pos, nv,
                                  tcfg)
        tst = tkv.store_chunk(tst, slot, rid, tc, pos, nv)
        _close(tl, jl)
        pos += nv
    _close_caches(tst["caches"], jst["caches"])
    if layout == "dense":
        for layer in tst["caches"]:
            for t in layer.values():
                assert not t[slot, len(prompt):].any()
                assert not t[0].any()


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------

class StepClock:
    """A clock the test loop advances once per engine step."""

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


def _greedy(jcfg, jp, prompt):
    """Model-level greedy stream of a prompt and its smallest top-1/top-2
    margin, from the JAX model (batch 1, monolithic prefill)."""
    step = jax.jit(lambda p, t, s: jlm.decode_step(p, t, s, jcfg,
                                                   NULL_POLICY))
    lg, st = jlm.prefill(jp, jnp.asarray(prompt[None]), jcfg, NULL_POLICY,
                         cache_len=L)
    toks, margin = [], np.inf
    for i in range(MAX_NEW):
        top = np.sort(np.asarray(lg[0]))[-2:]
        margin = min(margin, float(top[1] - top[0]))
        toks.append(int(jnp.argmax(lg[0])))
        if i < MAX_NEW - 1:
            lg, st = step(jp, jnp.asarray([toks[-1]], jnp.int32), st)
    return toks, margin


@pytest.fixture(scope="module")
def reference_greedy(model):
    jcfg, jp, _, _ = model
    return [_greedy(jcfg, jp, p) for p in PROMPTS]


def _run_both(cfgs, prompts, **kw):
    """The same requests through the reference engine and the port's, on
    a step clock; (engine, [(req_id, tokens)]) of each."""
    jcfg, jp, tcfg, tp = cfgs
    common = dict(cache_len=L, page_size=PS, eos_token=-1, scheduler="fcfs",
                  sampler="greedy", **kw)
    out = {}
    for name, make, req_cls in (
            ("ref", lambda c: JEngine(jcfg, jp, japi.EngineConfig(
                clock=c, **common)), japi.Request),
            ("port", lambda c: ServingEngine(tcfg, tp, api.EngineConfig(
                clock=c, **common), device="cpu"), api.Request)):
        clock = StepClock()
        eng = make(clock)
        for i, p in enumerate(prompts):
            eng.submit(req_cls(i, p.copy(), max_new_tokens=MAX_NEW))
        done = _drive(eng, clock)
        out[name] = (eng, [(r.req_id, r.tokens_out) for r in done])
    return out


def _assert_like_reference(runs):
    ref, port = runs["ref"][0], runs["port"][0]
    assert runs["port"][1] == runs["ref"][1]
    assert port.stats == {k: ref.stats[k] for k in port.stats}
    assert port.stats["host_syncs"] == (port.stats["prefills"]
                                        + port.stats["decode_spans"])
    assert len(port.prefix) == len(ref.prefix)
    port.prefix.clear()
    assert port.pool.n_free == port.pool.n_pages


# prefill_chunk 0 still uses the cache: a hit runs the prompt's tail as
# one chunk; "park" has too few pages for three slots, and parks
ENGINE_SETTINGS = {
    "chunk16-span8": dict(slots=2, n_pages=64, prefill_chunk=16,
                          decode_span=8),
    "chunk8-span1": dict(slots=2, n_pages=64, prefill_chunk=8,
                         decode_span=1),
    "budget32-span8": dict(slots=3, n_pages=64, prefill_chunk=8,
                           prefill_budget=32, decode_span=8),
    "tail-span8": dict(slots=2, n_pages=64, prefill_chunk=0,
                       decode_span=8),
    "park-span8": dict(slots=3, n_pages=10, prefill_chunk=8,
                       decode_span=8),
}


@pytest.mark.parametrize("setting", sorted(ENGINE_SETTINGS))
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_streams_match_reference(model, reference_greedy, layout,
                                        setting):
    """Same streams, completion order and every counter (prefill chunks,
    prefix hits and reused tokens, pages, parks) as the JAX engine at
    the same chunk width, budget and span, with prompts that share a
    page-aligned prefix; each stream is the model-level greedy one."""
    for toks, margin in reference_greedy:
        assert margin >= MARGIN, margin
    runs = _run_both(model, PROMPTS, kv_layout=layout,
                     prefix_cache_entries=32, **ENGINE_SETTINGS[setting])
    _assert_like_reference(runs)
    stats = runs["port"][0].stats
    assert stats["prefix_tokens_reused"] >= len(SHARED) * stats["prefix_hits"]
    if setting.startswith("park"):
        # page pressure: cached blocks are the first pages reclaimed
        assert stats["parked"] > 0
    else:
        assert stats["prefix_hits"] >= 1
    if ENGINE_SETTINGS[setting]["prefill_chunk"]:
        assert stats["prefill_chunks"] > stats["prefills"]
    else:
        assert stats["prefill_chunks"] == stats["prefix_hits"]
    for req_id, toks in runs["port"][1]:
        assert toks == reference_greedy[req_id][0]


def test_moonshot_chunked_engine_matches_reference(moonshot):
    """SMOKE moonshot (MoE) on paged with 16-token chunks: the padding
    rows of a tail chunk route and take expert capacity as in the
    reference, so streams and counters equal the JAX engine's. The
    prompts keep a margin of 1e-3 along the reference's own chunked
    chain."""
    jcfg, jp, _, _ = moonshot
    prompts = [_toks(n, s) for n, s in
               ((31, 200), (26, 210), (40, 220), (45, 240), (23, 250))]
    step = jax.jit(lambda p, t, s: jlm.decode_step(p, t, s, jcfg,
                                                   NULL_POLICY))
    for p in prompts:
        lg, caches = _ref_chain(jcfg, jp, p, 16, L)
        st = {"caches": caches,
              "lengths": jnp.full((1,), len(p), jnp.int32),
              "positions": jnp.full((1,), len(p), jnp.int32)}
        for i in range(MAX_NEW):
            top = np.sort(np.asarray(lg[0]))[-2:]
            assert top[1] - top[0] >= MARGIN
            if i < MAX_NEW - 1:
                lg, st = step(jp, jnp.argmax(lg, -1).astype(jnp.int32), st)
    runs = _run_both(moonshot, prompts, kv_layout="paged", slots=3,
                     n_pages=64, prefill_chunk=16, decode_span=8)
    assert runs["port"][0].stats["prefill_chunks"] > len(prompts)
    _assert_like_reference(runs)


# ---------------------------------------------------------------------------
# the engine: sharing, budget, contracts
# ---------------------------------------------------------------------------

def _engine(model, **kw):
    _, _, tcfg, tp = model
    base = dict(slots=2, cache_len=L, page_size=PS, n_pages=32,
                eos_token=-1, kv_layout="paged")
    return ServingEngine(tcfg, tp, api.EngineConfig(**{**base, **kw}),
                         device="cpu")


def _alone(model, prompt, max_new, **kw):
    """A request's stream with no cache and monolithic prefill."""
    eng = _engine(model, slots=1, prefix_cache_entries=0, **kw)
    eng.submit(api.Request(0, prompt.copy(), max_new_tokens=max_new))
    return eng.run_until_done()[0].tokens_out


def _syncs_ok(eng):
    return eng.stats["host_syncs"] == (eng.stats["prefills"]
                                       + eng.stats["decode_spans"])


def test_shared_prefix_pages_held_once(model):
    """Two live requests sharing a page-aligned prefix reference the same
    pages (counted once by the pool), and the one that finishes first
    leaves the other's decode intact."""
    p1, p2 = PROMPTS[0], PROMPTS[1]
    refs = [_alone(model, p1, 6), _alone(model, p2, MAX_NEW)]
    eng = _engine(model, prefill_chunk=8)
    eng.submit(api.Request(0, p1.copy(), max_new_tokens=6))
    assert eng.run_until_done()[0].tokens_out == refs[0]
    r1 = api.Request(1, p1.copy(), max_new_tokens=6)
    r2 = api.Request(2, p2.copy(), max_new_tokens=MAX_NEW)
    eng.submit(r1)
    eng.submit(r2)
    eng.step()
    pages1, pages2 = set(eng.pool.pages_of(1)), set(eng.pool.pages_of(2))
    common = pages1 & pages2
    assert len(common) == len(SHARED) // PS
    for p in common:                            # the cache + two sharers
        assert eng.pool.refcount(p) == 3
    # held once: every cached block is in the first sharer's table (its
    # prompt repeats the seed request's), so the pool holds the union of
    # the two tables and nothing more
    assert eng.stats["prefix_tokens_reused"] == 32 + len(SHARED)
    assert eng.pool.n_used == len(pages1 | pages2)
    assert eng.pool.n_used < len(pages1) + len(pages2)
    outs = {r.req_id: r.tokens_out for r in eng.run_until_done()}
    assert outs[1] == refs[0] and outs[2] == refs[1]
    assert _syncs_ok(eng)
    eng.prefix.clear()
    assert eng.pool.n_free == eng.pool.n_pages


def test_shared_prefix_survives_sharer_park(model):
    """Parking one sharer (its K/V to the host tier, its page references
    dropped) leaves the other sharer's pages intact; both finish with
    their streams from a run alone."""
    p1, p2 = PROMPTS[0], PROMPTS[3]
    refs = {1: _alone(model, p1, MAX_NEW), 2: _alone(model, p2, MAX_NEW)}
    eng = _engine(model, prefill_chunk=8, decode_span=1)
    eng.submit(api.Request(0, p1.copy(), max_new_tokens=4))
    eng.run_until_done()
    r1 = api.Request(1, p1.copy(), max_new_tokens=MAX_NEW)
    r2 = api.Request(2, p2.copy(), max_new_tokens=MAX_NEW)
    eng.submit(r1)
    eng.submit(r2)
    for _ in range(4):
        eng.step()
    assert eng._park_slot(eng.slot_req.index(r1))
    for _ in range(3):
        eng.step()
    outs = {r.req_id: r.tokens_out for r in eng.run_until_done()}
    assert outs[1] == refs[1] and outs[2] == refs[2]
    assert eng.stats["parked"] == eng.stats["unparked"] == 1
    assert _syncs_ok(eng)
    eng.prefix.clear()
    assert eng.pool.n_free == eng.pool.n_pages


def test_dense_payload_outlives_slot_reuse(model):
    """A dense cache block is a copy of the slot's rows: another request
    that overwrites the slot's slab leaves it as it was, and a later
    hit on it streams as the request would alone."""
    eng = _engine(model, slots=1, kv_layout="dense", prefill_chunk=8)
    eng.submit(api.Request(0, PROMPTS[0].copy(), max_new_tokens=4))
    eng.run_until_done()
    payloads = [e.payload for e in eng.prefix._d.values()]
    assert len(payloads) == len(PROMPTS[0]) // PS
    before = [[{k: t.clone() for k, t in layer.items()} for layer in p]
              for p in payloads]
    eng.submit(api.Request(1, PROMPTS[2].copy(), max_new_tokens=4))
    eng.run_until_done()                        # same slot, other rows
    for p, old in zip(payloads, before):
        for layer, old_layer in zip(p, old):
            for k, t in layer.items():
                assert torch.equal(t, old_layer[k])
    eng.submit(api.Request(2, PROMPTS[3].copy(), max_new_tokens=MAX_NEW))
    done = eng.run_until_done()
    assert eng.stats["prefix_hits"] == 1
    assert eng.stats["prefix_tokens_reused"] == len(SHARED)
    assert done[-1].tokens_out == _alone(model, PROMPTS[3], MAX_NEW,
                                         kv_layout="dense")
    assert _syncs_ok(eng)


def test_unaligned_chunk_raises_and_settings_are_accepted(model):
    cfg = api.EngineConfig(prefill_chunk=16, prefix_cache_entries=4,
                           prefill_budget=32)
    assert (cfg.prefill_chunk, cfg.prefix_cache_entries) == (16, 4)
    assert api.EngineConfig().prefix_cache_entries == 32
    with pytest.raises(ValueError, match="page_size"):
        _engine(model, prefill_chunk=12)


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_max_new_tokens_one_emits_exactly_one(model, layout, chunk):
    """max_new_tokens=1 gives the prefill's token and nothing more."""
    eng = _engine(model, kv_layout=layout, prefill_chunk=chunk)
    eng.submit(api.Request(0, _toks(11, 10), max_new_tokens=1))
    done = eng.run_until_done(max_steps=50)
    assert len(done) == 1 and len(done[0].tokens_out) == 1
    assert eng.stats["decode_spans"] == 0 and _syncs_ok(eng)


@pytest.mark.parametrize("chunk", [0, 8])
def test_eos_at_prefill_terminates(model, chunk):
    """A request whose prefill token is EOS completes at once."""
    _, _, tcfg, tp = model
    prompt = _toks(11, 11)
    logits, _ = lm.prefill(tp, torch.from_numpy(prompt[None]), tcfg,
                           cache_len=L)
    eos = int(torch.argmax(logits[0]))
    eng = _engine(model, prefill_chunk=chunk, eos_token=eos)
    eng.submit(api.Request(0, prompt, max_new_tokens=8))
    done = eng.run_until_done(max_steps=50)
    assert len(done) == 1 and done[0].tokens_out == [eos]
    assert _syncs_ok(eng)


def test_long_prompt_does_not_stall_decodes(model):
    """A prompt of many chunks goes in one chunk a step while the running
    slot gains one token every step (span 1); a chunk reads nothing
    back."""
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(model, cache_len=128, n_pages=48, prefill_chunk=8,
                  decode_span=1)
    short = api.Request(0, _toks(5, 1), max_new_tokens=40)
    eng.submit(short)
    eng.step()                       # short: prefill + first decode token
    assert len(short.tokens_out) == 2
    long = api.Request(1, _toks(120, 2), max_new_tokens=4)
    eng.submit(long)
    for i in range(15):              # 120 tokens / 8-token chunks
        before = len(short.tokens_out)
        if i == 5:
            syncs = eng.stats["host_syncs"]
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                eng._prefill_step()
            assert eng.stats["host_syncs"] == syncs
            assert not [e.key for e in prof.events() if e.key in (
                "aten::_local_scalar_dense", "aten::item")]
        eng.step()
        assert len(short.tokens_out) == before + 1    # never stalled
    assert len(long.tokens_out) >= 1                  # prefill finished
    assert len(eng.run_until_done()) == 2
    assert eng.stats["prefill_chunks"] == 16          # 1 + 15
    assert _syncs_ok(eng)


@pytest.mark.parametrize("budget", [0, 16])
def test_concurrent_prefills_share_the_budget(model, budget):
    """Two slots streaming prompts split the per-step budget (one chunk,
    or two) round-robin: neither runs away from the other."""
    chunk = 8
    eng = _engine(model, cache_len=96, n_pages=32, prefill_chunk=chunk,
                  prefill_budget=budget)
    eng.submit(api.Request(0, _toks(64, 30), max_new_tokens=2))
    eng.submit(api.Request(1, _toks(64, 31), max_new_tokens=2))
    eng.step()                                   # both admitted
    assert eng.prefilling.all()
    per_step = max(1, budget // chunk)
    for n in range(2, 5):
        eng.step()
        assert int(eng.prefill_pos.sum()) == n * per_step * chunk
    assert abs(int(eng.prefill_pos[0]) - int(eng.prefill_pos[1])) <= chunk
    assert len(eng.run_until_done()) == 2 and _syncs_ok(eng)


@pytest.mark.parametrize("arch,layout", [("rwkv6-1.6b", "recurrent"),
                                         ("jamba-v0.1-52b", "dense")])
def test_chunking_declined_serves_monolithic(arch, layout):
    """Backends whose state has no per-token rows for the stack take a
    prefill_chunk setting and serve monolithically, as the reference:
    no chunk, an inert prefix cache, the streams of prefill_chunk=0."""
    cfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    streams = []
    for chunk in (0, 16):
        eng = ServingEngine(cfg, params, api.EngineConfig(
            slots=2, cache_len=L, page_size=PS, n_pages=32, eos_token=-1,
            kv_layout=layout, prefill_chunk=chunk), device="cpu")
        assert not eng.kv.supports_chunked_prefill
        assert eng.prefix.capacity == 0
        for i, n in enumerate((19, 33, 24)):
            eng.submit(api.Request(i, _toks(n, 40 + i), max_new_tokens=5))
        streams.append({r.req_id: r.tokens_out
                        for r in eng.run_until_done()})
        assert eng.stats["prefill_chunks"] == 0
        assert len(eng.prefix) == 0 and _syncs_ok(eng)
    assert streams[0] == streams[1]
