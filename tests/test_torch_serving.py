"""The port's ServingEngine against ``repro.serve.engine.ServingEngine``.

Same bridged fp32 SMOKE qwen3-8b weights, same requests, the slice's
settings (paged layout, fcfs, greedy, monolithic prefill, no prefix
cache, eos_token -1), the port on the CPU. Greedy streams from two
frameworks agree only where the top-1/top-2 logit gap exceeds their
rounding difference (~1e-6 here), so the request seeds were chosen for a
reference margin of at least 1e-3 at every step, and the tests assert it
first. Both engines run on a step clock so park/unpark timing is
deterministic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.serve.prefix_cache import PrefixCache as JPrefixCache  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

L, PS, MAX_NEW = 64, 8, 12
# request seed -> prompt length; every one keeps a reference top-1/top-2
# margin >= 1e-3 over its MAX_NEW greedy tokens
SEEDS = {0: 13, 1: 31, 2: 23, 3: 15, 8: 17, 9: 26}
MARGIN = 1e-3


class StepClock:
    """A clock the driver advances once per engine step."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def model():
    jcfg = J_SMOKE["qwen3-8b"].scaled(dtype="float32")
    tcfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompt(seed):
    return np.random.default_rng(seed).integers(
        1, 512, size=SEEDS[seed]).astype(np.int32)


@pytest.fixture(scope="module")
def reference_greedy(model):
    """Model-level greedy stream and smallest top-1/top-2 margin of each
    request, from the JAX model (batch 1, dense cache)."""
    jcfg, jp, _, _ = model
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


def _run_both(model, seeds, **kw):
    jcfg, jp, tcfg, tp = model
    common = dict(slots=3, cache_len=L, page_size=PS, eos_token=-1,
                  kv_layout="paged", scheduler="fcfs", sampler="greedy",
                  prefill_chunk=0, prefix_cache_entries=0, **kw)
    out = {}
    for name, make in (
            ("ref", lambda c: JEngine(jcfg, jp, japi.EngineConfig(
                clock=c, **common))),
            ("port", lambda c: ServingEngine(tcfg, tp, api.EngineConfig(
                clock=c, **common), device="cpu"))):
        clock = StepClock()
        eng = make(clock)
        for i, s in enumerate(seeds):
            req_cls = japi.Request if name == "ref" else api.Request
            eng.submit(req_cls(i, _prompt(s), max_new_tokens=MAX_NEW))
        done = _drive(eng, clock)
        out[name] = (eng, [(r.req_id, r.tokens_out) for r in done])
    return out


def _assert_margins(reference_greedy, seeds):
    for s in seeds:
        assert reference_greedy[s][1] >= MARGIN, (s, reference_greedy[s][1])


@pytest.mark.parametrize("span", [1, 8])
def test_streams_and_order_match_reference(model, reference_greedy, span):
    seeds = [0, 1, 2, 3, 8]
    _assert_margins(reference_greedy, seeds)
    runs = _run_both(model, seeds, n_pages=64, decode_span=span)
    assert runs["port"][1] == runs["ref"][1]
    # and each stream is the model-level greedy stream
    for req_id, toks in runs["port"][1]:
        assert toks == reference_greedy[seeds[req_id]][0]
    eng = runs["port"][0]
    assert eng.stats["host_syncs"] == (eng.stats["prefills"]
                                       + eng.stats["decode_spans"])
    assert eng.stats["decode_steps"] == runs["ref"][0].stats["decode_steps"]


@pytest.mark.parametrize("span", [1, 8])
def test_parking_under_page_pressure_matches_reference(model,
                                                       reference_greedy,
                                                       span):
    seeds = [1, 9, 2, 0]
    _assert_margins(reference_greedy, seeds)
    runs = _run_both(model, seeds, n_pages=9, decode_span=span)
    ref_eng, port_eng = runs["ref"][0], runs["port"][0]
    assert ref_eng.stats["parked"] > 0
    assert port_eng.stats["parked"] == ref_eng.stats["parked"]
    for key in ("unparked", "span_shrinks", "preempt_restarts",
                "page_allocs", "decode_steps"):
        assert port_eng.stats[key] == ref_eng.stats[key], key
    assert runs["port"][1] == runs["ref"][1]
    assert port_eng.stats["host_syncs"] == (port_eng.stats["prefills"]
                                            + port_eng.stats["decode_spans"])
    assert port_eng.stats["pages_peak"] <= 9
    assert port_eng.pool.n_free == port_eng.pool.n_pages


@pytest.mark.parametrize("setting", [
    {"kv_layout": "latent"}, {"kv_layout": "no-such-layout"}])
def test_unsupported_settings_raise(setting):
    """An unknown layout is refused by the config; 'latent' is refused
    for qwen3-8b, which has no MLA layer, by the backend."""
    with pytest.raises(ValueError):
        ecfg = api.EngineConfig(**setting)
        api.make_state_backend(ecfg.kv_layout, SMOKE_CONFIGS["qwen3-8b"],
                               ecfg, "cpu")


def test_non_greedy_request_rejected_at_submit(model):
    _, _, tcfg, tp = model
    eng = ServingEngine(tcfg, tp, api.EngineConfig(cache_len=L, page_size=PS,
                                                   n_pages=16),
                        device="cpu")
    with pytest.raises(ValueError):
        eng.submit(api.Request(1, np.ones(L, np.int32)))   # len + 1 > L
    # sampled requests are served since stochastic sampling was ported
    eng.submit(api.Request(0, _prompt(0), max_new_tokens=4,
                           sampling=api.SamplingParams(temperature=0.7)))
    done = eng.run_until_done()
    assert [(r.req_id, len(r.tokens_out)) for r in done] == [(0, 4)]


def test_prefix_cache_copy_matches_reference():
    """The copied block cache answers like the reference on one op
    sequence (the engines' use of it: tests/test_torch_chunked.py)."""
    rng = np.random.default_rng(0)
    base = rng.integers(1, 100, size=40).astype(np.int32)
    prompts = [base, np.concatenate([base[:24], base[:9]]), base[:17],
               rng.integers(1, 100, size=30).astype(np.int32)]
    caches = [JPrefixCache(capacity=5, block=8), PrefixCache(capacity=5,
                                                             block=8)]
    logs = [[], []]
    for c, log in zip(caches, logs):
        for i, p in enumerate(prompts):
            log.append(c.match(p))
            log.append(c.insert(p, len(p) // 8, lambda b, i=i: (i, b)))
        log.append((c.evict_one(), len(c), c.hits, c.misses,
                    c.tokens_reused, c.hit_rate))
    assert logs[0] == logs[1]


@pytest.mark.parametrize("name", ["fcfs", "priority", "round_robin"])
def test_schedulers_pop_like_reference(name):
    """Same submits, pops and requeues: same admission order."""
    rng = np.random.default_rng(4)
    qos = rng.integers(0, 4, size=20)
    orders = []
    for mod in (japi, api):
        sched = mod.make_scheduler(name, n_classes=3, capacity=64)
        reqs = [mod.Request(i, np.ones(2, np.int32), qos=int(q))
                for i, q in enumerate(qos)]
        order = []
        for r in reqs[:12]:
            assert sched.submit(r)
        for _ in range(5):
            order.append(sched.next().req_id)
        assert sched.requeue(reqs[order[1]])
        for r in reqs[12:]:
            assert sched.submit(r)
        while sched.pending:
            order.append(sched.next().req_id)
        orders.append((order, sched.space))
    assert orders[0] == orders[1]


def test_decode_step_reads_nothing_back_inside_the_span(model):
    """A pure decode step (span 8) makes no scalar device read: the only
    transfer is the accounted `_host_sync` of the span's tokens."""
    from torch.profiler import ProfilerActivity, profile
    _, _, tcfg, tp = model
    eng = ServingEngine(tcfg, tp, api.EngineConfig(
        slots=3, cache_len=L, page_size=PS, n_pages=24, eos_token=-1,
        kv_layout="paged"), device="cpu")
    for i, s in enumerate([0, 3, 8]):
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
