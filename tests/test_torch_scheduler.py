"""Engine-level scheduler scenarios of tests/test_scheduler_api.py on the
port's engine, each held to the reference engine on the same requests:
policy equivalence under one QoS class, strict-priority and round-robin
completion order under mixed classes, the requeue class, registry
conformance, queue backpressure and priority-safe eviction. The fp32
tiny qwen3 of tests/test_sampling.py, weights bridged from the JAX
package; the port on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.schedulers import (FcfsScheduler,  # noqa: E402
                                          PriorityScheduler,
                                          RoundRobinScheduler)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BUILTINS = ("fcfs", "priority", "round_robin")
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    jcfg = J_SMOKE["qwen3-8b"].scaled(**TINY)
    tcfg = SMOKE_CONFIGS["qwen3-8b"].scaled(**TINY)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return {"ref": (japi, jcfg, jp), "port": (api, tcfg, tp)}


def _engine(side, tiny, **kw):
    mod, cfg, params = tiny[side]
    ecfg = mod.EngineConfig(**kw)
    if side == "ref":
        return mod.make_engine(cfg, params, ecfg)
    return mod.make_engine(cfg, params, ecfg, device="cpu")


def _run(side, tiny, reqs, scheduler, slots=1, **kw):
    mod = tiny[side][0]
    eng = _engine(side, tiny, slots=slots, cache_len=64, n_pages=64,
                  page_size=8, eos_token=-1, scheduler=scheduler,
                  qos_classes=2, **kw)
    for i, prompt, qos in reqs:
        eng.submit(mod.Request(i, prompt.copy(), max_new_tokens=4, qos=qos))
    done = eng.run_until_done()
    assert len(done) == len(reqs)
    return done, eng


def _outcome(done, eng):
    return ([r.req_id for r in done],
            {r.req_id: list(r.tokens_out) for r in done},
            {k: v for k, v in eng.stats.items()})


def _like_reference(tiny, reqs, scheduler, **kw):
    """The port's completion order, streams and counters equal the
    reference's; returns the port's (done, engine)."""
    port = _run("port", tiny, reqs, scheduler, **kw)
    ref = _run("ref", tiny, reqs, scheduler, **kw)
    p_order, p_streams, p_stats = _outcome(*port)
    r_order, r_streams, r_stats = _outcome(*ref)
    assert (p_order, p_streams) == (r_order, r_streams)
    assert p_stats == {k: v for k, v in r_stats.items() if k in p_stats}
    return port


def _trace(n, qos, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, 256, size=int(rng.integers(6, 14)))
             .astype(np.int32), qos[i]) for i in range(n)]


def test_uniform_class_all_schedulers_identical(tiny):
    reqs = _trace(5, qos=[0] * 5)
    results = {}
    for sched in BUILTINS:
        done, _ = _like_reference(tiny, reqs, sched, slots=2)
        results[sched] = ([r.req_id for r in done],
                          {r.req_id: r.tokens_out for r in done})
    assert results["priority"] == results["fcfs"]
    assert results["round_robin"] == results["fcfs"]


def test_priority_reorders_completion_mixed_class(tiny):
    reqs = _trace(6, qos=[1, 1, 1, 0, 0, 0])
    fcfs_done, _ = _like_reference(tiny, reqs, "fcfs")
    prio_done, _ = _like_reference(tiny, reqs, "priority")
    assert [r.req_id for r in fcfs_done] == [0, 1, 2, 3, 4, 5]
    assert [r.req_id for r in prio_done] == [3, 4, 5, 0, 1, 2]
    assert ({r.req_id: r.tokens_out for r in prio_done}
            == {r.req_id: r.tokens_out for r in fcfs_done})


def test_round_robin_interleaves_classes(tiny):
    reqs = _trace(6, qos=[1, 1, 1, 0, 0, 0])
    done, _ = _like_reference(tiny, reqs, "round_robin")
    assert [r.req_id for r in done] == [3, 0, 4, 1, 5, 2]


def test_requeue_preserves_qos_class():
    sched = api.make_scheduler("priority", n_classes=3)
    low = api.Request(0, np.arange(3, dtype=np.int32), qos=2)
    sched.submit(low)
    got = sched.next()
    assert got is low
    sched.requeue(got)
    assert sched.mq.qlen(2) == 1
    mid = api.Request(1, np.arange(3, dtype=np.int32), qos=1)
    sched.submit(mid)
    assert sched.next() is mid
    assert sched.next() is low


def test_scheduler_class_clamping():
    sched = api.make_scheduler("priority", n_classes=2)
    assert sched.class_of(api.Request(0, np.arange(2), qos=-3)) == 0
    assert sched.class_of(api.Request(1, np.arange(2), qos=99)) == 1
    fcfs = api.make_scheduler("fcfs", n_classes=8)
    assert fcfs.n_classes == 1
    assert fcfs.class_of(api.Request(2, np.arange(2), qos=5)) == 0


def _lifo():
    class LifoScheduler:
        n_classes = 1

        def __init__(self, n_classes=1, capacity=1024):
            self._stack = []

        def class_of(self, req):
            return 0

        def submit(self, req):
            self._stack.append(req)
            return True

        requeue = submit

        def next(self):
            return self._stack.pop() if self._stack else None

        def export(self):
            return [list(self._stack)], {}

        def import_(self, queues, aux):
            self._stack = [r for q in queues for r in q]

        @property
        def pending(self):
            return len(self._stack)

        @property
        def space(self):
            return 1024 - len(self._stack)
    return LifoScheduler


def test_third_party_scheduler_via_registry(tiny):
    """One class, defined outside src/, plugs into both engines."""
    cls = _lifo()
    api.register_scheduler("lifo-test")(cls)
    japi.register_scheduler("lifo-test")(cls)
    try:
        done, eng = _like_reference(tiny, _trace(3, qos=[0, 0, 0]),
                                    "lifo-test")
        assert isinstance(eng.sched, cls)
        assert [r.req_id for r in done] == [2, 1, 0]
    finally:
        del api.SCHEDULERS["lifo-test"]
        del japi.SCHEDULERS["lifo-test"]


def test_registry_rejects_nonconforming_scheduler():
    with pytest.raises(TypeError, match=r"missing property `space`"):
        @api.register_scheduler("broken-test")
        class BrokenScheduler:
            n_classes = 1

            def __init__(self, n_classes=1, capacity=1024):
                pass

            def class_of(self, req):
                return 0

            def submit(self, req):
                return True

            requeue = submit

            def next(self):
                return None

            @property
            def pending(self):
                return 0
    assert "broken-test" not in api.SCHEDULERS


def test_registry_rejects_arity_mismatch():
    with pytest.raises(TypeError, match=r"`submit` requires 2"):
        @api.register_scheduler("arity-test")
        class ArityScheduler:
            n_classes = 1

            def __init__(self, n_classes=1, capacity=1024):
                pass

            def class_of(self, req):
                return 0

            def submit(self, req, deadline):
                return True

            def requeue(self, req):
                return True

            def next(self):
                return None

            @property
            def pending(self):
                return 0

            @property
            def space(self):
                return 1

    assert "arity-test" not in api.SCHEDULERS


def test_full_queue_rejects_submit_loudly(tiny):
    eng = _engine("port", tiny, slots=1, cache_len=64, n_pages=64,
                  page_size=8, eos_token=-1, queue_capacity=2)
    for i in range(2):
        eng.submit(api.Request(i, np.arange(1, 5, dtype=np.int32),
                               max_new_tokens=2))
    with pytest.raises(RuntimeError, match="queue full"):
        eng.submit(api.Request(2, np.arange(1, 5, dtype=np.int32),
                               max_new_tokens=2))
    assert len(eng.run_until_done()) == 2


def _eviction_run(side, tiny):
    mod = tiny[side][0]
    eng = _engine(side, tiny, slots=2, cache_len=64, n_pages=4, page_size=8,
                  eos_token=-1, kv_layout="paged", scheduler="priority",
                  qos_classes=2, decode_span=1)
    rng = np.random.default_rng(7)
    hi = mod.Request(0, rng.integers(1, 256, size=20).astype(np.int32),
                     max_new_tokens=4, qos=0)
    eng.submit(hi)
    eng.step()
    assert eng.active[0]
    lo = mod.Request(1, rng.integers(1, 256, size=10).astype(np.int32),
                     max_new_tokens=4, qos=1)
    eng.submit(lo)
    done = eng.run_until_done()
    return eng, done


def test_eviction_never_inverts_priority(tiny):
    eng, done = _eviction_run("port", tiny)
    ref_eng, ref_done = _eviction_run("ref", tiny)
    assert eng.stats["parked"] == 0
    assert [r.req_id for r in done] == [0, 1]
    assert _outcome(done, eng)[:2] == _outcome(ref_done, ref_eng)[:2]
    assert eng.stats == {k: v for k, v in ref_eng.stats.items()
                         if k in eng.stats}


def test_unknown_scheduler_rejected(tiny):
    with pytest.raises(ValueError, match="unknown scheduler"):
        _engine("port", tiny, scheduler="nope")


def test_unknown_kv_layout_rejected(tiny):
    """The port refuses the layout when the config is built (it names the
    layouts it serves); the reference when the engine is."""
    with pytest.raises(ValueError, match="not ported yet"):
        _engine("port", tiny, kv_layout="sparse")
    with pytest.raises(ValueError, match="unknown kv layout"):
        _engine("ref", tiny, kv_layout="sparse")


def test_uniform_class_equivalence_paged_backend(tiny):
    reqs = _trace(4, qos=[0] * 4, seed=3)
    results = {}
    for sched in BUILTINS:
        done, eng = _like_reference(tiny, reqs, sched, slots=2,
                                    kv_layout="paged")
        eng.prefix.clear()
        assert eng.pool.n_free == eng.pool.n_pages
        results[sched] = {r.req_id: r.tokens_out for r in done}
    assert results["priority"] == results["fcfs"]
    assert results["round_robin"] == results["fcfs"]


def test_default_page_budget_covers_dense_worst_case():
    assert api.default_page_budget(4, 160, 16) == (4 + 1) * 10
    assert api.default_page_budget(3, 100, 16) == 4 * 7
    for n in BUILTINS:
        assert api.make_scheduler(n).name == n
    assert {api.SCHEDULERS[n] for n in BUILTINS} == {
        FcfsScheduler, PriorityScheduler, RoundRobinScheduler}
