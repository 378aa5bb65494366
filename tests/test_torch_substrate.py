"""The JingZhao substrate in the port against the JAX package: the device
multiqueue (``MQState``, ``mq_*``), ``batched_enqueue`` (and B7's plain
version at its positions), the VoQ resource store and its blocking
strawman, the event simulator, the PPU/Stage/Pipeline model with its
H100 bound, and the ``kernels.ops`` facade.

Inputs are the same numpy arrays on both sides (hypothesis draws the op
sequences, as tests/test_core_properties.py does); the port runs on the
CPU. Everything is compared exactly: the ring buffers move values
without arithmetic, the simulator and the store are host code.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (requirements.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import multiqueue as jmq  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import resource as jres  # noqa: E402
from repro.core import simulation as jsim  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import multiqueue as mq  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core import resource as res  # noqa: E402
from repro_torch.core import simulation as sim  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

Q, CAP, P = 4, 3, (2,)


# ---------------------------------------------------------------------------
# the device multiqueue
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.integers(0, Q - 1),
                          st.integers(-1000, 1000)),
                min_size=1, max_size=80))
def test_mq_sequence_equals_reference(ops_):
    """Pushes and pops on 4 queues of capacity 3 (so the rings wrap and
    fill): every ok, item and size, and the final buffers and counters,
    equal the reference's."""
    js = jmq.mq_init(Q, CAP, P)
    ts = mq.mq_init(Q, CAP, P, device="cpu")
    for push, q, val in ops_:
        item = np.full(P, val, np.float32)
        if push:
            js, jok = jmq.mq_push(js, jnp.int32(q), jnp.asarray(item))
            ts, ok = mq.mq_push(ts, torch.tensor(q, dtype=torch.int32),
                                torch.from_numpy(item))
        else:
            js, jitem, jok = jmq.mq_pop(js, jnp.int32(q))
            ts, got, ok = mq.mq_pop(ts, torch.tensor(q, dtype=torch.int32))
            np.testing.assert_array_equal(got.numpy(), np.asarray(jitem))
            assert got.shape == P
        assert ok.dim() == 0 and bool(ok) == bool(jok)
        np.testing.assert_array_equal(mq.mq_sizes(ts).numpy(),
                                      np.asarray(jmq.mq_sizes(js)))
    np.testing.assert_array_equal(ts.buf.numpy(), np.asarray(js.buf))
    np.testing.assert_array_equal(ts.head.numpy(), np.asarray(js.head))
    np.testing.assert_array_equal(ts.tail.numpy(), np.asarray(js.tail))


def test_in_graph_mq_roundtrip():
    """The reference test's sequence, with a scalar payload queue too."""
    state = mq.mq_init(4, 8, (2,), device="cpu")
    one = torch.tensor(1, dtype=torch.int32)
    state, ok = mq.mq_push(state, one, torch.ones(2))
    assert bool(ok)
    state, ok = mq.mq_push(state, one, 2 * torch.ones(2))
    state, item, ok = mq.mq_pop(state, one)
    assert bool(ok) and float(item[0]) == 1.0
    state, item2, ok2 = mq.mq_pop(state, one)
    assert bool(ok2) and float(item2[0]) == 2.0
    _, _, ok3 = mq.mq_pop(state, torch.tensor(0, dtype=torch.int32))
    assert not bool(ok3)
    s = mq.mq_init(2, 2, (), dtype=torch.int32, device="cpu")
    for v in (5, 6, 7):
        s, ok = mq.mq_push(s, one, torch.tensor(v))
    assert mq.mq_sizes(s).tolist() == [0, 2] and not bool(ok)
    s, v, ok = mq.mq_pop(s, one)
    assert v.shape == () and int(v) == 5


# ---------------------------------------------------------------------------
# batched enqueue
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 3), min_size=1, max_size=64),
       st.integers(1, 12), st.integers(1, 5))
def test_batched_enqueue_equals_reference_and_b7(queue_ids, capacity, D):
    """Buffers, positions and kept as the reference's; the buffers equal
    B7's plain version (``moe_dispatch`` on the CPU) at those positions."""
    T = len(queue_ids)
    items = (np.arange(T * D, dtype=np.float32).reshape(T, D) + 1.0)
    qs = np.asarray(queue_ids, np.int32)
    jb, jp, jk = jmq.batched_enqueue(jnp.asarray(items), jnp.asarray(qs),
                                     n_queues=4, capacity=capacity)
    buf, pos, kept = mq.batched_enqueue(torch.from_numpy(items),
                                        torch.from_numpy(qs), 4, capacity)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    assert pos.dtype == torch.int32 and kept.dtype == torch.bool
    b7 = md.moe_dispatch(torch.from_numpy(items), torch.from_numpy(qs), pos,
                         4, capacity)
    assert torch.equal(b7, buf)


def test_batched_enqueue_bf16_at_moe_shape():
    """bf16 rows at a routed shape (T 600, E 16, C 40): equal to B7's
    plain version and to the kernel's own tile algorithm."""
    rng = np.random.default_rng(0)
    T, D, E, C = 600, 64, 16, 40
    items = torch.from_numpy(rng.standard_normal((T, D)).astype(
        np.float32)).to(torch.bfloat16)
    qs = torch.from_numpy(rng.integers(0, E, size=T).astype(np.int32))
    buf, pos, kept = mq.batched_enqueue(items, qs, E, C)
    assert (~kept).any() and kept.any()
    assert torch.equal(buf, md.moe_dispatch_plain(items, qs, pos, E, C))
    assert torch.equal(buf, md.moe_dispatch_tiles_plain(items, qs, pos, E, C))


# ---------------------------------------------------------------------------
# the VoQ resource store and the simulator
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(store_cls, bus_cls, blocking, seed):
    """One trace of lookups over 6 connections and 10 keys, polls and
    clock steps: every return and the final stats."""
    clock = _Clock()
    store = store_cls(lambda k: np.full(2, k, np.float32), capacity_items=4,
                      item_bytes=4096.0,
                      bus=bus_cls(latency_s=1e-6, bandwidth_Bps=4e9),
                      blocking=blocking, n_connections=8, now=clock)
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(200):
        r = rng.random()
        if r < 0.6:
            conn, key = int(rng.integers(0, 6)), int(rng.integers(0, 10))
            got = store.lookup(conn, key)
            trace.append(("lookup", conn, key,
                          None if got is None else got.tolist()))
        elif r < 0.8:
            trace.append(("poll", sorted(store.poll())))
        else:
            clock.t += float(rng.choice([2e-7, 1e-6, 3e-6]))
        trace.append(("resident", [store.resident(k) for k in range(10)]))
    return trace, dict(store.stats)


@pytest.mark.parametrize("blocking", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voq_store_equals_reference(blocking, seed):
    got = _drive(res.VoQResourceStore, res.BusModel, blocking, seed)
    want = _drive(jres.VoQResourceStore, jres.BusModel, blocking, seed)
    assert got == want
    if blocking:
        assert got[1]["stalled_lookups"] > 0


def test_voq_store_wait_all_and_default_clock():
    """``wait_all`` on the port's clock completes every fetch; a miss
    parks only its own key: the other connection's resident key hits."""
    store = res.VoQResourceStore(lambda k: np.zeros(1), capacity_items=8,
                                 item_bytes=64.0)
    assert store.lookup(0, "a") is None
    store.wait_all()
    assert store.resident("a")
    assert store.lookup(1, "b") is None
    assert store.lookup(0, "a") is not None
    store.invalidate("a")
    assert not store.resident("a")
    assert store.stats["hits"] == 1 and store.stats["misses"] == 2


SIM_CONFIGS = [dict(miss_rate=m, policy=p) for m in (0.0, 1.0)
               for p in ("voq", "blocking")] + [
    dict(miss_rate=0.3, policy="voq", n_requests=5000, seed=3),
    dict(miss_rate=0.3, policy="blocking", payload_bytes=256, seed=4)]


@pytest.mark.parametrize("kw", SIM_CONFIGS,
                         ids=[f"{k['policy']}-{k['miss_rate']}"
                              f"-{k.get('seed', 0)}" for k in SIM_CONFIGS])
def test_simulate_equals_reference(kw):
    assert sim.simulate(sim.SimConfig(**kw)) == jsim.simulate(
        jsim.SimConfig(**kw))
    assert vars(sim.SimConfig(**kw)) == vars(jsim.SimConfig(**kw))


def test_voq_bandwidth_loss_and_blocking_collapse():
    """The reference's two claim tests on the port's simulator."""
    base = sim.simulate(sim.SimConfig(miss_rate=0.0))
    miss = sim.simulate(sim.SimConfig(miss_rate=1.0))
    loss = 1 - miss["bandwidth_Gbps"] / base["bandwidth_Gbps"]
    assert 0 < loss < 2.5 * sim.miss_overhead_model(4096) + 0.02
    assert sim.miss_overhead_model(4096) == jsim.miss_overhead_model(4096)
    voq = sim.simulate(sim.SimConfig(miss_rate=1.0, policy="voq"))
    blk = sim.simulate(sim.SimConfig(miss_rate=1.0, policy="blocking"))
    assert blk["bandwidth_Gbps"] < 0.6 * voq["bandwidth_Gbps"]
    assert blk["p99_latency_us"] > voq["p99_latency_us"]


# ---------------------------------------------------------------------------
# PPU / Stage / Pipeline
# ---------------------------------------------------------------------------

def _pipeline(mod, xp):
    """norm -> scale (2 replicas) -> residual, with cost hooks."""
    def n(x):
        return 4.0 * int(np.prod(x.shape))
    norm = mod.PPU("norm", lambda x: x / xp.sqrt((x * x).mean() + 1e-6),
                   bytes_per_call=lambda x: 2 * n(x),
                   flops_per_call=lambda x: 3 * n(x) / 4)
    scale = mod.PPU("scale", lambda x, s=2.0: x * s,
                    flops_per_call=lambda x: 1e6 * n(x), replicas=2)
    resid = mod.PPU("resid", lambda x: x + 1.0,
                    bytes_per_call=lambda x: 3 * n(x))
    return (mod.Pipeline("p").add(mod.Stage("a", [norm]))
            .add(mod.Stage("b", [scale, resid])))


def test_pipeline_composition_equals_reference():
    x = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    tp = _pipeline(pipe, torch)
    jp = _pipeline(jpipe, jnp)
    want = np.asarray(jp(jnp.asarray(x)))
    got = tp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(tp.jit()(torch.from_numpy(x)), got)
    assert [s.name for s in tp.stages] == [s.name for s in jp.stages]


def test_bound_stage_prices_an_h100():
    """Each PPU at max(bytes / 3.35 TB/s, operations / 989 TFLOP/s) over
    its replicas (NVIDIA H100 80GB HBM3 at 700 W, data-sheet peaks)."""
    assert (pipe.HBM_BYTES_PER_S, pipe.BF16_FLOPS_PER_S) == (3.35e12,
                                                             989e12)
    x = torch.zeros(8, 16)
    name, t = _pipeline(pipe, torch).bound_stage(x)
    nb = 4.0 * 128
    a = max(2 * nb / 3.35e12, 0.75 * nb / 989e12)
    b = max(0.0, 1e6 * nb / 989e12) / 2 + 3 * nb / 3.35e12
    assert name == ("b" if b > a else "a")
    assert t == pytest.approx(max(a, b), rel=1e-12)


def test_measure_ppu_on_the_cpu():
    calls = []
    us = pipe.measure_ppu(lambda x: calls.append(1) or x + 1,
                          torch.zeros(4), iters=5, warmup=2)
    assert us > 0 and len(calls) == 7


def test_core_exports_the_reference_names():
    import repro.core as jcore
    names = [n for n in dir(jcore) if not n.startswith("_")
             and n not in ("multiqueue", "pipeline", "primitives",
                           "resource", "simulation", "transport", "timing")]
    assert names and all(hasattr(core, n) for n in names)


# ---------------------------------------------------------------------------
# the kernels' facade
# ---------------------------------------------------------------------------

OPS = {
    "flash_attention": ("flash_attention", (1, 2, 3), {"window": 5},
                        {"window": 5}),
    "paged_decode_attention": ("paged_attention", (1, 2, 3, 4, 5), {}, {}),
    "sample_logits": ("sampling", (1, 2, 3, 4, 5), {}, {}),
    "moe_dispatch": ("moe_dispatch", (1, 2, 3, 4, 5), {}, {}),
    "linear_scan": ("linear_scan", (1, 2, 3), {"block_d": 128}, {}),
    "wkv6_chunked": ("wkv6", (1, 2, 3, 4, 5, 6), {"chunk": 16},
                     {"chunk": 16}),
    "wkv6_decode": ("wkv6", (1, 2, 3, 4, 5, 6), {}, {}),
    "ssm_decode_step": ("ssm_decode", (1, 2, 3, 4, 5), {"block_d": 64}, {}),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_name_reaches_its_wrapper(name, monkeypatch):
    """Each facade name calls its port wrapper with the arguments given
    (the TPU tile sizes dropped); ``interpret=True`` is refused."""
    import importlib
    mod_name, args, kw, passed = OPS[name]
    mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
    seen = []
    monkeypatch.setattr(mod, name, lambda *a, **k: seen.append((a, k)) or
                        "out")
    assert getattr(ops, name)(*args, **kw) == "out"
    assert seen == [(args, passed)]
    if name != "sample_logits":
        with pytest.raises(ValueError, match="interpret"):
            getattr(ops, name)(*args, interpret=True)


def test_ops_flash_attention_on_the_cpu_is_the_wrappers():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 40, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(
        np.float32))
    from repro_torch.kernels import flash_attention as fa
    assert torch.equal(ops.flash_attention(q, k, v, block_q=64),
                       fa.flash_attention(q, k, v))
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(q, k, v, causal=False)
