"""Crash and restore in the port (``repro_torch.ft``, engine snapshots,
the Checkpointer) against the JAX package's.

Every scenario runs the port on the CPU beside the reference with the
same settings, the same trace and the same fault schedule, on the fp32
tiny qwen3 of tests/test_crash_recovery.py (and, for the four-layout
matrix, the tiny rwkv6 and deepseek of tests/test_state_backends.py)
with the reference's weights bridged through ``models/convert.py``. The
port must keep every client stream byte-identical through a crash at
any step boundary, a stale snapshot, either recovery policy, a cold
restart and a round trip through disk, and give the reference's
streams, outcomes, crash logs and engine counters. Its snapshots equal
the reference's at the same boundary: every JSON-able part exactly,
lengths and positions exactly, page and slab contents within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ft as jft  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.ft import chaos as jchaos  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import loadgen as jlg  # noqa: E402
from repro_torch import ft as tft  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, latest_step,  # noqa: E402
                                    pack_tree, unpack_tree)
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.ft import chaos as tchaos  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve import loadgen as tlg  # noqa: E402


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
SIDES = ("ref", "port")
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, dtype="float32")


def _bridge(arch, scale, jextra=None, textra=None):
    jcfg = J_SMOKE[arch].scaled(**scale, **(jextra or {}))
    tcfg = SMOKE_CONFIGS[arch].scaled(**scale, **(textra or {}))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return {"ref": (jcfg, jp), "port": (tcfg, tp)}


@pytest.fixture(scope="module")
def tiny():
    """family -> {side: (cfg, params)}: the fp32 tiny configs of the
    reference's crash and state-backend tests."""
    small = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                 head_dim=32, d_ff=128, vocab_size=256, dtype="float32")
    mla = {side: dict(
        mla=b.MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16,
                        qk_rope_dim=8, v_head_dim=16),
        moe=b.MoEConfig(n_experts=4, top_k=2, d_expert=48, n_shared=1,
                        first_dense=1))
        for side, b in (("ref", jbase), ("port", tbase))}
    return {
        "attn": _bridge("qwen3-8b", TINY),
        "rwkv": _bridge("rwkv6-1.6b", small,
                        dict(rwkv=jbase.RWKVConfig(head_dim=32)),
                        dict(rwkv=tbase.RWKVConfig(head_dim=32))),
        "mla": _bridge("deepseek-v2-lite-16b", small, mla["ref"],
                       mla["port"]),
    }


def _mods(side):
    return (jft, jchaos, jlg, japi) if side == "ref" \
        else (tft, tchaos, tlg, api)


def _dev(side):
    return {} if side == "ref" else {"device": "cpu"}


# the reference's crash-test trace (tests/test_crash_recovery.py)
SPEC = dict(arrival="bursty", rate=0.5, burst=3.0, seed=5,
            prompt_lens=((1.0, 6, 18),), output_lens=((1.0, 4, 10),),
            qos_weights=(1.0, 1.0))
# and the four-layout matrix's (tests/test_state_backends.py)
MATRIX_SPEC = dict(arrival="bursty", rate=0.5, burst=4.0, seed=3,
                   prompt_lens=((1.0, 5, 14),),
                   output_lens=((1.0, 5, 10),))


def _trace_fn(side, vocab, n=4, spec=SPEC):
    lg = _mods(side)[2]
    return lambda: lg.make_trace(lg.TraceSpec(**spec), n, vocab)


def _kw(**over):
    kw = dict(slots=3, cache_len=96, kv_layout="paged", n_pages=64,
              page_size=8, decode_span=2, eos_token=-1,
              scheduler="priority", qos_classes=2, admit_capacity=64)
    kw.update(over)
    return kw


def _matrix_kw(layout, **over):
    kw = dict(slots=2, cache_len=64, page_size=8, n_pages=24,
              kv_layout=layout, decode_span=4, eos_token=-1)
    kw.update(over)
    return kw


def _drive(side, models, kw, n=4, spec=SPEC, **faults):
    cfg, params = models[side]
    ft = _mods(side)[0]
    return ft.drive(cfg, params, kw,
                    _trace_fn(side, cfg.vocab_size, n, spec)(),
                    **faults, **_dev(side))


def _report(r):
    """What a run must reproduce: streams, outcomes, logs, counters."""
    return {"steps": r.steps, "streams": r.streams, "outcomes": r.outcomes,
            "engine": r.engine_stats, "frontend": r.frontend_stats,
            "fault_log": r.fault_log, "crash_log": r.crash_log}


def _both(models, kw, n=4, spec=SPEC, **faults):
    """The same run on both stacks; the port's report must equal the
    reference's. Returns the port's ChaosReport."""
    got = {side: _drive(side, models, kw, n, spec, **faults)
           for side in SIDES}
    assert _report(got["port"]) == _report(got["ref"])
    return got["port"]


# ---------------------------------------------------------------------------
# the acceptance sweep: a crash at EVERY boundary, both layouts x spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,span", [
    ("paged", 1), ("paged", 8), ("dense", 1), ("dense", 8)])
def test_crash_anywhere_every_boundary(tiny, layout, span):
    tcfg, tp = tiny["attn"]["port"]
    kw = _kw(kv_layout=layout, decode_span=span)
    clean, reports = tft.crash_anywhere_sweep(
        tcfg, tp, kw, _trace_fn("port", tcfg.vocab_size, n=6),
        device="cpu")
    assert clean.steps >= 3 and len(reports) == clean.steps
    assert all(len(r.crash_log) == 1 for r in reports)
    assert all(set(r.outcomes) == set(clean.outcomes) for r in reports)
    # the fault-free run is the reference's
    assert _report(clean) == _report(
        _drive("ref", tiny["attn"], kw, n=6))


@pytest.mark.parametrize("family,layout", [
    ("attn", "dense"), ("attn", "paged"), ("rwkv", "recurrent"),
    ("mla", "latent")])
def test_crash_restore_four_layouts_like_reference(tiny, family, layout):
    """The four-layout matrix: crashes at boundaries (1, 2, 3) keep every
    stream, and each crashed run (streams, outcomes, crash log, counters)
    equals the reference's under the same schedule."""
    models = tiny[family]
    tcfg, tp = models["port"]
    clean, reports = tft.crash_anywhere_sweep(
        tcfg, tp, _matrix_kw("dense"),
        _trace_fn("port", tcfg.vocab_size, 4, MATRIX_SPEC),
        boundaries=(1, 2, 3), backend=layout, device="cpu")
    assert len(reports) == 3
    for s, r in zip((1, 2, 3), reports):
        ref = _drive("ref", models, _matrix_kw(layout), 4, MATRIX_SPEC,
                     crash_at=(s,))
        assert _report(r) == _report(ref)
    assert _report(clean) == _report(
        _drive("ref", models, _matrix_kw(layout), 4, MATRIX_SPEC))


# ---------------------------------------------------------------------------
# recovery policies: stale snapshot, per class, replay, cold restart
# ---------------------------------------------------------------------------

def test_stale_snapshot_restore_dedupes(tiny):
    kw = _kw()
    clean = _drive("port", tiny["attn"], kw)
    at = max(4, clean.steps // 2)
    r = _both(tiny["attn"], kw, crash_at=(at,), snapshot_every=3)
    assert r.crash_log[0]["restored_from"] == (at // 3) * 3
    assert r.streams == clean.streams and r.outcomes == clean.outcomes
    # a stale snapshot re-executes work: the log records what the dying
    # engine had done and what its successor starts from
    entry = r.crash_log[0]
    assert (entry["work_at_crash"]["decode_spans"]
            > entry["work_restored"]["decode_spans"])


def test_per_class_recovery_policy(tiny):
    kw = _kw()
    clean = _drive("port", tiny["attn"], kw)
    at = max(2, clean.steps // 2)
    r = _both(tiny["attn"], kw, crash_at=(at,),
              policy=("snapshot", "replay"))
    assert r.streams == clean.streams
    qos_of = {req.req_id: int(req.qos) for _, req in
              _trace_fn("port", 256)()}
    replayed = [rid for e in r.crash_log for rid in e["replayed"]]
    assert replayed and all(qos_of[rid] == 1 for rid in replayed)


def test_replay_all_policy(tiny):
    kw = _kw()
    clean = _drive("port", tiny["attn"], kw)
    at = max(2, clean.steps // 2)
    r = _both(tiny["attn"], kw, crash_at=(at,), policy=("sr",))
    assert r.streams == clean.streams
    assert r.crash_log[0]["replayed"]
    assert (r.engine_stats["preempt_restarts"]
            >= clean.engine_stats["preempt_restarts"])


def test_cold_restart_no_snapshot(tiny):
    kw = _kw()
    clean = _drive("port", tiny["attn"], kw)
    at = max(2, clean.steps // 2)
    r = _both(tiny["attn"], kw, crash_at=(at,), snapshot_every=0)
    assert r.crash_log[0]["restored_from"] is None
    assert r.streams == clean.streams and r.outcomes == clean.outcomes


def test_unknown_recovery_policy_rejected():
    with pytest.raises(ValueError, match="unknown recovery policy"):
        tft.policy_of(0, ("teleport",))
    for qos, policy in [(5, ("snapshot", "replay")), (0, ("gbn",)),
                        (1, ("snapshot", "sr")), (0, ())]:
        assert tft.policy_of(qos, policy) == jft.policy_of(qos, policy)
    assert tft.policy_of(5, ("snapshot", "replay")) == tft.POLICY_REPLAY
    assert tft.policy_of(0, ()) == tft.POLICY_SNAPSHOT


# ---------------------------------------------------------------------------
# mixed chaos: crash + park storm + kill, seeded schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_mixed_chaos(tiny, seed):
    kw = _kw()
    clean = _drive("port", tiny["attn"], kw, n=5)
    sched = tft.random_schedule(seed, clean.steps)
    assert sched == jft.random_schedule(seed, clean.steps)
    r = _both(tiny["attn"], kw, n=5, fault_seed=seed, **sched)
    assert r.streams == clean.streams, sched
    assert r.outcomes == clean.outcomes, sched
    assert len(r.crash_log) == len(set(sched["crash_at"]))


def test_fault_injector_deterministic(tiny):
    kw = _kw()
    faults = dict(park_storm_at=(5,), kill_at=(7, 11), fault_seed=13)
    runs = [_drive("port", tiny["attn"], kw, n=5, **faults)
            for _ in range(2)]
    assert _report(runs[0]) == _report(runs[1])
    assert any(e["slots"] for e in runs[0].fault_log)
    assert _report(runs[0]) == _report(
        _drive("ref", tiny["attn"], kw, n=5, **faults))


def test_fault_with_no_victims_logs_explicit_empty(tiny):
    r = _both(tiny["attn"], _kw(), park_storm_at=(0,), kill_at=(0,))
    assert {"step": 0, "fault": "park_storm", "slots": []} in r.fault_log
    assert {"step": 0, "fault": "kill", "slots": []} in r.fault_log


# ---------------------------------------------------------------------------
# restore refusals
# ---------------------------------------------------------------------------

def test_restore_rejects_mismatched_config_and_version(tiny):
    tcfg, tp = tiny["attn"]["port"]
    fe, _ = tft.build_stack(tcfg, tp, _kw(), device="cpu")
    snap = fe.engine.snapshot()
    fe2, _ = tft.build_stack(tcfg, tp, _kw(decode_span=4), device="cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        fe2.engine.restore(snap)
    with pytest.raises(ValueError, match="version"):
        fe.engine.restore(dict(snap, version=99))


# ---------------------------------------------------------------------------
# the snapshot itself against the reference's at the same boundary
# ---------------------------------------------------------------------------

def _ref_layers(tree, cfg):
    """The reference's {prefix, groups} cache tree as the port's list of
    per-layer {name: array} (groups unstacked)."""
    prefix, unit, n_groups = jtf.plan_layers(cfg)
    out = [{k: np.asarray(v) for k, v in layer.items()}
           for layer in tree["prefix"]]
    for g in range(n_groups):
        for j in range(len(unit)):
            out.append({k: np.asarray(v)[g]
                        for k, v in tree["groups"][f"b{j}"].items()})
    return out


def _close_layers(port, ref_tree, cfg):
    ref = _ref_layers(ref_tree, cfg)
    assert len(port) == len(ref)
    for t_layer, j_layer in zip(port, ref):
        assert set(t_layer) == set(j_layer)
        for k, t in t_layer.items():
            assert tuple(t.shape) == j_layer[k].shape, k
            np.testing.assert_allclose(t.float().numpy(), j_layer[k],
                                       atol=TOL, rtol=TOL)


SHARED = np.random.default_rng(100).integers(1, 256, 16).astype(np.int32)


def _prefix_reqs(mod, n=4, seed=9):
    """Requests under one two-page prefix, so the prefix cache holds
    entries at the snapshot."""
    rng = np.random.default_rng(seed)
    return [mod.Request(i, np.concatenate([SHARED, rng.integers(
                1, 256, size=int(rng.integers(3, 9))).astype(np.int32)]),
                max_new_tokens=int(rng.integers(6, 12)), qos=i % 2)
            for i in range(n)]


def _snapshot_at(side, models, kw, at, park_at):
    """Step a stack to boundary `at` (a park storm at `park_at` first)
    and snapshot there, after that step's hooks."""
    ft, chaos, _, mod = _mods(side)
    cfg, params = models[side]
    fe, _ = chaos.build_stack(cfg, params, kw, **_dev(side))
    ft.ServingFaultInjector(fe.engine, park_storm_at=(park_at,)).attach(fe)
    snaps = {}
    fe.step_hooks.append(
        lambda step: snaps.setdefault(step, fe.engine.snapshot())
        if step == at else None)
    for r in _prefix_reqs(mod):
        fe.submit(r)
    while at not in snaps:
        fe.step()
    return snaps[at]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_snapshot_equals_reference(tiny, layout):
    """At boundary 3 two slots decode (and a park storm parks them) while
    the third is mid-prefill, and the prefix cache holds the shared
    prefix's two blocks."""
    models = tiny["attn"]
    kw = _kw(kv_layout=layout, slots=3, prefill_chunk=8, prefill_budget=16)
    at = 3
    snaps = {side: _snapshot_at(side, models, kw, at, park_at=at)
             for side in SIDES}
    t, j = snaps["port"], snaps["ref"]
    tcfg, jcfg = models["port"][0], models["ref"][0]
    assert set(t) == set(j)
    for key in ("version", "config", "clock_t", "active", "running",
                "prefilling", "prefill_pos", "prefill_rr", "slot_req",
                "stalled", "sched", "completed", "stats"):
        assert t[key] == j[key], key
    assert any(t["prefilling"]) and t["sched"]["queues"] != [[], []]
    tkv, jkv = t["kv"], j["kv"]
    assert set(tkv) == set(jkv)
    assert tkv["pool"] == jkv["pool"]
    for key in ("lengths", "positions"):
        np.testing.assert_array_equal(tkv[key].numpy(), jkv[key])
    if layout == "paged":
        assert tkv["page_ids"] == jkv["page_ids"] and tkv["page_ids"]
        _close_layers(tkv["pages"], jkv["pages"], jcfg)
    else:
        _close_layers(tkv["caches"], jkv["caches"], jcfg)
    # the prefix cache: keys, parents and stats exact, payloads as coded
    assert t["prefix"]["stats"] == j["prefix"]["stats"]
    assert len(t["prefix"]["entries"]) == len(j["prefix"]["entries"]) > 0
    for (tk, tpar, tdata), (jk, jpar, jdata) in zip(
            t["prefix"]["entries"], j["prefix"]["entries"]):
        assert (tk, tpar) == (jk, jpar)
        if layout == "paged":
            assert tdata == jdata
        else:
            _close_layers(tdata, jdata, jcfg)
    # the parked payloads crossing the snapshot
    tt, jt = t["transport"], j["transport"]
    assert [[rid, meta] for rid, _, meta in tt["tier"]] == \
        [[rid, meta] for rid, _, meta in jt["tier"]]
    assert tt["tier"], "the park storm left nothing parked"
    assert tt["ready_at"] == jt["ready_at"]
    assert tt["bytes_moved"] == jt["bytes_moved"]
    for (_, tc, _), (_, jc, _) in zip(tt["tier"], jt["tier"]):
        _close_layers(tc, jc, jcfg)
    assert tcfg.n_layers == jcfg.n_layers


@pytest.mark.parametrize("family,layout", [("rwkv", "recurrent"),
                                           ("mla", "latent")])
def test_snapshot_equals_reference_other_layouts(tiny, family, layout):
    """At boundary 4, once as it is and once right after a park storm
    (which empties the latent pool into the host tier)."""
    models = tiny[family]
    kw = _matrix_kw(layout, slots=3)
    jcfg = models["ref"][0]
    for park_at in (-1, 4):
        snaps = {side: _snapshot_at(side, models, kw, 4, park_at=park_at)
                 for side in SIDES}
        t, j = snaps["port"], snaps["ref"]
        for key in ("config", "clock_t", "active", "running",
                    "prefill_pos", "slot_req", "sched", "completed",
                    "stats"):
            assert t[key] == j[key], key
        assert t["kv"]["pool"] == j["kv"]["pool"]
        for key in ("lengths", "positions"):
            np.testing.assert_array_equal(t["kv"][key].numpy(),
                                          j["kv"][key])
        if layout == "latent":
            assert t["kv"]["page_ids"] == j["kv"]["page_ids"]
            if park_at < 0:
                assert t["kv"]["page_ids"]
                _close_layers(t["kv"]["pages"], j["kv"]["pages"], jcfg)
            else:
                assert t["kv"]["pages"] is j["kv"]["pages"] is None
        else:
            _close_layers(t["kv"]["caches"], j["kv"]["caches"], jcfg)
        assert len(t["transport"]["tier"]) == len(j["transport"]["tier"])
        assert bool(t["transport"]["tier"]) == (park_at == 4)
        for (_, tc, tm), (_, jc, jm) in zip(t["transport"]["tier"],
                                            j["transport"]["tier"]):
            assert tm == jm
            _close_layers(tc, jc, jcfg)


def test_restore_writes_into_the_engines_own_tensors(tiny):
    """import_state copies into the fresh engine's tensors (their
    storage is kept), re-exports the page table at the crashed engine's
    width bucket, and gives the snapshot's bits back."""
    tcfg, tp = tiny["attn"]["port"]
    fe, rebuild = tft.build_stack(tcfg, tp, _kw(), device="cpu")
    for r in _prefix_reqs(api):
        fe.submit(r)
    for _ in range(5):
        fe.step()
    eng = fe.engine
    snap = eng.snapshot()
    eng2 = rebuild()
    ptrs = [t.data_ptr() for layer in eng2.state["caches"]
            for t in layer.values()]
    eng2.restore(snap)
    assert ptrs == [t.data_ptr() for layer in eng2.state["caches"]
                    for t in layer.values()]
    ids = snap["kv"]["page_ids"]
    for a, b in zip(eng.state["caches"], eng2.state["caches"]):
        for k in a:
            assert torch.equal(a[k][ids], b[k][ids])
    for k in ("lengths", "positions"):
        assert torch.equal(eng.state[k], eng2.state[k])
    req_ids = [r.req_id if r is not None else None for r in eng.slot_req]
    eng.kv.mark_dirty()
    eng.kv.sync(eng.state, req_ids)
    eng2.kv.sync(eng2.state, req_ids)
    assert torch.equal(eng.state["page_table"], eng2.state["page_table"])


# ---------------------------------------------------------------------------
# the codecs: pack_tree / unpack_tree and the Checkpointer
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_pack_tree_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"bf": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "f32": torch.randn(4, generator=g),
            "i32": torch.arange(6, dtype=torch.int32),
            "np": np.arange(4, dtype=np.int64),
            "b": [None, True, 2.5], "c": {"e": "x"},
            "t": (1, torch.zeros(3, dtype=torch.bool))}
    leaves, meta = pack_tree(tree)
    assert len(leaves) == 5
    assert meta["bf"] == {"__leaf__": 0, "dtype": "bfloat16"}
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(1, leaves, extra={"tree": meta}, blocking=True)
    disk_meta, disk_leaves = ckpt.load()
    # npz holds the bf16 leaf upcast to float32, as the reference's does
    assert disk_meta["leaves"][0]["dtype"] == "float32"
    for back in (unpack_tree(meta, leaves),
                 unpack_tree(disk_meta["extra"]["tree"], disk_leaves)):
        for k in ("bf", "f32", "i32"):
            assert back[k].dtype == tree[k].dtype
            assert torch.equal(_bits(back[k]), _bits(tree[k]))
        assert torch.equal(back["np"], torch.arange(4))
        assert back["b"] == [None, True, 2.5] and back["c"]["e"] == "x"
        assert back["t"][0] == 1                # tuples come back as lists
    with pytest.raises(TypeError, match="str dict keys"):
        pack_tree({1: "bad"})
    with pytest.raises(TypeError, match="cannot encode"):
        pack_tree({"f": object()})


def test_checkpointer_restore_template_and_reference_layout(tmp_path):
    """`restore(template)` gives torch tensors of the template's dtypes
    bit for bit, and the files read back through the reference's
    Checkpointer (same manifest and npz layout)."""
    g = torch.Generator().manual_seed(1)
    tree = {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
            "b": [torch.randn(3, generator=g),
                  torch.arange(5, dtype=torch.int32)]}
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(7, tree, extra={"note": "x"}, blocking=False)
    back, meta = ckpt.restore(tree)
    assert meta["step"] == 7 and meta["extra"] == {"note": "x"}
    assert torch.equal(_bits(back["w"]), _bits(tree["w"]))
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["b"][0], tree["b"][0])
    assert torch.equal(back["b"][1], tree["b"][1])
    jmeta, jleaves = JCheckpointer(tmp_path / "ck").load()
    assert jmeta == meta
    assert [m["name"] for m in meta["leaves"]] == ["b/0", "b/1", "w"]
    np.testing.assert_array_equal(jleaves[2], tree["w"].float().numpy())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore({"w": tree["w"]})


def test_checkpointer_serializes_async_saves(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck", keep=3)
    for s in range(1, 6):
        ckpt.save(s, [torch.full((8,), s)], extra={"s": s}, blocking=False)
    meta, leaves = ckpt.load()              # waits for the last write
    assert meta["step"] == 5 and meta["extra"]["s"] == 5
    np.testing.assert_array_equal(leaves[0], np.full(8, 5))
    assert latest_step(tmp_path / "ck") == 5
    kept = sorted(p.name for p in (tmp_path / "ck").glob("step_*"))
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]
    for p in (tmp_path / "ck").glob("step_*"):
        assert (p / "manifest.json").exists() and (p / "shards.npz").exists()


def test_checkpointer_resave_same_step_replaces(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(4, [torch.full((4,), 1)], extra={"v": 1}, blocking=False)
    ckpt.save(4, [torch.full((4,), 2)], extra={"v": 2}, blocking=True)
    meta, leaves = ckpt.load()
    assert meta["step"] == 4 and meta["extra"]["v"] == 2
    np.testing.assert_array_equal(leaves[0], np.full(4, 2))


def test_checkpointer_async_error_surfaces(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    blocker = tmp_path / "ck" / "blocker"
    blocker.write_text("")
    ckpt.dir = blocker                      # writes now land under a FILE
    ckpt.save(1, [torch.arange(3)], blocking=False)
    with pytest.raises(OSError):
        ckpt.wait()
    ckpt.dir = tmp_path / "ck"              # error consumed; usable again
    ckpt.save(2, [torch.arange(3)], blocking=False)
    ckpt.wait()
    assert latest_step(tmp_path / "ck") == 2


def test_checkpointer_async_save_keeps_the_values_at_save(tmp_path,
                                                          monkeypatch):
    """An asynchronous save holds the tree as it was when `save` returned,
    though the caller updates it in place before the write runs (as
    `adamw_update` does to the master copy, m and v): the writer is held
    until the tree has changed."""
    import threading
    release = threading.Event()
    savez = np.savez

    def held(*a, **kw):
        assert release.wait(30)
        return savez(*a, **kw)

    monkeypatch.setattr(np, "savez", held)
    tree = {"f32": torch.arange(6, dtype=torch.float32),
            "bf16": torch.arange(4, dtype=torch.bfloat16),
            "i32": torch.arange(5, dtype=torch.int32),
            "np": np.arange(3.0)}
    want = [tree["bf16"].float().numpy().copy(), tree["f32"].numpy().copy(),
            tree["i32"].numpy().copy(), tree["np"].copy()]
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(7, tree, blocking=False)
    for k in ("f32", "bf16", "i32"):
        tree[k].add_(100)
    tree["np"] += 100
    release.set()
    meta, leaves = ckpt.load()              # waits for the write
    assert meta["step"] == 7
    for got, ref in zip(leaves, want):
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the disk round trip: save mid-run, a fresh engine loads and finishes
# ---------------------------------------------------------------------------

def _fresh_reqs(mod, vocab=256, n=4, seed=9):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(1, vocab, size=int(
                rng.integers(6, 14))).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 9)), qos=i % 2)
            for i in range(n)]


def test_snapshot_persists_and_resumes_from_disk(tiny, tmp_path):
    tcfg, tp = tiny["attn"]["port"]
    kw = _kw()
    clean = {}
    for side in SIDES:
        ft, chaos, _, mod = _mods(side)
        cfg, params = tiny["attn"][side]
        fe, _ = chaos.build_stack(cfg, params, kw, **_dev(side))
        hs = [fe.submit(r) for r in _fresh_reqs(mod)]
        fe.run(max_steps=500)
        clean[side] = {h.req.req_id: tuple(h.streamed) for h in hs}
    assert clean["port"] == clean["ref"]

    fe, rebuild = tft.build_stack(tcfg, tp, kw, device="cpu")
    handles = [fe.submit(r) for r in _fresh_reqs(api)]
    for _ in range(6):
        fe.step()
    ckpt = Checkpointer(tmp_path / "snaps")
    fe.engine.save_snapshot(ckpt, step=6, blocking=False)
    ckpt.wait()
    eng2 = rebuild()                                 # "new process"
    snap = eng2.load_snapshot(Checkpointer(tmp_path / "snaps"))
    assert snap["version"] == 1
    fe.reattach(eng2)
    fe.run(max_steps=500)
    assert {h.req.req_id: tuple(h.streamed) for h in handles} == \
        clean["port"]
    s = eng2.stats
    assert s["host_syncs"] == s["prefills"] + s["decode_spans"]


# ---------------------------------------------------------------------------
# the launcher: --snapshot-dir / --snapshot-every, then --resume
# ---------------------------------------------------------------------------

def test_launcher_snapshots_and_resumes(tmp_path, capsys):
    from repro_torch.launch import serve as launch
    d = str(tmp_path / "snaps")
    base = ["--smoke", "--device", "cpu", "--kv-layout", "paged",
            "--arrival", "bursty", "--arrival-rate", "2.0",
            "--requests", "4", "--max-new", "5", "--snapshot-dir", d]
    launch.main(base + ["--snapshot-every", "2"])
    out = capsys.readouterr().out
    assert "4 arrivals over" in out and "# snapshot saved to" in out
    step = latest_step(d)
    assert step is not None and step > 0
    launch.main(base + ["--resume"])
    out = capsys.readouterr().out
    assert "# resumed from step" in out and "4 arrivals over" in out
    # batch mode takes the same flags
    launch.main(["--smoke", "--device", "cpu", "--kv-layout", "dense",
                 "--requests", "2", "--max-new", "4", "--snapshot-dir",
                 str(tmp_path / "batch"), "--snapshot-every", "3"])
    assert "completed 2/2" in capsys.readouterr().out
    assert latest_step(tmp_path / "batch") is not None
    for flags in (["--resume"], ["--snapshot-every", "2"]):
        with pytest.raises(SystemExit, match="need --snapshot-dir"):
            launch.main(["--smoke", "--device", "cpu"] + flags)


# ---------------------------------------------------------------------------
# discarded rows in an MoE group: a crash right after a completion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layout", [
    ("deepseek-v2-lite-16b", "latent"), ("moonshot-v1-16b-a3b", "paged")])
def test_moe_discarded_rows_survive_a_crash(arch, layout):
    """After a completion the finished slot's row still decodes (output
    discarded) through whatever its table reaches, and in an MoE group
    it takes expert capacity: a restore zeroes free pages the crashed
    process held stale. A crash at the boundary right after each
    completion keeps every stream, on both stacks, at SMOKE size (the
    crashed runs are the reference's too)."""
    models = _bridge(arch, dict(dtype="float32"))
    kw = _matrix_kw(layout, slots=3, decode_span=1)
    spec = dict(MATRIX_SPEC, output_lens=((1.0, 3, 12),))
    clean = {side: _drive(side, models, kw, 5, spec) for side in SIDES}
    assert _report(clean["port"]) == _report(clean["ref"])
    # every boundary, the ones right after each completion among them
    for s in range(1, clean["port"].steps):
        got = {side: _drive(side, models, kw, 5, spec, crash_at=(s,))
               for side in SIDES}
        assert got["ref"].streams == clean["ref"].streams, s
        assert _report(got["port"]) == _report(got["ref"]), s
