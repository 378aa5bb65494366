"""The port's serving examples (``examples_torch/serve_kv.py``,
``serve_live.py``, ``crash_recovery.py``) against the reference's
computation with the examples' own arguments.

Each script is loaded by path; its ``run(cfg, params, inputs, device)``
and the reference's APIs, called as the reference's script calls them,
take the same weights (drawn by the port on the CPU and bridged with
``params_to_numpy``) and the same inputs (each script's ``make_inputs``
equals the reference's draws, checked here). serve_kv and serve_live run
their SMOKE qwen3-8b scaled to fp32, so that the two packages' greedy
streams are the same bits to hold each other to (the repo's rule for
engine parity; tests/test_torch_frontend.py); crash_recovery runs in
fp32 as the script does. Streams, completion orders, outcomes, TTFTs,
shed lists, crash logs and every engine counter the port keeps must be
equal; snapshot bytes are reported beside the reference's.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ft as jft  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.ft.chaos import build_stack as j_build_stack  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import frontend as jfe  # noqa: E402
from repro.serve import loadgen as jlg  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread, as in tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(tcfg):
    """The port's CPU draw from seed 0 and the same numbers in the
    reference's layout."""
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return params, jax.tree.map(jnp.asarray, params_to_numpy(params, tcfg))


@pytest.fixture(scope="module")
def qwen3_fp32():
    tcfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    jcfg = J_SMOKE["qwen3-8b"].scaled(dtype="float32")
    return (tcfg, jcfg, *_weights(tcfg))


def _port_stats_of(ref: dict, port: dict) -> dict:
    """The reference's counters that the port keeps (every one of them)."""
    assert set(port) <= set(ref), set(port) - set(ref)
    return {k: ref[k] for k in port}


def _rows(trace):
    return [(t, r.req_id, r.prompt, r.max_new_tokens, r.qos)
            for t, r in trace]


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[0] == b[0] and a[1] == b[1] and a[3:] == b[3:]
        np.testing.assert_array_equal(a[2], b[2])


# --------------------------------------------------------------------------
# serve_kv
# --------------------------------------------------------------------------

def _reference_serve_kv(jcfg, jparams, prompts, layout, scheduler):
    """examples/serve_kv.py's engine and requests (greedy, chunk 16,
    span 8)."""
    eng = japi.make_engine(jcfg, jparams, japi.EngineConfig(
        slots=4, cache_len=128, n_pages=28, page_size=8, eos_token=-1,
        kv_layout=layout, scheduler=scheduler, qos_classes=2,
        prefill_chunk=16, decode_span=8, sampler="greedy"))
    for i, p in enumerate(prompts):
        eng.submit(japi.Request(i, p, max_new_tokens=10, qos=i % 2,
                                sampling=japi.SamplingParams()))
    done = eng.run_until_done()
    same = [tuple(r.tokens_out) for r in done if r.req_id % 2 == 0]
    return {"stats": dict(eng.stats), "prefix_hit_rate": eng.prefix.hit_rate,
            "order": [(r.req_id, r.qos) for r in done],
            "shared_identical": len(set(same)) == 1,
            "streams": {r.req_id: list(r.tokens_out) for r in done}}


def test_serve_kv_inputs_are_the_references():
    kv = load_example("serve_kv")
    rng = np.random.default_rng(0)
    base = rng.integers(1, 512, size=24).astype(np.int32)
    want = [base if i % 2 == 0 else rng.integers(
        1, 512, size=int(rng.integers(8, 40))).astype(np.int32)
        for i in range(10)]
    for a, b in zip(kv.make_inputs(512), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("scheduler", ["fcfs", "priority"])
def test_serve_kv_matches_reference(qwen3_fp32, layout, scheduler):
    kv = load_example("serve_kv")
    tcfg, jcfg, params, jparams = qwen3_fp32
    prompts = kv.make_inputs(tcfg.vocab_size)
    got = kv.run(tcfg, params, prompts, "cpu", scheduler=scheduler,
                 kv_layout=layout)
    want = _reference_serve_kv(jcfg, jparams, prompts, layout, scheduler)
    assert got["completed"] == 10
    assert got["streams"] == want["streams"]
    assert got["order"] == want["order"]
    assert got["stats"] == _port_stats_of(want["stats"], got["stats"])
    assert got["prefix_hit_rate"] == want["prefix_hit_rate"]
    assert got["shared_identical"] and want["shared_identical"]
    assert got["stats"]["prefix_hits"] > 0
    assert got["stats"]["prefill_chunks"] > 0


def test_serve_kv_main_runs_on_the_cpu(capsys):
    out = load_example("serve_kv").main(["--device", "cpu", "--scheduler",
                                         "round_robin", "--temperature",
                                         "0.8", "--top-k", "50"])
    text = capsys.readouterr().out
    assert text.startswith("completed 10/10")
    assert "shared-prompt outputs identical: False (sampler: stochastic)" \
        in text
    assert out["completed"] == 10
    assert all(len(s) == 10 for s in out["streams"].values())


# --------------------------------------------------------------------------
# serve_live
# --------------------------------------------------------------------------

def _reference_serve_live(jcfg, jparams, trace):
    """examples/serve_live.py's engine and front end on ``trace``; every
    token's (clock, req_id, index, token) as the script prints it."""
    eng = japi.make_engine(jcfg, jparams, japi.EngineConfig(
        slots=2, cache_len=128, n_pages=64, page_size=8, eos_token=-1,
        kv_layout="paged", scheduler="priority", qos_classes=2,
        decode_span=2, admit_capacity=4, slo_ttft=(0.0, 12.0),
        clock=jfe.VirtualClock()))
    fe = japi.make_frontend("local", eng, step_dt=1.0)
    seen = []
    handles = fe.run([(t, r, lambda tok, idx, r=r: seen.append(
        (fe.clock(), r.req_id, idx, tok))) for t, r in trace])
    assert all(h.streamed == h.req.tokens_out for h in handles if h.ok)
    return {"steps": fe.steps, "seen": seen,
            "handles": [{"req_id": h.req.req_id, "qos": h.req.qos,
                         "outcome": h.outcome, "reason": h.reason,
                         "streamed": list(h.streamed), "ttft": h.ttft}
                        for h in handles],
            "shed": [h.req.req_id for h in handles
                     if h.outcome != "completed"],
            "frontend_stats": dict(fe.stats), "engine_stats": dict(eng.stats)}


def test_serve_live_matches_reference(qwen3_fp32):
    live = load_example("serve_live")
    tcfg, jcfg, params, jparams = qwen3_fp32
    spec = jlg.TraceSpec(arrival="bursty", rate=3.0, burst=8.0, seed=2,
                         prompt_lens=((1.0, 8, 24),),
                         output_lens=((1.0, 6, 12),), qos_weights=(1.0, 3.0))
    trace = jlg.make_trace(spec, 14, jcfg.vocab_size)
    inputs = live.make_inputs(tcfg.vocab_size)
    _assert_rows_equal(inputs, _rows(trace))
    seen = []
    got = live.run(tcfg, params, inputs, "cpu",
                   on_token=lambda now, r, idx, tok: seen.append(
                       (now, r.req_id, idx, tok)))
    want = _reference_serve_live(jcfg, jparams, trace)
    assert got["handles"] == want["handles"]
    assert got["shed"] == want["shed"] and got["steps"] == want["steps"]
    assert seen == want["seen"]
    assert got["frontend_stats"] == want["frontend_stats"]
    assert got["engine_stats"] == _port_stats_of(want["engine_stats"],
                                                 got["engine_stats"])
    assert got["premium_all_completed"] and got["shed"]
    assert all(h["qos"] == 1 for h in got["handles"]
               if h["req_id"] in got["shed"])


def test_serve_live_main_runs_on_the_cpu(capsys):
    out = load_example("serve_live").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "14 arrivals over" in text
    assert text.rstrip().endswith("premium all completed: True")
    assert out["arrivals"] == 14


# --------------------------------------------------------------------------
# crash_recovery
# --------------------------------------------------------------------------

def _reference_crash_recovery(jcfg, jparams, trace_fn, kw, tmp_path):
    """examples/crash_recovery.py's three acts, on the given weights."""
    clean, reports = jft.crash_anywhere_sweep(jcfg, jparams, kw, trace_fn)
    out = {"clean_steps": clean.steps, "streams": clean.streams,
           "outcomes": clean.outcomes, "boundaries": len(reports),
           "snapshot_bytes": reports[0].snapshot_bytes,
           "sweep_crash_logs": [r.crash_log for r in reports],
           "policies": {}}
    at = max(2, clean.steps // 2)
    for policy in ("snapshot", "replay"):
        r = jft.drive(jcfg, jparams, kw, trace_fn(), crash_at=(at,),
                      snapshot_every=1, policy=(policy,))
        e = r.crash_log[0]
        assert r.streams == clean.streams
        out["policies"][policy] = {
            "crash_at": at, "restored_from": e["restored_from"],
            "replayed": list(e["replayed"]),
            "extra_steps": r.steps - clean.steps, "crash_log": r.crash_log}
    fe, rebuild = j_build_stack(jcfg, jparams, kw)
    handles = fe.run(trace_fn(), max_steps=500, drain=False)
    saved_at = fe.steps
    fe.engine.save_snapshot(JCheckpointer(str(tmp_path)), step=fe.steps)
    eng2 = rebuild()
    eng2.load_snapshot(JCheckpointer(str(tmp_path)))
    fe.reattach(eng2)
    fe.run(max_steps=500)
    got = {h.req.req_id: tuple(h.streamed) for h in handles}
    out["disk"] = {"saved_at": saved_at, "finished_at": fe.steps,
                   "streams": len(got), "identical": got == clean.streams}
    return out


def test_crash_recovery_main_matches_reference(tmp_path, capsys,
                                               record_property):
    """The script's main on the CPU against the reference's three acts
    from the same weights and trace: every printed count, the clean
    streams and outcomes, and every crash log equal."""
    cr = load_example("crash_recovery")
    got = cr.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "resumed engine finished 6 streams byte-identical" in text
    tcfg = cr.model_config()
    jcfg = J_SMOKE["qwen3-8b"].scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, dtype="float32")
    _, jparams = _weights(tcfg)
    spec = jlg.TraceSpec(arrival="bursty", rate=0.4, burst=4.0, seed=11,
                         prompt_lens=((1.0, 8, 24),),
                         output_lens=((1.0, 6, 14),))
    _assert_rows_equal(cr.make_inputs(tcfg.vocab_size),
                       _rows(jlg.make_trace(spec, 6, jcfg.vocab_size)))
    want = _reference_crash_recovery(
        jcfg, jparams, lambda: jlg.make_trace(spec, 6, jcfg.vocab_size),
        cr.ENGINE, tmp_path)
    record_property("snapshot_bytes", {"port": got["snapshot_bytes"],
                                       "reference": want["snapshot_bytes"]})
    for key in ("clean_steps", "streams", "outcomes", "boundaries",
                "sweep_crash_logs", "policies", "disk"):
        assert got[key] == want[key], key
    assert got["boundaries"] == got["clean_steps"] > 2
    assert got["snapshot_bytes"] > 0 and want["snapshot_bytes"] > 0
    assert got["disk"]["identical"]
