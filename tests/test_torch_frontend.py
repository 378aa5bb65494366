"""The port's front end (``repro_torch.serve.frontend``) and load generator
against the JAX package's: continuous arrivals on a virtual clock,
per-token streams byte-identical to ``tokens_out``, SLO-graded admission.

Each scenario runs on a port stack (CPU) and on a reference stack with
the same settings, the fp32 tiny qwen3 of tests/test_sampling.py and
bridged weights, and the port must give the reference's outcomes,
streams, shed logs and counters. The reference's dense streams differ
between span 1 and 8 and between chunked and monolithic prefill in its
own test (``test_stream_invariant_to_span_and_chunking[dense]``), so the
port is held to the reference's stream at each (span, chunk), and to the
invariance only where the reference holds it. Crash reattach is held in
tests/test_torch_crash.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve import frontend as jfe  # noqa: E402
from repro.serve import loadgen as jlg  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve import frontend as tfe  # noqa: E402
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

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, dtype="float32")
SIDES = ("ref", "port")


@pytest.fixture(scope="module")
def tiny():
    jcfg = J_SMOKE["qwen3-8b"].scaled(**TINY)
    tcfg = SMOKE_CONFIGS["qwen3-8b"].scaled(**TINY)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return {"ref": (jcfg, jp), "port": (tcfg, tp)}


def _mods(side):
    return (japi, jfe, jlg) if side == "ref" else (api, tfe, tlg)


def _stack(side, tiny, step_dt=1.0, **kw):
    mod, fe_mod, _ = _mods(side)
    cfg, params = tiny[side]
    clock = fe_mod.VirtualClock()
    kw.setdefault("slots", 3)
    kw.setdefault("cache_len", 96)
    kw.setdefault("n_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("eos_token", -1)
    ecfg = mod.EngineConfig(clock=clock, **kw)
    eng = (mod.make_engine(cfg, params, ecfg) if side == "ref"
           else mod.make_engine(cfg, params, ecfg, device="cpu"))
    return clock, eng, mod.make_frontend("local", eng, step_dt=step_dt)


def _prompts(n, lo=6, hi=20, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _summary(eng, fe, handles):
    """What a run must reproduce: per handle its outcome, reason,
    stream and stamps; the front end's stats and shed log; the engine's
    counters."""
    return {"handles": [(h.req.req_id, h.outcome, h.reason, h.degraded,
                         tuple(h.streamed), h.submitted_at, h.first_token_at,
                         h.finished_at, h.ttft, h.tpot) for h in handles],
            "fe": dict(fe.stats), "shed_log": list(fe.shed_log),
            "steps": fe.steps, "engine": dict(eng.stats)}


def _both(scenario, tiny, **kw):
    """Run ``scenario(side, tiny, **kw)`` on both stacks and require the
    port's summary to equal the reference's; returns the port's."""
    got = {side: scenario(side, tiny, **kw) for side in SIDES}
    ref, port = got["ref"], got["port"]
    port_engine = port["summary"]["engine"]
    ref["summary"]["engine"] = {k: v for k, v in
                                ref["summary"]["engine"].items()
                                if k in port_engine}
    assert port["summary"] == ref["summary"]
    return port


# ---------------------------------------------------------------------------
# streaming: callback stream byte-identical to tokens_out
# ---------------------------------------------------------------------------

def _stream_run(side, tiny, layout, span, chunk):
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, kv_layout=layout, decode_span=span,
                        prefill_chunk=chunk)
    got = {}
    handles = [fe.submit(mod.Request(i, p, max_new_tokens=6),
                         on_token=lambda t, k, i=i:
                         got.setdefault(i, []).append((t, k)))
               for i, p in enumerate(_prompts(4))]
    fe.run()
    return {"summary": _summary(eng, fe, handles), "handles": handles,
            "callback": got}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("span,chunk", [(1, 0), (8, 0), (8, 8)])
def test_stream_matches_tokens_out(tiny, layout, span, chunk):
    run = _both(_stream_run, tiny, layout=layout, span=span, chunk=chunk)
    assert all(h.ok for h in run["handles"])
    for h in run["handles"]:
        assert h.streamed == h.req.tokens_out
        assert run["callback"][h.req.req_id] == [
            (t, k) for k, t in enumerate(h.req.tokens_out)]
        assert len(h.streamed) == 6


def _invariance_run(side, tiny, layout, span, chunk):
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, kv_layout=layout, decode_span=span,
                        prefill_chunk=chunk)
    hs = [fe.submit(mod.Request(i, p, max_new_tokens=6))
          for i, p in enumerate(_prompts(3))]
    fe.run()
    return {"summary": _summary(eng, fe, hs),
            "streams": [h.streamed for h in hs]}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_stream_invariant_to_span_and_chunking(tiny, layout):
    """The reference's stream at each (span, chunk); on paged, where the
    reference holds it, also one stream across them."""
    streams = {}
    for span, chunk in ((1, 0), (8, 0), (8, 8)):
        streams[(span, chunk)] = _both(_invariance_run, tiny, layout=layout,
                                       span=span, chunk=chunk)["streams"]
    if layout == "paged":
        assert streams[(1, 0)] == streams[(8, 0)] == streams[(8, 8)]


def _park_run(side, tiny):
    mod = _mods(side)[0]
    prompt = np.arange(1, 12, dtype=np.int32)
    _, eng, fe = _stack(side, tiny, decode_span=1)
    h = fe.submit(mod.Request(0, prompt, max_new_tokens=6))
    fe.step()
    assert eng._evict_someone(exclude=-1)
    assert eng.stats["parked"] == 1
    fe.run()
    _, _, ref_fe = _stack(side, tiny, decode_span=1)
    undisturbed = ref_fe.submit(mod.Request(0, prompt, max_new_tokens=6))
    ref_fe.run()
    return {"summary": _summary(eng, fe, [h]), "h": h, "eng": eng,
            "undisturbed": undisturbed.streamed}


def test_stream_survives_park_unpark_midstream(tiny):
    run = _both(_park_run, tiny)
    h = run["h"]
    assert run["eng"].stats["unparked"] == 1
    assert h.ok and h.streamed == h.req.tokens_out == run["undisturbed"]


def _preempt_run(side, tiny):
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, decode_span=1)
    h = fe.submit(mod.Request(0, np.arange(1, 10, dtype=np.int32),
                              max_new_tokens=5))
    fe.step()
    seen = list(h.streamed)
    eng._preempt_restart(int(np.nonzero(eng.active)[0][0]))
    fe.run()
    return {"summary": _summary(eng, fe, [h]), "h": h, "seen": seen,
            "eng": eng}


def test_stream_survives_preempt_restart(tiny):
    run = _both(_preempt_run, tiny)
    h = run["h"]
    assert run["seen"] and h.ok
    assert h.streamed == h.req.tokens_out
    assert h.streamed[:len(run["seen"])] == run["seen"]
    assert run["eng"].stats["preempt_restarts"] == 1


def _syncs_run(side, tiny, sampled):
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, decode_span=8,
                        sampler="stochastic" if sampled else "greedy")
    sp = (mod.SamplingParams(temperature=0.8, top_k=30, top_p=0.9, seed=4,
                             logprobs=True) if sampled
          else mod.SamplingParams())
    hs = [fe.submit(mod.Request(i, p, max_new_tokens=9, sampling=sp),
                    on_token=lambda t, k: None)
          for i, p in enumerate(_prompts(4))]
    fe.run()
    return {"summary": _summary(eng, fe, hs), "hs": hs, "eng": eng}


@pytest.mark.parametrize("sampled", [False, True])
def test_streaming_adds_zero_host_syncs(tiny, sampled):
    run = _both(_syncs_run, tiny, sampled=sampled)
    eng = run["eng"]
    assert all(h.ok for h in run["hs"])
    assert (eng.stats["host_syncs"]
            == eng.stats["prefills"] + eng.stats["decode_spans"])
    if sampled:
        assert all(len(h.req.logprobs_out) == 9 for h in run["hs"])


# ---------------------------------------------------------------------------
# continuous arrivals + injected clock
# ---------------------------------------------------------------------------

def _midflight_run(side, tiny):
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, decode_span=1)
    h0 = fe.submit(mod.Request(0, np.arange(1, 20, dtype=np.int32),
                               max_new_tokens=8))
    for _ in range(3):
        fe.step()
    assert not h0.done
    h1 = fe.submit(mod.Request(1, np.arange(1, 9, dtype=np.int32),
                               max_new_tokens=4))
    fe.run()
    return {"summary": _summary(eng, fe, [h0, h1]), "hs": [h0, h1]}


def test_submit_while_engine_is_running(tiny):
    run = _both(_midflight_run, tiny)
    for h in run["hs"]:
        assert h.ok and h.streamed == h.req.tokens_out


SPEC = dict(arrival="bursty", rate=0.7, burst=3.0, qos_weights=(1, 1),
            seed=3, prompt_lens=((1.0, 6, 14),), output_lens=((1.0, 3, 7),))


def test_make_trace_matches_reference():
    """Same spec, same events: times, ids, prompts, lengths, classes,
    sampling; poisson and bursty, with length mixtures."""
    for arrival in ("poisson", "bursty"):
        kw = dict(SPEC, arrival=arrival,
                  prompt_lens=((0.7, 8, 32), (0.3, 32, 48)))
        ref = jlg.make_trace(jlg.TraceSpec(**dict(
            kw, sampling=japi.SamplingParams(temperature=0.5, seed=9))),
            12, 256, t0=2.0, start_id=5)
        port = tlg.make_trace(tlg.TraceSpec(**dict(
            kw, sampling=api.SamplingParams(temperature=0.5, seed=9))),
            12, 256, t0=2.0, start_id=5)
        assert len(port) == len(ref) == 12
        for (tp, rp), (tr, rr) in zip(port, ref):
            assert tp == tr and rp.req_id == rr.req_id and rp.qos == rr.qos
            assert rp.max_new_tokens == rr.max_new_tokens
            np.testing.assert_array_equal(rp.prompt, rr.prompt)
            assert (rp.sampling.temperature, rp.sampling.seed) == (0.5, 9)
    with pytest.raises(ValueError, match="unknown arrival"):
        tlg.make_trace(tlg.TraceSpec(arrival="nope"), 2, 256)


def _trace_run(side, tiny):
    _, _, lg = _mods(side)
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, scheduler="priority", qos_classes=2,
                        admit_capacity=4, slo_ttft=(0.0, 6.0))
    hs = fe.run(lg.make_trace(lg.TraceSpec(**SPEC,
                                           sampling=mod.SamplingParams()),
                              10, 256))
    return {"summary": _summary(eng, fe, hs),
            "rows": [(h.req.req_id, h.outcome, tuple(h.streamed),
                      h.req.arrived_at, h.submitted_at, h.first_token_at,
                      h.finished_at) for h in hs]}


def test_virtual_clock_replays_identically(tiny):
    first = _both(_trace_run, tiny)
    again = _trace_run("port", tiny)
    assert first["rows"] == again["rows"]


def test_engine_submit_stamps_injected_clock(tiny):
    clock, eng, _ = _stack("port", tiny)
    clock.advance(41.5)
    r = api.Request(0, np.arange(1, 8, dtype=np.int32), max_new_tokens=2)
    eng.submit(r)
    assert r.arrived_at == clock()
    eng.run_until_done()
    assert r.finished_at >= 41.5


# ---------------------------------------------------------------------------
# SLO-graded admission control
# ---------------------------------------------------------------------------

def _flood(side, fe, classes, max_new=6, seed=1):
    mod = _mods(side)[0]
    return [fe.submit(mod.Request(i, p, max_new_tokens=max_new, qos=c))
            for i, (p, c) in enumerate(
                zip(_prompts(len(classes), seed=seed), classes))]


def _overload_run(side, tiny):
    _, eng, fe = _stack(side, tiny, slots=1, decode_span=1,
                        scheduler="priority", qos_classes=3,
                        admit_capacity=3, feed_depth=1)
    hs = _flood(side, fe, [2, 2, 2, 1, 2, 0, 1, 2, 0, 2, 1, 0])
    fe.run()
    return {"summary": _summary(eng, fe, hs), "hs": hs, "fe": fe,
            "eng": eng}


def test_overload_sheds_only_lower_classes(tiny):
    run = _both(_overload_run, tiny)
    hs, fe, eng = run["hs"], run["fe"], run["eng"]
    assert all(h.outcome in ("completed", "rejected", "shed") for h in hs)
    assert (fe.stats["completed"] + fe.stats["rejected"]
            + fe.stats["shed_capacity"] + fe.stats["shed_slo"] == len(hs))
    drops = [e for e in fe.shed_log if e["reason"] == "capacity"]
    assert drops
    assert all(e["qos"] > e["trigger_qos"] for e in drops)
    assert all(h.ok for h in hs if h.req.qos == 0)
    done = [r.req_id for r in eng.completed]
    assert all(h.req.req_id not in done for h in hs if h.outcome == "shed")


def _reject_run(side, tiny):
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, slots=1, decode_span=1,
                        scheduler="priority", qos_classes=2,
                        admit_capacity=2, feed_depth=1)
    hs = _flood(side, fe, [0, 0, 0])
    low = fe.submit(mod.Request(9, np.arange(1, 8, dtype=np.int32),
                                max_new_tokens=4, qos=1))
    same = fe.submit(mod.Request(10, np.arange(1, 8, dtype=np.int32),
                                 max_new_tokens=4, qos=0))
    outcomes = (low.outcome, same.outcome)
    fe.run()
    return {"summary": _summary(eng, fe, hs + [low, same]),
            "outcomes": outcomes, "fe": fe}


def test_arrival_rejected_when_every_waiter_outranks_it(tiny):
    run = _both(_reject_run, tiny)
    assert run["outcomes"] == ("rejected", "rejected")
    assert run["fe"].stats["rejected"] == 2


def _displace_run(side, tiny):
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, slots=1, decode_span=1,
                        scheduler="priority", qos_classes=2,
                        admit_capacity=2, feed_depth=1)
    hs = _flood(side, fe, [1, 1, 1])
    hi = fe.submit(mod.Request(9, np.arange(1, 8, dtype=np.int32),
                               max_new_tokens=4, qos=0))
    at_submit = (hs[2].outcome, hs[1].outcome)
    fe.run()
    return {"summary": _summary(eng, fe, hs + [hi]), "at": at_submit,
            "hi": hi}


def test_high_class_displaces_newest_low_waiter(tiny):
    run = _both(_displace_run, tiny)
    assert run["at"] == ("shed", None)
    assert run["hi"].ok


def _expiry_run(side, tiny):
    _, eng, fe = _stack(side, tiny, slots=1, decode_span=1,
                        scheduler="priority", qos_classes=2,
                        admit_capacity=16, feed_depth=1,
                        slo_ttft=(0.0, 2.0))
    hs = _flood(side, fe, [0, 1, 1, 1, 1], max_new=8)
    fe.run()
    return {"summary": _summary(eng, fe, hs), "hs": hs, "fe": fe}


def test_slo_ttft_expiry_is_explicit(tiny):
    run = _both(_expiry_run, tiny)
    hs = run["hs"]
    shed = [h for h in hs if h.outcome == "shed"]
    assert shed and all(h.req.qos == 1 for h in shed)
    assert all(h.reason.startswith("slo-ttft") for h in shed)
    assert all(h.ok for h in hs if h.req.qos == 0)
    assert run["fe"].stats["shed_slo"] == len(shed)


def _degrade_run(side, tiny):
    _, eng, fe = _stack(side, tiny, slots=1, decode_span=1,
                        scheduler="priority", qos_classes=2,
                        admit_capacity=8, feed_depth=1, degrade_max_new=2)
    hs = _flood(side, fe, [0, 1, 1, 1, 1, 1], max_new=8)
    fe.run()
    return {"summary": _summary(eng, fe, hs), "hs": hs, "fe": fe}


def test_degrade_caps_low_class_output(tiny):
    run = _both(_degrade_run, tiny)
    hs = run["hs"]
    degraded = [h for h in hs if h.degraded]
    assert degraded and all(h.req.qos == 1 for h in degraded)
    assert all(h.ok and len(h.streamed) <= 2 for h in degraded)
    assert run["fe"].stats["degraded"] == len(degraded)
    assert all(not h.degraded and len(h.streamed) == 8
               for h in hs if h.req.qos == 0)


def _metrics_run(side, tiny):
    mod = _mods(side)[0]
    _, eng, fe = _stack(side, tiny, decode_span=1)
    h = fe.submit(mod.Request(0, np.arange(1, 10, dtype=np.int32),
                              max_new_tokens=4))
    fe.run()
    checks = (h.meets_slo(), h.meets_slo(slo_ttft=(1e9,), slo_tpot=(1e9,)),
              h.meets_slo(slo_ttft=(1e-9,)))
    return {"summary": _summary(eng, fe, [h]), "h": h, "checks": checks}


def test_handle_slo_metrics(tiny):
    run = _both(_metrics_run, tiny)
    h = run["h"]
    assert h.ok and h.ttft is not None and h.tpot is not None
    assert h.ttft >= 0 and h.tpot > 0
    assert run["checks"] == (True, True, False)


def test_slo_budget_broadcasts_like_reference():
    for budgets in ((), (0.0,), (3.0,), (0.0, 6.0), (1.0, -1.0, 2.0)):
        for cls in range(4):
            assert (api.slo_budget(cls, budgets)
                    == japi.slo_budget(cls, budgets))


# ---------------------------------------------------------------------------
# registry: a third-party frontend plugs in by name
# ---------------------------------------------------------------------------

def test_third_party_frontend_registry(tiny):
    @api.register_frontend("test_logging")
    class LoggingFrontend(tfe.LocalFrontend):
        def submit(self, req, on_token=None):
            self.log = getattr(self, "log", []) + [req.req_id]
            return super().submit(req, on_token)

    try:
        cfg, params = tiny["port"]
        eng = api.make_engine(cfg, params, api.EngineConfig(
            slots=2, cache_len=64, n_pages=32, page_size=8, eos_token=-1,
            clock=tfe.VirtualClock()), device="cpu")
        fe = api.make_frontend("test_logging", eng, step_dt=1.0)
        hs = [fe.submit(api.Request(i, np.arange(1, 8, dtype=np.int32),
                                    max_new_tokens=3)) for i in range(2)]
        fe.run()
        assert fe.log == [0, 1] and all(h.ok for h in hs)
    finally:
        api.FRONTENDS.pop("test_logging", None)
    with pytest.raises(ValueError, match="unknown frontend"):
        api.make_frontend("nope", eng)


# ---------------------------------------------------------------------------
# the launcher's sampling flags and live mode, on the CPU
# ---------------------------------------------------------------------------

def test_launcher_live_mode_reports_each_class(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--smoke", "--device", "cpu", "--kv-layout", "paged",
                 "--arrival", "bursty", "--arrival-rate", "2.0",
                 "--admit-capacity", "3", "--scheduler", "priority",
                 "--slo-ttft", "0", "30", "--temperature", "0.8",
                 "--top-k", "40", "--requests", "6", "--max-new", "6",
                 "--stream"])
    out = capsys.readouterr().out
    assert "6 arrivals over" in out and "stochastic sampler" in out
    rows = [ln.split(",") for ln in out.splitlines()
            if ln[:2] in ("0,", "1,")]
    assert len(rows) == 2
    assert sum(int(r[1]) for r in rows) == 6
    assert "token[0] =" in out


def test_launcher_batch_mode_samples(capsys):
    from repro_torch.launch import serve as launch
    args = ["--smoke", "--device", "cpu", "--kv-layout", "paged",
            "--requests", "3", "--max-new", "5", "--temperature", "0.9",
            "--top-p", "0.9", "--seed", "3"]
    launch.main(args)
    first = capsys.readouterr().out
    assert "completed 3/3" in first and "stochastic sampler" in first
    launch.main(args)
    again = capsys.readouterr().out
    assert first.split("stats:")[1] == again.split("stats:")[1]
