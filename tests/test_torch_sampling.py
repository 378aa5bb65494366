"""The port's stochastic sampling against ``repro.kernels.sampling`` and
the JAX engine's sampled streams.

Keys and random bits must equal JAX's bit for bit (threefry2x32 with the
partitionable bit stream). The Gumbel noise and the top-p prefix sum go
through ``log``, ``exp`` and ``cumsum``, which agree with XLA's only to a
few ulp, so a draw is held to the reference's wherever the winner of the
reference's draw leads the runner-up by more than ``MARGIN``: a token
that differs must sit within that margin of a tie, and the flips are
counted. Engine tests run the port (CPU) and the reference engine at the
same span, layout and settings on the fp32 tiny qwen3 of
tests/test_sampling.py, with bridged weights; logprobs agree within
1e-5 and every counter is equal.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.kernels import sampling as jks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import api as japi  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.kernels import sampling as ks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
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

MARGIN = 1e-4
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, dtype="float32")
F32_TINY = np.finfo(np.float32).tiny


@pytest.fixture(scope="module")
def tiny():
    jcfg = J_SMOKE["qwen3-8b"].scaled(**TINY)
    tcfg = SMOKE_CONFIGS["qwen3-8b"].scaled(**TINY)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _wrap(v):
    return np.uint32(int(v) & 0xFFFFFFFF).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# seeds, req_ids and indices as the engine hands them over: negative
# words, words >= 2^31 (wrapped), indices up to 2^20
SEEDS = [0, 1, -1, -5, 2**31 - 1, 2**31 + 5, 2**32 - 3, 123456789]
RIDS = [0, 3, 2**31 - 1, -7, 2**40 + 3, 9, -2**31, 42]
IDXS = [0, 1, 2, 2**20, 17, 5, 1000, 2**20 - 1]


def _keys():
    s, r, i = (np.asarray([_wrap(v) for v in vs], np.int32)
               for vs in (SEEDS, RIDS, IDXS))
    return (s, r, i), np.asarray(jks.derive_keys(*map(jnp.asarray,
                                                      (s, r, i))))


# ---------------------------------------------------------------------------
# keys, bits, uniform, Gumbel
# ---------------------------------------------------------------------------

def test_derive_keys_exact():
    (s, r, i), jk = _keys()
    got = ks.derive_keys(_t(s), _t(r), _t(i))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jk.astype(np.int64))
    # wider integers wrap modulo 2^32, as the engine's int32 wrap does
    raw = ks.derive_keys(torch.tensor(SEEDS, dtype=torch.int64),
                         torch.tensor(RIDS, dtype=torch.int64),
                         torch.tensor(IDXS, dtype=torch.int64))
    np.testing.assert_array_equal(raw.numpy(), jk.astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 256, 4099])
def test_random_bits_and_uniform_exact(n):
    _, jk = _keys()
    tk = _t(jk.astype(np.int64))
    bits = np.stack([np.asarray(jax.random.bits(k, (n,), jnp.uint32))
                     for k in jk])
    np.testing.assert_array_equal(ks.random_bits(tk, n).numpy(),
                                  bits.astype(np.int64))
    uni = np.stack([np.asarray(jax.random.uniform(
        k, (n,), jnp.float32, minval=F32_TINY, maxval=1.0)) for k in jk])
    np.testing.assert_array_equal(ks.uniform(tk, n).numpy(), uni)


def test_gumbel_within_4_ulp():
    """Within 4 ulp of max(|g|, 1): near g = 0 the inner log's rounding
    (an ulp of 1) is what both sides carry."""
    _, jk = _keys()
    n = 20000
    want = np.stack([np.asarray(jax.random.gumbel(k, (n,), jnp.float32))
                     for k in jk])
    got = ks.gumbel(_t(jk.astype(np.int64)), n).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got - want) <= 4 * ulp)


# ---------------------------------------------------------------------------
# sample_logits against the reference, under the margin rule
# ---------------------------------------------------------------------------

def _logits(b, v, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(b, v)) * scale
            ).astype(np.float32)


def _draw_margins(logits, jkeys, temp, top_k, top_p):
    """The reference's top-1 minus top-2 of the quantity its argmax
    reads: Gumbel + filtered logits (the filter taken from the port,
    whose mask must equal the reference's away from a p boundary), or
    the raw logits for greedy rows."""
    masked = ks.masked_logits(_t(logits), _t(temp), _t(top_k),
                              _t(top_p)).numpy()
    out = []
    for b in range(len(logits)):
        if temp[b] <= 0:
            z = logits[b]
        else:
            z = masked[b] + np.asarray(jax.random.gumbel(
                jnp.asarray(jkeys[b]), logits[b].shape, jnp.float32))
        top = np.sort(z[np.isfinite(z)])[-2:]
        out.append(np.inf if len(top) < 2 else float(top[1] - top[0]))
    return np.asarray(out)


def _reference_mask(logits, temp, top_k, top_p):
    """The filters in float64: keep mask [B, V] and each kept-set
    boundary's distance from p (near-ties excuse a mask difference)."""
    B, V = logits.shape
    scaled = logits.astype(np.float64) / np.maximum(temp, 1e-6)[:, None]
    order = np.argsort(-scaled, axis=-1, kind="stable")
    srt = np.take_along_axis(scaled, order, axis=-1)
    k = np.where((top_k <= 0) | (top_k >= V), V, top_k)[:, None]
    keep_k = np.arange(V)[None] < k
    e = np.where(keep_k, np.exp(srt - srt[:, :1]), 0.0)
    probs = e / e.sum(-1, keepdims=True)
    before = np.cumsum(probs, -1) - probs
    keep = keep_k & ((before < top_p[:, None]) | (top_p[:, None] >= 1))
    keep[:, 0] = True
    near = keep_k & (np.abs(before - top_p[:, None]) < 1e-5)
    out = np.zeros_like(keep)
    np.put_along_axis(out, order, keep, axis=-1)
    near_v = np.zeros_like(near)
    np.put_along_axis(near_v, order, near, axis=-1)
    return out, near_v


GRIDS = {
    "mixed": ([0.0, 0.5, 0.8, 1.0, 1.5, 0.7, 1.0, 2.0],
              [0, 3, 0, 512, 10, 1, 17, 50],
              [1.0, 0.9, 0.6, 1.0, 0.3, 0.9, 0.85, 0.95]),
    "temperature": ([0.3, 0.7, 1.0, 1.3, 0.1, 2.5, 1.0, 0.9],
                    [0] * 8, [1.0] * 8),
    "top_k": ([1.0] * 8, [1, 2, 5, 40, 100, 511, 512, 0], [1.0] * 8),
    "top_p": ([1.0] * 8, [0] * 8,
              [0.05, 0.1, 0.3, 0.5, 0.8, 0.9, 0.95, 0.999]),
    "k_and_p": ([0.8, 1.3, 0.6, 1.0, 1.1, 0.9, 0.7, 1.5],
                [40, 40, 8, 100, 3, 64, 20, 200],
                [0.95, 0.9, 0.7, 0.5, 1.0, 0.99, 0.8, 0.6]),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sample_logits_matches_reference(grid):
    temp, top_k, top_p = (np.asarray(a, dt) for a, dt in zip(
        GRIDS[grid], (np.float32, np.int32, np.float32)))
    B, V = len(temp), 512
    (s, r, _), _ = _keys()
    flips = draws = 0
    for trial in range(6):
        logits = _logits(B, V, seed=trial)
        idx = np.arange(B, dtype=np.int32) * 7 + trial
        jkeys = jks.derive_keys(*map(jnp.asarray, (s, r, idx)))
        want = np.asarray(jks.sample_logits(
            jnp.asarray(logits), jkeys, jnp.asarray(temp),
            jnp.asarray(top_k), jnp.asarray(top_p)))
        got = ks.sample_logits(_t(logits), ks.derive_keys(_t(s), _t(r),
                                                          _t(idx)),
                               _t(temp), _t(top_k), _t(top_p)).numpy()
        mask, near = _reference_mask(logits, temp, top_k, top_p)
        port_mask = np.isfinite(ks.masked_logits(
            _t(logits), _t(temp), _t(top_k), _t(top_p)).numpy())
        assert np.all((port_mask == mask) | near)
        margins = _draw_margins(logits, np.asarray(jkeys), temp, top_k,
                                top_p)
        tied = (margins <= MARGIN) | near.any(-1)
        assert np.all((got == want) | tied), (got, want, margins)
        flips += int((got != want).sum())
        draws += B
        # every draw lands inside the kept set
        assert port_mask[np.arange(B), got].all()
    print(f"{grid}: {flips} flips in {draws} draws")
    assert flips <= draws // 20


def test_disabled_filters_equal_pure_temperature():
    """k = V (or 0) and p = 1: the masked logits ARE the scaled logits,
    bit for bit, and the draw is the reference's plain categorical."""
    B, V = 6, 96
    logits = _logits(B, V, seed=3)
    s = np.full(B, 4, np.int32)
    r = np.arange(B, dtype=np.int32)
    i = np.full(B, 2, np.int32)
    jkeys = jks.derive_keys(*map(jnp.asarray, (s, r, i)))
    t = np.full(B, 0.85, np.float32)
    pure = np.asarray(jax.vmap(jax.random.categorical)(
        jkeys, jnp.asarray(logits) / 0.85))
    margins = _draw_margins(logits, np.asarray(jkeys), t,
                            np.zeros(B, np.int32), np.ones(B, np.float32))
    for k_off in (0, V):
        k = np.full(B, k_off, np.int32)
        masked = ks.masked_logits(_t(logits), _t(t), _t(k),
                                  torch.ones(B)).numpy()
        np.testing.assert_array_equal(
            masked, (_t(logits) / _t(t)[:, None]).numpy())
        got = ks.sample_logits(_t(logits), ks.derive_keys(_t(s), _t(r),
                                                          _t(i)),
                               _t(t), _t(k), torch.ones(B)).numpy()
        assert np.all((got == pure) | (margins <= MARGIN))


def test_temperature_zero_is_argmax():
    logits = _logits(5, 64, seed=2)
    keys = ks.derive_keys(torch.zeros(5, dtype=torch.int32),
                          torch.arange(5, dtype=torch.int32),
                          torch.zeros(5, dtype=torch.int32))
    out = ks.sample_logits(_t(logits), keys, torch.zeros(5),
                           torch.zeros(5, dtype=torch.int32), torch.ones(5))
    np.testing.assert_array_equal(out.numpy(), np.argmax(logits, -1))


def test_rows_do_not_depend_on_neighbours():
    """A row's masked logits, noise and token are the same bits whatever
    the other rows hold."""
    B, V = 4, 300
    base = _logits(B, V, seed=8)
    other = _logits(B, V, seed=9)
    other[2] = base[2]
    args = [torch.tensor([0.9, 1.1, 0.7, 1.0]),
            torch.tensor([0, 20, 50, 3], dtype=torch.int32),
            torch.tensor([0.9, 1.0, 0.8, 0.5])]
    keys = ks.derive_keys(torch.arange(4), torch.arange(4) + 10,
                          torch.arange(4))
    a = ks.masked_logits(_t(base), *args)
    b = ks.masked_logits(_t(other), *args)
    assert torch.equal(a[2], b[2])
    assert (ks.sample_logits(_t(base), keys, *args)[2]
            == ks.sample_logits(_t(other), keys, *args)[2])


def test_token_logprob_matches_reference():
    logits = _logits(6, 256, seed=5)
    toks = np.random.default_rng(1).integers(0, 256, size=6).astype(np.int32)
    want = np.asarray(jks.token_logprob(jnp.asarray(logits),
                                        jnp.asarray(toks)))
    got = ks.token_logprob(_t(logits), _t(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_select_token_matches_reference():
    """The prefill first-token selector: (token, logprob) for greedy and
    for the stochastic sampler at index 0."""
    from repro.serve.samplers import StochasticSampler as JStochastic
    from repro_torch.serve.samplers import StochasticSampler
    logits = _logits(3, 128, seed=6)
    tok, lp = lm.select_token(_t(logits))
    jtok, jlp = jlm.select_token(jnp.asarray(logits))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-6)
    params = (np.full(3, 0.9, np.float32), np.full(3, 20, np.int32),
              np.full(3, 0.95, np.float32))
    rng = (np.asarray([5, -2, 7], np.int32), np.arange(3, dtype=np.int32),
           np.zeros(3, np.int32))
    tok, lp = lm.select_token(_t(logits), StochasticSampler().sample,
                              tuple(map(_t, params)), tuple(map(_t, rng)))
    jtok, jlp = jlm.select_token(jnp.asarray(logits), JStochastic().sample,
                                 tuple(map(jnp.asarray, params)),
                                 tuple(map(jnp.asarray, rng)))
    margins = _draw_margins(logits, np.asarray(jks.derive_keys(
        *map(jnp.asarray, rng))), *params)
    assert np.all((tok.numpy() == np.asarray(jtok)) | (margins <= MARGIN))
    same = tok.numpy() == np.asarray(jtok)
    np.testing.assert_allclose(lp.numpy()[same], np.asarray(jlp)[same],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# engines: port (CPU) against the reference, same span and layout
# ---------------------------------------------------------------------------

def _prompt(n, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(
        1, vocab, size=n).astype(np.int32)


REQS = [(i, _prompt(n, seed=70 + i)) for i, n in enumerate([22, 9, 15])]


def _sp(mod, temp=0.9, seed=11, **kw):
    return mod.SamplingParams(temperature=temp, top_k=kw.pop("top_k", 40),
                              top_p=kw.pop("top_p", 0.95), seed=seed, **kw)


class ManualClock:
    """A clock only the test advances."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _mk(side, tiny, span, clock=None, **kw):
    jcfg, jp, tcfg, tp = tiny
    e = dict(slots=3, cache_len=96, n_pages=64, page_size=8, eos_token=-1,
             decode_span=span, clock=clock or ManualClock())
    e.update(kw)
    if side == "ref":
        return JEngine(jcfg, jp, japi.EngineConfig(**e))
    return ServingEngine(tcfg, tp, api.EngineConfig(**e), device="cpu")


def _mod(side):
    return japi if side == "ref" else api


def _submit(eng, side, reqs, max_new, sampling):
    mod = _mod(side)
    for i, p in reqs:
        eng.submit(mod.Request(i, p.copy(), max_new_tokens=max_new,
                               sampling=sampling(mod)))


def _run(side, tiny, span, reqs, max_new=12, sampling=None, **kw):
    eng = _mk(side, tiny, span, **kw)
    _submit(eng, side, reqs, max_new,
            sampling or (lambda mod: mod.SamplingParams()))
    done = eng.run_until_done()
    assert len(done) == len(reqs)
    return eng, done


def _margin_at(tiny, req, step):
    """The reference's draw margin for a request's token ``step``, from
    a full prefill over prompt + the tokens before it."""
    jcfg, jp, _, _ = tiny
    seq = np.concatenate([req.prompt, np.asarray(req.tokens_out[:step],
                                                 np.int32)])
    lg, _ = jlm.prefill(jp, jnp.asarray(seq[None]), jcfg, NULL_POLICY,
                        cache_len=len(seq))
    sp = req.sampling
    rng = tuple(np.asarray([v], np.int32) for v in
                (_wrap(sp.seed), _wrap(req.req_id), step))
    return _draw_margins(np.asarray(lg, np.float32),
                         np.asarray(jks.derive_keys(*map(jnp.asarray, rng))),
                         np.asarray([sp.temperature], np.float32),
                         np.asarray([sp.top_k], np.int32),
                         np.asarray([sp.top_p], np.float32))[0]


def _assert_like(tiny, port, ref, counters=True):
    """Same completion order and streams under the margin rule (a stream
    may leave the reference's only at a draw within MARGIN of a tie),
    logprobs within 1e-5 where the streams agree, every counter equal."""
    (peng, pdone), (reng, rdone) = port, ref
    assert [r.req_id for r in pdone] == [r.req_id for r in rdone]
    flips = 0
    for p, r in zip(pdone, rdone):
        assert len(p.tokens_out) == len(r.tokens_out)
        diff = [i for i, (a, b) in enumerate(zip(p.tokens_out, r.tokens_out))
                if a != b]
        n = diff[0] if diff else len(p.tokens_out)
        if diff:
            flips += 1
            assert _margin_at(tiny, r, n) <= MARGIN, (p.req_id, n)
        assert len(p.logprobs_out) == len(r.logprobs_out)
        np.testing.assert_allclose(p.logprobs_out[:n], r.logprobs_out[:n],
                                   atol=1e-5, rtol=0)
    if counters:
        assert peng.stats == {k: v for k, v in reng.stats.items()
                              if k in peng.stats}
    return flips


def _streams(done):
    return {r.req_id: tuple(r.tokens_out) for r in done}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_temp0_stochastic_identical_to_greedy(tiny, layout):
    """temperature 0 through the stochastic sampler is the greedy engine,
    token for token, at span 1 and 8, like the reference's."""
    for span in (1, 8):
        greedy = _run("port", tiny, span, REQS, kv_layout=layout)
        got = _run("port", tiny, span, REQS, kv_layout=layout,
                   sampler="stochastic",
                   sampling=lambda m: m.SamplingParams(temperature=0.0,
                                                       seed=3))
        assert _streams(got[1]) == _streams(greedy[1]), (layout, span)
        ref = _run("ref", tiny, span, REQS, kv_layout=layout,
                   sampler="stochastic",
                   sampling=lambda m: m.SamplingParams(temperature=0.0,
                                                       seed=3))
        _assert_like(tiny, got, ref)


def test_fixed_seed_stream_span_and_layout_invariant(tiny):
    """A seeded stream is the same at span 1 and 8 on both layouts, and
    the reference's at each, and differs from greedy."""
    outs = {}
    for layout in ("dense", "paged"):
        for span in (1, 8):
            kw = dict(kv_layout=layout, sampler="stochastic",
                      sampling=lambda m: _sp(m))
            port = _run("port", tiny, span, REQS, **kw)
            _assert_like(tiny, port, _run("ref", tiny, span, REQS, **kw))
            outs[(layout, span)] = _streams(port[1])
    vals = list(outs.values())
    assert all(v == vals[0] for v in vals), outs.keys()
    assert vals[0] != _streams(_run("port", tiny, 8, REQS)[1])


def test_fixed_seed_stream_batch_invariant(tiny):
    target = (7, _prompt(18, seed=99))
    crowd_reqs = [(1, _prompt(25, seed=101)), target,
                  (2, _prompt(11, seed=102))]
    kw = dict(sampler="stochastic", sampling=lambda m: _sp(m, seed=21))
    solo = _run("port", tiny, 8, [target], **kw)
    crowd = _run("port", tiny, 8, crowd_reqs, **kw)
    assert _streams(crowd[1])[7] == _streams(solo[1])[7]
    _assert_like(tiny, crowd, _run("ref", tiny, 8, crowd_reqs, **kw))


def test_fixed_seed_stream_prefill_mode_invariant(tiny):
    kw = dict(sampler="stochastic", sampling=lambda m: _sp(m, seed=5))
    mono = _run("port", tiny, 8, REQS, **kw)
    chunked = _run("port", tiny, 8, REQS, prefill_chunk=8,
                   kv_layout="paged", **kw)
    assert _streams(chunked[1]) == _streams(mono[1])
    _assert_like(tiny, chunked, _run("ref", tiny, 8, REQS, prefill_chunk=8,
                                     kv_layout="paged", **kw))


def _park_run(side, tiny, span):
    """One request: prefill + a 4-token span, parked, three frozen spans,
    the transfer's time passes, then served to the end."""
    clock = ManualClock()
    eng = _mk(side, tiny, span, clock=clock, sampler="stochastic")
    _submit(eng, side, [(0, _prompt(11, seed=9))], 20,
            lambda m: _sp(m, seed=13))
    eng.step()
    assert len(eng.slot_req[0].tokens_out) == 5
    assert eng._evict_someone(exclude=-1)
    for _ in range(3):
        eng.step()
    clock.t += 1.0
    return eng, eng.run_until_done()


def test_stochastic_stream_survives_park_unpark(tiny):
    """Parked mid-stream and unparked, the request emits the undisturbed
    stream: keys re-derive from seed + emitted index."""
    ref_solo = _run("port", tiny, 1, [(0, _prompt(11, seed=9))], max_new=20,
                    sampler="stochastic", sampling=lambda m: _sp(m, seed=13))
    port = _park_run("port", tiny, 4)
    assert port[0].stats["unparked"] == 1
    assert _streams(port[1]) == _streams(ref_solo[1])
    _assert_like(tiny, port, _park_run("ref", tiny, 4))


def _preempt_run(side, tiny):
    eng = _mk(side, tiny, 8, sampler="stochastic")
    _submit(eng, side, [(0, _prompt(13, seed=31))], 16,
            lambda m: _sp(m, seed=17))
    eng.step()
    assert len(eng.slot_req[0].tokens_out) > 1
    eng._preempt_restart(0)
    return eng, eng.run_until_done()


def test_stochastic_stream_survives_preempt_restart(tiny):
    undisturbed = _run("port", tiny, 8, [(0, _prompt(13, seed=31))],
                       max_new=16, sampler="stochastic",
                       sampling=lambda m: _sp(m, seed=17))
    port = _preempt_run("port", tiny)
    assert port[0].stats["preempt_restarts"] == 1
    assert _streams(port[1]) == _streams(undisturbed[1])
    _assert_like(tiny, port, _preempt_run("ref", tiny))


def test_prefill_selects_first_token_through_sampler():
    src = (inspect.getsource(engine_mod.ServingEngine._prefill_full)
           + inspect.getsource(engine_mod.ServingEngine._process_chunk))
    assert "argmax" not in src
    assert "_first_token" in src


def test_host_sync_accounting_covers_prefill(tiny):
    for kw in (dict(), dict(prefill_chunk=8, kv_layout="paged")):
        eng, _ = _run("port", tiny, 4, REQS, max_new=9, **kw)
        assert eng.stats["host_syncs"] == (eng.stats["prefills"]
                                           + eng.stats["decode_spans"]), kw
        if kw:
            assert eng.stats["prefill_chunks"] > eng.stats["prefills"]


def test_stochastic_adds_zero_host_syncs(tiny):
    for span in (1, 8):
        g, _ = _run("port", tiny, span, REQS)
        s, _ = _run("port", tiny, span, REQS, sampler="stochastic",
                    sampling=lambda m: _sp(m))
        assert s.stats["host_syncs"] == g.stats["host_syncs"], span
        assert s.stats["decode_spans"] == g.stats["decode_spans"], span


def test_logprobs_recorded_without_extra_syncs(tiny):
    reqs = [(0, _prompt(10, seed=41)), (1, _prompt(14, seed=42))]
    sampling = {0: True, 1: False}

    def run(side):
        eng = _mk(side, tiny, 8, sampler="stochastic")
        mod = _mod(side)
        for i, p in reqs:
            eng.submit(mod.Request(i, p.copy(), max_new_tokens=8,
                                   sampling=_sp(mod, seed=2,
                                                logprobs=sampling[i])))
        return eng, eng.run_until_done()

    port = run("port")
    eng, done = port
    assert eng.stats["host_syncs"] == (eng.stats["prefills"]
                                       + eng.stats["decode_spans"])
    r = {d.req_id: d for d in done}
    assert len(r[0].logprobs_out) == len(r[0].tokens_out) == 8
    assert all(lp <= 0.0 for lp in r[0].logprobs_out)
    assert r[1].logprobs_out == []
    _assert_like(tiny, port, run("ref"))


def test_third_party_sampler_via_registry(tiny):
    @api.register_sampler("const-seven")
    class ConstSampler:
        """Always emits token 7."""
        needs_rng = False

        def slot_params(self, req):
            return ()

        def sample(self, logits, keys, params):
            return torch.full(logits.shape[:1], 7, dtype=torch.int32)

    try:
        _, done = _run("port", tiny, 4, [(0, _prompt(9, seed=51))],
                       max_new=6, sampler="const-seven")
        assert tuple(done[0].tokens_out) == (7,) * 6
    finally:
        api.SAMPLERS.pop("const-seven", None)


def test_seed_outside_int32_wraps_instead_of_crashing(tiny):
    reqs = [(2**40 + 3, _prompt(9, seed=61))]
    kw = dict(max_new=6, sampler="stochastic",
              sampling=lambda m: _sp(m, seed=2**31 + 5))
    port = _run("port", tiny, 8, reqs, **kw)
    assert len(port[1][0].tokens_out) == 6
    _assert_like(tiny, port, _run("ref", tiny, 8, reqs, **kw))


def test_unknown_sampler_name_is_loud(tiny):
    with pytest.raises(ValueError, match="unknown sampler"):
        _mk("port", tiny, 4, sampler="nope")


def test_stochastic_sampler_registered_with_slot_params():
    from repro_torch.serve.samplers import StochasticSampler
    s = api.make_sampler("stochastic")
    assert isinstance(s, StochasticSampler) and s.needs_rng
    req = api.Request(0, np.ones(3, np.int32),
                      sampling=api.SamplingParams(temperature=0.5, top_k=7,
                                                  top_p=0.8))
    got = s.slot_params(req)
    assert [type(v) for v in got] == [np.float32, np.int32, np.float32]
    assert got == (np.float32(0.5), np.int32(7), np.float32(0.8))
    assert s.slot_params(None) == (np.float32(0.0), np.int32(0),
                                   np.float32(1.0))
