"""The port on a CUDA card: each kernel against its plain version, and
the serving engine on the card against the same engine on the CPU, on
the paged (qwen3-8b, moonshot-v1-16b-a3b), recurrent (rwkv6-1.6b) and
dense (jamba-v0.1-52b) backends.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor ``repro``, so it also runs on a machine without
JAX, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssm_decode as sd  # noqa: E402
from repro_torch.kernels import wkv6  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, dtype, window):
    rng = np.random.default_rng(5)
    q, k, v = [_randn(rng, *s).to(cuda, dtype)
               for s in ((2, 8, 300, 128), (2, 2, 300, 128),
                         (2, 2, 300, 128))]
    n = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, window=window)
    assert fa.flash_attention.launches == n + 1
    expected = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        window=window)
    torch.testing.assert_close(out.float(), expected, atol=_TOL[dtype],
                               rtol=_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain(cuda, dtype):
    """Length 0 gives 0; a length past MP * page reads MP pages only."""
    rng = np.random.default_rng(6)
    q = _randn(rng, 4, 8, 128).to(cuda, dtype)
    kp, vp = [_randn(rng, 32, 16, 2, 128).to(cuda, dtype) for _ in range(2)]
    table = torch.from_numpy(rng.integers(0, 32, (4, 4)).astype(
        np.int32)).to(cuda)
    lengths = torch.tensor([0, 30, 64, 200], dtype=torch.int32, device=cuda)
    n = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, kp, vp, table, lengths)
    assert pa.paged_decode_attention.launches == n + 1
    assert not out[0].float().any()
    expected = pa.paged_decode_plain(q.float(), kp.float(), vp.float(),
                                     table, lengths)
    torch.testing.assert_close(out.float(), expected, atol=_TOL[dtype],
                               rtol=_TOL[dtype])


@pytest.mark.parametrize("B,H,KV", [(2, 4, 4), (1, 8, 2)])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 1531])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_bf16_kernel_matches_plain(cuda, hd, S, B, H, KV):
    """The tensor-core kernel at every head dim it is built for, on
    lengths at and around its 64-row tiles, G = 1 and 4; two calls agree
    bit for bit."""
    rng = np.random.default_rng(hd + S)
    q, k, v = [_randn(rng, *s).to(cuda, torch.bfloat16)
               for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]
    out = fa.flash_attention(q, k, v)
    assert torch.equal(out, fa.flash_attention(q, k, v))
    expected = fa.flash_attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), expected, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window", [32, 96])
def test_flash_bf16_window_matches_plain(cuda, window):
    """The sliding window on the tensor-core kernel: band edge tiles
    masked, tiles left of the band skipped."""
    rng = np.random.default_rng(window)
    q, k, v = [_randn(rng, *s).to(cuda, torch.bfloat16)
               for s in ((1, 8, 333, 64), (1, 2, 333, 64), (1, 2, 333, 64))]
    out = fa.flash_attention(q, k, v, window=window)
    assert torch.equal(out, fa.flash_attention(q, k, v, window=window))
    expected = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        window=window)
    torch.testing.assert_close(out.float(), expected, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,H,KV,S,hd,hd_v", [(1, 8, 2, 300, 120, 120),
                                              (2, 4, 1, 65, 120, 120),
                                              (1, 4, 4, 257, 48, 32),
                                              (2, 8, 8, 64, 48, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_through_padded_head_dims(cuda, dtype, B, H, KV, S, hd,
                                               hd_v):
    """The model's prefill attention at head dims B2 is not built for
    (120, and q/k 48 with v 32) runs B2 once, zero-padded to 128 or 64,
    and matches the plain attention on the unpadded tensors."""
    from repro_torch.models.attention import chunked_causal_attention
    rng = np.random.default_rng(hd + S)
    q, k, v = [_randn(rng, *s).to(cuda, dtype)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd_v))]
    n = fa.flash_attention.launches
    out = chunked_causal_attention(q, k, v)
    assert fa.flash_attention.launches == n + 1
    assert out.shape == (B, S, H, hd_v)
    expected = fa.flash_attention_plain(*(t.float().transpose(1, 2)
                                          for t in (q, k, v)))
    torch.testing.assert_close(out.float(), expected.transpose(1, 2),
                               atol=_TOL[dtype], rtol=_TOL[dtype])


@pytest.mark.parametrize("MP", [1, 32])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (6, 2), (16, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_split_kernel_edges(cuda, dtype, H, KV, MP):
    """B1's split at its edges (page 16; MP 32 gives partitions of 4
    pages): lengths 0, 1, a page, a partition, a partition + 1, MP * page
    and past it; G = 1, 4, and 3 and 8 (several blocks per KV head).
    Length 0 gives exactly 0; two calls agree bit for bit; the result
    matches the plain version and the plain split algorithm."""
    page = 16
    pp = pa.partition_pages(MP, page)
    lengths = sorted({0, 1, page, pp * page, pp * page + 1, MP * page,
                      MP * page + 88})
    rng = np.random.default_rng(MP + H)
    q = _randn(rng, len(lengths), H, 128).to(cuda, dtype)
    kp, vp = [_randn(rng, 80, page, KV, 128).to(cuda, dtype)
              for _ in range(2)]
    table = torch.from_numpy(rng.integers(0, 80, (len(lengths), MP)).astype(
        np.int32)).to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    out = pa.paged_decode_attention(q, kp, vp, table, lens)
    assert torch.equal(out, pa.paged_decode_attention(q, kp, vp, table,
                                                      lens))
    assert not out[0].float().any()
    for expected in (pa.paged_decode_plain(q.float(), kp.float(),
                                           vp.float(), table, lens),
                     pa.paged_decode_split_plain(q.float(), kp.float(),
                                                 vp.float(), table, lens,
                                                 partition_pages=pp)):
        torch.testing.assert_close(out.float(), expected, atol=_TOL[dtype],
                                   rtol=_TOL[dtype])


def test_engine_on_card_matches_cpu(cuda):
    """fp32 SMOKE weights, page pressure that parks: the card's streams
    (kernels) equal the CPU's (plain versions)."""
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (31, 26, 23, 13)]
    streams, stats = {}, {}
    for dev in ("cpu", "cuda"):
        p = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
        eng = ServingEngine(cfg, p, api.EngineConfig(
            slots=3, cache_len=64, page_size=8, n_pages=9, eos_token=-1,
            decode_span=8, kv_layout="paged"), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(api.Request(i, pr, max_new_tokens=12))
        streams[dev] = {r.req_id: r.tokens_out
                        for r in eng.run_until_done()}
        stats[dev] = eng.stats
    assert stats["cuda"]["parked"] > 0
    assert stats["cuda"]["host_syncs"] == (stats["cuda"]["prefills"]
                                           + stats["cuda"]["decode_spans"])
    assert streams["cuda"] == streams["cpu"]


def test_decode_span_never_syncs_on_card(cuda):
    """No host synchronisation inside a decode span on the card: CUDA's
    sync debug mode turns any device->host wait into an error."""
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    state = lm.init_paged_serve_state(cfg, 3, 16, 8, 4, device=cuda)
    state["page_table"] = torch.arange(12, dtype=torch.int32,
                                       device=cuda).reshape(3, 4)
    state["lengths"][:] = torch.tensor([5, 9, 0], dtype=torch.int32)
    state["positions"].copy_(state["lengths"])
    args = (torch.tensor([3, 4, 5], dtype=torch.int32, device=cuda),)
    active = torch.tensor([True, True, False], device=cuda)
    budgets = torch.tensor([8, 3, 8], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emit, state = lm.decode_span(
            params, *args, state, cfg, active, budgets, span=8,
            eos_token=-1, cache_len=32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert emit.sum(0).tolist() == [8, 3, 0]
    assert state["positions"].tolist() == [13, 12, 0]


def _wkv_inputs(rng, B, S, H, hd, dtype, cuda):
    """r, k, v in `dtype`; logw in the model's clamp range; u, S0 fp32."""
    r, k, v = [_randn(rng, B, S, H, hd).to(cuda, dtype) for _ in range(3)]
    logw = -torch.exp(torch.clamp(_randn(rng, B, S, H, hd), -8, 0.5))
    u = _randn(rng, H, hd) * 0.1
    s0 = _randn(rng, B, H, hd, hd) * 0.1
    return r, k, v, logw.to(cuda), u.to(cuda), s0.to(cuda)


@pytest.mark.parametrize("chunk", [1, 32])
@pytest.mark.parametrize("hd", [6, 8, 64, 128])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 37, 300, 1531])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_chunked_kernel_matches_plain(cuda, dtype, S, hd, chunk):
    """Both run fp32 math on the same (upcast) inputs: the tolerances of
    tests/test_kernels.py, y 2e-4 and state 2e-5, for either r/k/v
    dtype, B = 2 and a non-zero state0. The three passes at their edges:
    one token, a chunk less one, a chunk, a chunk and one, ragged tails,
    a long prompt; chunks of 1 and 32; hd 8, 64 and 128 (rows loaded by
    cp.async) and 6 (rows that are no 16-byte multiple, loaded element by
    element and padded to 8 on chip). One wrapper call counts one
    launch."""
    rng = np.random.default_rng(7 + S + hd)
    xs = _wkv_inputs(rng, 2, S, 2, hd, dtype, cuda)
    assert float(xs[-1].abs().max()) > 0
    n = wkv6.wkv6_chunked.launches
    y, s = wkv6.wkv6_chunked(*xs, chunk=chunk)
    assert wkv6.wkv6_chunked.launches == n + 1
    ey, es = wkv6.wkv6_chunked_plain(*xs, chunk=chunk)
    torch.testing.assert_close(y, ey, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, es, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,H", [(1, 1), (4, 8), (4, 32)])
@pytest.mark.parametrize("hd", [6, 8, 16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_decode_kernel_matches_plain(cuda, dtype, hd, B, H):
    """One token per (slot, head) at 1e-5, and the t = 1 column of the
    chunked kernel gives the same token; two calls bit for bit. B3's
    column tiles at their edges: 16 value columns a block at hd 16, 64
    and 128, a partial tile at hd 8, element by element at hd 6 (rows
    that are no 16-byte multiple); B * H of 1, 32 and 128."""
    rng = np.random.default_rng(8 + hd + B * H)
    r, k, v, logw, u, s0 = _wkv_inputs(rng, B, 1, H, hd, dtype, cuda)
    w = torch.exp(logw)
    args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    n = wkv6.wkv6_decode.launches
    y, s = wkv6.wkv6_decode(*args)
    assert wkv6.wkv6_decode.launches == n + 1
    ey, es = wkv6.wkv6_decode_plain(*args)
    torch.testing.assert_close(y, ey, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s, es, atol=1e-5, rtol=1e-5)
    cy, cs = wkv6.wkv6_chunked(r, k, v, torch.log(w), u, s0, chunk=1)
    torch.testing.assert_close(cy[:, 0], y, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(cs, s, atol=2e-5, rtol=2e-5)
    y2, s2 = wkv6.wkv6_decode(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_rwkv_engine_on_card_matches_cpu(cuda):
    """fp32 SMOKE rwkv6 on the recurrent backend with fewer pages than
    slots, so it parks: the card's streams (kernels B3/B4) equal the
    CPU's (plain versions), through both kernels."""
    cfg = SMOKE_CONFIGS["rwkv6-1.6b"].scaled(dtype="float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (31, 26, 40, 13)]
    streams, stats = {}, {}
    chunked, decode = wkv6.wkv6_chunked.launches, wkv6.wkv6_decode.launches
    for dev in ("cpu", "cuda"):
        p = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
        eng = ServingEngine(cfg, p, api.EngineConfig(
            slots=3, cache_len=64, page_size=8, n_pages=2, eos_token=-1,
            decode_span=8, kv_layout="recurrent"), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(api.Request(i, pr, max_new_tokens=12))
        streams[dev] = {r.req_id: r.tokens_out
                        for r in eng.run_until_done()}
        stats[dev] = eng.stats
    st = stats["cuda"]
    assert st["parked"] > 0 and st["unparked"] == st["parked"]
    assert st["host_syncs"] == st["prefills"] + st["decode_spans"]
    assert (wkv6.wkv6_chunked.launches - chunked
            == cfg.n_layers * st["prefills"])
    assert (wkv6.wkv6_decode.launches - decode
            == cfg.n_layers * st["decode_steps"])
    assert streams["cuda"] == streams["cpu"]


def test_rwkv_decode_span_never_syncs_on_card(cuda):
    """No host synchronisation inside an RWKV decode span on the card,
    the freeze of inactive slots included."""
    cfg = SMOKE_CONFIGS["rwkv6-1.6b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    state = lm.init_serve_state(cfg, 3, 64, device=cuda)
    state["lengths"][:] = torch.tensor([5, 9, 0], dtype=torch.int32)
    state["positions"].copy_(state["lengths"])
    frozen = state["caches"][0]["wkv"][2].clone()
    args = (torch.tensor([3, 4, 5], dtype=torch.int32, device=cuda),)
    active = torch.tensor([True, True, False], device=cuda)
    budgets = torch.tensor([8, 3, 8], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emit, state = lm.decode_span(
            params, *args, state, cfg, active, budgets, span=8,
            eos_token=-1, cache_len=32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert emit.sum(0).tolist() == [8, 3, 0]
    assert state["positions"].tolist() == [13, 12, 0]
    assert torch.equal(state["caches"][0]["wkv"][2], frozen)


def _dispatch_inputs(rng, T, D, E, dtype, cuda):
    """Token rows and each row's queue position among the rows of its
    expert (a cumsum of one-hots, as the MoE layer computes them)."""
    toks = _randn(rng, T, D).to(cuda, dtype)
    eids = torch.from_numpy(rng.integers(0, E, size=T).astype(np.int32))
    onehot = (eids[:, None] == torch.arange(E)).to(torch.int32)
    pos = torch.cumsum(onehot, 0, dtype=torch.int32).gather(
        1, eids[:, None].long())[:, 0] - 1
    return toks, eids.to(cuda), pos.to(cuda)


@pytest.mark.parametrize("T,D,E,C", [(64, 32, 8, 12), (100, 16, 4, 40),
                                     (32, 8, 2, 4), (128, 64, 16, 8),
                                     (48, 7, 3, 5), (24, 2048, 64, 4),
                                     (3000, 2048, 64, 60)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_kernel_equals_plain(cuda, dtype, T, D, E, C):
    """Exactly equal, on the sweep of tests/test_kernels.py, an odd row
    width (the element-by-element path), moonshot's decode shape and a
    prefill-sized case where rows drop."""
    rng = np.random.default_rng(T + D + E)
    toks, eids, pos = _dispatch_inputs(rng, T, D, E, dtype, cuda)
    n = md.moe_dispatch.launches
    out = md.moe_dispatch(toks, eids, pos, E, C)
    assert md.moe_dispatch.launches == n + 1
    assert torch.equal(out, md.moe_dispatch_plain(toks, eids, pos, E, C))


@pytest.mark.parametrize("T,D,E,C", [(64, 32, 8, 12), (100, 16, 4, 40),
                                     (48, 7, 3, 5), (64, 64, 8, 100),
                                     (0, 64, 4, 8), (3000, 2048, 64, 60)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_kernel_on_sparse_positions(cuda, dtype, T, D, E, C):
    """Exactly equal to the plain version where positions are not dense
    from 0 and come in no order, some rows fall past C, some ids are out
    of range, whole tiles of slots get no row (C 100 for 64 rows), and
    where there are no rows at all."""
    rng = np.random.default_rng(T + C)
    toks = _randn(rng, T, D).to(cuda, dtype)
    eids = rng.integers(0, E + 2, size=T).astype(np.int32)
    pos = np.zeros(T, np.int32)
    for e in range(E + 2):
        at = np.nonzero(eids == e)[0]
        pos[at] = rng.permutation(max(2 * C, len(at)))[:len(at)]
    eids, pos = torch.from_numpy(eids).to(cuda), torch.from_numpy(pos).to(cuda)
    n = md.moe_dispatch.launches
    out = md.moe_dispatch(toks, eids, pos, E, C)
    assert md.moe_dispatch.launches == n + 1
    assert torch.equal(out, md.moe_dispatch_plain(toks, eids, pos, E, C))


def test_moe_dispatch_kernel_on_unaligned_rows(cuda):
    """Token rows that start off a 16-byte boundary (a view at an odd
    offset) take the element-by-element path and still equal the plain
    version; a non-contiguous view is refused."""
    rng = np.random.default_rng(9)
    toks, eids, pos = _dispatch_inputs(rng, 65, 64, 8, torch.bfloat16, cuda)
    flat = toks.reshape(-1)[1:].reshape(-1)[:64 * 64].reshape(64, 64)
    out = md.moe_dispatch(flat, eids[:64], pos[:64], 8, 10)
    assert torch.equal(out, md.moe_dispatch_plain(flat, eids[:64], pos[:64],
                                                  8, 10))
    with pytest.raises(ValueError):
        md.moe_dispatch(toks.t(), eids[:64], pos[:64], 8, 10)


def test_moe_engine_on_card_matches_cpu(cuda):
    """fp32 SMOKE moonshot on the paged backend with page pressure that
    parks: the card's streams (kernels B1, B2, B7) equal the CPU's (plain
    versions), and every kernel ran once per layer of its kind."""
    cfg = SMOKE_CONFIGS["moonshot-v1-16b-a3b"].scaled(dtype="float32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (31, 26, 23, 13)]
    streams, stats = {}, {}
    n_moe = cfg.mlp_kinds().count("moe")
    before = (md.moe_dispatch.launches, fa.flash_attention.launches,
              pa.paged_decode_attention.launches)
    for dev in ("cpu", "cuda"):
        p = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
        eng = ServingEngine(cfg, p, api.EngineConfig(
            slots=3, cache_len=64, page_size=8, n_pages=9, eos_token=-1,
            decode_span=8, kv_layout="paged"), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(api.Request(i, pr, max_new_tokens=12))
        streams[dev] = {r.req_id: r.tokens_out
                        for r in eng.run_until_done()}
        stats[dev] = eng.stats
    st = stats["cuda"]
    assert st["parked"] > 0 and st["unparked"] == st["parked"]
    assert st["host_syncs"] == st["prefills"] + st["decode_spans"]
    assert (md.moe_dispatch.launches - before[0]
            == n_moe * (st["prefills"] + st["decode_steps"]))
    assert (fa.flash_attention.launches - before[1]
            == cfg.n_layers * st["prefills"])
    assert (pa.paged_decode_attention.launches - before[2]
            == cfg.n_layers * st["decode_steps"])
    assert streams["cuda"] == streams["cpu"]


def test_moe_decode_span_never_syncs_on_card(cuda):
    """No host synchronisation inside a decode span through MoE layers
    (routing, queue positions, the B7 dispatch and the combine) on the
    card."""
    cfg = SMOKE_CONFIGS["moonshot-v1-16b-a3b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    state = lm.init_paged_serve_state(cfg, 3, 16, 8, 4, device=cuda)
    state["page_table"] = torch.arange(12, dtype=torch.int32,
                                       device=cuda).reshape(3, 4)
    state["lengths"][:] = torch.tensor([5, 9, 0], dtype=torch.int32)
    state["positions"].copy_(state["lengths"])
    args = (torch.tensor([3, 4, 5], dtype=torch.int32, device=cuda),)
    active = torch.tensor([True, True, False], device=cuda)
    budgets = torch.tensor([8, 3, 8], dtype=torch.int32, device=cuda)
    n = md.moe_dispatch.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emit, state = lm.decode_span(
            params, *args, state, cfg, active, budgets, span=8,
            eos_token=-1, cache_len=32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert md.moe_dispatch.launches - n == 8
    assert emit.sum(0).tolist() == [8, 3, 0]
    assert state["positions"].tolist() == [13, 12, 0]


@pytest.mark.parametrize("B,T,D,N", [(2, 16, 8, 4), (1, 32, 16, 4),
                                     (3, 8, 32, 8), (1, 256, 8192, 16),
                                     (1, 108, 8192, 16), (2, 9, 24, 16)])
def test_linear_scan_kernel_matches_plain(cuda, B, T, D, N):
    """The sweep of tests/test_kernels.py, jamba's prefill chunk and its
    ragged tail, and a T that leaves a remainder of the unrolled loop:
    within 1e-5 (the kernel rounds as the plain version does)."""
    rng = np.random.default_rng(B * T + D)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, T, D, N)).astype(
        np.float32)).to(cuda)
    b, h0 = _randn(rng, B, T, D, N).to(cuda), _randn(rng, B, D, N).to(cuda)
    n = ls.linear_scan.launches
    hs, hl = ls.linear_scan(a, b, h0)
    assert ls.linear_scan.launches == n + 1
    ehs, ehl = ls.linear_scan_plain(a, b, h0)
    torch.testing.assert_close(hs, ehs, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hl, ehl, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("B,Di,N", [(2, 8, 4), (1, 32, 8), (3, 16, 4),
                                    (4, 8192, 16), (3, 5, 8),
                                    *((B, Di, N) for N in (1, 2, 4, 8, 16, 32)
                                      for B, Di in ((1, 5), (3, 300)))])
def test_ssm_decode_kernel_matches_plain_and_scan(cuda, B, Di, N, offset):
    """One token on the sweep of tests/test_kernels.py, jamba's decode
    shape, every N the kernel takes (four n a thread from N 4, one below)
    with Di ragged against every block's d-range, and h, dA one element
    into larger buffers (not 16-byte aligned: the one-n-a-thread instance
    at any N). y within 1e-5 of the plain version; h' equal to it and to
    the T = 1 step of the B6 kernel; two calls bit for bit."""
    rng = np.random.default_rng(B * Di * N + offset)
    n = B * Di * N
    h = _randn(rng, n + offset).to(cuda)[offset:].view(B, Di, N)
    dA = torch.from_numpy(rng.uniform(0.5, 1.0, n + offset).astype(
        np.float32)).to(cuda)[offset:].view(B, Di, N)
    dtx = _randn(rng, B, Di).to(cuda)
    Bs, Cs = _randn(rng, B, N).to(cuda), _randn(rng, B, N).to(cuda)
    launches = sd.ssm_decode_step.launches
    y, hn = sd.ssm_decode_step(h, dA, dtx, Bs, Cs)
    assert sd.ssm_decode_step.launches == launches + 1
    ey, ehn = sd.ssm_decode_step_plain(h, dA, dtx, Bs, Cs)
    torch.testing.assert_close(y, ey, atol=1e-5, rtol=1e-5)
    assert torch.equal(hn, ehn)
    _, sl = ls.linear_scan(dA[:, None].contiguous(),
                           (dtx[..., None] * Bs[:, None, :])[:, None]
                           .contiguous(), h)
    assert torch.equal(sl, hn)
    y2, hn2 = sd.ssm_decode_step(h, dA, dtx, Bs, Cs)
    assert torch.equal(y, y2) and torch.equal(hn, hn2)
    z, z2 = torch.zeros(B, Di, 3, device=cuda), torch.zeros(B, 3, device=cuda)
    with pytest.raises(ValueError):             # N = 3 does not divide 32
        sd.ssm_decode_step(z, z, dtx, z2, z2)


def test_jamba_engine_on_card_matches_cpu(cuda):
    """fp32 SMOKE jamba on the dense backend with a page budget that
    parks: the card's streams (kernels B2, B5, B6, B7) equal the CPU's
    (plain versions), and each kernel ran as often as its layers and the
    engine's counters say (B6 once per Mamba layer per 256-token chunk;
    these prompts are one chunk each)."""
    cfg = SMOKE_CONFIGS["jamba-v0.1-52b"].scaled(dtype="float32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (31, 26, 23, 13)]
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    wrappers = (fa.flash_attention, ls.linear_scan, sd.ssm_decode_step,
                md.moe_dispatch, pa.paged_decode_attention)
    streams, stats = {}, {}
    for dev in ("cpu", "cuda"):
        p = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
        eng = ServingEngine(cfg, p, api.EngineConfig(
            slots=3, cache_len=64, page_size=8, n_pages=10, eos_token=-1,
            decode_span=8, kv_layout="dense"), device=dev)
        before = [w.launches for w in wrappers]
        for i, pr in enumerate(prompts):
            eng.submit(api.Request(i, pr, max_new_tokens=12))
        streams[dev] = {r.req_id: r.tokens_out
                        for r in eng.run_until_done()}
        stats[dev] = eng.stats
    st = stats["cuda"]
    assert st["parked"] > 0 and st["unparked"] == st["parked"]
    assert st["host_syncs"] == st["prefills"] + st["decode_spans"]
    got = [w.launches - n for w, n in zip(wrappers, before)]
    assert got == [kinds.count("attn") * st["prefills"],
                   kinds.count("mamba") * st["prefills"],
                   kinds.count("mamba") * st["decode_steps"],
                   mlps.count("moe") * (st["prefills"] + st["decode_steps"]),
                   0]
    assert streams["cuda"] == streams["cpu"]


def test_jamba_decode_span_never_syncs_on_card(cuda):
    """No host synchronisation inside a decode span on the dense backend
    through Mamba (B5 and the commit of its carry), dense attention (the
    slab write and its restore for inactive slots) and MoE layers; the
    inactive slot's slabs and carries stay as they were."""
    cfg = SMOKE_CONFIGS["jamba-v0.1-52b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    state = lm.init_serve_state(cfg, 3, 64, device=cuda)
    for layer in state["caches"]:
        for t in layer.values():
            t.normal_()
    state["lengths"][:] = torch.tensor([5, 9, 0], dtype=torch.int32)
    state["positions"].copy_(state["lengths"])
    frozen = [{k: t[2].clone() for k, t in layer.items()}
              for layer in state["caches"]]
    args = (torch.tensor([3, 4, 5], dtype=torch.int32, device=cuda),)
    active = torch.tensor([True, True, False], device=cuda)
    budgets = torch.tensor([8, 3, 8], dtype=torch.int32, device=cuda)
    n = sd.ssm_decode_step.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emit, state = lm.decode_span(
            params, *args, state, cfg, active, budgets, span=8,
            eos_token=-1, cache_len=32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sd.ssm_decode_step.launches - n == 8 * cfg.layer_kinds().count(
        "mamba")
    assert emit.sum(0).tolist() == [8, 3, 0]
    assert state["positions"].tolist() == [13, 12, 0]
    for layer, old in zip(state["caches"], frozen):
        for k, t in layer.items():
            assert torch.equal(t[2], old[k]), k
