"""The port on a CUDA card: each kernel against its plain version, and
the serving engine on the card against the same engine on the CPU, on
the paged (qwen3-8b, moonshot-v1-16b-a3b), recurrent (rwkv6-1.6b) and
dense (jamba-v0.1-52b) backends; chunked prefill against monolithic
prefill, and a paged serve with prefix-cache hits; stochastic sampling
on the card against its CPU path, and sampled streams across spans and
parking; B2 in a sliding window at h2o-danube-3-4b's padded head dim,
B1 at nemotron-4-15b's and musicgen-large's head groupings, and a
full-width danube across its ring's wrap; B2's (192, 128) instance, the
MLA engine (deepseek-v2-lite-16b) on the latent and dense backends
against the CPU, and an MLA decode span with no sync; crash and restore
on the card (SMOKE configs crashed at step boundaries on all four
layouts keep the card's clean streams) and bf16 pools bit for bit
through a snapshot, the Checkpointer's files and a restore; B2's
log-sum-exp and the B2-bwd kernels against their plain versions, bit
for bit across calls (the tensor-core route at every instance on its
tile edges), and a SMOKE train step on the card against the CPU; the
other backward kernels (B2-bwd at (192, 128), B7-bwd, B6-bwd,
B4-bwd) against their plain versions on shape sweeps, bit for bit across
calls, and the gradients of SMOKE moonshot, deepseek, rwkv6 and jamba on
the card against the CPU; the device multiqueue on the card against the
CPU, ``batched_enqueue`` against B7's kernel, and ``reshard_tree`` on a
one-rank ``cuda`` mesh; four gloo ranks on a (2, 2) mesh sharing the
card against one-rank card runs.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor ``repro``, so it also runs on a machine without
JAX, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import SMOKE_CONFIGS, get_config  # noqa: E402,E501
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import sampling as ks  # noqa: E402
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


@pytest.mark.parametrize("B,H,KV", [(2, 4, 4), (1, 8, 2)])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 1531])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_mla_head_dims(cuda, dtype, S, B, H, KV):
    """The (192, 128) instance (q/k 192, v 128, MLA's full width) in both
    dtypes on lengths at and around its 64-row tiles, G = 1 and 4: the
    output takes v's width, two calls agree bit for bit, and the model's
    ``chunked_causal_attention`` hands it the tensors unpadded."""
    from repro_torch.models.attention import chunked_causal_attention
    rng = np.random.default_rng(S + H)
    q, k, v = [_randn(rng, *s).to(cuda, dtype)
               for s in ((B, H, S, 192), (B, KV, S, 192), (B, KV, S, 128))]
    out = fa.flash_attention(q, k, v)
    assert out.shape == (B, H, S, 128)
    assert torch.equal(out, fa.flash_attention(q, k, v))
    expected = fa.flash_attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), expected, atol=_TOL[dtype],
                               rtol=_TOL[dtype])
    n = fa.flash_attention.launches
    via_model = chunked_causal_attention(
        *(t.transpose(1, 2) for t in (q, k, v)))
    assert fa.flash_attention.launches == n + 1
    assert torch.equal(via_model.transpose(1, 2), out)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_same_bits_at_every_table_width(cuda, dtype):
    """The engine exports tables at the batch's live width, which parking
    and span reservation move: a slot's output must be the same bits at
    every width that covers its live pages."""
    g = torch.Generator(cuda).manual_seed(0)
    B, H, KV, hd, page = 4, 32, 8, 128, 16
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    kp, vp = [torch.randn(80, page, KV, hd, generator=g, device=cuda)
              .to(dtype) for _ in range(2)]
    lens = torch.tensor([37, 200, 250, 90], dtype=torch.int32, device=cuda)
    table = torch.zeros(B, 128, dtype=torch.int32, device=cuda)
    table[:, :16] = torch.randperm(80, generator=g, device=cuda)[
        :64].reshape(B, 16).to(torch.int32)
    outs = [pa.paged_decode_attention(q, kp, vp,
                                      table[:, :mp].contiguous(), lens)
            for mp in (16, 32, 64, 128)]
    assert all(torch.equal(o, outs[0]) for o in outs)


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
            decode_span=8, kv_layout="paged", prefix_cache_entries=0),
            device=dev)
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


def test_chunked_prefill_matches_monolithic_on_card(cuda):
    """fp32 SMOKE qwen3 on the card: a prompt chained through
    ``prefill_chunk`` (plain chunk attention, padded tail) gives the
    monolithic prefill's logits (B2) within 1e-4, and the CPU chain's."""
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    prompt = np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=75).astype(np.int32)
    chained = {}
    for dev in ("cpu", "cuda"):
        p = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
        caches = lm.init_serve_state(cfg, 1, 96, device=dev)["caches"]
        for pos in range(0, len(prompt), 16):
            nv = min(16, len(prompt) - pos)
            chunk = np.zeros((1, 16), np.int32)
            chunk[0, :nv] = prompt[pos:pos + nv]
            logits, caches = lm.prefill_chunk(
                p, torch.from_numpy(chunk).to(dev), caches, pos, nv, cfg)
        chained[dev] = logits
    n = fa.flash_attention.launches
    mono, _ = lm.prefill(p, torch.from_numpy(prompt[None]).to(cuda), cfg,
                         cache_len=96)
    assert fa.flash_attention.launches == n + cfg.n_layers
    torch.testing.assert_close(chained["cuda"], mono, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(chained["cuda"].cpu(), chained["cpu"],
                               atol=1e-4, rtol=1e-4)


def test_paged_engine_prefix_hit_on_card(cuda):
    """fp32 SMOKE qwen3 on the paged backend with 16-token chunks and the
    prefix cache: requests that share a 32-token prefix hit it, the
    card's streams equal the CPU's, chunks launch no B2 and decode runs
    B1 once per layer per step."""
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    rng = np.random.default_rng(5)
    shared = rng.integers(1, cfg.vocab_size, size=32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        1, cfg.vocab_size, size=n).astype(np.int32)]) for n in (9, 20, 3)]
    streams, stats = {}, {}
    for dev in ("cpu", "cuda"):
        p = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
        eng = ServingEngine(cfg, p, api.EngineConfig(
            slots=2, cache_len=64, page_size=8, n_pages=32, eos_token=-1,
            decode_span=8, kv_layout="paged", prefill_chunk=16,
            prefix_cache_entries=32), device=dev)
        before = (fa.flash_attention.launches,
                  pa.paged_decode_attention.launches)
        eng.submit(api.Request(0, prompts[0], max_new_tokens=6))
        eng.run_until_done()
        for i, pr in enumerate(prompts[1:], 1):
            eng.submit(api.Request(i, pr, max_new_tokens=10))
        streams[dev] = {r.req_id: r.tokens_out
                        for r in eng.run_until_done()}
        stats[dev] = eng.stats
        launched = (fa.flash_attention.launches - before[0],
                    pa.paged_decode_attention.launches - before[1])
    st = stats["cuda"]
    assert st["prefix_hits"] == 2 and st["prefix_tokens_reused"] == 64
    assert st["prefill_chunks"] > st["prefills"]
    assert st["host_syncs"] == st["prefills"] + st["decode_spans"]
    assert launched == (0, cfg.n_layers * st["decode_steps"])
    assert st == stats["cpu"]
    assert streams["cuda"] == streams["cpu"]


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
            decode_span=8, kv_layout="paged", prefix_cache_entries=0),
            device=dev)
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


@pytest.mark.parametrize("layout", ["latent", "dense"])
def test_mla_engine_on_card_matches_cpu(cuda, layout):
    """fp32 SMOKE deepseek-v2-lite-16b with page pressure that parks: the
    card's streams (B2 through C1's padding, B7; the absorbed decode in
    plain PyTorch) equal the CPU's, B2 and B7 ran once per layer of their
    kind and count, B1 never, and the pool is empty after."""
    cfg = SMOKE_CONFIGS["deepseek-v2-lite-16b"].scaled(dtype="float32")
    rng = np.random.default_rng(4)
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
            slots=3, cache_len=64, page_size=8, n_pages=10, eos_token=-1,
            decode_span=8, kv_layout=layout, prefix_cache_entries=0),
            device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(api.Request(i, pr, max_new_tokens=12))
        streams[dev] = {r.req_id: r.tokens_out
                        for r in eng.run_until_done()}
        stats[dev] = eng.stats
        assert eng.pool.n_free == eng.pool.n_pages
    st = stats["cuda"]
    assert st["parked"] > 0 and st["unparked"] == st["parked"]
    assert st["host_syncs"] == st["prefills"] + st["decode_spans"]
    assert (md.moe_dispatch.launches - before[0]
            == n_moe * (st["prefills"] + st["decode_steps"]))
    assert (fa.flash_attention.launches - before[1]
            == cfg.n_layers * st["prefills"])
    assert pa.paged_decode_attention.launches == before[2]
    assert streams["cuda"] == streams["cpu"]


def test_mla_decode_span_never_syncs_on_card(cuda):
    """No host synchronisation inside a decode span through the latent
    pools (the gather through the table, the absorbed attention, the
    dropped write of an inactive slot) on the card."""
    cfg = SMOKE_CONFIGS["deepseek-v2-lite-16b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    state = lm.init_paged_serve_state(cfg, 3, 16, 8, 4, device=cuda)
    state["page_table"] = torch.arange(12, dtype=torch.int32,
                                       device=cuda).reshape(3, 4)
    state["lengths"][:] = torch.tensor([5, 9, 0], dtype=torch.int32)
    state["positions"].copy_(state["lengths"])
    pools = [t.clone() for t in state["caches"][0].values()]
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
    for old, new in zip(pools, state["caches"][0].values()):
        assert torch.equal(old[8:12], new[8:12])      # slot 2's pages


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


def _draw_inputs(seed, V):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((4, V)) * 2.0
    for b in range(4):
        lg[b, rng.choice(V, size=20, replace=False)] += 8.0
    wrap = np.uint32((2**31 + 5) & 0xFFFFFFFF).astype(np.int32)
    return {"logits": torch.from_numpy(lg.astype(np.float32)),
            "temperature": torch.tensor([0.0, 0.7, 1.0, 0.8]),
            "top_k": torch.tensor([0, 0, 50, 0], dtype=torch.int32),
            "top_p": torch.tensor([1.0, 1.0, 1.0, 0.9]),
            "seeds": torch.tensor([int(wrap), -7, 0, 12345],
                                  dtype=torch.int32),
            "req_ids": torch.tensor([0, 1, 2**31 - 1, 9 + seed],
                                    dtype=torch.int32),
            "indices": torch.tensor([0, 17, 2**20, 3], dtype=torch.int32)}


def _draw(x):
    keys = ks.derive_keys(x["seeds"], x["req_ids"], x["indices"])
    flt = (x["temperature"], x["top_k"], x["top_p"])
    tok = ks.sample_logits(x["logits"], keys, *flt)
    return {"keys": keys, "bits": ks.random_bits(keys, 1024),
            "gumbel": ks.gumbel(keys, x["logits"].shape[1]),
            "masked": ks.masked_logits(x["logits"], *flt), "tokens": tok,
            "logprobs": ks.token_logprob(x["logits"], tok)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampling_on_card_matches_cpu(cuda, seed):
    """Keys and bits bit for bit, Gumbel noise within 4 ulp of
    max(|g|, 1), tokens equal wherever the CPU's winner leads by more
    than 1e-4, t = 0 the argmax, logprobs within 1e-5; the card bit for
    bit across two calls and whatever a row's neighbours hold."""
    x = _draw_inputs(seed, 4099)
    xd = {k: v.to(cuda) for k, v in x.items()}
    cpu = _draw(x)
    card = {k: v.cpu() for k, v in _draw(xd).items()}
    again = {k: v.cpu() for k, v in _draw(xd).items()}
    assert all(torch.equal(card[k], again[k]) for k in card)
    assert torch.equal(card["keys"], cpu["keys"])
    assert torch.equal(card["bits"], cpu["bits"])
    g = torch.clamp_min(cpu["gumbel"].abs(), 1.0)
    ulp = torch.nextafter(g, torch.tensor(float("inf"))) - g
    assert bool(((card["gumbel"] - cpu["gumbel"]).abs() <= 4 * ulp).all())
    z = cpu["gumbel"] + cpu["masked"]
    top2 = torch.topk(z, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = card["tokens"] == cpu["tokens"]
    assert bool((same | (margin <= 1e-4)).all())
    assert int(card["tokens"][0]) == int(torch.argmax(x["logits"][0]))
    torch.testing.assert_close(card["logprobs"], cpu["logprobs"],
                               atol=1e-5, rtol=0)
    other = dict(xd)
    other["logits"] = torch.randn(xd["logits"].shape, device=cuda,
                                  generator=torch.Generator(cuda)
                                  .manual_seed(seed)) * 3.0
    other["logits"][1] = xd["logits"][1]
    nb = _draw(other)
    assert torch.equal(nb["masked"][1].cpu(), card["masked"][1])
    assert int(nb["tokens"][1]) == int(card["tokens"][1])


def test_stochastic_streams_across_spans_and_parking_on_card(cuda):
    """2-layer full-width qwen3-8b (bf16) on the paged engine with mixed
    sampling: the same streams at decode_span 1 and 8 and in a run that
    parks; logprobs where asked for; one host sync a prefill and a
    span; B1 once a layer a decode step."""
    cfg = get_config("qwen3-8b").scaled(n_layers=2)
    params = lm.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                            device=cuda)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (37, 200, 333, 90, 150)]
    kinds = ((0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 50, 1.0), (0.8, 0, 0.9),
             (1.3, 40, 0.95))
    runs = {}
    for span, n_pages in ((8, 160), (1, 160), (8, 30)):
        eng = ServingEngine(cfg, params, api.EngineConfig(
            slots=3, cache_len=512, page_size=16, n_pages=n_pages,
            eos_token=-1, decode_span=span, kv_layout="paged",
            prefix_cache_entries=0, sampler="stochastic"), device=cuda)
        for i, pr in enumerate(prompts):
            t, k, p = kinds[i]
            eng.submit(api.Request(i, pr, max_new_tokens=24,
                                   sampling=api.SamplingParams(
                                       temperature=t, top_k=k, top_p=p,
                                       seed=2**31 + i, logprobs=i % 2 == 0)))
        n = pa.paged_decode_attention.launches
        done = eng.run_until_done()
        st = eng.stats
        assert (pa.paged_decode_attention.launches - n
                == cfg.n_layers * st["decode_steps"])
        assert st["host_syncs"] == st["prefills"] + st["decode_spans"]
        for r in done:
            assert len(r.tokens_out) == 24
            if r.sampling.logprobs:
                assert len(r.logprobs_out) == 24
                assert all(np.isfinite(v) and v <= 0 for v in r.logprobs_out)
            else:
                assert r.logprobs_out == []
        runs[(span, n_pages)] = ({r.req_id: r.tokens_out for r in done},
                                 st["parked"])
    assert runs[(8, 30)][1] > 0
    assert runs[(8, 160)][0] == runs[(1, 160)][0] == runs[(8, 30)][0]


# ---------------------------------------------------------------------------
# the rest of the dense family: B2 in a sliding window at a padded head
# dim (h2o-danube-3-4b), B1 at G 6 (nemotron-4-15b) and G 1, hd 64
# (musicgen-large), a full-width danube across its ring's wrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [64, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_through_padded_head_dim(cuda, dtype, window):
    """danube's head dim 120 (GQA 4:1) through the model's zero-padding
    to 128, a sliding window over S 1500: one B2 launch, the plain
    masked softmax on the unpadded tensors, two calls bit for bit."""
    from repro_torch.models.attention import chunked_causal_attention
    rng = np.random.default_rng(window)
    q, k, v = [_randn(rng, *s).to(cuda, dtype)
               for s in ((1, 1500, 8, 120), (1, 1500, 2, 120),
                         (1, 1500, 2, 120))]
    n = fa.flash_attention.launches
    out = chunked_causal_attention(q, k, v, window=window)
    assert fa.flash_attention.launches == n + 1
    assert torch.equal(out, chunked_causal_attention(q, k, v,
                                                     window=window))
    expected = fa.flash_attention_plain(
        *(t.float().transpose(1, 2) for t in (q, k, v)), window=window)
    torch.testing.assert_close(out.float(), expected.transpose(1, 2),
                               atol=_TOL[dtype], rtol=_TOL[dtype])


@pytest.mark.parametrize("H,KV,hd", [(48, 8, 128), (32, 32, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_dense_family_groups(cuda, dtype, H, KV, hd):
    """B1 at nemotron's G = 6 (three blocks of two heads per KV head) and
    musicgen's G = 1 at hd 64, on lengths around a page and a partition:
    the plain version and the plain split algorithm, two calls bit for
    bit, length 0 exactly 0."""
    page, MP = 16, 32
    pp = pa.partition_pages(MP, page)
    lengths = [0, 1, 16, pp * page, pp * page + 1, MP * page, 600]
    rng = np.random.default_rng(H + hd)
    q = _randn(rng, len(lengths), H, hd).to(cuda, dtype)
    kp, vp = [_randn(rng, 80, page, KV, hd).to(cuda, dtype)
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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_danube_full_width_on_card_across_the_ring_wrap(cuda):
    """2-layer h2o-danube-3-4b at full width (hd 120, GQA 4:1), fp32, its
    window cut to 512 so that a 700-token prompt prefills through B2's
    band into a rolled ring and 16 decode steps of a 500-token prompt run
    on past its wrap: the card's logits and ring slabs within 2e-3 of the
    CPU's at every step (TF32 off, the default), the same greedy
    tokens."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("h2o-danube-3-4b").scaled(n_layers=2, dtype="float32",
                                               swa_window=512)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    sides = {"cpu": (torch.device("cpu"), p_cpu),
             "card": (cuda, _to(p_cpu, cuda))}
    rng = np.random.default_rng(0)
    for n, steps in ((700, 8), (500, 16)):
        toks = rng.integers(1, cfg.vocab_size, size=(1, n))
        runs = {name: lm.prefill(params, torch.as_tensor(toks, device=dev),
                                 cfg, cache_len=1024)
                for name, (dev, params) in sides.items()}
        for i in range(steps + 1):
            (lc, sc), (lg, sg) = runs["cpu"], runs["card"]
            torch.testing.assert_close(lg.cpu(), lc, atol=2e-3, rtol=2e-3)
            for a, b in zip(sg["caches"], sc["caches"]):
                assert a["k"].shape[1] == 512
                for key in ("k", "v"):
                    torch.testing.assert_close(a[key].cpu(), b[key],
                                               atol=2e-3, rtol=2e-3)
            nxt = torch.argmax(lc, -1).to(torch.int32)
            assert torch.equal(torch.argmax(lg, -1).cpu().to(torch.int32),
                               nxt)
            if i < steps:
                runs = {name: lm.decode_step(params, nxt.to(dev),
                                             runs[name][1], cfg)
                        for name, (dev, params) in sides.items()}
        assert n + steps > 512


# ---------------------------------------------------------------------------
# crash and restore on the card
# ---------------------------------------------------------------------------

_CRASH_SPEC = dict(arrival="bursty", rate=0.5, burst=4.0, seed=3,
                   prompt_lens=((1.0, 5, 14),), output_lens=((1.0, 5, 10),))


def _crash_trace(cfg, n=4):
    from repro_torch.serve.loadgen import TraceSpec, make_trace
    return lambda: make_trace(TraceSpec(**_CRASH_SPEC), n, cfg.vocab_size)


@pytest.mark.parametrize("arch,layout,every", [
    ("qwen3-8b", "paged", True), ("qwen3-8b", "dense", True),
    ("rwkv6-1.6b", "recurrent", False),
    ("deepseek-v2-lite-16b", "latent", False)])
def test_crash_restore_on_card_keeps_streams(cuda, arch, layout, every):
    """SMOKE configs (bf16 pools and slabs) crashed at every step boundary
    (paged, dense) or at boundaries 1-3 (recurrent, latent) on the card
    give the card's clean streams and outcomes; `drive` holds
    host_syncs == prefills + decode_spans over the restored stats."""
    from repro_torch.ft import crash_anywhere_sweep
    cfg = SMOKE_CONFIGS[arch]
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    kw = dict(slots=2, cache_len=64, page_size=8, n_pages=24,
              kv_layout=layout, decode_span=4, eos_token=-1)
    clean, reports = crash_anywhere_sweep(
        cfg, params, kw, _crash_trace(cfg),
        boundaries=None if every else (1, 2, 3), device=cuda)
    assert clean.steps >= 3
    assert len(reports) == (clean.steps if every else 3)
    for r in reports:
        assert len(r.crash_log) == 1
        s = r.engine_stats
        assert s["host_syncs"] == s["prefills"] + s["decode_spans"]


def test_bf16_pools_survive_snapshot_and_disk_on_card(cuda, tmp_path):
    """A snapshot of bf16 pools on the card, through pack_tree, the
    Checkpointer's files and unpack_tree, restores onto a fresh engine on
    the card bit for bit, into that engine's own tensors."""
    from repro_torch.checkpoint import Checkpointer, pack_tree, unpack_tree
    from repro_torch.ft import build_stack
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    kw = dict(slots=2, cache_len=64, page_size=8, n_pages=24,
              kv_layout="paged", decode_span=4, eos_token=-1)
    fe, rebuild = build_stack(cfg, params, kw, device=cuda)
    handles = [fe.submit(r) for _, r in _crash_trace(cfg)()]
    for _ in range(3):
        fe.step()
    eng = fe.engine
    pool = eng.state["caches"][0]["k"]
    assert pool.dtype == torch.bfloat16 and pool.is_cuda
    snap = eng.snapshot()
    leaves, meta = pack_tree(snap)
    ckpt = Checkpointer(tmp_path / "snaps")
    ckpt.save(3, leaves, extra={"engine_snapshot": meta}, blocking=True)
    disk_meta, disk_leaves = ckpt.load()
    back = unpack_tree(disk_meta["extra"]["engine_snapshot"], disk_leaves)
    eng2 = rebuild()
    ptrs = [t.data_ptr() for layer in eng2.state["caches"]
            for t in layer.values()]
    eng2.restore(back)
    ids = snap["kv"]["page_ids"]
    assert ids
    for a, b in zip(eng.state["caches"], eng2.state["caches"]):
        for k in a:
            assert b[k].is_cuda and b[k].dtype == torch.bfloat16
            assert torch.equal(a[k][ids].view(torch.int16),
                               b[k][ids].view(torch.int16))
    assert ptrs == [t.data_ptr() for layer in eng2.state["caches"]
                    for t in layer.values()]
    fe.reattach(eng2)
    fe.run()
    s = eng2.stats
    assert s["host_syncs"] == s["prefills"] + s["decode_spans"]
    assert all(h.ok and h.streamed == h.req.tokens_out for h in handles)


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("S", [1, 63, 65, 200])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_and_backward_match_plain(cuda, dtype, hd, H, KV, S,
                                            window):
    """B2's lse and B2-bwd's dq, dk, dv against their plain versions on
    the same inputs (fp32 2e-5, bf16 2e-2 of max(1, |ref|)); two calls
    give the same bits; one launch each."""
    rng = np.random.default_rng(hd * 1000 + S + window + H)
    q, k, v, do = [_randn(rng, *s).to(cuda, dtype)
                   for s in ((2, H, S, hd), (2, KV, S, hd), (2, KV, S, hd),
                             (2, H, S, hd))]
    n = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    out, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    assert (fa.flash_attention.launches - n[0],
            fa.flash_attention_bwd.launches - n[1]) == (1, 1)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert torch.equal(out, fa.flash_attention(q, k, v, window=window))
    _, want_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           window=window, return_lse=True)
    want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        out.float(), lse, do.float(),
                                        window=window)
    tol = _TOL[dtype]
    for got, ref in zip((lse, *grads), (want_lse, *want)):
        assert got.dtype == (torch.float32 if got is lse else dtype)
        err = (got.float() - ref).abs() / ref.abs().clamp(min=1)
        assert float(err.max()) <= tol


def test_train_step_on_card_matches_cpu(cuda):
    """A 2-layer qwen3-8b SMOKE model in fp32 (TF32 off) on the card (B2
    with lse, B2-bwd) and on the CPU (the plain versions) from the same
    weights: the gradients within 1e-4 of each leaf's largest; then two
    train steps with microbatch 2, the losses within 1e-5, and the params
    within 5e-5 of max(1, |cpu|) but for at most 1e-3 of the elements,
    each of those within 1 lr: AdamW's m / sqrt(v) can move an element
    whose gradient is near zero by up to lr a step on a 1e-7 gradient
    difference (the largest difference measured 1.3e-4 at lr 1e-3; the
    test prints its readings). Every leaf moved by more than 20 times
    5e-5, so a step that left the params alone fails. B2 launched layers
    x microbatches x 2 (remat) a step, B2-bwd layers x microbatches."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = _to(cpu, cuda)
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 96))
                             .astype(np.int32)) for _ in range(2)]
    (_, _), gc_ = value_and_grad(cpu, toks[0], cfg)
    (_, _), gg = value_and_grad(card, toks[0].to(cuda), cfg)
    for a, b in zip(_leaves(gg), _leaves(gc_)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    lr = 1e-3
    step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=1,
                                            total_steps=4), microbatch=2)
    oc, og = adamw_init(cpu), adamw_init(card)
    start = [p.clone() for p in _leaves(cpu)]
    for t in toks:
        n = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
        cpu, oc, mc = step(cpu, oc, t)
        card, og, mg = step(card, og, t.to(cuda))
        assert (fa.flash_attention.launches - n[0],
                fa.flash_attention_bwd.launches - n[1]) == (2 * 2 * 2, 2 * 2)
        assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-5 * float(
            mc["loss"])
    diffs = [(a.cpu() - b).abs() for a, b in zip(_leaves(card), _leaves(cpu))]
    far = sum(int((d > 5e-5 * b.abs().clamp(min=1)).sum())
              for d, b in zip(diffs, _leaves(cpu)))
    total = sum(b.numel() for b in _leaves(cpu))
    largest = max(float(d.max()) for d in diffs)
    print(f"params: {far} of {total} elements beyond 5e-5, largest "
          f"difference {largest:.3e}")
    assert far <= 1e-3 * total and largest <= lr
    for b, b0 in zip(_leaves(cpu), start):
        assert float((b - b0).abs().max()) > 20 * 5e-5


def _leaves(tree):
    from repro_torch.core.tree import leaves
    return leaves(tree)


def _rel(got, ref):
    """max |got - ref| over the largest |ref| (1 for an all-zero ref)."""
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30) if ref.numel() else 0.0


@pytest.mark.parametrize("S", [1, 63, 65, 200])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_at_mla_head_dims_matches_plain(cuda, dtype, H, KV,
                                                       S):
    """B2-bwd's (192, 128) instance (q/k 192, v 128: deepseek-v2-lite-16b's
    MLA) against its plain version (fp32 2e-5, bf16 2e-2 of max(1,
    |ref|)), the same bits on a second call, one launch."""
    rng = np.random.default_rng(S + H)
    q, k, v, do = [_randn(rng, *s).to(cuda, dtype)
                   for s in ((2, H, S, 192), (2, KV, S, 192),
                             (2, KV, S, 128), (2, H, S, 128))]
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    n = fa.flash_attention_bwd.launches
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do)
    assert fa.flash_attention_bwd.launches == n + 1
    again = fa.flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        out.float(), lse, do.float())
    for got, ref in zip(grads, want):
        assert got.dtype == dtype and got.shape == ref.shape
        err = (got.float() - ref).abs() / ref.abs().clamp(min=1)
        assert float(err.max()) <= _TOL[dtype]


@pytest.mark.parametrize("window", [0, 48, 64, 65])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 4095])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("hd,hd_v", fa.INSTANCES)
def test_flash_backward_tensor_cores_match_plain(cuda, hd, hd_v, H, KV, S,
                                                 window):
    """B2-bwd's bf16 route (the tensor-core kernels, P and dS rounded to
    bf16 before their products) at every instance against its plain
    version in fp32: dq, dk, dv within 2e-2 of max(1, |ref|); the same
    bits on a second call; one launch. Lengths at and around the 64-row
    tiles (a ragged last tile, two tiles, 4095 = 64 tiles less a row),
    windows inside a tile, of one tile and one past it, G 1, 4 and 6."""
    rng = np.random.default_rng(hd * 100000 + S * 100 + window + H)
    B = 1 if S > 1000 else 2
    q, k, v, do = [_randn(rng, *s).to(cuda, torch.bfloat16)
                   for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd_v),
                             (B, H, S, hd_v))]
    out, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
    n = fa.flash_attention_bwd.launches
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    assert fa.flash_attention_bwd.launches == n + 1
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        out.float(), lse, do.float(),
                                        window=window)
    for got, ref in zip(grads, want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        err = (got.float() - ref).abs() / ref.abs().clamp(min=1)
        assert float(err.max()) <= _TOL[torch.bfloat16]


@pytest.mark.parametrize("T,D,E,C", [(64, 32, 8, 12), (100, 16, 4, 40),
                                     (48, 7, 3, 5), (0, 64, 4, 8),
                                     (3000, 2048, 64, 60)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_backward_matches_plain(cuda, dtype, T, D, E, C):
    """B7-bwd equal to its plain gather, on ids out of range, positions
    past C and rows of an odd width; the same bits on a second call."""
    rng = np.random.default_rng(T + C)
    dbuf = _randn(rng, E, C, D).to(cuda, dtype)
    ids = torch.from_numpy(rng.integers(0, E + 2, T).astype(np.int32))
    pos = torch.from_numpy(rng.integers(-1, 2 * C, T).astype(np.int32))
    ids, pos = ids.to(cuda), pos.to(cuda)
    n = md.moe_dispatch_bwd.launches
    got = md.moe_dispatch_bwd(dbuf, ids, pos)
    assert md.moe_dispatch_bwd.launches == n + 1
    assert torch.equal(got, md.moe_dispatch_bwd(dbuf, ids, pos))
    assert torch.equal(got, md.moe_dispatch_bwd_plain(dbuf, ids, pos))


@pytest.mark.parametrize("B,T,D,N", [(2, 16, 8, 4), (1, 1, 16, 4),
                                     (3, 9, 32, 8), (1, 256, 512, 16)])
def test_linear_scan_backward_matches_plain(cuda, B, T, D, N):
    """B6-bwd against its plain loop within 1e-5 of max(1, |ref|), the
    same bits on a second call; the ragged remainder of its unrolled
    loop (T 9) and a single step (T 1)."""
    rng = np.random.default_rng(T + D)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, T, D, N)).astype(
        np.float32)).to(cuda)
    b, g_all = (_randn(rng, B, T, D, N).to(cuda) for _ in range(2))
    h0, g_last = (_randn(rng, B, D, N).to(cuda) for _ in range(2))
    h_all, _ = ls.linear_scan(a, b, h0)
    n = ls.linear_scan_bwd.launches
    got = ls.linear_scan_bwd(a, h0, h_all, g_all, g_last)
    assert ls.linear_scan_bwd.launches == n + 1
    again = ls.linear_scan_bwd(a, h0, h_all, g_all, g_last)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = ls.linear_scan_bwd_plain(a, h0, h_all, g_all, g_last)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("chunk", [32, 16])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 63, 64, 65, 70, 300])
@pytest.mark.parametrize("hd", [6, 8, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_backward_matches_plain(cuda, dtype, hd, S, chunk):
    """B4-bwd (three chunk-parallel passes a call, in chunks of
    min(chunk, S)) against autograd through the chunked plain version at
    the same chunk, on the same inputs, a nonzero state0 and a gradient on
    the final state, S on both sides of one and two chunks: every gradient
    within 1e-4 of its largest |value| in fp32 (sums of up to S * hd terms
    in another order, dlogw through a carried difference), within 1e-2
    where bf16 gradients round; the same bits on a second call; one
    launch."""
    rng = np.random.default_rng(hd * 100 + S)
    B, H = 2, 2
    r, k, v = (_randn(rng, B, S, H, hd).to(cuda, dtype) for _ in range(3))
    logw = -torch.exp(torch.clamp(_randn(rng, B, S, H, hd), -8, 0.5))
    u, s0 = _randn(rng, H, hd) * 0.1, _randn(rng, B, H, hd, hd) * 0.3
    dy, ds = _randn(rng, B, S, H, hd), _randn(rng, B, H, hd, hd)
    args = (r, k, v, *(t.to(cuda) for t in (logw, u, s0, dy, ds)))
    n = wkv6.wkv6_chunked_bwd.launches
    got = wkv6.wkv6_chunked_bwd(*args, chunk=chunk)
    assert wkv6.wkv6_chunked_bwd.launches == n + 1
    again = wkv6.wkv6_chunked_bwd(*args, chunk=chunk)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = wkv6.wkv6_chunked_bwd_plain(*args, chunk=chunk)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        tol = 1e-2 if x.dtype == torch.bfloat16 else 1e-4
        assert _rel(x, y) <= tol


def test_wkv6_backward_refuses_what_its_kernels_do_not_take(cuda):
    """B4-bwd on the card refuses chunks past ``MAX_CHUNK`` and head dims
    past ``MAX_HEAD_DIM``, as B4 does, naming the limit; no launch."""
    rng = np.random.default_rng(0)
    for S, hd, chunk in ((40, 8, 33), (4, 132, 32)):
        r, k, v, logw, dy = (_randn(rng, 1, S, 1, hd).to(cuda)
                             for _ in range(5))
        u, s0, ds = (_randn(rng, *shape).to(cuda)
                     for shape in ((1, hd), (1, 1, hd, hd), (1, 1, hd, hd)))
        n = wkv6.wkv6_chunked_bwd.launches
        with pytest.raises(ValueError, match="the kernels take hd <="):
            wkv6.wkv6_chunked_bwd(r, k, v, -logw.abs(), u, s0, dy, ds,
                                  chunk=chunk)
        assert wkv6.wkv6_chunked_bwd.launches == n


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_family_gradients_on_card_match_cpu(cuda, arch):
    """SMOKE fp32 (TF32 off), 300 tokens (a Mamba tail past its 256-token
    chunk): the loss within 1e-5 and every gradient within 1e-4 of its
    leaf's largest on the card (B2, B2-bwd, B7, B7-bwd, B6, B6-bwd, B4,
    B4-bwd) against the CPU (the plain versions); the routed experts
    equal; each backward kernel launched once a layer (B6-bwd once a
    chunk)."""
    from repro_torch.models import moe
    from repro_torch.train.train_step import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = _to(cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32))
    routes, route = [], moe.route

    def rec(*a):
        out = route(*a)
        routes.append(out[2].cpu())
        return out
    moe.route = rec
    try:
        (lc, _), gc_ = value_and_grad(cpu, toks, cfg)
        n = [len(routes)]
        counts = {w: w.launches for w in (fa.flash_attention_bwd,
                                          md.moe_dispatch_bwd,
                                          ls.linear_scan_bwd,
                                          wkv6.wkv6_chunked_bwd)}
        (lg, _), gg = value_and_grad(card, toks.to(cuda), cfg)
    finally:
        moe.route = route
    kinds = cfg.layer_kinds()
    want = {fa.flash_attention_bwd: kinds.count("attn"),
            md.moe_dispatch_bwd: cfg.mlp_kinds().count("moe")
            if cfg.moe else 0,
            ls.linear_scan_bwd: kinds.count("mamba") * 2,
            wkv6.wkv6_chunked_bwd: kinds.count("rwkv")}
    assert {w: w.launches - c for w, c in counts.items()} == want
    n_moe = n[0] if cfg.moe else 0
    for a, b in zip(routes[:n_moe], routes[n[0]:n[0] + n_moe]):
        assert torch.equal(a, b)
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(_leaves(gg), _leaves(gc_)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(
            float(b.abs().max()), 1e-30)


def _mq_run(device, ops_, cap=3, n_q=4):
    """The items, oks and sizes of an op sequence, on ``device``."""
    from repro_torch.core import multiqueue as mq
    st = mq.mq_init(n_q, cap, (3,), device=device)
    out = []
    for push, q, val in ops_:
        qt = torch.tensor(q, dtype=torch.int32, device=device)
        if push:
            st, ok = mq.mq_push(st, qt, torch.full((3,), float(val),
                                                   device=device))
            out.append((ok,))
        else:
            st, item, ok = mq.mq_pop(st, qt)
            out.append((item, ok))
        out.append((mq.mq_sizes(st),))
    return [tuple(t.cpu() for t in o) for o in out], st


def test_mq_on_card_matches_cpu(cuda):
    """400 pushes and pops on 4 queues of capacity 3 (the rings wrap many
    times and fill): every item, ok and size, and the final buffers and
    counters, equal the CPU's."""
    rng = np.random.default_rng(3)
    ops_ = [(bool(rng.random() < 0.55), int(rng.integers(0, 4)),
             int(rng.integers(-100, 100))) for _ in range(400)]
    got, st = _mq_run(cuda, ops_)
    want, st_cpu = _mq_run(torch.device("cpu"), ops_)
    assert all(torch.equal(a, b) for g, w in zip(got, want)
               for a, b in zip(g, w))
    for n in ("buf", "head", "tail"):
        assert torch.equal(getattr(st, n).cpu(), getattr(st_cpu, n))
    assert int(st.tail.max()) > 3 * 3          # wrapped


@pytest.mark.parametrize("T,D,E,C,dtype", [
    (11400, 2048, 64, 223, torch.bfloat16),
    (600, 64, 16, 40, torch.float32)])
def test_batched_enqueue_matches_b7_kernel(cuda, T, D, E, C, dtype):
    """At moonshot's prefill shape and at a small one, on routing skewed
    so that the first queues overflow: the buffers of ``batched_enqueue``
    equal B7's kernel at its positions, bit for bit, and its kept rows are
    those with a position below C."""
    from repro_torch.core.multiqueue import batched_enqueue
    rng = np.random.default_rng(4)
    items = _randn(rng, T, D).to(cuda, dtype)
    probs = 1.0 / np.arange(1, E + 1) ** 0.3
    ids = torch.from_numpy(rng.choice(E, size=T, p=probs / probs.sum())
                           .astype(np.int32)).to(cuda)
    buf, pos, kept = batched_enqueue(items, ids, E, C)
    n = md.moe_dispatch.launches
    b7 = md.moe_dispatch(items, ids, pos, E, C)
    assert md.moe_dispatch.launches == n + 1
    assert torch.equal(buf, b7)
    assert torch.equal(kept, pos < C) and bool((~kept).any())
    cpu = batched_enqueue(items.cpu(), ids.cpu(), E, C)
    assert all(torch.equal(a.cpu(), b) for a, b in zip((buf, pos, kept),
                                                        cpu))


def test_reshard_tree_on_a_one_rank_cuda_mesh(cuda):
    """SMOKE qwen3's params and AdamW state, made on the CPU, laid out on
    train_shardings over the (1, 1) cuda smoke mesh: every leaf on the
    card, bit for bit."""
    from repro_torch.checkpoint import reshard_tree
    from repro_torch.core.tree import leaves
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import make_policy
    from repro_torch.train.train_step import train_shardings
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    pol = make_policy(make_smoke_mesh("cuda"), fsdp=True)
    (p_sh, o_sh, _), _ = train_shardings(cfg, pol)
    placed = reshard_tree((params, opt), (p_sh, o_sh))
    for a, b in zip(leaves((params, opt)), leaves(placed)):
        assert b.is_cuda and b.dtype == a.dtype
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_card_walk_counts_the_meta_walks_kernel_calls(cuda, arch):
    """A SMOKE train step on the card under the cost walk (batch 2 in 2
    microbatches of 300 tokens): each wrapper launches its kernel once a
    call the walk counts, and the calls and their work equal the dry
    run's walk of the same step on meta, which launches nothing."""
    from repro_torch.launch import dryrun
    from repro_torch.optim import adamw_init
    from repro_torch.train.train_step import make_train_step
    cfg = SMOKE_CONFIGS[arch]
    wrappers = {"flash_attention": fa.flash_attention,
                "flash_attention_bwd": fa.flash_attention_bwd,
                "moe_dispatch": md.moe_dispatch,
                "moe_dispatch_bwd": md.moe_dispatch_bwd,
                "linear_scan": ls.linear_scan,
                "linear_scan_bwd": ls.linear_scan_bwd,
                "wkv6_chunked": wkv6.wkv6_chunked,
                "wkv6_chunked_bwd": wkv6.wkv6_chunked_bwd}
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(2, 300)).astype(np.int32), device=cuda)
    step = make_train_step(cfg, microbatch=2)
    before = {n: w.launches for n, w in wrappers.items()}
    card = dryrun.walk_step(step, (params, adamw_init(params), toks))
    launched = {n: w.launches - before[n] for n, w in wrappers.items()
                if w.launches != before[n]}
    meta_params = lm.abstract_params(cfg)
    before = {n: w.launches for n, w in wrappers.items()}
    meta = dryrun.walk_step(step, (meta_params, adamw_init(meta_params),
                                   torch.empty_like(toks, device="meta")))
    assert {n: w.launches for n, w in wrappers.items()} == before
    assert card["kernel_calls"] == launched == meta["kernel_calls"]
    assert card["kernel_work"] == meta["kernel_work"]


def _example(name):
    """``examples_torch/<name>.py``, loaded by path."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples_torch" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b",
                                  "rwkv6-1.6b", "jamba-v0.1-52b"])
def test_quickstart_example_on_the_card_matches_the_cpu(cuda, arch):
    """examples_torch/quickstart.py's run on fp32 SMOKE weights, TF32
    off: the card's loss within 1e-5 and grad norm within 1e-4 of the
    CPU's, tokens equal up to a CPU margin under 1e-3."""
    qs = _example("quickstart")
    cfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    inputs = qs.make_inputs(cfg.vocab_size)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = qs.run(cfg, _to(p_cpu, cuda), inputs, cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = qs.run(cfg, p_cpu, inputs, "cpu")
    for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        assert abs(card[key] - cpu[key]) <= tol * max(1.0, abs(cpu[key]))
    for i, (a, b) in enumerate(zip(card["tokens"], cpu["tokens"])):
        if a != b:
            assert cpu["margins"][i] < 1e-3, (i, card, cpu)
            break


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_serve_kv_example_on_the_card_matches_the_cpu(cuda, layout):
    """examples_torch/serve_kv.py's run (chunk 16, span 8, 28 pages) on
    fp32 SMOKE qwen3-8b: completion order, every counter and the streams
    equal the CPU's, the shared prompts' greedy outputs identical."""
    kv = _example("serve_kv")
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(dtype="float32")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = kv.make_inputs(cfg.vocab_size)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = kv.run(cfg, _to(p_cpu, cuda), prompts, cuda, kv_layout=layout)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = kv.run(cfg, p_cpu, prompts, "cpu", kv_layout=layout)
    for key in ("completed", "order", "stats", "prefix_hit_rate",
                "shared_identical", "streams"):
        assert card[key] == cpu[key], key
    assert card["shared_identical"]


def test_examples_run_on_the_card_by_default(cuda, capsys):
    """With no --device, the scripts' mains run on the card."""
    out = _example("quickstart").main(["--arch", "jamba-v0.1-52b"])
    assert "ok" in capsys.readouterr().out and len(out["tokens"]) == 9
    out = _example("serve_live").main([])
    assert out["arrivals"] == 14 and out["premium_all_completed"]


def _four_ranks_on_the_card(arch):
    """chip_smoke.py's ranks phase, its fp32 part for SMOKE ``arch``, on
    four gloo ranks sharing the card: every run held to the one-rank
    card runs within 1e-5 (loss) and 1e-4 of each leaf's largest
    (gradients, ``chip_smoke.ranks_grads_ok``: rwkv6's held to its
    float64 witness, no further from it than the one-rank runs plus
    1e-4), each SP run to the run before it within 1e-5 and 1e-4; each
    rank's launches held to one gradient call
    (``chip_smoke.train_kernel_calls``)."""
    import sys
    from pathlib import Path
    from repro_torch.launch.mesh import spawn
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    recs = spawn(chip_smoke.ranks_main, 4, (arch,), (), timeout=600)
    assert [r["device"] for r in recs] == ["cuda:0"] * 4
    rows = recs[0]["smoke"]
    assert [(r["mesh"], r["sp"], r["fsdp"]) for r in rows] == [
        ([2, 2], False, False), ([2, 2], False, True), ([2, 2], True, True),
        ([2, 1, 2], True, True)]
    for r in rows:
        assert max(r["errors"].values()) <= 1e-5
        assert ("float64" in r) == (arch in chip_smoke.RANKS_FLOAT64)
        assert chip_smoke.ranks_grads_ok(r)
        if r["sp"]:
            assert max(r["vs"]["errors"].values()) <= 1e-5
            assert r["vs"]["grad_err"] <= 1e-4
    want = chip_smoke.train_kernel_calls(
        SMOKE_CONFIGS[arch], chip_smoke.RANKS_SMOKE_SHAPE[1])
    for rec in recs:
        for r in rec["smoke"]:
            got = {n: c for n, c in r["path"]["launches"].items() if c}
            assert got == want
    return want


def test_four_ranks_sharing_the_card_equal_one_rank(cuda):
    """Four gloo ranks on a (2, 2) ("data", "model") mesh and a (2, 1, 2)
    ("pod", "data", "model") mesh, all on the one card (chip_smoke.py's
    ranks phase, its fp32 part for SMOKE qwen3-8b): forward_loss's loss
    within 1e-5 relative and every gathered gradient within 1e-4 of its
    leaf's largest |value| of the mean over the data shards of one-rank
    runs on the card, FSDP off and on, then under sequence parallelism
    and on the pod mesh, each of those also held to the run before it;
    each rank's B2 and B2-bwd launches held to one gradient call."""
    assert _four_ranks_on_the_card("qwen3-8b") == {
        "flash_attention": 4, "flash_attention_bwd": 2}


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_four_ranks_sharing_the_card_equal_one_rank_inner(cuda, arch):
    """The same for the stacks with ``inner`` layers: SMOKE rwkv6-1.6b
    (B4 and B4-bwd on each rank's heads) and jamba-v0.1-52b (B6 and
    B6-bwd on each rank's Mamba channels, B2 and B7 on its heads and
    experts), each against one-rank card runs on all four meshes and
    policies."""
    kinds = {"rwkv6-1.6b": {"wkv6_chunked", "wkv6_chunked_bwd"},
             "jamba-v0.1-52b": {"linear_scan", "linear_scan_bwd",
                                "flash_attention", "flash_attention_bwd",
                                "moe_dispatch", "moe_dispatch_bwd"}}[arch]
    assert set(_four_ranks_on_the_card(arch)) == kinds
