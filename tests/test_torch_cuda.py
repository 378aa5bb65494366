"""The port on a CUDA card: each kernel against its plain version, and
the serving engine on the card against the same engine on the CPU.

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
from repro_torch.kernels import paged_attention as pa  # noqa: E402
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
            decode_span=8), device=dev)
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
