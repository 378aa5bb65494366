"""The port's optimizer, schedule, gradient compression and data
pipeline against the JAX package.

AdamW runs on equal numpy trees of fp32 and bf16 leaves, with clipping
on and off, over steps across the warmup and the cosine decay: master,
m and v within 2e-6 relative (the same fp32 ops; the two frameworks may
round a sum or a root an ulp apart; see ``_close_rel`` for values that
come out of a cancellation), bf16 params within one bf16 ulp.
The schedule within 1e-6 relative (fp32 cos, an ulp apart). Compression,
packing and the synthetic data bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import primitives as jprim  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticPackedDataset as JDataset  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.core import primitives as prim  # noqa: E402
from repro_torch.core.tree import leaves, map_tree  # noqa: E402
from repro_torch.data import DataConfig, SyntheticPackedDataset  # noqa
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, cosine_schedule)
from repro_torch.train import grad_compress as gc  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {"a": ((8, 16), "float32"), "b": ((32,), "bfloat16"),
          "c": {"d": ((4, 4), "bfloat16"), "e": ((3, 5), "float32")}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def one(spec):
        if isinstance(spec, dict):
            return {k: one(v) for k, v in spec.items()}
        shape, _ = spec
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return one(SHAPES)


def _dtypes(spec=SHAPES):
    if isinstance(spec, dict):
        return {k: _dtypes(v) for k, v in spec.items()}
    return spec[1]


def _to_jax(tree, dtypes):
    return jax.tree.map(lambda a, d: jnp.asarray(a, d), tree, dtypes)


def _to_torch(tree, dtypes):
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    return map_tree(lambda a, d: torch.from_numpy(a).to(table[d]), tree,
                    dtypes)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_rel(a, b, rtol):
    """|a - b| <= rtol * max(|b|, max|b| / 10): relative, except for an
    element that came out of a cancellation. The global norm is a sum the
    two frameworks may round an ulp apart, so each clipped gradient may
    move by an ulp; m = b1 m + (1 - b1) g of opposite signs keeps that
    ulp of its operands in a smaller result, so there the error is held
    relative to a tenth of the leaf's largest value."""
    floor = 0.1 * float(np.abs(b).max(initial=0.0))
    assert np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(b), floor))


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_update_matches_reference(clip):
    """Eight steps with warmup 3 and 8 total: the lr rises, then decays;
    gradients of norm ~10, so a clip of 1.0 scales them."""
    dtypes = _dtypes()
    p0 = _tree(0)
    jcfg = JAdamWConfig(lr=1e-2, grad_clip=clip, warmup_steps=3,
                        total_steps=8)
    cfg = AdamWConfig(lr=1e-2, grad_clip=clip, warmup_steps=3, total_steps=8)
    jp = _to_jax(p0, dtypes)
    jo = j_adamw_init(jp)
    tp = _to_torch(p0, dtypes)
    to = adamw_init(tp)
    for i in range(8):
        g = _tree(100 + i, scale=3.0)
        jp, jo, jm = j_adamw_update(_to_jax(g, dtypes), jo, jp, jcfg)
        tp, to, tm = adamw_update(_to_torch(g, dtypes), to, tp, cfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=2e-6)
        for key in ("master", "m", "v"):
            for a, b in zip(leaves(to[key]), jax.tree.leaves(jo[key])):
                _close_rel(_f32(a), _f32(b), 2e-6)
        for a, b, d in zip(leaves(tp), jax.tree.leaves(jp),
                           jax.tree.leaves(dtypes)):
            assert str(a.dtype).endswith(d)
            a, b = _f32(a), _f32(b)
            if d == "bfloat16":     # one bf16 ulp: 2^-7 of the exponent
                ulp = 2.0 ** (np.floor(np.log2(np.abs(b) + 1e-30)) - 7)
                assert np.all(np.abs(a - b) <= ulp)
            else:
                _close_rel(a, b, 2e-6)
    assert int(to["step"]) == int(jo["step"]) == 8


def test_adamw_init_copies_the_master():
    p = {"w": torch.ones(3), "b": torch.ones(2, dtype=torch.bfloat16)}
    opt = adamw_init(p)
    assert opt["master"]["w"].data_ptr() != p["w"].data_ptr()
    assert opt["master"]["b"].dtype == torch.float32
    assert int(opt["step"]) == 0 and opt["step"].dtype == torch.int32


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 10_000)])
def test_cosine_schedule_matches_reference(warmup, total):
    steps = np.arange(0, 2 * total + 5, max(1, total // 200),
                      dtype=np.int32)
    want = np.asarray(j_cosine(3e-4, warmup, total)(jnp.asarray(steps)))
    got = cosine_schedule(3e-4, warmup, total)(
        torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_grad_compression_bit_for_bit():
    """Ten steps of error feedback on fp32 and bf16 leaves: the
    dequantized grads and the residuals equal the reference's bits."""
    dtypes = _dtypes()
    jres = jgc.init_residuals(_to_jax(_tree(0), dtypes))
    res = gc.init_residuals(_to_torch(_tree(0), dtypes))
    for i in range(10):
        g = _tree(200 + i, scale=0.1 * (i + 1))
        jdeq, jres = jgc.compress_tree(_to_jax(g, dtypes), jres)
        deq, res = gc.compress_tree(_to_torch(g, dtypes), res)
        for a, b in zip(leaves(deq), jax.tree.leaves(jdeq)):
            np.testing.assert_array_equal(_f32(a), _f32(b))
        for a, b in zip(leaves(res), jax.tree.leaves(jres)):
            np.testing.assert_array_equal(_f32(a), _f32(b))
    x = np.linspace(-2.5, 2.5, 11).astype(np.float32) * 127 / 2.5
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    q, s = gc.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_grad_compression_of_stacked_layers_bit_for_bit():
    """Blocks the reference stacks into one leaf share its one scale: four
    blocks in two groups of a 2-block unit (blocks 0 and 2 are the
    reference's ``b0``, 1 and 3 its ``b1``), each layer at another
    magnitude, so a per-layer scale would differ; three steps of error
    feedback give the reference's bits."""
    rng = np.random.default_rng(7)
    spec = {"w": ((8, 16), torch.float32, jnp.float32),
            "n": ((16,), torch.bfloat16, jnp.bfloat16)}

    def grads(i):
        blocks = [{k: (rng.standard_normal(shape) * (b + 1) * (i + 1))
                   .astype(np.float32) for k, (shape, _, _) in spec.items()}
                  for b in range(4)]
        return {"embed": rng.standard_normal((10, 8)).astype(np.float32),
                "blocks": blocks}

    def port(t):
        return {"embed": torch.from_numpy(t["embed"]),
                "blocks": [{k: torch.from_numpy(b[k]).to(spec[k][1])
                            for k in spec} for b in t["blocks"]]}

    def ref(t):
        return {"embed": jnp.asarray(t["embed"]),
                **{f"b{j}": {k: jnp.asarray(np.stack([t["blocks"][j][k],
                                                      t["blocks"][j + 2][k]]),
                                            spec[k][2]) for k in spec}
                   for j in (0, 1)}}

    def unstack(t):
        out = {"embed": _f32(t["embed"]), "blocks": [None] * 4}
        for j in (0, 1):
            for g in (0, 1):
                out["blocks"][j + 2 * g] = {k: _f32(t[f"b{j}"][k])[g]
                                            for k in spec}
        return out

    res = gc.init_residuals(port(grads(0)))
    jres = jgc.init_residuals(ref(grads(0)))
    for i in range(3):
        g = grads(i)
        deq, res = gc.compress_tree(port(g), res, stacked=[[0, 2], [1, 3]])
        jdeq, jres = jgc.compress_tree(ref(g), jres)
        for mine, theirs in ((deq, jdeq), (res, jres)):
            want = unstack(theirs)
            np.testing.assert_array_equal(_f32(mine["embed"]), want["embed"])
            for b in range(4):
                for k in spec:
                    np.testing.assert_array_equal(
                        _f32(mine["blocks"][b][k]), want["blocks"][b][k])


def test_pack_documents_and_headers_bit_for_bit():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 50, size=n).astype(np.int32)
            for n in (5, 17, 3, 40, 1, 9)]
    for seq in (8, 16, 64):
        t, s = prim.pack_documents(docs, seq)
        jt, js = jprim.pack_documents(docs, seq)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(s, js)
        assert t.dtype == jt.dtype == np.int32
        for a, b in zip(prim.unpack_documents(t, s), docs):
            np.testing.assert_array_equal(a, b)
    pkt = prim.append_header(docs[1], 7)
    np.testing.assert_array_equal(pkt, jprim.append_header(docs[1], 7))
    doc_id, payload = prim.remove_header(pkt)
    assert doc_id == 7
    np.testing.assert_array_equal(payload, docs[1])


def test_scatter_gather_pages_match_reference():
    pool = np.arange(6 * 2 * 3, dtype=np.float32).reshape(6, 2, 3)
    ids = np.array([4, 1], np.int32)
    data = -np.ones((2, 2, 3), np.float32)
    want = jprim.scatter_pages(jnp.asarray(pool), jnp.asarray(ids),
                               jnp.asarray(data))
    got = prim.scatter_pages(torch.from_numpy(pool), torch.from_numpy(ids),
                             torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        prim.gather_pages(got, torch.from_numpy(ids)).numpy(),
        np.asarray(jprim.gather_pages(want, jnp.asarray(ids))))


@pytest.mark.parametrize("dp_size", [1, 2])
def test_synthetic_data_bit_for_bit(dp_size):
    kw = dict(seq_len=64, global_batch=4, vocab_size=1000, dp_size=dp_size)
    for rank in range(dp_size):
        mine = SyntheticPackedDataset(DataConfig(dp_rank=rank, **kw))
        ref = JDataset(JDataConfig(dp_rank=rank, **kw))
        for _ in range(3):
            (t, s), (jt, js) = mine.next_batch(), ref.next_batch()
            np.testing.assert_array_equal(t, jt)
            np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(mine.batch_at(7, rank)[0],
                                      ref.batch_at(7, rank)[0])


def test_synthetic_data_state_round_trip():
    cfg = DataConfig(seq_len=64, global_batch=4, vocab_size=1000)
    ds = SyntheticPackedDataset(cfg)
    batches = [ds.next_batch()[0] for _ in range(5)]
    assert ds.state_dict() == {"step": 5}
    again = SyntheticPackedDataset(cfg)
    again.load_state_dict({"step": 3})
    np.testing.assert_array_equal(again.next_batch()[0], batches[3])
    np.testing.assert_array_equal(ds.batch_at(2)[0], batches[2])
    with pytest.raises(ValueError):
        SyntheticPackedDataset(DataConfig(global_batch=3, dp_size=2))


def test_port_adamw_reduces_loss():
    """The reference's ``test_adamw_reduces_loss`` on the port: 20 steps
    on one batch lower the loss by more than 0.5."""
    cfg = SMOKE_CONFIGS["qwen1.5-4b"].scaled(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=64)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=100)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32))
    from repro_torch.train.train_step import value_and_grad
    losses = []
    for _ in range(20):
        (loss, _), g = value_and_grad(params, toks, cfg)
        params, opt, _ = adamw_update(g, opt, params, ocfg)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]
