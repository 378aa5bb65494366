"""The port's one-card dry run against the JAX package's: the shapes,
``input_specs``, ``roofline.model_flops``, the walk's argument bytes
against XLA's ``memory_analysis`` and its FLOPs against the reference's
HLO walk (``repro.launch.hlo_analysis``); the kernels' ``meta`` path
(outputs as shapes, no launch, the wrapper calls of a train step) and
the refusals; ``kernels/work.py`` against every bound of PERF.md §6.

Everything runs on the CPU, the port on ``meta``. Tolerances: argument
bytes exact; FLOPs within 2% once the attention term is split out
(``test_prefill_flops_match_the_reference_hlo_walk`` says why); every
§6 bound to the digits the table prints.
"""
import ast
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import shapes as j_shapes  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import roofline as j_roofline  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.sharding.policy import NULL_POLICY as J_NULL  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssm_decode as sd  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.cost_walk import CostWalk  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import unstack_layers  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s.name) for a in ARCH_NAMES
         for s in j_shapes.applicable_shapes(a)]


def _smoke_module():
    """chip_smoke.py as a module (its top level imports only the standard
    library), for ``train_kernel_calls``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# shapes, input specs, model FLOPs
# --------------------------------------------------------------------------

def test_shapes_equal_the_reference():
    assert shapes.SHAPES == tuple(
        shapes.ShapeConfig(s.name, s.kind, s.seq_len, s.global_batch)
        for s in j_shapes.SHAPES)
    assert set(shapes.SHAPES_BY_NAME) == set(j_shapes.SHAPES_BY_NAME)
    assert shapes.LONG_CONTEXT_ARCHS == j_shapes.LONG_CONTEXT_ARCHS
    assert len(ARCH_NAMES) == 10
    for arch in ARCH_NAMES:
        assert [s.name for s in shapes.applicable_shapes(arch)] == \
            [s.name for s in j_shapes.applicable_shapes(arch)]


def test_card_batch_and_microbatch():
    """CARD_BATCH is the global batch over the pod mesh's data axis of 16;
    TRAIN_MICROBATCH is the reference dry run's (read from its source:
    importing it would set the 512-device XLA flag in this process)."""
    assert shapes.CARD_BATCH == {"train_4k": 16, "prefill_32k": 2,
                                 "decode_32k": 8, "long_500k": 1}
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "TRAIN_MICROBATCH"
                for t in node.targets):
            assert ast.literal_eval(node.value) == shapes.TRAIN_MICROBATCH
            break
    else:
        raise AssertionError("no TRAIN_MICROBATCH in the reference")


def _leaf_sig(x):
    return tuple(x.shape), str(x.dtype).split(".")[-1]


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_the_reference(arch, shape_name):
    """Tokens' shape and dtype; for decode the state: each layer's cache
    leaves (the reference's stack ordered by layer), lengths and
    positions; where a leaf has no counterpart, total bytes."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shape = shapes.SHAPES_BY_NAME[shape_name]
    got = lm.input_specs(cfg, shape)
    want = jlm.input_specs(jcfg, j_shapes.SHAPES_BY_NAME[shape_name])
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert _leaf_sig(got["tokens"]) == _leaf_sig(want["tokens"])
    if shape.kind != "decode":
        assert set(got) == {"tokens"}
        return
    st, jst = got["state"], want["state"]
    for key in ("lengths", "positions"):
        assert _leaf_sig(st[key]) == _leaf_sig(jst[key])
    j_caches = unstack_layers(jst["caches"], jcfg,
                              lambda a, g: jax.ShapeDtypeStruct(
                                  a.shape[1:], a.dtype))
    assert len(j_caches) == len(st["caches"]) == cfg.n_layers
    for mine, theirs in zip(st["caches"], j_caches):
        if set(mine) == set(theirs):
            for k in mine:
                assert _leaf_sig(mine[k]) == _leaf_sig(theirs[k]), k
        else:
            assert sum(t.numel() * t.element_size() for t in mine.values()) \
                == sum(a.size * a.dtype.itemsize for a in theirs.values())


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_model_flops_equal_the_reference(arch, shape_name):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shape = shapes.SHAPES_BY_NAME[shape_name]
    want = j_roofline.model_flops(jcfg, j_shapes.SHAPES_BY_NAME[shape_name])
    assert roofline.model_flops(cfg, shape) == want
    b = shapes.CARD_BATCH[shape_name]
    assert roofline.model_flops(cfg, shape, b) * shape.global_batch == \
        pytest.approx(want * b, rel=1e-12)


# --------------------------------------------------------------------------
# the walk against XLA
# --------------------------------------------------------------------------

SEQ = 256


def _reference_compiled(arch, kind):
    jcfg = J_SMOKE[arch]
    params = jlm.abstract_params(jcfg)
    tok = jax.ShapeDtypeStruct((2, SEQ), jnp.int32)
    if kind == "train":
        opt = jax.eval_shape(j_adamw_init, params)
        return jax.jit(jts.make_train_step(jcfg, J_NULL)).lower(
            params, opt, tok).compile()
    return jax.jit(jts.make_prefill_step(jcfg, J_NULL)).lower(
        params, tok).compile()


def _port_walk(arch, kind, microbatch=0):
    cfg = SMOKE_CONFIGS[arch]
    params = lm.abstract_params(cfg)
    tok = torch.empty((2, SEQ), dtype=torch.int32, device="meta")
    if kind == "train":
        return dryrun.walk_step(ts.make_train_step(cfg, microbatch=microbatch),
                                (params, adamw_init(params), tok))
    return dryrun.walk_step(ts.make_prefill_step(cfg, NULL_POLICY),
                            (params, tok))


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_argument_bytes_equal_xla(arch, kind):
    """The walk's argument bytes (params, AdamW's state and the tokens
    for train; params and tokens for prefill) equal XLA's
    ``argument_size_in_bytes`` of the reference's compiled step."""
    want = _reference_compiled(arch, kind).memory_analysis()
    got = _port_walk(arch, kind)["memory"]
    assert got["argument_bytes"] == want.argument_size_in_bytes


def test_prefill_flops_match_the_reference_hlo_walk():
    """SMOKE qwen3-8b prefill of 2 x 256 tokens: the walk's FLOPs against
    ``hlo_analysis.analyze`` of the reference's compiled prefill. The two
    count attention differently: the reference's chunk-pair scan runs
    whole C x C blocks of the (q-chunk, k-chunk) pairs at or below the
    diagonal (C = min(1024, S): here one 256 x 256 block, the masked upper
    half included), where B2's work counts the causal band's S (S + 1) / 2
    pairs. So the attention term is split out, each side's by its own
    formula, and the rest (every projection, MLP and the head) is held
    within 2%."""
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    want = hlo_analysis.analyze(
        _reference_compiled("qwen3-8b", "prefill").as_text())["flops"]
    got = _port_walk("qwen3-8b", "prefill")
    hd, H, L, B = cfg.head_dim, cfg.n_heads, cfg.n_layers, 2
    C = min(1024, SEQ)
    nq = -(-SEQ // C)
    ref_attn = 2.0 * (hd + hd) * B * H * C * C * nq * (nq + 1) // 2 * L
    port_attn = got["kernel_work"]["flash_attention"]["flops"]
    assert port_attn == 2.0 * (hd + hd) * B * H * work.band_pairs(SEQ) * L
    assert got["kernel_calls"] == {"flash_attention": L}
    assert abs(got["flops"] - want) / want > 0.02   # hence the split
    assert got["flops"] - port_attn == pytest.approx(want - ref_attn,
                                                     rel=0.02)


# --------------------------------------------------------------------------
# the meta path
# --------------------------------------------------------------------------

def _wrappers():
    return {"paged_decode_attention": pa.paged_decode_attention,
            "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "wkv6_decode": wk.wkv6_decode, "wkv6_chunked": wk.wkv6_chunked,
            "wkv6_chunked_bwd": wk.wkv6_chunked_bwd,
            "ssm_decode_step": sd.ssm_decode_step,
            "linear_scan": ls.linear_scan,
            "linear_scan_bwd": ls.linear_scan_bwd,
            "moe_dispatch": md.moe_dispatch,
            "moe_dispatch_bwd": md.moe_dispatch_bwd}


def _launches():
    return {n: w.launches for n, w in _wrappers().items()}


def _inputs(name, make):
    """Small inputs of each wrapper, each tensor from ``make(shape,
    dtype)``; the int32 ones are valid ids for the CPU's plain path."""
    f32, bf, i32 = torch.float32, torch.bfloat16, torch.int32
    B, H, KV, S, hd, T, D, E, C = 2, 4, 2, 40, 16, 12, 8, 3, 5
    if name == "paged_decode_attention":
        return (make((B, H, hd), bf), make((6, 4, KV, hd), bf),
                make((6, 4, KV, hd), bf), make((B, 3), i32),
                make((B,), i32)), {}
    if name == "flash_attention":
        return (make((B, H, S, hd), bf), make((B, KV, S, hd), bf),
                make((B, KV, S, hd), bf)), {"return_lse": True}
    if name == "flash_attention_bwd":
        return (make((B, H, S, hd), bf), make((B, KV, S, hd), bf),
                make((B, KV, S, hd), bf), make((B, H, S, hd), bf),
                make((B, H, S), f32), make((B, H, S, hd), bf)), {}
    if name == "wkv6_decode":
        return (make((B, H, hd), bf), make((B, H, hd), bf),
                make((B, H, hd), bf), make((B, H, hd), f32),
                make((H, hd), f32), make((B, H, hd, hd), f32)), {}
    if name in ("wkv6_chunked", "wkv6_chunked_bwd"):
        args = [make((B, S, H, hd), bf) for _ in range(3)] + [
            make((B, S, H, hd), f32), make((H, hd), f32),
            make((B, H, hd, hd), f32)]
        if name == "wkv6_chunked_bwd":
            args += [make((B, S, H, hd), f32), make((B, H, hd, hd), f32)]
        return tuple(args), {"chunk": 16}
    if name == "ssm_decode_step":
        return (make((B, D, 4), f32), make((B, D, 4), f32), make((B, D), f32),
                make((B, 4), f32), make((B, 4), f32)), {}
    if name in ("linear_scan", "linear_scan_bwd"):
        a, h0 = make((B, T, D, 4), f32), make((B, D, 4), f32)
        if name == "linear_scan":
            return (a, make((B, T, D, 4), f32), h0), {}
        return (a, h0, make((B, T, D, 4), f32), make((B, T, D, 4), f32),
                make((B, D, 4), f32)), {}
    if name == "moe_dispatch":
        return (make((T, D), bf), make((T,), i32), make((T,), i32), E, C), {}
    return (make((E, C, D), bf), make((T,), i32), make((T,), i32)), {}


def _cpu(shape, dtype):
    g = torch.Generator().manual_seed(len(shape))
    if dtype == torch.int32:
        return torch.randint(0, 2, shape, generator=g, dtype=dtype)
    return (-torch.rand(shape, generator=g)).to(dtype)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


class _Elsewhere(torch.Tensor):
    """A tensor on a device the port has no path for (``xla``): metadata
    only."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xla")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"no values on this device: {func}")


def _sigs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_meta_path_gives_the_kernels_shapes_and_launches_nothing(name):
    """On meta each wrapper returns what its plain version returns on the
    CPU, as shapes and dtypes on meta, reports one call's work and bumps
    no launch count."""
    fn = _wrappers()[name]
    args, kw = _inputs(name, _cpu)
    want = _sigs(fn(*args, **kw))
    before = _launches()
    margs, mkw = _inputs(name, _meta)
    seen = []

    def observer(n, w):
        seen.append(n)
    work.observe(observer)
    try:
        got = fn(*margs, **mkw)
    finally:
        work.unobserve(observer)
    assert _sigs(got) == want
    assert all(t.device.type == "meta" for t in
               (got if isinstance(got, tuple) else (got,)))
    assert seen == [name]
    assert _launches() == before


@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_wrappers_raise_on_another_device(name):
    args, kw = _inputs(name, _Elsewhere)
    before = _launches()
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        _wrappers()[name](*args, **kw)
    assert _launches() == before


@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_meta_train_step_counts_the_smokes_kernel_calls(arch):
    """A meta train step of every SMOKE family, batch 2 in 2 microbatches
    of 300 tokens (Mamba: chunks of 256 + 44), remat on: the walk counts
    ``chip_smoke.train_kernel_calls`` x 2 calls of each wrapper, the
    backward wrappers under the autograd Functions included, and no
    launch."""
    cfg = SMOKE_CONFIGS[arch]
    want = {n: c * 2 for n, c in
            _smoke_module().train_kernel_calls(cfg, 300).items()}
    params = lm.abstract_params(cfg)
    tok = torch.empty((2, 300), dtype=torch.int32, device="meta")
    before = _launches()
    rec = dryrun.walk_step(ts.make_train_step(cfg, microbatch=2),
                           (params, adamw_init(params), tok))
    assert rec["kernel_calls"] == want
    assert _launches() == before
    assert rec["host_max_bytes"] < 1 << 20
    # params and AdamW's state come back in place; the step counter is a
    # new scalar
    assert rec["memory"]["alias_bytes"] == rec["memory"]["argument_bytes"] \
        - tok.numel() * 4 - 4


# --------------------------------------------------------------------------
# the walk's memory, the fit, the CLI
# --------------------------------------------------------------------------

def test_walk_counts_each_storage_once():
    """Views and in-place updates add nothing; a storage leaves the live
    count with its last tensor; the peak stays."""
    a = torch.empty(1000, device="meta")          # 4000 bytes, an argument
    walk = CostWalk()
    walk.track((a, a[10:], a.view(10, 100)))
    with walk:
        b = a * 2                                 # +4000
        v = b[:500].view(5, 100)
        b.add_(1)
        del b
        c = torch.cat([v.reshape(-1), v.reshape(-1)])   # +4000: the peak
        del v                                     # b's storage goes
        d = c.sum()                               # +4
        del c
    rec = walk.record()
    assert walk.argument_bytes == 4000
    assert rec["peak_bytes"] == 12000
    assert walk.live_bytes == 4004
    assert rec["kernel_calls"] == {}
    assert rec["collective_bytes"] == 0.0 and rec["ranks"] == 1
    # mul, add_, cat, sum: operands read and outputs written
    assert rec["hbm_bytes"] == 8000 + 8000 + 8000 + 4004
    del d


def test_fit_depth_is_the_deepest_that_fits():
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(n_layers=6)
    shape = shapes.TRAIN_4K
    # a first walk also makes the rotary frequencies, which stay cached
    dryrun.cell_peak(cfg.scaled(n_layers=1), shape, 2, 2)
    peaks = {n: dryrun.cell_peak(cfg.scaled(n_layers=n), shape, 2, 2)
             for n in range(1, 7)}
    assert all(peaks[n] < peaks[n + 1] for n in range(1, 6))
    for budget, depth in ((peaks[4], 4), (peaks[4] - 1, 3),
                          (peaks[6] + 1, 6), (peaks[1] - 1, 0)):
        got = dryrun.fit_depth(cfg, shape, 2, 2, budget)
        assert got["depth"] == depth


def test_fit_depth_search_on_given_peaks():
    """The search against every depth's peak, on growing peaks of random
    steps at random budgets (1-60 layers, at and between the peaks)."""
    import random
    rng = random.Random(0)
    for _ in range(500):
        n = rng.randint(1, 60)
        peaks, total = {}, rng.random() * 5
        for d in range(1, n + 1):
            total += rng.choice((0.0, rng.random() * 10))
            peaks[d] = total
        budget = rng.choice((peaks[rng.randint(1, n)],
                             rng.random() * peaks[n] * 1.2))
        want = max([d for d in peaks if peaks[d] <= budget], default=0)
        cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(n_layers=n)
        got = dryrun.fit_depth(cfg, None, 0, 0, budget,
                               peak_of=lambda d: peaks[d])
        assert got["depth"] == want
        assert len(got["peaks"]) <= n


def test_dryrun_cli_writes_a_record_and_refuses(tmp_path):
    out = tmp_path / "dr"
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k",
                        "--memory-gb", "80", "--out", str(out)]) == 0
    rec = json.loads((out / "baseline__rwkv6-1.6b__long_500k.json")
                     .read_text())
    assert rec["device"] == "meta" and rec["ranks"] == 1
    assert rec["batch"] == 1 and rec["fits"]
    assert rec["kernel_calls"] == {"wkv6_decode": 24}
    assert rec["host_max_bytes"] < 1 << 20
    table = roofline.build_table("baseline", out)
    assert "| rwkv6-1.6b | long_500k | 24 | 1 |" in table
    assert work.CARD in table
    with pytest.raises(NotImplementedError, match="one rank"):
        dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k",
                     "--multipod"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="memory-gb"):
            dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k",
                         "--fit", "--out", str(out)])


# --------------------------------------------------------------------------
# kernels/work.py against PERF.md §6
# --------------------------------------------------------------------------

BF, F32 = "bfloat16", "float32"
# each row of the kernel table: its shape, and the bound the table prints;
# B1's live positions and B7's kept rows are what the smoke's seeds draw
# (its records print them)
QWEN_LENS = (77, 200, 1, 218)
LONG_LENS = (77, 712, 1025, 218)
MOON_LENS = (648, 1951, 150, 58)


def _live(lens, MP, page=16):
    return sum(min(n, MP * page) for n in lens)


PERF_ROWS = [
    ("B1 qwen3 MP16", work.paged_decode_attention(
        4, 32, 8, 128, 16, 16, BF, live=_live(QWEN_LENS, 16)), "0.000626"),
    ("B1 qwen3 MP128", work.paged_decode_attention(
        4, 32, 8, 128, 128, 16, BF, live=_live(LONG_LENS, 128)), "0.00250"),
    ("B1 moonshot", work.paged_decode_attention(
        4, 16, 16, 128, 128, 16, BF, live=_live(MOON_LENS, 128)), "0.00687"),
    ("B1 nemotron", work.paged_decode_attention(
        4, 48, 8, 128, 128, 16, BF, live=_live(LONG_LENS, 128)), "0.00251"),
    ("B1 musicgen", work.paged_decode_attention(
        4, 32, 32, 64, 128, 16, BF, live=_live(MOON_LENS, 128)), "0.00687"),
    ("B2 S200", work.flash_attention(1, 32, 8, 200, 128, 128, 0, BF),
     "0.00122"),
    ("B2 S1000", work.flash_attention(1, 32, 8, 1000, 128, 128, 0, BF),
     "0.00829"),
    ("B2 S1531", work.flash_attention(1, 32, 8, 1531, 128, 128, 0, BF),
     "0.0194"),
    ("B2 S1900", work.flash_attention(1, 32, 8, 1900, 128, 128, 0, BF),
     "0.0299"),
    ("B2 moonshot S1000", work.flash_attention(1, 16, 16, 1000, 128, 128, 0,
                                               BF), "0.00489"),
    ("B2 moonshot S1900", work.flash_attention(1, 16, 16, 1900, 128, 128, 0,
                                               BF), "0.0150"),
    ("B2 danube S4500", work.flash_attention(1, 32, 8, 4500, 120, 120, 4096,
                                             BF), "0.1560"),
    ("B2 danube S7000", work.flash_attention(1, 32, 8, 7000, 120, 120, 4096,
                                             BF), "0.3150"),
    ("B2 nemotron", work.flash_attention(1, 48, 8, 1900, 128, 128, 0, BF),
     "0.0449"),
    ("B2 mla S1000", work.flash_attention(1, 16, 16, 1000, 192, 128, 0, BF),
     "0.00611"),
    ("B2 mla S1900", work.flash_attention(1, 16, 16, 1900, 192, 128, 0, BF),
     "0.0187"),
    ("B2 mla S1000 fp32", work.flash_attention(1, 16, 16, 1000, 192, 128, 0,
                                               F32), "0.0765"),
    ("B2 mla S1900 fp32", work.flash_attention(1, 16, 16, 1900, 192, 128, 0,
                                               F32), "0.2760"),
    ("B2 qwen3 train lse", work.flash_attention(
        1, 32, 8, 4096, 128, 128, 0, BF, lse=True), "0.1390"),
    ("B2-bwd qwen3 train", work.flash_attention_bwd(
        1, 32, 8, 4096, 128, 128, 0, BF), "0.3475"),
    ("B2-bwd mla S4096", work.flash_attention_bwd(
        1, 16, 16, 4096, 192, 128, 0, BF), "0.2259"),
    ("B2-bwd mla S1900", work.flash_attention_bwd(
        1, 16, 16, 1900, 192, 128, 0, BF), "0.0486"),
    ("B3", work.wkv6_decode(4, 32, 64, F32), "0.00130"),
    ("B4 S200", work.wkv6_chunked(1, 200, 32, 64, 32, BF), "0.00203"),
    ("B4 S1000", work.wkv6_chunked(1, 1000, 32, 64, 32, BF), "0.00971"),
    ("B4 S1531", work.wkv6_chunked(1, 1531, 32, 64, 32, BF), "0.0149"),
    ("B4-bwd S4096", work.wkv6_chunked_bwd(1, 4096, 32, 64, BF), "0.0801"),
    ("B4-bwd S1531", work.wkv6_chunked_bwd(1, 1531, 32, 64, BF), "0.0300"),
    ("B5", work.ssm_decode_step(4, 8192, 16), "0.00196"),
    ("B6 T256", work.linear_scan(1, 256, 8192, 16), "0.1205"),
    ("B6 T108", work.linear_scan(1, 108, 8192, 16), "0.0510"),
    ("B6-bwd T256", work.linear_scan_bwd(1, 256, 8192, 16), "0.2008"),
    ("B7 moonshot prefill", work.moe_dispatch(11400, 2048, 64, 223, BF,
                                              kept=11400), "0.0314"),
    ("B7 moonshot decode", work.moe_dispatch(24, 2048, 64, 4, BF, kept=24),
     "0.000342"),
    ("B7 jamba prefill", work.moe_dispatch(3800, 4096, 16, 297, BF,
                                           kept=3800), "0.0209"),
    ("B7 jamba decode", work.moe_dispatch(8, 4096, 16, 4, BF, kept=8),
     "0.000176"),
    ("B7-bwd moonshot prefill", work.moe_dispatch_bwd(
        11400, 2048, 64, 223, BF, kept=11400), "0.0279"),
]


@pytest.mark.parametrize("w,printed", [r[1:] for r in PERF_ROWS],
                         ids=[r[0] for r in PERF_ROWS])
def test_work_reproduces_the_perf_table_bounds(w, printed):
    """Each bound of PERF.md §6, to the digits the table prints."""
    decimals = len(printed.split(".")[1])
    assert f"{work.bound_s(w) * 1e3:.{decimals}f}" == printed
    perf = (ROOT / "PERF.md").read_text()
    assert f"| {printed} (" in perf
