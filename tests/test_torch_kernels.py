"""The port's kernel modules against the JAX package's kernels.

On the CPU the wrappers take their plain PyTorch versions; these are held
against the Pallas kernels (interpret mode, through ``repro.kernels.ops``)
and the ``repro.kernels.ref`` oracles on the same inputs, made from numpy
with fixed seeds. Tolerances are those of tests/test_kernels.py: fp32
2e-5, bf16 2e-2. The kernels themselves run only on a CUDA card:
tests/test_torch_cuda.py and ``python3 chip_smoke.py`` hold them against
the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of `dtype`
    (both round the same fp32 values to bf16)."""
    return (jnp.asarray(x).astype(_JDT[dtype]),
            torch.from_numpy(x).to(_TDT[dtype]))


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def _flash_inputs(B, H, KV, S, hd, seed, hd_v=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd_v or hd))]


# ---------------------------------------------------------------------------
# B2: causal flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,S,hd", [
    (2, 4, 2, 256, 64), (1, 4, 4, 200, 32), (2, 8, 2, 192, 64),
    (1, 2, 1, 128, 16),
    (1, 4, 4, 130, 192),            # MLA: q/k 192 with v 128, no grouping
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_ref(B, H, KV, S, hd, dtype):
    """Every instance's v head dim is its own (``fa.INSTANCES``): hd for
    the square ones, 128 for q/k 192."""
    hd_v = dict(fa.INSTANCES)[hd]
    xs = _flash_inputs(B, H, KV, S, hd, seed=B * S + H, hd_v=hd_v)
    tq, tk, tv = [_pair(x, dtype)[1] for x in xs]
    out = fa.flash_attention(tq, tk, tv)
    assert out.dtype == _TDT[dtype] and out.shape == (B, H, S, hd_v)
    # like test_kernels.py: the oracle runs on the fp32 values the
    # low-precision inputs were rounded to
    expected = ref.flash_attention_ref(jnp.asarray(tq.float().numpy()),
                                       jnp.asarray(tk.float().numpy()),
                                       jnp.asarray(tv.float().numpy()))
    _close(out, expected, _TOL[dtype])


@pytest.mark.parametrize("window", [32, 96])
def test_flash_plain_swa_matches_ref(window):
    xs = _flash_inputs(2, 4, 2, 256, 32, seed=window)
    out = fa.flash_attention(*[torch.from_numpy(x) for x in xs],
                             window=window)
    expected = ref.flash_attention_ref(*[jnp.asarray(x) for x in xs],
                                       window=window)
    _close(out, expected, 2e-5)


@pytest.mark.parametrize("dtype,window", [("float32", 0), ("bfloat16", 0),
                                          ("float32", 32)])
def test_flash_plain_matches_pallas(dtype, window):
    """Against the TPU kernel itself, run in interpret mode."""
    xs = _flash_inputs(1, 2, 1, 128, 16, seed=7)
    js, ts = zip(*[_pair(x, dtype) for x in xs])
    out = fa.flash_attention(*ts, window=window)
    expected = ops.flash_attention(*js, window=window, block_q=64,
                                   block_k=64, interpret=True)
    _close(out, expected, _TOL[dtype])


# ---------------------------------------------------------------------------
# B1: paged decode attention
# ---------------------------------------------------------------------------

def _paged_inputs(B, H, KV, hd, NP, page, MP, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((NP, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, page, KV, hd)).astype(np.float32)
    table = rng.integers(0, NP, size=(B, MP)).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, MP * page + 1, size=B)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("B,H,KV,hd,NP,page,MP", [
    (2, 4, 2, 32, 16, 16, 4), (3, 8, 4, 64, 32, 8, 6), (1, 2, 1, 16, 8, 4, 3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_ref(B, H, KV, hd, NP, page, MP, dtype):
    q, kp, vp, table, lengths = _paged_inputs(B, H, KV, hd, NP, page, MP,
                                              seed=NP + MP)
    tq, tk, tv = [_pair(x, dtype)[1] for x in (q, kp, vp)]
    out = pa.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                    torch.from_numpy(lengths))
    assert out.dtype == _TDT[dtype] and out.shape == (B, H, hd)
    expected = ref.paged_decode_attention_ref(
        jnp.asarray(tq.float().numpy()), jnp.asarray(tk.float().numpy()),
        jnp.asarray(tv.float().numpy()), jnp.asarray(table),
        jnp.asarray(lengths))
    _close(out, expected, _TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas_edge_rows(dtype):
    """Row 0 has length 0 and must give 0 (the kernel's l == 0 guard);
    row 2 is a parked slot whose length runs past a narrowed table
    (MP * page = 12 < 20): every table entry is live. Against the TPU
    kernel in interpret mode, and against the ref on rows of length > 0
    (the ref's softmax over all-masked scores would average V)."""
    q, kp, vp, table, lengths = _paged_inputs(3, 2, 1, 16, 8, 4, 3, seed=3,
                                              lengths=[0, 7, 20])
    js, ts = zip(*[_pair(x, dtype) for x in (q, kp, vp)])
    out = pa.paged_decode_attention(*ts, torch.from_numpy(table),
                                    torch.from_numpy(lengths))
    assert not out[0].float().any()
    pallas = ops.paged_decode_attention(*js, jnp.asarray(table),
                                        jnp.asarray(lengths), interpret=True)
    _close(out, pallas, _TOL[dtype])
    expected = ref.paged_decode_attention_ref(
        *[jnp.asarray(t.float().numpy()) for t in ts], jnp.asarray(table),
        jnp.asarray(lengths))
    _close(out[1:], np.asarray(expected, np.float32)[1:], _TOL[dtype])


@pytest.mark.parametrize("pp", [1, 2, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_plain_matches_ref(dtype, pp):
    """The kernel's split-K algorithm (partials per partition of ``pp``
    pages, then the reduce) against the JAX oracle: lengths 0 (every
    partition empty: 0, not 0/0), 1, a page, a partition, a partition +
    1, MP * page and past it (clamped to the table); partitions after a
    slot's length are empty; pp = 6 = MP is one partition a slot. GQA
    with G = 4."""
    page, MP = 4, 6
    lengths = [0, 1, page, pp * page, pp * page + 1, MP * page,
               MP * page + 7]
    q, kp, vp, table, lengths = _paged_inputs(len(lengths), 8, 2, 32, 20,
                                              page, MP, seed=pp,
                                              lengths=lengths)
    tq, tk, tv = [_pair(x, dtype)[1] for x in (q, kp, vp)]
    tt, tl = torch.from_numpy(table), torch.from_numpy(lengths)
    out = pa.paged_decode_split_plain(tq, tk, tv, tt, tl, partition_pages=pp)
    assert out.dtype == _TDT[dtype] and out.shape == tq.shape
    assert torch.isfinite(out.float()).all()
    assert not out[0].float().any()
    expected = ref.paged_decode_attention_ref(
        *[jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)],
        jnp.asarray(table), jnp.asarray(lengths))
    _close(out[1:], np.asarray(expected, np.float32)[1:], _TOL[dtype])
    # and the one-pass plain version the wrapper takes on the CPU
    _close(out, pa.paged_decode_plain(tq, tk, tv, tt, tl).float().numpy(),
           _TOL[dtype])


def test_paged_split_plain_all_empty_is_zero():
    """Every partition empty in every slot (m = -1e30, l = 0 throughout):
    the combine returns 0, never NaN."""
    q, kp, vp, table, lengths = _paged_inputs(3, 4, 4, 16, 8, 4, 5, seed=1,
                                              lengths=[0, 0, 0])
    out = pa.paged_decode_split_plain(
        *[torch.from_numpy(x) for x in (q, kp, vp, table, lengths)],
        partition_pages=2)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("MP,page,want", [
    (128, 16, 16), (16, 16, 16), (1, 16, 1), (4, 16, 4), (6, 8, 6),
    (256, 16, 16), (64, 32, 8), (64, 512, 1),
])
def test_partition_pages_from_shapes(MP, page, want):
    """The split's partition size follows page only, capped at MP, so its
    partitions start at the same pages at every table width: a slot's
    output does not depend on how wide the batch's table is. At the serve
    shapes (4 slots, MP 128, page 16) the split pass has at least two
    blocks per SM of the card's 132: 256 for qwen3-8b (KV 8), 512 for
    moonshot-v1-16b-a3b (KV 16)."""
    pp = pa.partition_pages(MP, page)
    assert pp == want
    assert 1 <= pp <= max(1, pa.PARTITION_TOKENS // page)
    for wider in (2 * MP, 4 * MP, 1024):
        pw = pa.partition_pages(wider, page)
        assert ([lo for lo in range(0, wider, pw) if lo < MP]
                == list(range(0, MP, pp)))
    splits = -(-MP // pp)
    if MP == 128 and page == 16:
        assert 4 * 8 * splits >= 256 and 4 * 16 * splits >= 512


@pytest.mark.parametrize("active", [None, [True, False, True, False],
                                    [False, False, False, False],
                                    [False, True, True, False]])
def test_paged_append_matches_jax(active):
    """Same writes as the JAX scatter: active rows land in their pages,
    inactive rows leave the pools bit-identical. Slot 1's table is
    narrower than its position (a parked slot), so the column clamps;
    slots 2 and 3 hold a zero row, like free slots, so both aim at the
    same row of page 0."""
    rng = np.random.default_rng(11)
    NP, page, KV, hd = 10, 4, 2, 8
    kp = rng.standard_normal((NP, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, page, KV, hd)).astype(np.float32)
    k_new = rng.standard_normal((4, KV, hd)).astype(np.float32)
    v_new = rng.standard_normal((4, KV, hd)).astype(np.float32)
    table = np.array([[3, 7, 1], [5, 2, 9], [0, 0, 0], [0, 0, 0]], np.int32)
    positions = np.array([6, 17, 1, 1], np.int32)
    j_act = None if active is None else jnp.asarray(active)
    t_act = None if active is None else torch.tensor(active)
    if active is None:
        positions[1] = 9                    # no clamp: every row writes
        table[3, 0] = 8                     # and no two rows alias
    jk, jv = jpa.paged_append(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(table), jnp.asarray(positions),
                              active=j_act)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = pa.paged_append(tk, tv, torch.from_numpy(k_new),
                          torch.from_numpy(v_new), torch.from_numpy(table),
                          torch.from_numpy(positions), active=t_act)
    assert out[0] is tk and out[1] is tv          # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_live_table_width_matches_jax():
    for max_pages in (1, 2, 3, 7, 8, 16, 100, 128):
        for n in range(0, 140):
            assert (pa.live_table_width(n, max_pages)
                    == jpa.live_table_width(n, max_pages)), (n, max_pages)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_do_not_count_launches():
    xs = [torch.from_numpy(x) for x in _flash_inputs(1, 2, 1, 32, 16, 0)]
    q, kp, vp, table, lengths = _paged_inputs(2, 2, 1, 16, 8, 4, 3, seed=0)
    before = (fa.flash_attention.launches,
              pa.paged_decode_attention.launches)
    fa.flash_attention(*xs)
    pa.paged_decode_attention(*[torch.from_numpy(x) for x in
                                (q, kp, vp, table, lengths)])
    assert (fa.flash_attention.launches,
            pa.paged_decode_attention.launches) == before


@pytest.mark.parametrize("bad", ["hd", "dtype", "int64_table"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    if bad == "hd":
        x = torch.zeros(1, 2, 8, 20)
        with pytest.raises(ValueError):
            fa.flash_attention(x, x[:, :1], x[:, :1])
    elif bad == "dtype":
        x = torch.zeros(1, 2, 8, 16, dtype=torch.float16)
        with pytest.raises(TypeError):
            fa.flash_attention(x, x, x)
    else:
        q, kp, vp, table, lengths = [
            torch.from_numpy(x) for x in _paged_inputs(2, 2, 1, 16, 8, 4, 3, 0)]
        with pytest.raises(TypeError):
            pa.paged_decode_attention(q, kp, vp, table.long(), lengths)


def test_every_pallas_kernel_has_a_hopper_counterpart():
    """Each function of the JAX package that reaches ``pl.pallas_call``
    (by file and line) is named as replaced by one kernel source of the
    port and by ``chip_smoke.py``'s kernel line; every source in
    ``kernels/csrc`` is built (``_build.SOURCES``) and exports the error
    string its wrapper reads."""
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    repo = Path(__file__).resolve().parents[1]
    calls = {f"src/repro/kernels/{p.name}:{i}"
             for p in sorted((repo / "src/repro/kernels").glob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if "pl.pallas_call(" in line}
    assert len(calls) == 7, calls
    smoke = (repo / "chip_smoke.py").read_text()
    named = set(re.findall(r'"(src/repro/kernels/\w+\.py:\d+)"', smoke))
    assert named == calls
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == sources
    for name in sources:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces:" in text and "src/repro/kernels/" in text, name
        assert "cuda_error_string" in text, name
