"""Training the MoE, MLA, Mamba and RWKV-6 families in the port against
the JAX package: each new autograd Function's backward against
``jax.grad`` of the reference's jnp form, ``forward_loss`` and every
gradient on SMOKE configs, remat on an MoE stack, the train step, the
launcher, and the wrappers' routing through their Functions.

The port runs on the CPU, where each Function's forward and backward take
the plain versions. Weights are bridged from ``repro.models.lm.
init_params`` (fp32). Tolerances: the kernel backwards within 1e-5
absolute plus 1e-5 relative (fp32 sums in another order); the loss
within 1e-5, each
gradient within 1e-4 of max(1, |g|), as tests/test_torch_train.py holds
the dense family.
"""
import functools
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.grad_compress import init_residuals as j_init_res  # noqa
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.data import DataConfig, SyntheticPackedDataset  # noqa
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import lm, mamba, moe, rwkv  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        opt_state_to_numpy,
                                        params_from_numpy, params_to_numpy)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.grad_compress import init_residuals  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread, as in tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = ("moonshot-v1-16b-a3b", "deepseek-v2-lite-16b", "rwkv6-1.6b",
            "jamba-v0.1-52b")


def _rnd(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max(1, |want|) element by element."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert float(err.max(initial=0.0)) <= tol, (what, float(err.max()))


def _assert_tree_close(a, b, tol, path=""):
    """|a - b| <= tol * max(1, |b|) leaf by leaf, the same keys."""
    if isinstance(b, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for key in b:
            _assert_tree_close(a[key], b[key], tol, f"{path}/{key}")
        return
    if isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_close(x, y, tol, f"{path}/{i}")
        return
    _close(a, b, tol, path)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


# --------------------------------------------------------------------------
# forward_loss and its gradients on SMOKE configs
# --------------------------------------------------------------------------

# jamba's SMOKE at 5 of its 8 layers in both packages: JAX's gradient of
# the 8-layer stack alone takes ~21 s on a CPU; 5 keep Mamba, the attention
# layer at index 4, the dense first layer and MoE
LAYERS = {"jamba-v0.1-52b": 5}


def _bridge(arch):
    more = {"n_layers": LAYERS[arch]} if arch in LAYERS else {}
    jcfg = J_SMOKE[arch].scaled(dtype="float32", **more)
    tcfg = SMOKE_CONFIGS[arch].scaled(dtype="float32", **more)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    return jcfg, tcfg, tree


def _tokens(B, S, V, seed=0):
    return np.random.default_rng(seed).integers(0, V, size=(B, S)).astype(
        np.int32)


def _record_jax_routes(monkeypatch):
    """Record every MoE layer's experts as the reference routes them:
    jax.lax.top_k's indices through a debug callback, which fires inside
    the jitted group scan too. The forward's calls come first, in layer
    order (a rematerialised backward may call again)."""
    seen, top_k = [], jax.lax.top_k

    def rec(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda e: seen.append(np.asarray(e)), out[1])
        return out
    monkeypatch.setattr(jax.lax, "top_k", rec)
    return seen


def _routes_port(monkeypatch, fn):
    """Record every MoE layer's experts as the port routes them."""
    seen, route = [], moe.route

    def rec(*a):
        out = route(*a)
        seen.append(out[2].numpy())
        return out
    monkeypatch.setattr(moe, "route", rec)
    fn()
    return seen


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_and_grads_match_reference(arch, monkeypatch):
    """S 40 (a ragged Mamba tail in jamba's one chunk of 40 tokens, B4's
    chunks of 32 and a tail of 8, each MoE queue's capacity as the
    config's factor gives). The routed experts of every MoE layer are
    checked equal first; then the loss, ce and moe_aux within 1e-5,
    moe_dropped within 1e-6 (fp32 rounding of a share of equal counts),
    and every gradient within 1e-4 of max(1, |g|)."""
    jcfg, tcfg, tree = _bridge(arch)
    toks = _tokens(2, 40, tcfg.vocab_size, seed=3)
    jp = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, tcfg, device="cpu")
    routes_j = _record_jax_routes(monkeypatch)
    (loss_j, met_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jlm.forward_loss(p, jnp.asarray(toks), jcfg, NULL_POLICY),
        has_aux=True))(jp)
    jax.effects_barrier()
    routes = _routes_port(monkeypatch, lambda: None)
    (loss, met), g = ts.value_and_grad(params, torch.from_numpy(toks), tcfg)
    n_moe = tcfg.mlp_kinds().count("moe")
    assert len(routes) >= n_moe and len(routes_j) >= n_moe
    for a, b in zip(routes[:n_moe], routes_j[:n_moe]):
        np.testing.assert_array_equal(a, b)
    assert set(met) == set(met_j) == {"ce", "moe_aux", "moe_dropped"}
    for key, got, want in (("loss", loss, loss_j), ("ce", met["ce"],
                                                    met_j["ce"]),
                           ("moe_aux", met["moe_aux"], met_j["moe_aux"])):
        assert abs(float(got) - float(want)) <= 1e-5 * max(
            1, abs(float(want))), (key, float(got), float(want))
    # the share of dropped picks, summed over the layers: the same counts
    # give it to an ulp or two (XLA forms 1 - mean as one fused
    # multiply-add by 1/n inside its scan, eagerly as two ops)
    assert abs(float(met["moe_dropped"]) - float(met_j["moe_dropped"])) \
        <= 1e-6
    if tcfg.moe is not None:
        assert float(met["moe_aux"]) > 0
    _assert_tree_close(params_to_numpy(g, tcfg), _np_tree(g_j), 1e-4)


def test_remat_on_a_moe_stack(monkeypatch):
    """moonshot SMOKE at 3 layers (at its 2 the reference's ``plan_layers``
    finds no prefix: the dense and the MoE layer form one unit): remat
    gives the gradients and stats of the run without it, bit for bit, and
    checkpoints every block but the ``first_dense`` prefix."""
    tcfg = SMOKE_CONFIGS["moonshot-v1-16b-a3b"].scaled(dtype="float32",
                                                       n_layers=3)
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(_tokens(2, 24, tcfg.vocab_size, seed=1))
    prefix, unit, n_groups = tf.plan_layers(tcfg)
    assert len(prefix) == tcfg.moe.first_dense == 1
    calls, ckpt = [], torch.utils.checkpoint.checkpoint

    def rec(fn, *a, **k):
        if isinstance(fn, functools.partial):   # a block, not a CE chunk
            calls.append(fn.args[1:3])          # its (kind, mlp_kind)
        return ckpt(fn, *a, **k)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", rec)
    (l1, m1), g1 = ts.value_and_grad(params, toks, tcfg, remat=True)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", ckpt)
    assert calls == [("attn", "moe")] * (tcfg.n_layers - 1)
    (l0, m0), g0 = ts.value_and_grad(params, toks, tcfg, remat=False)
    assert torch.equal(l0, l1)
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    _assert_tree_close(params_to_numpy(g1, tcfg), params_to_numpy(g0, tcfg),
                       0.0)


def _count_calls(monkeypatch, calls, module, names):
    """Count the calls of ``module.<name>`` for each name into ``calls``."""
    for n in names:
        calls[n] = 0
        fn = getattr(module, n)

        def counted(*a, _fn=fn, _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, n, counted)


@pytest.mark.parametrize("arch,remat", [
    ("moonshot-v1-16b-a3b", True), ("moonshot-v1-16b-a3b", False),
    ("rwkv6-1.6b", True), ("jamba-v0.1-52b", True),
    ("jamba-v0.1-52b", False)])
def test_gradient_kernel_calls(arch, remat, monkeypatch):
    """The wrapper calls one gradient makes, which chip_smoke.py holds the
    card's launches to: B7 once an MoE layer (twice with remat past the
    prefix) and B7-bwd once; B4 once an RWKV layer (twice with remat) and
    B4-bwd once; B6 once a Mamba chunk, twice with the chunk's own
    checkpoint, three times inside a rematerialised block, and B6-bwd
    once a chunk."""
    cfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    S = 300                                    # Mamba: chunks of 256 + 44
    # the forward wrappers as the model modules call them, the backward
    # ones as their Functions do
    calls = {}
    for module, names in ((moe, ["moe_dispatch"]), (md, ["moe_dispatch_bwd"]),
                          (rwkv, ["wkv6_chunked"]),
                          (wk, ["wkv6_chunked_bwd"]),
                          (mamba, ["linear_scan"]),
                          (ls, ["linear_scan_bwd"])):
        _count_calls(monkeypatch, calls, module, names)
    ts.value_and_grad(params, torch.from_numpy(_tokens(1, S,
                                                       cfg.vocab_size)),
                      cfg, remat=remat)
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    n_prefix = len(tf.plan_layers(cfg)[0])
    n_moe = mlps.count("moe")
    moe_replayed = sum(1 for i, m in enumerate(mlps)
                       if m == "moe" and remat and i >= n_prefix)
    n_mamba = kinds.count("mamba")
    chunks = -(-S // 256)
    want = {"moe_dispatch": n_moe + moe_replayed,
            "moe_dispatch_bwd": n_moe,
            "wkv6_chunked": kinds.count("rwkv") * (2 if remat else 1),
            "wkv6_chunked_bwd": kinds.count("rwkv"),
            "linear_scan": n_mamba * chunks * (3 if remat else 2),
            "linear_scan_bwd": n_mamba * chunks}
    assert calls == want


# --------------------------------------------------------------------------
# bridges, the train step and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_weight_and_state_bridges_round_trip(arch):
    """Every family's tree (a dense prefix, MoE experts and shared
    experts, MLA, Mamba's fp32 leaves, RWKV's) to the port and back, and
    AdamW's state, exactly."""
    _, tcfg, tree = _bridge(arch)
    params = params_from_numpy(tree, tcfg, device="cpu")
    _assert_tree_close(params_to_numpy(params, tcfg), tree, 0.0)
    back = opt_state_from_numpy(opt_state_to_numpy(adamw_init(params), tcfg),
                                tcfg, device="cpu")
    _assert_tree_close(opt_state_to_numpy(back, tcfg)["master"], tree, 0.0)


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference_on_moe(compress):
    """Three steps of moonshot SMOKE in fp32 in 2 microbatches against the
    reference's jitted step: loss, ce, moe_aux, moe_dropped, grad_norm and
    lr each step (the last microbatch's stats, as the reference reports
    them), then the params and AdamW's master within 5e-5 of max(1, |ref|)
    and m, v within 1e-4 and 1e-5 of max(1e-3, |ref|), the tolerances of
    qwen3's step in tests/test_torch_train.py. With int8 compression a
    gradient 1e-7 from the reference's can round a quantum away: there at
    most 1e-4 of the params and master, each within 1 lr, may differ more,
    and at most 1e-3 of m and v, each within 2e-2 of its leaf's largest
    |value|, with the grad norm within 2e-5."""
    lr = 1e-3
    jcfg, tcfg, tree = _bridge("moonshot-v1-16b-a3b")
    jstep = jax.jit(jts.make_train_step(
        jcfg, NULL_POLICY, JAdamWConfig(lr=lr, warmup_steps=2,
                                        total_steps=4),
        grad_compression=compress, microbatch=2))
    step = ts.make_train_step(tcfg, AdamWConfig(lr=lr, warmup_steps=2,
                                                total_steps=4),
                              grad_compression=compress, microbatch=2)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = j_adamw_init(jp)
    params = params_from_numpy(tree, tcfg, device="cpu")
    opt = adamw_init(params)
    jres, res = j_init_res(jp), init_residuals(params)
    for i in range(3):
        toks = _tokens(4, 32, tcfg.vocab_size, seed=10 + i)
        if compress:
            jp, jo, jm, jres = jstep(jp, jo, jnp.asarray(toks), jres)
            params, opt, m, res = step(params, opt, torch.from_numpy(toks),
                                       res)
        else:
            jp, jo, jm = jstep(jp, jo, jnp.asarray(toks))
            params, opt, m = step(params, opt, torch.from_numpy(toks))
        assert set(m) == set(jm)
        for key in ("loss", "ce", "moe_aux", "moe_dropped", "grad_norm",
                    "lr"):
            tol = 2e-5 if compress and key == "grad_norm" else 1e-6
            err = abs(float(m[key]) - float(jm[key])) / max(
                1, abs(float(jm[key])))
            assert err <= tol, (i, key, float(m[key]), float(jm[key]))
    got = opt_state_to_numpy(opt, tcfg)
    mine = {"params": params_to_numpy(params, tcfg), **got}
    ref = {"params": _np_tree(jp), **{k: _np_tree(jo[k])
                                      for k in ("master", "m", "v")}}
    for key, tol, floor, frac, cap in (
            ("params", 5e-5, 1.0, 1e-4, lambda y: lr),
            ("master", 5e-5, 1.0, 1e-4, lambda y: lr),
            ("m", 1e-4, 1e-3, 1e-3, lambda y: 2e-2 * float(np.abs(y).max())),
            ("v", 1e-5, 1e-3, 1e-3,
             lambda y: 2e-2 * float(np.abs(y).max()))):
        pairs = [(np.asarray(x, np.float32), np.asarray(y, np.float32))
                 for x, y in zip(jax.tree.leaves(mine[key]),
                                 jax.tree.leaves(ref[key]))]
        assert len(pairs) == len(jax.tree.leaves(ref[key]))
        far = sum(int((np.abs(x - y) > tol * np.maximum(floor, np.abs(y)))
                      .sum()) for x, y in pairs)
        if not compress:
            assert far == 0, key
        else:
            assert far <= frac * sum(y.size for _, y in pairs), (key, far)
            for x, y in pairs:
                assert float(np.abs(x - y).max(initial=0.0)) <= cap(y), key


LAUNCH = ["--smoke", "--device", "cpu", "--seq", "32", "--batch", "2"]


def _launch(args):
    with redirect_stdout(io.StringIO()) as buf:
        out = launcher.main(LAUNCH + args)
    return out, buf.getvalue()


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_trains_every_family(arch, tmp_path):
    """Two steps of each family's SMOKE config through the launcher:
    finite losses and grad norms, equal to make_train_step's on the same
    weights and data, bit for bit."""
    out, text = _launch(["--arch", arch, "--steps", "2", "--ckpt-dir",
                         str(tmp_path)])
    assert "done: 2 steps" in text
    cfg = SMOKE_CONFIGS[arch]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    step = ts.make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=10,
                                               total_steps=2))
    data = SyntheticPackedDataset(DataConfig(
        seq_len=32, global_batch=2, vocab_size=cfg.vocab_size))
    for rec in out["steps"]:
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
        params, opt, m = step(params, opt,
                              torch.from_numpy(data.next_batch()[0]))
        assert rec["loss"] == float(m["loss"])


def test_launcher_resume_continues_a_moe_run(tmp_path):
    """moonshot SMOKE stopped at its step-2 checkpoint and resumed gives
    the uninterrupted run's losses bit for bit (2 microbatches)."""
    base = ["--arch", "moonshot-v1-16b-a3b", "--microbatch", "2"]
    full, _ = _launch(base + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "full")])
    ck = str(tmp_path / "ck")
    first, _ = _launch(base + ["--steps", "2", "--ckpt-every", "2",
                               "--ckpt-dir", ck])
    rest, text = _launch(base + ["--steps", "4", "--resume", "--ckpt-dir",
                                 ck])
    assert "resumed from step 2" in text and rest["start"] == 2
    assert [r["loss"] for r in first["steps"] + rest["steps"]] == \
        [r["loss"] for r in full["steps"]]
