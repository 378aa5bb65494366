"""The port's train path on a mesh of more than one rank against the JAX
package's multi-device mesh, both on the CPU.

The reference runs in one subprocess with eight forced XLA host devices
(``--xla_force_host_platform_device_count=8``, as tests/test_sharding.py
does): ``lm.forward_loss`` and its gradients under ``jax.value_and_grad``
on ``("data", "model")`` and ``("pod", "data", "model")`` meshes, each
case with its ``make_policy`` flags (sequence parallelism, the pod axis,
FSDP), and one ``make_train_step`` step jitted on ``train_shardings``.
The port runs every mesh of one world size in one spawn of that many
gloo ranks on a ``FileStore`` (``repro_torch.launch.mesh.spawn``, one
torch thread each; tests/torch_ranks.py), on the same fp32 SMOKE weights,
tp-aligned for the mesh's model axis (``init_params(tp=)``: qwen3-8b's
2 KV heads duplicated to 4 at tp 4, and a qwen1.5-4b of 6 heads and 2 KV
heads padded to 8 and 4), made by the port and carried to the reference
through ``models/convert.py``. Meshes: qwen3-8b on (2, 1), (1, 4) and
(2, 2); the padded qwen1.5-4b and moonshot-v1-16b-a3b (8 experts, 2 a
rank) on (2, 4), the reference test's own mesh; the port with FSDP off
and on (the reference's values do not depend on where its params lie).
Under SP (``act_seq`` over ``model``): qwen3-8b on (2, 2) and (1, 4),
moonshot on (2, 4), each on the weights and tokens of its mesh's case
without SP, which the port's SP run must also equal; pod + SP on (2, 2,
2): qwen3-8b (the (2, 2) case's weights, a step and an int8 step) and
moonshot (8 rows, two microbatches, a step); the port alone on a (2, 1,
2) pod mesh, which must equal its (2, 2) SP run, and the train launcher
on it against ``make_train_step``.

Under a data axis of 2 the reference's MoE stats are the mean over the
data shards of each shard's statistics (``_moe_mlp_sharded``'s
``pmean``), so moonshot's ``moe_aux`` and loss on the mesh differ from
its one-device values; the port reproduces the mesh's; on the pod mesh
the mean runs over pod x data, four shards. The port's
one-rank values are held too: against the reference's mesh for the dense
configs (the same function there), against its one-device run for
moonshot.

Tolerances: loss, ce, moe_aux and moe_dropped within 1e-5 relative;
gradients within 1e-4 of each leaf's largest |value| (the ranks sum in
another order); the stepped params within 1e-4 of each leaf's largest
|value| or 0.1 lr, whichever is larger: AdamW's first update m / sqrt(v)
is ill-conditioned where a gradient is near zero and moves there by a
fraction of lr (tests/test_torch_train.py), and a leaf that starts at
zero (the QKV biases) is no larger than the step (measured 5.3e-6 at lr
1e-4, the weights' worst). Every leaf must move by at least lr / 2.
"""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_mesh, spawn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.train import train_step as ts  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

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
LR = 1e-4
MOON = "moonshot-v1-16b-a3b"
PAD = {"n_heads": 6, "n_kv_heads": 2}
DM, POD = ("data", "model"), ("pod", "data", "model")
CASES = [
    dict(key="qwen3_dp", arch="qwen3-8b", mesh=(2, 1), fsdp=(False, True)),
    dict(key="qwen3_tp", arch="qwen3-8b", mesh=(1, 4), fsdp=(True,)),
    dict(key="qwen3_2x2", arch="qwen3-8b", mesh=(2, 2), fsdp=(False, True),
         step=True, compress=True),
    dict(key="qwen15_pad", arch="qwen1.5-4b", scale=PAD, mesh=(2, 4),
         fsdp=(False,), step=True),
    dict(key="moonshot", arch=MOON, mesh=(2, 4), fsdp=(False, True),
         step=True, microbatch=2),
    # sequence parallelism (sp) and the pod axis, on the weights and
    # tokens of the case they are held to (params_of) where there is one
    dict(key="qwen3_2x2_sp", arch="qwen3-8b", mesh=(2, 2), sp=True,
         fsdp=(True,), params_of="qwen3_2x2"),
    dict(key="qwen3_tp_sp", arch="qwen3-8b", mesh=(1, 4), sp=True,
         fsdp=(True,), params_of="qwen3_tp"),
    dict(key="moonshot_sp", arch=MOON, mesh=(2, 4), sp=True, fsdp=(True,),
         params_of="moonshot"),
    dict(key="qwen3_pod", arch="qwen3-8b", mesh=(2, 2, 2), axes=POD, sp=True,
         fsdp=(True,), step=True, compress=True, params_of="qwen3_2x2"),
    # 8 rows: each of 2 microbatches gives each of the 4 batch shards one
    dict(key="moonshot_pod", arch=MOON, mesh=(2, 2, 2), axes=POD, sp=True,
         fsdp=(True,), step=True, microbatch=2, batch=8),
    # the port's own: pod x data as the (2, 2) mesh's data axis
    dict(key="qwen3_pod_2x1x2", arch="qwen3-8b", mesh=(2, 1, 2), axes=POD,
         sp=True, fsdp=(True,), params_of="qwen3_2x2", ref=False),
]
for _c in CASES:
    _c.setdefault("axes", DM)
REF_CASES = [c for c in CASES if c.get("ref", True)]
# the reference's one-device run of moonshot's weights
NULL_CASE = dict(key="moonshot_null", arch=MOON, mesh=None, params_of=
                 "moonshot")
RUNS = [(c["key"], f) for c in REF_CASES for f in c["fsdp"]]
STEP_RUNS = [(c["key"], f) for c in REF_CASES if c.get("step")
             for f in c["fsdp"]]
# the train launcher's run on a pod mesh of four ranks
LAUNCH = ((2, 1, 2), POD)
# the port's runs that must equal another of its runs: SP against none
# on the same mesh, a pod mesh against the (2, 2) mesh whose data axis
# is as long as its pod x data
SAME_RUNS = [(("qwen3_2x2_sp", True), ("qwen3_2x2", True)),
             (("qwen3_tp_sp", True), ("qwen3_tp", True)),
             (("moonshot_sp", True), ("moonshot", True)),
             (("qwen3_pod_2x1x2", True), ("qwen3_2x2_sp", True)),
             (("qwen3_pod", True), ("qwen3_2x2_sp", True))]

REFERENCE = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[5])
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs.registry import SMOKE_CONFIGS
    from repro.models import lm
    from repro.optim import AdamWConfig, adamw_init
    from repro.sharding.policy import NULL_POLICY, make_policy
    from repro.train.grad_compress import init_residuals
    from repro.train.train_step import make_train_step, train_shardings

    cases = json.load(open(sys.argv[1]))
    data = np.load(sys.argv[2])
    lr = float(sys.argv[4])
    at = getattr(jax.sharding, "AxisType", None)

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def flat(prefix, tree, out):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + key(path)] = np.asarray(x, np.float32)

    out = {}
    for c in cases:
        cfg = SMOKE_CONFIGS[c["arch"]].scaled(dtype="float32",
                                              **c.get("scale", {}))
        src = c.get("params_of", c["key"])
        toks = jnp.asarray(data[src + ":tokens"])
        if c["mesh"] is None:
            mesh, pol, tp = None, NULL_POLICY, c["tp"]
        else:
            axes = tuple(c["axes"])
            mesh = jax.make_mesh(tuple(c["mesh"]), axes,
                                 **({"axis_types": (at.Auto,) * len(axes)}
                                    if at else {}))
            pol = make_policy(mesh, multi_pod="pod" in axes,
                              sp=c.get("sp", False),
                              fsdp=True in c["fsdp"])
            tp = pol.tp_size
        shape = lm.abstract_params(cfg, tp=tp)
        leaves, tdef = jax.tree_util.tree_flatten_with_path(shape)
        params = jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(data[src + ":params/" + key(p)])
                   for p, _ in leaves])

        def run():
            (l, met), g = jax.jit(jax.value_and_grad(
                lambda p, t: lm.forward_loss(p, t, cfg, pol),
                has_aux=True))(params, toks)
            k = c["key"]
            out[k + ":loss"] = np.float64(l)
            for n, v in met.items():
                out[k + ":" + n] = np.float64(v)
            flat(k + ":grads/", g, out)
            if c.get("step"):
                (p_sh, o_sh, tok_sh), out_sh = train_shardings(cfg, pol)
                step = jax.jit(make_train_step(
                    cfg, pol, AdamWConfig(lr=lr, warmup_steps=1),
                    microbatch=c.get("microbatch", 0)),
                    in_shardings=(p_sh, o_sh, tok_sh),
                    out_shardings=out_sh)
                p2, _, m2 = step(params, adamw_init(params), toks)
                for n in ("loss", "grad_norm"):
                    out[k + ":step_" + n] = np.float64(m2[n])
                flat(k + ":params/", p2, out)
            if c.get("compress"):
                res_sh = o_sh["master"]
                step8 = jax.jit(make_train_step(
                    cfg, pol, AdamWConfig(lr=lr, warmup_steps=1),
                    grad_compression=True),
                    in_shardings=(p_sh, o_sh, tok_sh, res_sh),
                    out_shardings=(p_sh, o_sh, None, res_sh))
                p8, _, m8, _ = step8(params, adamw_init(params), toks,
                                     init_residuals(params))
                for n in ("loss", "grad_norm"):
                    out[k + ":int8_" + n] = np.float64(m8[n])
                flat(k + ":int8_params/", p8, out)
        if mesh is None:
            run()
        else:
            with mesh:
                run()
    np.savez(sys.argv[3], **out)
    print("OK")
''')


def _config(case):
    return torch_ranks.case_config(case)


def _flat(tree, prefix=""):
    """{path: array} of a params_to_numpy tree, in the reference's path
    format (dict keys and list indices joined by '/')."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat(t, f"{prefix}{i}/"))
        return out
    if tree is None:
        return {}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's values (one subprocess) and the port's (a spawn of
    ranks per world size, every mesh of that size inside it, meanwhile),
    on the same weights and tokens."""
    tmp = tmp_path_factory.mktemp("multirank")
    inputs, weights = {}, {}
    for i, case in enumerate(CASES):
        cfg = _config(case)
        if "params_of" in case:
            case["tokens"] = _case(case["params_of"])["tokens"]
            case["params"] = weights[case["params_of"]]
            continue
        params = lm.init_params(cfg, torch.Generator().manual_seed(i),
                                device="cpu", tp=case["mesh"][-1])
        weights[case["key"]] = params_to_numpy(params, cfg)
        case["params"] = weights[case["key"]]
        case["tokens"] = torch_ranks.np_tokens(case.get("batch", 4), 32,
                                               cfg.vocab_size, seed=100 + i)
        inputs[case["key"] + ":tokens"] = case["tokens"]
        for k, v in _flat(weights[case["key"]]).items():
            inputs[f"{case['key']}:params/{k}"] = v
    np.savez(tmp / "inputs.npz", **inputs)
    meta = [{k: v for k, v in c.items() if k not in ("params", "tokens")}
            for c in REF_CASES]
    meta.append(dict(NULL_CASE, tp=4))
    (tmp / "cases.json").write_text(json.dumps(meta))
    t0 = time.monotonic()
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "cases.json"),
         str(tmp / "inputs.npz"), str(tmp / "ref.npz"), str(LR),
         str(ROOT / "src")], cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for world in dict.fromkeys(int(np.prod(c["mesh"])) for c in CASES):
            mine = [c for c in CASES if np.prod(c["mesh"]) == world]
            launch = LAUNCH + (str(tmp / "launch"),) if world == 4 \
                else None
            port.update(spawn(torch_ranks.train_cases, world, mine, LR,
                              launch, timeout=300)[0])
        out, err = ref.communicate(timeout=480)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    print(f"reference and ranks: {time.monotonic() - t0:.1f} s")
    return {"ref": dict(np.load(tmp / "ref.npz")), "port": port,
            "weights": weights}


def _case(key):
    return next(c for c in CASES if c["key"] == key)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_errs(got: dict, ref: dict, prefix: str):
    """{path: |got - ref| max over |ref| max} for every leaf."""
    errs = {}
    for k, v in got.items():
        r = ref[prefix + k]
        assert v.shape == r.shape, (k, v.shape, r.shape)
        errs[k] = float(np.abs(v - r).max()) / max(float(np.abs(r).max()),
                                                   1e-30)
    assert len(errs) == sum(1 for k in ref if k.startswith(prefix))
    return errs


@pytest.mark.parametrize("key,fsdp", RUNS)
def test_mesh_loss_and_stats_equal_reference(runs, key, fsdp):
    """forward_loss on the mesh: loss, ce, moe_aux and moe_dropped within
    1e-5 relative of the reference's mesh values, the same on every
    rank."""
    got, ref = runs["port"][(key, fsdp)], runs["ref"]
    for name in ("loss", "ce", "moe_aux", "moe_dropped"):
        want = float(ref[f"{key}:{name}"])
        assert _rel(got[name], want) <= 1e-5 or (
            want == 0 and got[name] == 0), (name, got[name], want)


@pytest.mark.parametrize("key,fsdp", RUNS)
def test_mesh_gradients_equal_reference(runs, key, fsdp):
    """Every gradient of forward_loss, summed over data and gathered from
    the ranks' shards, within 1e-4 of the leaf's largest |value| of the
    reference's mesh gradient."""
    got = _flat(runs["port"][(key, fsdp)]["grads"])
    errs = _leaf_errs(got, runs["ref"], f"{key}:grads/")
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("key,fsdp", STEP_RUNS)
def test_mesh_train_step_equals_reference(runs, key, fsdp):
    """One make_train_step step on the mesh (ZeRO-1, FSDP as the policy
    says; moonshot with 2 microbatches) against the reference's step
    jitted on train_shardings: loss and grad norm within 1e-5 relative,
    every stepped param within 1e-4 of its leaf's largest |value| or 0.1
    lr, and every leaf moved by lr / 2 or more."""
    rec, ref = runs["port"][(key, fsdp)], runs["ref"]
    for name in ("loss", "grad_norm"):
        want = float(ref[f"{key}:step_{name}"])
        assert _rel(rec["step_metrics"][name], want) <= 1e-5, (name, want)
    got = _flat(rec["params"])
    assert len(got) == sum(1 for k in ref if k.startswith(f"{key}:params/"))
    before = _flat(_case(key)["params"])
    for k, v in got.items():
        want = ref[f"{key}:params/{k}"]
        tol = max(1e-4 * float(np.abs(want).max()), 0.1 * LR)
        err = float(np.abs(v - want).max())
        assert err <= tol, (k, err, tol)
        moved = float(np.abs(v - before[k]).max())
        assert moved > 0.5 * LR, (k, moved)


@pytest.mark.parametrize("key", ["qwen3_dp", "qwen3_tp", "qwen3_2x2",
                                 "qwen15_pad", "moonshot"])
def test_one_rank_equals_reference(runs, key):
    """The port on one rank (NULL_POLICY) over the same tp-aligned
    weights: the dense configs' loss and gradients equal the reference's
    mesh values (the same function there); moonshot's equal the
    reference's one-device run, whose moe_aux differs from its mesh's."""
    case = _case(key)
    cfg = _config(case)
    params = params_from_numpy(runs["weights"][key], cfg, device="cpu")
    (loss, metrics), grads = ts.value_and_grad(
        params, torch.from_numpy(case["tokens"]), cfg)
    ref_key = NULL_CASE["key"] if case["arch"] == MOON else key
    ref = runs["ref"]
    got = {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}
    for name in ("loss", "ce", "moe_aux", "moe_dropped"):
        want = float(ref[f"{ref_key}:{name}"])
        assert _rel(got[name], want) <= 1e-5 or want == got[name] == 0, (
            name, got[name], want)
    errs = _leaf_errs(_flat(params_to_numpy(grads, cfg)), ref,
                      f"{ref_key}:grads/")
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    if case["arch"] == MOON:
        # the mesh's mean of per-shard products differs from the global
        assert _rel(float(ref[f"{key}:moe_aux"]), got["moe_aux"]) > 1e-4


def test_collectives_values_and_gradients():
    """Two gloo ranks: psum and pmean forward the sum and mean with the
    identity and 1/n backward, copy_in the identity with the summed
    backward, all_gather tiles and reduce-scatters the cotangent (by
    all_to_all on gloo), pmax the maximum; a bf16 psum, gather and
    reduce-scatter; the counts tally each call."""
    a, b = spawn(torch_ranks.collectives, 2, timeout=120)
    assert (a["axis_index"], b["axis_index"]) == (0, 1)
    x = [np.arange(4.0) + 1, np.arange(4.0) + 2]
    w = [np.arange(4.0), 2 * np.arange(4.0)]
    for r, out in enumerate((a, b)):
        np.testing.assert_array_equal(out["psum"][0], x[0] + x[1])
        np.testing.assert_array_equal(out["psum"][1], w[r])
        np.testing.assert_array_equal(out["pmean"][0], (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(out["pmean"][1], w[r] / 2)
        np.testing.assert_array_equal(out["copy_in"][0], x[r])
        np.testing.assert_array_equal(out["copy_in"][1], w[0] + w[1])
        np.testing.assert_array_equal(out["all_gather"][0],
                                      np.concatenate(x))
        wg = [np.arange(8.0), 2 * np.arange(8.0)]
        np.testing.assert_array_equal(out["all_gather"][1],
                                      (wg[0] + wg[1])[4 * r:4 * r + 4])
        np.testing.assert_array_equal(out["pmax"], [0.0, 1.0, 2.0, 3.0])
        np.testing.assert_array_equal(out["bf16_psum"], [2.0, 2.0 ** -8])
        np.testing.assert_array_equal(out["bf16_gather"],
                                      [[1.5, -2.0 ** -9, 3.0, -2.0 ** -8]])
        want = [[[3.0, 6.0]], [[9.0, 3 * 2.0 ** -9]]][r]
        np.testing.assert_array_equal(out["bf16_scatter"], want)
        assert out["counts"]["all_reduce"]["calls"] == 5
        assert out["counts"]["all_gather"]["calls"] == 2
        assert out["counts"]["all_to_all"]["calls"] == 2


def test_make_mesh_refusals(monkeypatch):
    """make_mesh names what it needs: a process group or a store and a
    rank, as many axes as dims, a card for cuda, and (with cards) one
    GPU per rank for NCCL. Another test in this process may have left
    the one-rank smoke group up, so the first case hides it."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(ValueError, match="give store= and rank="):
        make_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("data",), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh((1, 1), device="cuda", backend="cpu:gloo,cuda:nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL takes one GPU per rank"):
        make_mesh((2, 2), device="cuda", backend="cpu:gloo,cuda:nccl")


@pytest.mark.parametrize("key,fsdp", [("qwen3_2x2", False),
                                      ("qwen3_2x2", True),
                                      ("qwen3_pod", True)])
def test_mesh_int8_compression_equals_reference(runs, key, fsdp):
    """One step with int8 gradient compression on qwen3-8b's (2, 2) mesh
    and its (2, 2, 2) pod mesh under SP against the reference's: each
    leaf's scale is the whole leaf's (a pmax over the ranks' ZeRO-1
    slices, after the sum over pod; qwen3's two layers share one, the
    reference's stacked leaf), so the loss agrees within 1e-5 and the
    compressed gradients' norm within 2e-5. A gradient 1e-7 from the
    reference's can round to the neighbouring quantum near a half, which
    moves a zero quantum's first update by up to lr: at most 1e-4 of the
    stepped params lie outside the step test's tolerance, each within
    lr of the reference's."""
    rec, ref = runs["port"][(key, fsdp)], runs["ref"]
    m = rec["int8_metrics"]
    assert _rel(m["loss"], float(ref[f"{key}:int8_loss"])) <= 1e-5
    assert _rel(m["grad_norm"], float(ref[f"{key}:int8_grad_norm"])) <= 2e-5
    got = _flat(rec["int8_params"])
    n_out = n_all = 0
    for k, v in got.items():
        want = ref[f"{key}:int8_params/{k}"]
        tol = max(1e-4 * float(np.abs(want).max()), 0.1 * LR)
        err = np.abs(v - want)
        n_out += int((err > tol).sum())
        n_all += err.size
        assert float(err.max()) <= LR, (k, float(err.max()))
    assert n_out <= 1e-4 * n_all, (n_out, n_all)
    # compression moved the step: not the uncompressed one
    plain = _flat(rec["params"])
    assert max(float(np.abs(got[k] - plain[k]).max()) for k in got) > 0


@pytest.mark.parametrize("run,same", SAME_RUNS)
def test_sp_and_pod_runs_equal_the_port_without_them(runs, run, same):
    """The port against itself on the same weights and tokens: sequence
    parallelism gives what its mesh gives without it, and a pod mesh
    what the (2, 2) mesh gives whose data axis is as long as its pod x
    data: loss and stats within 1e-5 relative, every gathered gradient
    within 1e-4 of its leaf's largest |value| (the sums run in another
    order)."""
    got, want = runs["port"][run], runs["port"][same]
    for name in ("loss", "ce", "moe_aux", "moe_dropped"):
        assert _rel(got[name], want[name]) <= 1e-5 or (
            want[name] == got[name] == 0), (name, got[name], want[name])
    g, w = _flat(got["grads"]), _flat(want["grads"])
    assert g.keys() == w.keys()
    for k in g:
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= 1e-4 * max(float(np.abs(w[k]).max()), 1e-30), (k, err)


def test_pod_moe_stats_are_the_mean_over_pod_x_data(runs):
    """moonshot on the (2, 2, 2) pod mesh: moe_aux and moe_dropped are
    the mean over the four pod x data shards of each shard's one-rank
    statistics (the reference's pmean over ("pod", "data")), within
    1e-5 relative, and moe_aux is not the mean over two halves of the
    batch."""
    case = _case("moonshot_pod")
    cfg = _config(case)
    params = params_from_numpy(case["params"], cfg, device="cpu")
    toks = torch.from_numpy(case["tokens"])

    def shard_mean(n):
        b, got = toks.shape[0] // n, {"moe_aux": 0.0, "moe_dropped": 0.0}
        with torch.no_grad():
            for i in range(n):
                _, m = lm.forward_loss(params, toks[i * b:(i + 1) * b], cfg,
                                       remat=False)
                for k in got:
                    got[k] += float(m[k]) / n
        return got
    four, rec = shard_mean(4), runs["port"][("moonshot_pod", True)]
    for k, v in four.items():
        assert _rel(rec[k], v) <= 1e-5 or rec[k] == v == 0, (k, rec[k], v)
    assert _rel(rec["moe_aux"], shard_mean(2)["moe_aux"]) > 1e-4


def test_launcher_on_a_pod_mesh_equals_make_train_step(runs):
    """The train launcher given a (2, 1, 2) pod mesh of four ranks
    (``--smoke``: SMOKE qwen3-8b in bf16 without SP or FSDP; ZeRO-1 and
    the pod axis's batch rules) gives make_train_step's losses and grad
    norms on that mesh, weights, data and schedule, bit for bit."""
    rec = runs["port"]["launcher"]
    assert len(rec["launcher"]) == 2
    assert rec["launcher"] == rec["make_train_step"]
