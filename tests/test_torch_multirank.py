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
import sys
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
from torch_ranks import (check_gradients, check_int8_step,  # noqa: E402
                         check_loss_and_stats, check_same_run,
                         check_train_step, flat, leaf_errs, rel)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: these shapes are too small to gain
    from more, and with several test workers on one host the idle threads'
    spin-waits slow every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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



def _config(case):
    return torch_ranks.case_config(case)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's values (one subprocess) and the port's (a spawn of
    ranks per world size, every mesh of that size inside it, meanwhile),
    on the same weights and tokens."""
    return torch_ranks.reference_and_ranks(
        tmp_path_factory.mktemp("multirank"), CASES, LR, 100, LAUNCH,
        extra=[dict(NULL_CASE, tp=4)])


def _case(key):
    return next(c for c in CASES if c["key"] == key)


@pytest.mark.parametrize("key,fsdp", RUNS)
def test_mesh_loss_and_stats_equal_reference(runs, key, fsdp):
    """forward_loss on the mesh: loss, ce, moe_aux and moe_dropped within
    1e-5 relative of the reference's mesh values, the same on every
    rank."""
    check_loss_and_stats(runs["port"][(key, fsdp)], runs["ref"], key)


@pytest.mark.parametrize("key,fsdp", RUNS)
def test_mesh_gradients_equal_reference(runs, key, fsdp):
    """Every gradient of forward_loss, summed over data and gathered from
    the ranks' shards, within 1e-4 of the leaf's largest |value| of the
    reference's mesh gradient."""
    check_gradients(runs["port"][(key, fsdp)], runs["ref"], key)


@pytest.mark.parametrize("key,fsdp", STEP_RUNS)
def test_mesh_train_step_equals_reference(runs, key, fsdp):
    """One make_train_step step on the mesh (ZeRO-1, FSDP as the policy
    says; moonshot with 2 microbatches) against the reference's step
    jitted on train_shardings: loss and grad norm within 1e-5 relative,
    every stepped param within 1e-4 of its leaf's largest |value| or 0.1
    lr, and every leaf moved by lr / 2 or more."""
    check_train_step(runs["port"][(key, fsdp)], runs["ref"], key,
                     _case(key)["params"], LR)


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
        assert rel(got[name], want) <= 1e-5 or want == got[name] == 0, (
            name, got[name], want)
    errs = leaf_errs(flat(params_to_numpy(grads, cfg)), ref,
                      f"{ref_key}:grads/")
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    if case["arch"] == MOON:
        # the mesh's mean of per-shard products differs from the global
        assert rel(float(ref[f"{key}:moe_aux"]), got["moe_aux"]) > 1e-4


def test_collectives_values_and_gradients():
    """Two gloo ranks: psum and pmean forward the sum and mean with the
    identity and 1/n backward, copy_in the identity with the summed
    backward, psum_inside the sum both ways, all_gather tiles and
    reduce-scatters the cotangent (by all_to_all on gloo), all_to_all
    exchanges parts (equal, or of the sizes given) and its backward
    the cotangent's the other way, pmax the maximum; a bf16 psum,
    gather and reduce-scatter; the counts tally each call."""
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
        np.testing.assert_array_equal(out["psum_inside"][0], x[0] + x[1])
        np.testing.assert_array_equal(out["psum_inside"][1], w[0] + w[1])
        # rank q's part r to rank r, the cotangent's parts back the same
        # way: equal parts, or rank 0's of 1 and 3 elements, rank 1's of
        # 3 and 1
        for name, a, b in (
                ("all_to_all", slice(2 * r, 2 * r + 2),
                 slice(2 * r, 2 * r + 2)),
                ("all_to_all_uneven", slice(1, 4) if r else slice(0, 1),
                 slice(3, 4) if r else slice(0, 3))):
            for got, v in zip(out[name], (x, w)):
                np.testing.assert_array_equal(
                    got, np.concatenate([v[0][a], v[1][b]]))
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
        assert out["counts"]["all_reduce"]["calls"] == 7
        assert out["counts"]["all_gather"]["calls"] == 2
        assert out["counts"]["all_to_all"]["calls"] == 6


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
    check_int8_step(runs["port"][(key, fsdp)], runs["ref"], key, LR)


@pytest.mark.parametrize("run,same", SAME_RUNS)
def test_sp_and_pod_runs_equal_the_port_without_them(runs, run, same):
    """The port against itself on the same weights and tokens: sequence
    parallelism gives what its mesh gives without it, and a pod mesh
    what the (2, 2) mesh gives whose data axis is as long as its pod x
    data: loss and stats within 1e-5 relative, every gathered gradient
    within 1e-4 of its leaf's largest |value| (the sums run in another
    order)."""
    check_same_run(runs["port"][run], runs["port"][same])


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
        assert rel(rec[k], v) <= 1e-5 or rec[k] == v == 0, (k, rec[k], v)
    assert rel(rec["moe_aux"], shard_mean(2)["moe_aux"]) > 1e-4


def test_launcher_on_a_pod_mesh_equals_make_train_step(runs):
    """The train launcher given a (2, 1, 2) pod mesh of four ranks
    (``--smoke``: SMOKE qwen3-8b in bf16 without SP or FSDP; ZeRO-1 and
    the pod axis's batch rules) gives make_train_step's losses and grad
    norms on that mesh, weights, data and schedule, bit for bit."""
    rec = runs["port"]["launcher"]
    assert len(rec["launcher"]) == 2
    assert rec["launcher"] == rec["make_train_step"]
