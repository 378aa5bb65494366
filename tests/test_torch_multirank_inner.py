"""RWKV-6, Mamba and jamba trained on a mesh of more than one rank, the
``inner`` axis over ``model``, against the JAX package's multi-device
mesh, both on the CPU.

The same harness as tests/test_torch_multirank.py (tests/torch_ranks.py),
in a module of its own so that its reference subprocess runs beside that
module's under ``--dist loadfile``: the reference in one subprocess with
eight forced XLA host devices (``torch_ranks.REFERENCE``),
``lm.forward_loss`` and its gradients under ``jax.value_and_grad`` and
``make_train_step`` steps jitted on ``train_shardings``; the port's
ranks in one ``launch.mesh.spawn`` per world size, on the same
fp32 SMOKE weights made by the port and carried across through
``models/convert.py``. Cases: rwkv6-1.6b on (2, 2) with FSDP off and on,
(1, 4), (2, 2) under SP and (2, 2, 2) pod under SP (a step and an int8
step); jamba-v0.1-52b cut to 5 layers on both sides (Mamba with dense
and MoE MLPs, the attention layer at index 4) on (2, 2) with FSDP off
and on, (2, 2) under SP and (2, 2, 2) pod under SP (8 rows, 2
microbatches, a step). The port's own runs: its SP runs against its
runs without SP, rwkv6's pod run against its (2, 2) SP run (one
function: no MoE), jamba's against a (4, 2) SP run with as many batch
shards (the MoE stats are the mean over them); the train launcher on
jamba's (2, 2) mesh against make_train_step.

Beside them, the collectives Mamba's region adds on their own: the
exchange of ``in_proj``'s output to each rank's channels of xm and z
(``mamba._rank_halves``) at tp 2, 3 and 4, values and gradients.

Tolerances as tests/test_torch_multirank.py's: loss and stats within
1e-5 relative, gathered gradients within 1e-4 of each leaf's largest
|value|, stepped params within 1e-4 of the leaf's largest or 0.1 lr.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import spawn  # noqa: E402
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
    """torch on one intra-op thread, as in tests/test_torch_multirank.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 1e-4
RWKV, JAMBA = "rwkv6-1.6b", "jamba-v0.1-52b"
# jamba's first five layers: four Mamba (MLPs dense, MoE, dense, MoE) and
# the attention layer at index 4 (dense MLP)
J5 = {"n_layers": 5}
DM, POD = ("data", "model"), ("pod", "data", "model")
CASES = [
    dict(key="rwkv_2x2", arch=RWKV, mesh=(2, 2), fsdp=(False, True)),
    dict(key="rwkv_tp", arch=RWKV, mesh=(1, 4), fsdp=(True,)),
    dict(key="rwkv_2x2_sp", arch=RWKV, mesh=(2, 2), sp=True, fsdp=(True,),
         params_of="rwkv_2x2"),
    dict(key="rwkv_pod", arch=RWKV, mesh=(2, 2, 2), axes=POD, sp=True,
         fsdp=(True,), step=True, compress=True, params_of="rwkv_2x2"),
    dict(key="jamba_2x2", arch=JAMBA, scale=J5, mesh=(2, 2),
         fsdp=(False, True)),
    dict(key="jamba_2x2_sp", arch=JAMBA, scale=J5, mesh=(2, 2), sp=True,
         fsdp=(True,), params_of="jamba_2x2"),
    # 8 rows: each of 2 microbatches gives each of the 4 batch shards one
    dict(key="jamba_pod", arch=JAMBA, scale=J5, mesh=(2, 2, 2), axes=POD,
         sp=True, fsdp=(True,), step=True, microbatch=2, batch=8),
    # the port's own: a data axis as long as the pod mesh's pod x data
    dict(key="jamba_4x2_sp", arch=JAMBA, scale=J5, mesh=(4, 2), sp=True,
         fsdp=(True,), params_of="jamba_pod", ref=False),
]
for _c in CASES:
    _c.setdefault("axes", DM)
REF_CASES = [c for c in CASES if c.get("ref", True)]
RUNS = [(c["key"], f) for c in REF_CASES for f in c["fsdp"]]
STEP_RUNS = [(c["key"], f) for c in REF_CASES if c.get("step")
             for f in c["fsdp"]]
# the train launcher's run of jamba (Mamba, attention and MoE layers) on
# a (2, 2) mesh of four ranks: mesh, axes, then launcher_run's steps, seq,
# batch and arch after its checkpoint directory
LAUNCH = ((2, 2), DM, 2, 32, 4, JAMBA)
# the port's runs that must equal another of its runs
SAME_RUNS = [(("rwkv_2x2_sp", True), ("rwkv_2x2", True)),
             (("rwkv_pod", True), ("rwkv_2x2_sp", True)),
             (("jamba_2x2_sp", True), ("jamba_2x2", True)),
             (("jamba_pod", True), ("jamba_4x2_sp", True))]


def _case(key):
    return next(c for c in CASES if c["key"] == key)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's values (one subprocess) and the port's (a spawn of
    ranks per world size, meanwhile), on the same weights and tokens."""
    return torch_ranks.reference_and_ranks(
        tmp_path_factory.mktemp("multirank_inner"), CASES, LR, 200, LAUNCH)


@pytest.mark.parametrize("key,fsdp", RUNS)
def test_inner_mesh_loss_and_stats_equal_reference(runs, key, fsdp):
    """forward_loss on the mesh: loss, ce, moe_aux and moe_dropped within
    1e-5 relative of the reference's mesh values (jamba's MoE stats the
    mean over the batch shards, as there)."""
    check_loss_and_stats(runs["port"][(key, fsdp)], runs["ref"], key)


@pytest.mark.parametrize("key,fsdp", RUNS)
def test_inner_mesh_gradients_equal_reference(runs, key, fsdp):
    """Every gradient of forward_loss, summed over the batch axes and
    gathered from the ranks' shards (``inner``'s over ``model``: RWKV's
    heads and Mamba's channels, in_proj's columns cut as GSPMD cuts
    them), within 1e-4 of the leaf's largest |value| of the reference's
    mesh gradient."""
    check_gradients(runs["port"][(key, fsdp)], runs["ref"], key)


@pytest.mark.parametrize("key,fsdp", STEP_RUNS)
def test_inner_mesh_train_step_equals_reference(runs, key, fsdp):
    """One make_train_step step on the pod mesh under SP (ZeRO-1, FSDP;
    jamba with 2 microbatches) against the reference's step jitted on
    train_shardings: loss and grad norm within 1e-5 relative, every
    stepped param within 1e-4 of its leaf's largest |value| or 0.1 lr,
    and every leaf moved by lr / 2 or more."""
    check_train_step(runs["port"][(key, fsdp)], runs["ref"], key,
                     _case(key)["params"], LR)


def test_inner_mesh_int8_compression_equals_reference(runs):
    """One step with int8 gradient compression of rwkv6 on the (2, 2, 2)
    pod mesh under SP against the reference's, held as
    tests/test_torch_multirank.py holds qwen3's: loss within 1e-5, the
    compressed gradients' norm within 2e-5, every stepped param within lr
    and at most 1e-4 of them outside the step test's tolerance (a
    quantum near a half may round the other way)."""
    check_int8_step(runs["port"][("rwkv_pod", True)], runs["ref"],
                    "rwkv_pod", LR)


@pytest.mark.parametrize("run,same", SAME_RUNS)
def test_inner_sp_and_pod_runs_equal_the_port_without_them(runs, run, same):
    """The port against itself on the same weights and tokens: under SP
    the token shift and the conv see the gathered sequence, so SP gives
    what its mesh gives without it; a pod mesh gives what a mesh with as
    many batch shards gives: loss and stats within 1e-5 relative, every
    gathered gradient within 1e-4 of its leaf's largest |value|."""
    check_same_run(runs["port"][run], runs["port"][same])


@pytest.mark.parametrize("key", ["rwkv_2x2", "rwkv_tp"])
def test_inner_one_rank_equals_reference_mesh(runs, key):
    """The port on one rank (NULL_POLICY) over the same weights: rwkv6's
    loss and gradients equal the reference's mesh values (the same
    function there: no MoE stats to average)."""
    case = _case(key)
    cfg = torch_ranks.case_config(case)
    params = params_from_numpy(runs["weights"][key], cfg, device="cpu")
    (loss, metrics), grads = ts.value_and_grad(
        params, torch.from_numpy(case["tokens"]), cfg)
    ref = runs["ref"]
    assert rel(float(loss), float(ref[f"{key}:loss"])) <= 1e-5
    assert rel(float(metrics["ce"]), float(ref[f"{key}:ce"])) <= 1e-5
    errs = leaf_errs(flat(params_to_numpy(grads, cfg)), ref,
                      f"{key}:grads/")
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])


def test_launcher_trains_jamba_on_a_mesh_as_make_train_step(runs):
    """The train launcher given a (2, 2) mesh of four ranks and jamba's
    SMOKE (``--smoke``: bf16, ZeRO-1, no SP or FSDP) gives
    make_train_step's losses and grad norms on that mesh, weights, data
    and schedule, bit for bit."""
    rec = runs["port"]["launcher"]
    assert len(rec["launcher"]) == 2
    assert rec["launcher"] == rec["make_train_step"]


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_rank_halves_exchange_values_and_gradients(tp):
    """``mamba._rank_halves`` on a (1, tp) mesh of gloo ranks: each rank's
    columns of x @ in_proj, cut contiguously over ``model``, come back as
    its own channels of xm and z (at tp 2 rank 0 holds all of xm; at an
    odd tp one rank's blocks go to ranks out of order, and the parts
    differ in size), and the backward returns each rank's cotangent of
    them to the columns' owners."""
    outs = spawn(torch_ranks.rank_halves, tp, tp, timeout=120)
    di, w = 6 * tp, 6
    xz = np.arange(2.0 * 2 * di).reshape(2, 2 * di)
    cot = np.zeros_like(xz)
    for r, (got, gx) in enumerate(outs):
        mine = np.r_[r * w:(r + 1) * w, di + r * w:di + (r + 1) * w]
        np.testing.assert_array_equal(got, xz[:, mine])
        cot[:, mine] = (r + 1) * np.arange(2 * w)
    for q, (_, gx) in enumerate(outs):
        cols = slice(q * 2 * w, (q + 1) * 2 * w)
        np.testing.assert_array_equal(gx, cot[:, cols])
