"""The port's training examples (``examples_torch/ft_demo.py``,
``train_lm.py``) against the reference's computation with the examples'
own arguments.

Each script is loaded by path. The fault-tolerance demo's main runs on
the CPU as the script runs it (bf16) and the reference's SR and GBN runs
take the same weights (the port's draw, bridged with
``params_to_numpy``): every recovery counter must be equal, as failures
come from ``random.Random(seed)`` in the same order. The training
example's ``run(cfg, params, inputs, device)`` takes the reference's fp32
weights (``params_from_numpy``) at ``--steps 30 --dim 64 --layers 2
--seq 64 --batch 4 --vocab 256``: counters equal, the initial loss
within 1e-5 and the final loss within 1e-3 of max(1, |x|) after 30 AdamW
steps (fp32 sums in another order, compounded over the steps).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticPackedDataset as JDataset  # noqa: E402
from repro.ft import FaultTolerantTrainer as JTrainer  # noqa: E402
from repro.ft import FTConfig as JFTConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.sharding.policy import NULL_POLICY  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"
FT_COUNTERS = ("steps", "failures", "microbatches_recomputed",
               "steps_replayed", "checkpoints_restored")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread, as in tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


# --------------------------------------------------------------------------
# the fault-tolerance demo
# --------------------------------------------------------------------------

def _reference_ft_run(jcfg, jparams, policy, rate, tmp_path, steps=30):
    """examples/ft_demo.py's ``run``, on the given weights."""
    data = JDataset(JDataConfig(seq_len=64, global_batch=4,
                                vocab_size=jcfg.vocab_size))
    ocfg = JAdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    grad_fn = jax.jit(lambda p, t: (
        jax.grad(lambda pp: jlm.forward_loss(pp, t, jcfg, NULL_POLICY)[0])(p),
        {}))
    update_fn = jax.jit(lambda g, o, p: j_adamw_update(g, o, p, ocfg))
    ckpt = JCheckpointer(str(tmp_path / f"ref_{policy}_{rate}"))
    opt = j_adamw_init(jparams)
    ckpt.save(0, (jparams, opt), blocking=True)
    tr = JTrainer(grad_fn, update_fn, data, ckpt,
                  JFTConfig(policy=policy, failure_rate=rate,
                            checkpoint_every=10, seed=11), n_workers=4)
    params, _, stats = tr.run(jparams, opt, steps)
    ckpt.wait()
    return params, stats


def test_ft_demo_main_matches_reference_counters(tmp_path, capsys):
    """The demo's main on the CPU (bf16, as the script runs it) against
    the reference's SR and GBN runs from the same weights: every
    recovery counter and the goodput equal; the port's GBN run ends on
    its no-failure params bit for bit."""
    ft = load_example("ft_demo")
    out = ft.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("SR : failures=") and "GBN: failures=" in text
    tcfg = ft.model_config()
    jcfg = J_SMOKE["musicgen-large"].scaled(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=256)
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                           params_to_numpy(params, tcfg))
    for pol in ("sr", "gbn"):
        _, s = _reference_ft_run(jcfg, jparams, pol, 0.08, tmp_path)
        for name in FT_COUNTERS:
            assert out[pol][name] == getattr(s, name), (pol, name)
        eff = s.steps / (s.steps + s.steps_replayed
                         + s.microbatches_recomputed / 4)
        assert out[pol]["goodput"] == eff
        if pol == "gbn":
            assert out[pol]["param_drift_vs_no_failure"] == 0.0
    assert out["sr"]["failures"] > 0 and out["gbn"]["checkpoints_restored"]
    # every worker slot computes one gradient, a failed SR slot twice
    assert out["sr"]["grad_calls"] == 4 * 30
    assert out["no_failure_grad_calls"] == 4 * 30


# --------------------------------------------------------------------------
# the training example
# --------------------------------------------------------------------------

SMALL = ["--steps", "30", "--dim", "64", "--layers", "2", "--seq", "64",
         "--batch", "4", "--vocab", "256"]


def _reference_train_lm(jcfg, jparams, inputs, ckpt_dir, steps=30,
                        policy="sr", rate=0.02):
    """examples/train_lm.py's training and its losses, on the given
    weights."""
    data = JDataset(JDataConfig(**inputs))
    ocfg = JAdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    grad_fn = jax.jit(lambda p, t: (
        jax.grad(lambda pp: jlm.forward_loss(pp, t, jcfg, NULL_POLICY)[0])(p),
        {}))
    loss_fn = jax.jit(lambda p, t: jlm.forward_loss(p, t, jcfg,
                                                    NULL_POLICY)[0])
    update_fn = jax.jit(lambda g, o, p: j_adamw_update(g, o, p, ocfg))
    opt = j_adamw_init(jparams)
    ckpt = JCheckpointer(str(ckpt_dir))
    ckpt.save(0, (jparams, opt), blocking=True)
    trainer = JTrainer(grad_fn, update_fn, data, ckpt,
                       JFTConfig(policy=policy, failure_rate=rate,
                                 checkpoint_every=25), n_workers=4)
    eval_toks = jnp.asarray(data.batch_at(10_000)[0])
    initial = float(loss_fn(jparams, eval_toks))
    params, _, stats = trainer.run(jparams, opt, steps)
    ckpt.wait()
    return {"initial_loss": initial,
            "final_loss": float(loss_fn(params, eval_toks)),
            **{k: getattr(stats, k) for k in FT_COUNTERS}}


@pytest.mark.parametrize("policy", ["sr", "gbn"])
def test_train_lm_matches_reference_fp32(policy, tmp_path):
    """The example at 30 steps, dim 64, 2 layers, seq 64, batch 4, vocab
    256 in fp32, failures at the script's rate 0.02, on weights from the
    reference."""
    tl = load_example("train_lm")
    rate = 0.02
    tcfg = tl.model_config(64, 2, 256).scaled(dtype="float32")
    dim = 64                 # examples/train_lm.py's config at --dim 64
    jcfg = JModelConfig(
        name="trainer-demo", family="dense", n_layers=2, d_model=dim,
        n_heads=dim // 64 or 2, n_kv_heads=max(1, (dim // 64 or 2) // 2),
        head_dim=64, d_ff=dim * 4, vocab_size=256, dtype="float32")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                               device="cpu")
    inputs = {"seq_len": 64, "global_batch": 4, "vocab_size": 256}
    got = tl.run(tcfg, params, inputs, "cpu", steps=30, policy=policy,
                 failure_rate=rate, ckpt_dir=tmp_path / "port")
    want = _reference_train_lm(jcfg, jparams, inputs, tmp_path / "ref",
                               policy=policy, rate=rate)
    for name in FT_COUNTERS:
        assert got[name] == want[name], name
    assert got["failures"] > 0
    if policy == "gbn":
        assert got["checkpoints_restored"] > 0
    assert _rel(got["initial_loss"], want["initial_loss"]) <= 1e-5
    assert _rel(got["final_loss"], want["final_loss"]) <= 1e-3
    assert got["final_loss"] < got["initial_loss"]


def test_train_lm_main_runs_on_the_cpu(tmp_path, capsys):
    out = load_example("train_lm").main(
        ["--device", "cpu", *SMALL, "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "tokens/s:" in text and out["steps"] == 30
    assert out["final_loss"] < out["initial_loss"]
    assert out["grad_calls"] == 4 * 30
