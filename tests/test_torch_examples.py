"""The port's quickstart (``examples_torch/quickstart.py``) against the
reference's computation with the example's own arguments, and every
example's refusal to run without a card unless asked for the CPU.

The script is loaded by path and its ``run(cfg, params, inputs,
device)`` is handed the same weights (the port's CPU draw, bridged to
the reference with ``params_to_numpy``) and inputs as the reference's
APIs, called as examples/quickstart.py calls them (the reference's
scripts are not imported: they draw their own weights and print). The
port runs on the CPU, where every kernel wrapper takes its plain
version. Tolerances: the loss within 1e-5 and the grad norm within 1e-4
of max(1, |x|) (fp32 sums in another order over a train step), decoded
tokens equal up to the first step whose reference top-1/top-2 margin is
under 1e-3 (the repo's margin rule). The serving examples are held in
tests/test_torch_examples_serve.py, the training ones in
tests/test_torch_examples_train.py; card runs of the examples in
tests/test_torch_cuda.py, which imports no JAX.
"""
import importlib.util
from pathlib import Path

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
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"
MARGIN = 1e-3


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


def _weights(tcfg):
    """The port's CPU draw from seed 0 and the same numbers in the
    reference's layout (the reference's own op-by-op draw of jamba's
    SMOKE weights takes seconds longer)."""
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return params, jax.tree.map(jnp.asarray, params_to_numpy(params, tcfg))


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def assert_tokens_under_margin(got, want, margins):
    """Equal tokens up to the first step where they differ; there the
    reference's top-1/top-2 margin must be under MARGIN (a near tie),
    and the streams are not compared past it."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            assert margins[i] < MARGIN, (i, got, want, margins[i])
            return


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------

def _reference_quickstart(jcfg, jparams, inputs):
    """examples/quickstart.py's train step, prefill and greedy decode,
    on the given weights and inputs; each decoded token's margin."""
    step = jax.jit(jts.make_train_step(jcfg, NULL_POLICY,
                                       JAdamWConfig(lr=1e-3)))
    params, _, metrics = step(jparams, j_adamw_init(jparams),
                              jnp.asarray(inputs["train_tokens"]))
    logits, state = jax.jit(lambda p, t: jlm.prefill(
        p, t, jcfg, NULL_POLICY, cache_len=32))(
            params, jnp.asarray(inputs["prompt"]))
    dec = jax.jit(lambda p, t, s: jlm.decode_step(p, t, s, jcfg,
                                                  NULL_POLICY))
    tokens, margins = [], []
    for i in range(9):
        if i:
            logits, state = dec(params, jnp.asarray([tokens[-1]], jnp.int32),
                                state)
        row = np.asarray(logits[0], np.float32)
        top = np.sort(row)[-2:]
        tokens.append(int(np.argmax(row)))
        margins.append(float(top[1] - top[0]))
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "tokens": tokens,
            "margins": margins,
            "params_m": sum(x.size for x in jax.tree.leaves(jparams)) / 1e6}


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_quickstart_matches_reference(arch):
    qs = load_example("quickstart")
    jcfg = J_SMOKE[arch].scaled(dtype="float32")
    tcfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    params, jparams = _weights(tcfg)
    inputs = qs.make_inputs(tcfg.vocab_size)
    want = _reference_quickstart(jcfg, jparams, inputs)
    got = qs.run(tcfg, params, inputs, "cpu")
    assert got["params_m"] == pytest.approx(want["params_m"], abs=1e-9)
    assert _rel(got["loss"], want["loss"]) <= 1e-5, (got["loss"],
                                                     want["loss"])
    assert _rel(got["grad_norm"], want["grad_norm"]) <= 1e-4, (
        got["grad_norm"], want["grad_norm"])
    assert_tokens_under_margin(got["tokens"], want["tokens"],
                               want["margins"])
    assert len(got["tokens"]) == 9


def test_quickstart_main_runs_on_the_cpu(capsys):
    out = load_example("quickstart").main(["--arch", "moonshot-v1-16b-a3b",
                                           "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("ok")
    assert "decoded tokens:" in text and np.isfinite(out["loss"])
    assert len(out["tokens"]) == 9


def test_examples_raise_without_a_card():
    """Every script runs on the card by default: without one its main
    raises before it draws a weight."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    for name in ("quickstart", "serve_kv", "serve_live", "crash_recovery",
                 "ft_demo", "train_lm"):
        with pytest.raises(RuntimeError, match="CUDA"):
            load_example(name).main([])
