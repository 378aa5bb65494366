"""The port's rotary embedding against the JAX package's.

``rope_angles`` takes its frequencies from ``exp_f32``, the float32 exp
sequence of XLA's CPU backend written in numpy, so the angles equal the
reference's bit for bit at every position, for every (head dim, theta)
of the registry and MLA's rope dims. What remains is ``cos`` and
``sin``: torch and XLA round some of them an ulp apart (at most 2^-24
for values in [-1, 1]), a gap that does not grow with the position, so
``apply_rope`` on unit-normal inputs stays within 1e-6 of the larger of
1 and the reference's output (4.4e-7 measured).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS as J_CONFIGS  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402

POSITIONS = np.arange(8192)
ROPE_TOL = 1e-6


def _rope_dims():
    """Every (rotary dim, theta) the registry's configs rotate with: the
    attention head dim, and for MLA its rope dim."""
    dims = set()
    for table in (J_CONFIGS, J_SMOKE):
        for cfg in table.values():
            if cfg.attn_free:
                continue
            dims.add((cfg.head_dim, cfg.rope_theta))
            if cfg.mla is not None:
                dims.add((cfg.mla.qk_rope_dim, cfg.rope_theta))
    return sorted(dims)


ROPE_DIMS = _rope_dims()


def test_rope_dims_cover_mla():
    assert (64, 10_000.0) in ROPE_DIMS and (16, 10_000.0) in ROPE_DIMS
    assert len({t for _, t in ROPE_DIMS}) >= 4


@pytest.mark.parametrize("dim", [16, 32, 64, 96, 120, 128, 192])
@pytest.mark.parametrize("theta", [1e4, 5e4, 1e5, 5e5, 1e6, 5e6])
def test_exp_f32_equals_jnp_exp_on_rope_frequencies(dim, theta):
    arg = (np.float32(-math.log(theta))
           * np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim))
    want = np.asarray(jnp.exp(jnp.asarray(arg)))
    np.testing.assert_array_equal(layers.exp_f32(arg), want)


def test_exp_f32_equals_jnp_exp_on_a_sweep():
    """200 000 uniform float32 inputs in [-16, 0], every one bit for bit;
    ``torch.exp`` is shown to miss some, which is the fault repaired."""
    x = np.random.default_rng(0).uniform(-16, 0, 200_000).astype(np.float32)
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    np.testing.assert_array_equal(layers.exp_f32(x), want)
    assert (torch.exp(torch.from_numpy(x)).numpy() != want).any()


@pytest.mark.parametrize("dim,theta", ROPE_DIMS)
def test_rope_angles_bit_for_bit(dim, theta):
    want = np.asarray(jlayers.rope_angles(jnp.asarray(POSITIONS), dim, theta))
    got = layers.rope_angles(torch.from_numpy(POSITIONS), dim, theta)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim,theta", ROPE_DIMS)
def test_apply_rope_within_the_cos_sin_ulp(dim, theta):
    """The angles are equal; cos and sin differ by at most an ulp, which
    bounds ``apply_rope`` at every position up to 8191."""
    ang = np.asarray(jlayers.rope_angles(jnp.asarray(POSITIONS), dim, theta))
    t_ang = layers.rope_angles(torch.from_numpy(POSITIONS), dim, theta)
    for f_j, f_t in ((jnp.cos, torch.cos), (jnp.sin, torch.sin)):
        gap = np.abs(np.asarray(f_j(jnp.asarray(ang)))
                     - f_t(t_ang).numpy()).max()
        assert gap <= 2.0 ** -24, gap
    x = np.random.default_rng(dim).standard_normal(
        (len(POSITIONS), 2, dim)).astype(np.float32)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(ang)))
    got = layers.apply_rope(torch.from_numpy(x), t_ang).numpy()
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= ROPE_TOL, err.max()


def test_rope_freqs_are_made_once_per_device():
    cpu = torch.device("cpu")
    a = layers.rope_freqs(128, 1e6, cpu)
    assert layers.rope_freqs(128, 1e6, cpu) is a
    assert a.dtype == torch.float32 and a.shape == (64,)
