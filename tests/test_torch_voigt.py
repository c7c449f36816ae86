"""lart_tpu_torch Voigt function H(x, a) against lart_tpu's, on the CPU.

Both evaluate Humlicek's w4 in f32 with the same formulas; they differ
only by the last-ulp rounding of exp/cos between the two CPU libraries,
so the tolerance is rtol 2e-5 (the kernel K1 is held to the same bound
against the plain version on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.physics.voigt import voigt as voigt_jax
from lart_tpu_torch.physics.voigt import voigt, voigt_plain


def _x_grid(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.linspace(-8.0, 8.0, 4001),                  # core, regions III/IV
        rng.uniform(-15.0, 15.0, 20000),               # region II
        np.sign(rng.uniform(-1, 1, 20000))
        * np.exp(rng.uniform(np.log(15.0), np.log(3e3), 20000)),  # region I
    ]).astype(np.float32)


def _regions(x, a):
    s = np.abs(x) + a
    return np.where(s >= 15, 1, np.where(s >= 5.5, 2, np.where(
        a >= 0.195 * np.abs(x) - 0.176, 3, 4)))


@pytest.mark.parametrize('a', [1e-6, 4.7e-4, 1.49e-2, 0.1])
def test_voigt_matches_jax(a):
    x = _x_grid(int(a * 1e7) % 1000)
    regions = set(np.unique(_regions(x.astype(np.float64), a)).tolist())
    assert regions >= {1, 2, 4}, regions   # III needs a >~ 0.176 at x = 0
    h_t = voigt(torch.from_numpy(x), a).numpy()
    h_j = np.asarray(voigt_jax(jnp.asarray(x), jnp.float32(a)))
    assert np.all(np.isfinite(h_t))
    np.testing.assert_allclose(h_t, h_j, rtol=2e-5, atol=0)


def test_voigt_region_three_matches_jax():
    """Region III (s < 5.5, a >= 0.195|x| - 0.176) needs a large damping
    parameter or |x| < 0.9; cover it with a per-point a."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-5.0, 5.0, 50000).astype(np.float32)
    a = rng.uniform(1e-6, 0.1, 50000).astype(np.float32)
    assert (_regions(x, a) == 3).sum() > 1000
    h_t = voigt_plain(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    h_j = np.asarray(voigt_jax(jnp.asarray(x), jnp.asarray(a)))
    np.testing.assert_allclose(h_t, h_j, rtol=2e-5, atol=0)


def test_voigt_wrapper_takes_plain_version_on_cpu():
    x = torch.linspace(-30.0, 30.0, 257)
    torch.testing.assert_close(voigt(x, 4.7e-4), voigt_plain(x, 4.7e-4),
                               rtol=0, atol=0)
