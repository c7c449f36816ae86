"""lart_tpu_torch samplers with injected uniforms against lart_tpu's, and
the Philox generator against the Random123 known-answer vectors.

Tolerances: the envelope constants and the accept/reject decisions agree
to rtol 1e-5; the sampled u_par agrees to 1e-5 (relative to max(|u|, 1))
on at least 99.8% of lanes and to 1e-3 everywhere.  The wing proposal
x0 + a tan(theta) amplifies the last-ulp differences of the two CPU
libraries' tan/atan near the pole: at x0 = 5, a = 1.49e-2 a proposal
u ~ 0.7 needs tan ~ -290, where one ulp of theta moves u by ~3e-4, and
0.1% of the lanes land there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.physics import samplers as jsamp
from lart_tpu_torch.physics import rng as trng
from lart_tpu_torch.physics import samplers as tsamp

ENV_FIELDS = ('x0', 'sgn', 'a', 'S0', 'S01', 'Stot', 'beta0', 'lo1', 'w1',
              'C1', 'lo2', 'w2', 'C2')


@pytest.mark.parametrize('x0', [0.3, 2.0, 5.0, 50.0, 3000.0])
def test_vz_envelope_and_rounds_match_jax(x0):
    rng = np.random.default_rng(int(x0 * 10))
    n = 50_000
    for a in (4.7e-4, 1.49e-2):
        x = (x0 * np.where(rng.random(n) < 0.5, -1.0, 1.0)).astype(np.float32)
        env_j = jsamp.vz_envelope(jnp.asarray(x), jnp.float32(a))
        env_t = tsamp.vz_envelope(torch.from_numpy(x), a)
        np.testing.assert_array_equal(env_t.core.numpy(),
                                      np.asarray(env_j.core))
        for f in ENV_FIELDS:
            np.testing.assert_allclose(getattr(env_t, f).numpy(),
                                       np.asarray(getattr(env_j, f)),
                                       rtol=1e-5, atol=0, err_msg=f)
        active = rng.random(n) < 0.9
        acc_j, vz_j = jnp.zeros(n, bool), jnp.zeros(n, jnp.float32)
        acc_t = torch.zeros(n, dtype=torch.bool)
        vz_t = torch.zeros(n)
        for _ in range(4):
            xi = np.maximum(rng.random((4, n)), 1e-12).astype(np.float32)
            acc_j, vz_j = jsamp.vz_round_xi(jnp.asarray(xi), env_j, acc_j,
                                            vz_j, jnp.asarray(active))
            acc_t, vz_t = tsamp.vz_round_xi(torch.from_numpy(xi), env_t,
                                            acc_t, vz_t,
                                            torch.from_numpy(active))
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
        assert not acc_t.numpy()[~active].any()
        vz_j = np.asarray(vz_j)
        d = np.abs(vz_t.numpy() - vz_j) / np.maximum(np.abs(vz_j), 1.0)
        assert np.mean(d > 1e-5) < 2e-3, (a, np.mean(d > 1e-5))
        assert d.max() < 1e-3, (a, d.max())


@pytest.mark.parametrize('E1', [1.0, 0.5, 0.0, -0.2])
def test_rand_resonance_cost_matches_jax(E1):
    xi = np.random.default_rng(3).random(100_000).astype(np.float32)
    c_t = tsamp.rand_resonance_cost(torch.from_numpy(xi), E1).numpy()
    c_j = np.asarray(jsamp.rand_resonance_cost(jnp.asarray(xi),
                                               jnp.float32(E1)))
    assert np.all(np.abs(c_t) <= 1.0)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize('word,key,expect', [
    (0x00000000, 0x00000000,
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    (0xffffffff, 0xffffffff,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
])
def test_philox_known_answers(word, key, expect):
    c = torch.full((1,), word, dtype=torch.int64)
    out = trng.philox4x32(c, c, c, c, key, key)
    assert tuple(int(w) for w in out) == expect


def test_uniforms_blocks_and_range():
    lanes = torch.arange(20_000, dtype=torch.int64)
    u = trng.uniforms(7, trng.STREAM_SCATTER, lanes, 3, range(3))
    assert u.shape == (3, 4, 20_000) and u.dtype == torch.float32
    torch.testing.assert_close(
        u[2], trng.uniforms(7, trng.STREAM_SCATTER, lanes, 3, 2),
        rtol=0, atol=0)
    assert float(u.min()) >= 1e-12 and float(u.max()) < 1.0
    # 24-bit uniforms: mean 1/2, variance 1/12, blocks uncorrelated
    flat = u.reshape(12, -1).double()
    assert abs(float(flat.mean()) - 0.5) < 3e-3
    assert abs(float(flat.var()) - 1.0 / 12.0) < 2e-3
    corr = torch.corrcoef(flat)
    assert float((corr - torch.eye(12, dtype=torch.float64)).abs().max()) \
        < 0.05
    # another stream or counter gives other numbers
    assert not torch.equal(u[0], trng.uniforms(7, trng.STREAM_REFILL,
                                               lanes, 3, 0))
    assert not torch.equal(u[0], trng.uniforms(7, trng.STREAM_SCATTER,
                                               lanes, 4, 0))


def test_rand_voigt_x_is_voigt_distributed():
    """Cauchy(a) + N(0, 1/2) has the Voigt profile H(x, a)/sqrt(pi)."""
    from scipy.special import wofz
    lanes = torch.arange(400_000, dtype=torch.int64)
    u = trng.uniforms(1, trng.STREAM_REFILL, lanes, 0, range(2))
    a = 4.7e-4
    x = tsamp.rand_voigt_x(a, u[0, 2], u[0, 3], u[1, 0]).double().numpy()
    edges = np.linspace(-3.0, 3.0, 61)
    hist = np.histogram(x, edges)[0] / x.size
    mid = 0.5 * (edges[1:] + edges[:-1])
    expect = wofz(mid + 1j * a).real / np.sqrt(np.pi) * np.diff(edges)
    sigma = np.sqrt(expect / x.size)
    assert np.max(np.abs(hist - expect) / np.maximum(sigma, 1e-9)) < 5.0
