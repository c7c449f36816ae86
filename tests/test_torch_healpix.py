"""HEALPix RING pixelization of the port (instruments/healpix.py, the plain
version of csrc/healpix.cuh) against lart_tpu/instruments/healpix.py on
the CPU.

pix2vec_ring on every pixel for nside 1, 8 and 64, run as lart_tpu's
sightline runs it (eagerly): z equal, x and y to 2.5e-7 (torch's and XLA's cos and
sin differ by an ulp now and then).  vec2pix_ring, jitted as lart_tpu's
peel runs it, on every pixel centre and on random directions with the
poles, z = +-2/3 and phi = 0 among them: equal on all but at most 1e-4 of
the random directions, each of those within 1e-6 rad of a pixel edge (a
direction moved by 1e-6 changes pixel there).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.instruments import healpix as jhp
from lart_tpu_torch.instruments import healpix as thp

NSIDES = (1, 8, 64)


@pytest.mark.parametrize('nside', NSIDES)
def test_pix2vec_matches_lart_tpu(nside):
    ip = np.arange(thp.nside2npix(nside))
    want = [np.asarray(v) for v in jhp.pix2vec_ring(nside, ip)]
    got = [v.numpy() for v in thp.pix2vec_ring(nside, torch.as_tensor(ip))]
    assert np.array_equal(got[2], want[2])
    for a in range(2):
        np.testing.assert_allclose(got[a], want[a], rtol=0, atol=2.5e-7)
    # the port's own roundtrip: each centre in its own pixel
    back = thp.vec2pix_ring(nside, *(torch.as_tensor(v) for v in got))
    assert np.array_equal(back.numpy(), ip)


def _directions(seed, n=50_000):
    """Random f32 directions with the special ones: the poles, the ring
    boundary z = +-2/3, phi = 0 and phi just below 2 pi, the axes."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(3, n))
    v /= np.linalg.norm(v, axis=0)
    z23 = 2.0 / 3.0
    s23 = math.sqrt(1.0 - z23 * z23)
    special = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0],
                        [0, 1, 0], [0, -1, 0], [s23, 0, z23], [s23, 0, -z23],
                        [0.6, 0.0, 0.8], [0.6, -1e-7, 0.8], [1.0, 1e-30, 0.0],
                        [0, s23, z23], [-s23, 0, -z23]]).T
    return np.concatenate([special, v], axis=1).astype(np.float32)


@pytest.mark.parametrize('nside', (1, 4, 16, 64))
def test_vec2pix_matches_lart_tpu(nside):
    v = _directions(nside)
    jv2p = jax.jit(lambda a, b, c: jhp.vec2pix_ring(nside, a, b, c))
    want = np.asarray(jv2p(*(jnp.asarray(q) for q in v)))
    got = thp.vec2pix_ring(nside, *(torch.as_tensor(q) for q in v)).numpy()
    assert np.array_equal(got[:13], want[:13])
    off = np.nonzero(got != want)[0]
    assert len(off) <= 1e-4 * v.shape[1], len(off)
    # each direction that differs sits on an edge: a nudge of 1e-6 moves it
    rng = np.random.default_rng(1)
    for i in off:
        d = v[:, i].astype(np.float64)
        moved = {int(thp.vec2pix_ring(nside, *(torch.tensor(
            [np.float32(q)]) for q in d + 1e-6 * rng.normal(size=3)))[0])
            for _ in range(8)}
        assert len(moved) > 1, (i, d)
    # pixel centres, as lart_tpu computes them, fall in their own pixel
    cen = [np.asarray(q, np.float32) for q in jhp.pix2vec_ring(
        nside, np.arange(thp.nside2npix(nside)))]
    got = thp.vec2pix_ring(nside, *(torch.as_tensor(q) for q in cen))
    assert np.array_equal(got.numpy(), np.asarray(jv2p(*cen)))


def test_equal_area_and_nside_validation():
    nside = 4
    v = _directions(7, 300_000)[:, 13:]
    pix = thp.vec2pix_ring(nside, *(torch.as_tensor(q) for q in v)).numpy()
    counts = np.bincount(pix, minlength=thp.nside2npix(nside))
    assert counts.std() / counts.mean() < 2.5 / math.sqrt(counts.mean())
    for bad in (0, 3, 16384):
        with pytest.raises(ValueError):
            thp.nside2npix(bad)
    assert thp.nside2npix(64) == 49152
