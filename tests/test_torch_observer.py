"""The port's external observers against lart_tpu's build_observers: the
Euler-angle and coordinate placements, the angle aliases, the default
+z observer, the automatic field of view of a sphere and of a box (square
and oblong images), explicit pixel sizes, and the oblique (1, 1, 1)
observer of examples/pol_animation.  Both are the same float64 numpy
arithmetic, so the metadata agree exactly, and the f32 device copies of
the positions and rotation matrices bit for bit."""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lart_tpu.instruments import observer as jobs
from lart_tpu_torch import testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.instruments import observer as tobs
from lart_tpu_torch.transport import engine as teng

import _torch_jax_bridge as bridge

EXAMPLES = Path(__file__).resolve().parents[1] / 'examples'

CASES = {
    'angles_sphere': lambda: testing.sphere_params(
        n=9, save_peeloff=True, alpha=(0.0, 30.0, -45.0),
        beta=(0.0, 60.0, 120.0), distance=50.0, nxim=31, nyim=31),
    'angles_gamma_box': lambda: testing.hubble_params(
        n=9, save_peeloff=True, alpha=(10.0, 200.0), beta=(80.0, 35.0),
        gamma=(15.0, -70.0), distance=1e3, nxim=40, nyim=24),
    'angle_aliases': lambda: testing.hubble_params(
        n=9, save_peeloff=True, phase_angle=(20.0,),
        inclination_angle=(45.0,), position_angle=(5.0,), nxim=33,
        nyim=33),
    'default_observer': lambda: testing.slab_params(
        nz=9, save_peeloff=True, nxim=17, nyim=17),
    'explicit_pixels': lambda: testing.sphere_params(
        n=9, save_peeloff=True, alpha=(0.0,), beta=(90.0,), dxim=0.01,
        dyim=0.02, nxim=21, nyim=11),
    'coordinates': lambda: testing.hubble_params(
        n=9, save_peeloff=True, obsx=(3.0, -1.0), obsy=(4.0, 0.0),
        obsz=(0.0, 2.0), distance=500.0, rotation_center_x=0.1,
        nxim=33, nyim=33),
    'pol_animation_111': lambda: Params.from_namelist(
        str(EXAMPLES / 'pol_animation' / 't1tau3_cub111.in')),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_build_observers_matches_lart_tpu(case):
    cfg, jcfg = bridge.resolve_both(CASES[case]())
    tmeta, tdev = tobs.build_observers(cfg)
    jmeta, jdev = jobs.build_observers(jcfg)
    t, j = dataclasses.asdict(tmeta), dataclasses.asdict(jmeta)
    np.testing.assert_array_equal(t.pop('pos_host'), j.pop('pos_host'))
    assert t == j
    assert tmeta.nobs >= 1 and tmeta.dxim > 0.0 and tmeta.dyim > 0.0
    for f in ('pos', 'rmat'):
        u = getattr(tdev, f)
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(u.numpy(), np.asarray(getattr(jdev, f)))
    # each rotation is orthonormal and takes the observer's direction from
    # the rotation centre to its +z axis
    R = tdev.rmat.double().numpy()
    for o in range(tmeta.nobs):
        np.testing.assert_allclose(R[o] @ R[o].T, np.eye(3), atol=1e-6)
        d = tmeta.pos_host[o] - np.array([
            v if math.isfinite(v) else 0.0 for v in (
                cfg.par.rotation_center_x, cfg.par.rotation_center_y,
                cfg.par.rotation_center_z)])
        np.testing.assert_allclose(R[o] @ (d / np.linalg.norm(d)),
                                   [0.0, 0.0, 1.0], atol=1e-6)
    if case == 'pol_animation_111':
        np.testing.assert_allclose(tmeta.pos_host[0] / tmeta.distance,
                                   np.full(3, 1.0 / math.sqrt(3.0)))


def test_no_observers_without_save_peeloff():
    cfg = testing.sphere_params(n=9).resolve()
    assert tobs.build_observers(cfg) is None


def test_interior_observer_is_not_ported():
    """The one interior-observer path still refused: sight-line maps on an
    AMR grid (lart_tpu's AMR sightline has no interior branch); the
    observers themselves are built, as lart_tpu builds them."""
    par = testing.sphere_params(n=9, save_peeloff=True, nside=4)
    meta, dev = tobs.build_observers(par.resolve())
    assert meta.inside and meta.npix == 192 and meta.nxim == 192
    assert tuple(dev.pos.shape) == (1, 3)
    par.save_sightline_tau, par.use_amr_grid = True, True
    with pytest.raises(NotImplementedError, match='nside'):
        teng.check_supported(par.resolve())
