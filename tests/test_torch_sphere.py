"""The sphere slices as a whole on the CPU: lart_tpu_torch.driver.run
against lart_tpu's make_chunk on a uniform static sphere (the chord flight
K6) and on an expanding Hubble-flow sphere folded by xyz_symmetry (the
Cartesian walk K5 with comoving frequency updates and a moving-medium
refill), and the port's sphere fast path against its own generic walk.

The packages draw from different generators, so they agree statistically
by ROADMAP's rules (lart_tpu_torch.testing.spectra_agree): every photon's
weight escapes (to 1e-3 each), <N_scatt> within 5%, chi2/dof < 3 over the
populated Jout bins, and Jmu's angular distribution to atol 0.02.  The
fast path against the walk follows tests/test_uniform_slab_fastpath.py
(without peel-off): <N_scatt> to rel 0.06, where the voxelized ball of the
walk differs from the analytic one by O(dx), and chi2/dof < 3."""

import numpy as np
import pytest

from lart_tpu_torch import testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
from lart_tpu_torch.transport.fly_sphere import SphereFlight

import _torch_jax_bridge as bridge

NPH = 10_000
CASES = {
    'uniform_sphere': lambda: testing.sphere_params(tau0=100.0, n=33,
                                                    nphotons=NPH),
    'hubble_sphere': lambda: testing.hubble_params(tau0=100.0, n=17,
                                                   nphotons=NPH),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_sphere_port_matches_jax(case):
    par = CASES[case]()
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg)
    flight = teng.make_fly(cfg, meta, grid)
    assert isinstance(flight, SphereFlight if case == 'uniform_sphere'
                      else CartesianFlight)
    J_j, Jmu_j, N_j = bridge.run_jax_chunks(par, seed=9)
    res = bridge.run_port_cpu(par, seed=9)
    assert res.nphotons == NPH and res.Jmu.shape == (meta.nxfreq, 8)
    assert np.all(np.isfinite(res.Jout)) and np.all(res.Jout >= 0.0)
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-6
    J_t, Jmu_t, N_t = testing.run_tallies(res)
    testing.spectra_agree(J_t, Jmu_t, N_t, J_j, Jmu_j, N_j, NPH, 8)
    if case == 'hubble_sphere':
        # an outflow shifts the escaping photons to the red (x < 0)
        x = res.xfreq
        assert J_t[x < 0].sum() > 0.6 * J_t.sum()


def test_sphere_fastpath_matches_generic_walk():
    nph = 8000
    out = {}
    for generic in (False, True):
        par = testing.sphere_params(tau0=50.0, n=33, nphotons=nph,
                                    force_generic_kernel=generic)
        res = bridge.run_port_cpu(par, seed=13)
        assert abs(res.W_escape + res.W_oor - 1.0) < 1e-6
        out[generic] = testing.run_tallies(res)
    (J_f, _, ns_f), (J_g, _, ns_g) = out[False], out[True]
    assert ns_f == pytest.approx(ns_g, rel=0.06), (ns_f, ns_g)
    p1, p2 = J_f / J_f.sum(), J_g / J_g.sum()
    sel = (p1 + p2) > (p1 + p2).max() * 1e-3
    var = (np.maximum(p1, 1e-12) + np.maximum(p2, 1e-12)) / nph
    chi2_dof = float(np.sum((p1[sel] - p2[sel]) ** 2 / var[sel])
                     / max(sel.sum(), 1))
    assert chi2_dof < 3.0, chi2_dof
