"""The metal-line slice as a whole on the CPU: lart_tpu_torch's driver.run
against lart_tpu's on 17^3 uniform static spheres (tau0 = 20, 10 for H+D,
a central point source, testing.line_params) of three line types:

- the Mg II 2796/2803 doublet (line type 2, a Voigt source shifted to the
  K line a third of the time);
- the Si II 1190/1193 multiplet with its fluorescent Si II* 1194/1197
  branches (type 5, a Voigt source shifted to a level and a branch,
  recoil, Stokes), seen by one observer on the +z axis (17 x 17 image);
- H + D Ly-alpha (type 7, monochromatic, D/H 3e-3: a hundred times the
  examples' so that the deuterium line at x ~ +6.7 takes its share).

The packages draw from different generators, so they agree statistically
over NPH photons each, by ROADMAP's rules:

- the weight closes, W_esc + W_oor = 1 to 1e-3;
- the mean scatterings per photon within 5% (a per-photon relative
  variance near 1 gives each mean 1.6% at NPH photons);
- the escaped spectra's shapes, each normalized to unit sum: chi2/dof < 3
  over the populated bins with the counting variance of the escaped
  photons (testing.spectra_chi2);
- the multiplet's fluorescent share of the escaped weight (the Si II*
  photons, shifted by Elow / D ~ -420 Doppler widths) within 3 sigma of
  its binomial spread, sqrt(2 p (1 - p) / NPH);
- its peel-off as tests/test_torch_peel_slice.py holds it: 4 pi d^2 times
  the peeled flux over the escaped weight is 1 in each package within 3
  sigma of testing.PEEL_V_PHOTON's spread, the peel spectra's shapes and
  the ring profile of Q/I chi2/dof < 3.
"""

import dataclasses
import functools

import numpy as np
import pytest

from lart_tpu import driver as jdriver
from lart_tpu_torch import testing

import _torch_jax_bridge as bridge

NPH, B = 4000, 4096
CASES = {
    'doublet': {},
    'multiplet': dict(spectral_type='voigt', use_stokes=True),
    'hd': dict(D_to_H_ratio=3e-3, tau0=10.0),
}
FLUORESCENT_X = -200.0     # the Si II* photons sit at x ~ -420


@functools.lru_cache(maxsize=None)
def _runs(case):
    """The RunResults of both packages on one case, run once a process."""
    par = testing.line_params(case, n=17, nphotons=NPH, batch=B,
                              **{'tau0': 20.0, **CASES[case]})
    if case == 'multiplet':
        par = dataclasses.replace(testing.peel_params(par, nim=17),
                                  alpha=(0.0,), beta=(0.0,))
    port = bridge.run_port_cpu(par, seed=31)
    ref = jdriver.run(bridge.jax_params(par), seed=31)
    return case, {'lart_tpu_torch': port, 'lart_tpu': ref}


@pytest.fixture(params=sorted(CASES))
def runs(request):
    return _runs(request.param)


def test_weight_closes_and_scatterings_agree(runs):
    case, r = runs
    for name, res in r.items():
        w = res.W_escape + res.W_oor
        assert abs(w - 1.0) < 1e-3, (case, name, res.W_escape, res.W_oor)
        assert res.nscatt_gas > 1.0, (case, name, res.nscatt_gas)
    t, j = r['lart_tpu_torch'], r['lart_tpu']
    assert t.nscatt_gas == pytest.approx(j.nscatt_gas, rel=0.05), case


def test_spectra_agree(runs):
    case, r = runs
    t, j = r['lart_tpu_torch'], r['lart_tpu']
    chi2, nbins = testing.spectra_chi2(t.Jout, j.Jout, NPH * t.W_escape,
                                       NPH * j.W_escape)
    assert nbins >= 5 and chi2 < 3.0, (case, chi2, nbins)


@pytest.mark.parametrize('runs', ['multiplet'], indirect=True)
def test_fluorescent_share_and_peel_agree(runs):
    _, r = runs
    t, j = r['lart_tpu_torch'], r['lart_tpu']
    share = {}
    for name, res in r.items():
        J = res.Jout
        share[name] = float(J[res.xfreq < FLUORESCENT_X].sum() / J.sum())
        assert 0.3 < share[name] < 0.95, (name, share)
        (c,) = testing.peel_closure(res)
        assert abs(c - 1.0) < 3.0 * np.sqrt(testing.PEEL_V_PHOTON / NPH), (
            name, c)
    p = 0.5 * (share['lart_tpu_torch'] + share['lart_tpu'])
    assert abs(share['lart_tpu_torch'] - share['lart_tpu']) <= 3.0 * np.sqrt(
        2.0 * p * (1.0 - p) / NPH), share
    chi2, nbins = testing.peel_spectra_chi2(t, j, 0, NPH)
    assert nbins >= 5 and chi2 < 3.0, (chi2, nbins)
    assert testing.ring_polarization_chi2(t, j, 0) < 3.0
