"""The dust slice as a whole on the CPU: lart_tpu_torch's driver.run against
lart_tpu's on the dusty expanding shell of testing.dust_params (17^3, a
Gaussian line centred on the 200 km/s outflow, gas tau0 ~ 20, dust tau
~ 1), with Stokes (the Mueller table), seen by one observer on the +z axis
(17 x 17 TAN image), and without (Henyey-Greenstein).

The packages draw from different generators, so they agree statistically
over NPH photons each:

- the weight closes in each package, W_esc + W_abs + W_oor = 1, as
  closely as lart_tpu's own (1e-3: the frequency axis covers every
  absorption);
- the absorbed weight of the two within 3 sigma of its binomial spread,
  sqrt(2 p (1 - p) / NPH);
- the escaped and absorbed spectra's shapes, each normalized to unit sum:
  chi2/dof < 3 over the populated bins with the counting variance of the
  escaped or absorbed photons;
- the mean gas scatterings and the dust events per photon within 5% (at
  NPH photons their relative spreads are ~2% and ~1.5%);
- the peel-off, as tests/test_torch_peel_slice.py holds it but with this
  shell's per-photon variance (testing.PEEL_V_DUST = 14.1, a relative error
  of sqrt(14.1 / NPH) = 5.9% per estimate): 4 pi d^2 times the peeled flux
  over the escaped weight is 1 in each package (the shell and its central
  source are isotropic) within 3 sigma, and the total Stokes I of the two
  within 3 sigma of their difference.
"""

import dataclasses

import numpy as np
import pytest

from lart_tpu import driver as jdriver
from lart_tpu_torch import testing

import _torch_jax_bridge as bridge

NPH = 4000
SIG_PEEL = np.sqrt(testing.PEEL_V_DUST / NPH)


@pytest.fixture(scope='module', params=['mueller', 'hg'])
def runs(request):
    stokes = request.param == 'mueller'
    par = testing.dust_params(nphotons=NPH, stokes=stokes)
    if stokes:
        par = dataclasses.replace(testing.peel_params(par, nim=17),
                                  alpha=(0.0,), beta=(0.0,))
    port = bridge.run_port_cpu(par, seed=23)
    ref = jdriver.run(bridge.jax_params(par), seed=23)
    return {'lart_tpu_torch': port, 'lart_tpu': ref}


def test_weight_closes(runs):
    for name, r in runs.items():
        w = r.W_escape + r.W_absorb + r.W_oor
        assert abs(w - 1.0) < 1e-3, (name, r.W_escape, r.W_absorb, r.W_oor)
        assert 0.2 < r.W_absorb < 0.8, (name, r.W_absorb)


def test_absorbed_weight_and_spectra_agree(runs):
    t, j = runs['lart_tpu_torch'], runs['lart_tpu']
    p = 0.5 * (t.W_absorb + j.W_absorb)
    assert abs(t.W_absorb - j.W_absorb) <= 3.0 * np.sqrt(
        2.0 * p * (1.0 - p) / NPH), (t.W_absorb, j.W_absorb)
    for name, w in (('Jout', 'W_escape'), ('Jabs', 'W_absorb')):
        chi2, nbins = testing.spectra_chi2(getattr(t, name), getattr(j, name),
                                           NPH * getattr(t, w),
                                           NPH * getattr(j, w))
        assert nbins >= 5 and chi2 < 3.0, (name, chi2, nbins)


def test_scatterings_agree(runs):
    t, j = runs['lart_tpu_torch'], runs['lart_tpu']
    assert t.nscatt_gas == pytest.approx(j.nscatt_gas, rel=0.05)
    assert t.nscatt_dust == pytest.approx(j.nscatt_dust, rel=0.05)
    assert t.nscatt_dust > 0.5


@pytest.mark.parametrize('runs', ['mueller'], indirect=True)
def test_peel_closure_and_total_intensity(runs):
    totals = {}
    for name, r in runs.items():
        (c,) = testing.peel_closure(r)
        assert abs(c - 1.0) < 3.0 * SIG_PEEL, (name, c)
        # the polarized run deposits I as scattered + direct
        totals[name] = float(r.peel['I'].sum())
        assert totals[name] == pytest.approx(float(
            r.peel['scatt'].sum() + r.peel['direc'].sum()), rel=1e-5)
    t, j = totals['lart_tpu_torch'], totals['lart_tpu']
    assert abs(t / j - 1.0) < 3.0 * np.sqrt(2.0) * SIG_PEEL, (t, j)
