"""The polarized peel-off slice as a whole on the CPU: lart_tpu_torch's
driver.run against lart_tpu's on a 17^3 uniform sphere (tau0 = 100, a
central point source, Stokes), seen by two observers at distance 1e3 (one
on the +z axis, one oblique), 17 x 17 TAN images.

The packages draw from different generators, so they agree statistically.
A peel-off estimate is noisier than a count of escaping photons: a photon
deposits into the cubes at every scattering near the surface, so its share
varies from photon to photon.  On this configuration the peeled flux of
2000 photons varied by 3.7% (the standard deviation over five runs: each
package with seeds 3 and 7, the port with seed 11), a per-photon variance
of 2.7 in units of the mean squared (testing.PEEL_V_PHOTON).  With NPH
photons each estimate has a relative error of sqrt(2.7 / NPH) = 1.6%,
which sets the tolerances:

- flux closure, per package and observer: 4 pi d^2 times the peeled flux
  (scattered + direct, over the image and the spectrum) equals the escaped
  weight, since the source and the sphere are isotropic: to 5% (3 sigma);
- the total Stokes I of the two packages within 5% (2.2 sigma of their
  difference);
- the peel spectra's shapes, each normalized to unit sum: chi2/dof < 3
  over the populated bins with the counting variance (the normalization
  takes out the spread of the total);
- the radial profile of the tangential polarization Q/I, per observer:
  chi2/dof < 3 over the rings, each ring's error from the scatter of its
  pixels about the ring's ratio.
"""

import numpy as np
import pytest

from lart_tpu import driver as jdriver
from lart_tpu_torch import testing

import _torch_jax_bridge as bridge

NPH, B = 10_000, 4096


@pytest.fixture(scope='module')
def runs():
    par = testing.peel_params(testing.sphere_params(
        tau0=100.0, n=17, nphotons=NPH, batch=B), nim=17)
    port = bridge.run_port_cpu(par, seed=21)
    ref = jdriver.run(bridge.jax_params(par), seed=21)
    assert port.peel['scatt'].shape == ref.peel['scatt'].shape == (
        2, port.meta.nxfreq, 17, 17)
    return {'lart_tpu_torch': port, 'lart_tpu': ref}


@pytest.mark.parametrize('package', ['lart_tpu_torch', 'lart_tpu'])
def test_flux_closure(runs, package):
    res = runs[package]
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-6
    for o, c in enumerate(testing.peel_closure(res)):
        assert abs(c - 1.0) < 0.05, (package, o, c)
        # the polarized run deposits I as scattered + direct
        assert float(res.peel['I'][o].sum()) == pytest.approx(float(
            res.peel['scatt'][o].sum() + res.peel['direc'][o].sum()),
            rel=1e-5)
    assert float(np.abs(res.peel['V']).max()) == 0.0   # unpolarized birth


def test_total_stokes_I_agrees(runs):
    t, j = runs['lart_tpu_torch'], runs['lart_tpu']
    for o in range(t.obs_meta.nobs):
        it, ij = (float(r.peel['I'][o].sum()) for r in (t, j))
        assert abs(it / ij - 1.0) < 0.05, (o, it, ij)


def test_peel_spectra_agree(runs):
    t, j = runs['lart_tpu_torch'], runs['lart_tpu']
    for o in range(t.obs_meta.nobs):
        chi2_dof, nbins = testing.peel_spectra_chi2(t, j, o, NPH)
        assert nbins >= 10 and chi2_dof < 3.0, (o, chi2_dof)


def test_radial_polarization_agrees(runs):
    t, j = runs['lart_tpu_torch'], runs['lart_tpu']
    # the sphere looks alike from every direction: both images are
    # symmetric about their centres
    for o in range(t.obs_meta.nobs):
        chi2_dof = testing.ring_polarization_chi2(t, j, o)
        assert chi2_dof < 3.0, (o, chi2_dof)
