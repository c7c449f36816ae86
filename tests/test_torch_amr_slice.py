"""The AMR slice as a whole on the CPU: lart_tpu_torch's driver.run against
lart_tpu's on two generic-AMR files written from the same leaves:

- the uniform AMR sphere make_amr_sphere(16, 1) (R = 1, tau0 20, levels
  4-5), seen by one observer on the +z axis (17 x 17 TAN image);
- the jellyfish_pt grid (testing.jellyfish_amr: levels 4-6, 8e3 / 3e5 K, a
  moving medium, dust from the ndust column, core-skip), taumax cut to 10
  and cext_dust raised 1e8-fold so that the dust absorbs a share.

Each package reads the file itself (the port through grid.amr's
read_generic_amr).  They draw from different generators, so they agree
statistically over NPH photons each (lart_tpu at B = 4096: ROADMAP's
B = 2048 quirk):

- the weight closes in each package, W_esc + W_abs + W_oor = 1 to 1e-3;
- the mean gas scatterings per photon within 5%;
- the escaped spectra's shapes, each normalized to unit sum: chi2/dof < 3
  over the populated bins with the counting variance of the escaped
  photons;
- on the jellyfish grid the absorbed weight within 3 sigma of its binomial
  spread;
- on the sphere the peel-off flux closure: 4 pi d^2 times the peeled flux
  over the escaped weight is 1 (an isotropic medium and source) within 3
  sigma of its per-photon spread (testing.PEEL_V_PHOTON).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from lart_tpu import driver as jdriver
from lart_tpu.grid import amr as jamr
from lart_tpu_torch import testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.grid.amr import make_amr_sphere

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]
NPH = {'sphere': 2000, 'jellyfish': 3000}
# a frequency axis of +-80 Doppler widths (+-1000 km/s, jellyfish_pt's
# velocity range): the automatic one of a cut tau spans +-4, and lart_tpu
# drops the weight absorbed off the axis from every tally
JELLY_FREQ = dict(xfreq_min=-80.0, xfreq_max=80.0, nxfreq=320)


def _par(case, path):
    if case == 'sphere':
        par = dataclasses.replace(
            testing.amr_params(16, 1, tau0=20.0, nphotons=NPH[case]),
            save_peeloff=True, nobs=1, nxim=17, nyim=17, distance=1e3,
            alpha=(0.0,), beta=(0.0,))
    else:
        par = Params.from_namelist(
            str(ROOT / 'examples/jellyfish_rmhd/jellyfish_pt.in'))
        # the dust raised 1e8-fold: a dust tau ~0.3 at the gas's cut tau
        par = dataclasses.replace(par, taumax=10.0, nphotons=NPH[case],
                                  batch_size=4096, save_peeloff=False,
                                  cext_dust=1.6e-13, **JELLY_FREQ)
    return dataclasses.replace(par, amr_file=str(path), grid_type='',
                               use_amr_grid=True)


@pytest.fixture(scope='module', params=['sphere', 'jellyfish'])
def runs(request, tmp_path_factory):
    pytest.importorskip('h5py')
    case = request.param
    leaves = make_amr_sphere(16, 1) if case == 'sphere' \
        else testing.jellyfish_amr()
    path = tmp_path_factory.mktemp('amr') / f'{case}.h5'
    jamr.write_generic_amr(str(path), leaves)
    par = _par(case, path)
    port = bridge.run_port_cpu(par, seed=29)
    ref = jdriver.run(bridge.jax_params(par), seed=29)
    return case, {'lart_tpu_torch': port, 'lart_tpu': ref}


def test_weight_closes(runs):
    case, rr = runs
    for name, r in rr.items():
        w = r.W_escape + r.W_absorb + r.W_oor
        assert abs(w - 1.0) < 1e-3, (case, name, r.W_escape, r.W_absorb,
                                     r.W_oor)
        assert (r.W_absorb > 0.0) == (case == 'jellyfish'), (case, name)


def test_scatterings_and_spectra_agree(runs):
    case, rr = runs
    a, b = rr['lart_tpu_torch'], rr['lart_tpu']
    assert abs(a.nscatt_gas / b.nscatt_gas - 1.0) < 0.05, (
        case, a.nscatt_gas, b.nscatt_gas)
    n = NPH[case]
    chi2, nb = testing.spectra_chi2(a.Jout, b.Jout, n * a.W_escape,
                                    n * b.W_escape)
    assert nb > 10 and chi2 < 3.0, (case, chi2, nb)


def test_absorption_or_peel_flux(runs):
    case, rr = runs
    a, b = rr['lart_tpu_torch'], rr['lart_tpu']
    n = NPH[case]
    if case == 'jellyfish':
        p = 0.5 * (a.W_absorb + b.W_absorb)
        assert abs(a.W_absorb - b.W_absorb) <= 3 * np.sqrt(
            2 * p * (1 - p) / n), (a.W_absorb, b.W_absorb)
        return
    sig = np.sqrt(testing.PEEL_V_PHOTON / n)
    for name, r in rr.items():
        c = testing.peel_closure(r)[0]
        assert abs(c - 1.0) < 3 * sig, (name, c, sig)
