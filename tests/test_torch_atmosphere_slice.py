"""The atmospheres and the illuminations end to end: the configs of
lart_tpu's tests/test_atmosphere.py through lart_tpu_torch.driver.run on
the CPU and through lart_tpu's driver.run at B = 2560 (its generic walk
needs B >= 2560 to agree with its chord paths, ROADMAP queue 3), by
_torch_jax_bridge.atmosphere_against_lart_tpu; the AMR transit case runs
in tests/test_torch_atmosphere.py, so that each file stays near a minute.

Each case checks, for the port's run:
- the budget: W_esc + W_abs2 + W_oor (Jout's, Jabs2's and the weight off
  the frequency grid) equals the birth weights (Jin's sum: every birth of
  these cases falls in the band) to 1e-3;
- against lart_tpu's run: <N_scatt>, the Jabs2 share of the budget and the
  normalized flux factor (sum / (nphotons + nrejected)) within 5% or 3
  sigma.  The port runs its photons as NSEEDS runs from different seeds,
  whose spread gives one photon's <N_scatt> (a forced first scattering's
  weight, ~tau0 of its ray, has a long tail in a thin atmosphere); a
  share's sigma is its binomial one, the flux factor's the delta method's
  on 2^16 births of the port's sampler (_ff_sigma);
- with a stellar peel: Direct <= Direct0 (1 + 1e-6) in every bin and a
  transit depth 1 - Direct / Direct0 within 3 sigma of lart_tpu's
  (testing.transit: sigma from the spread of a pair's attenuation), on a
  Cartesian grid and on the AMR sphere.

The cases are lart_tpu's, cut where the port's plain versions on one CPU
thread would take minutes: the thick plane to tau 30 and 800 photons, the
transit sphere to 17^3 (a core of radius 0.4 added, as wasp52b_like.in
has), tau 10 and 400 photons.
"""

import pytest
import torch

from lart_tpu_torch import testing
from lart_tpu_torch.config import Params

import _torch_jax_bridge as bridge

NSEEDS = 4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The plain versions in one thread (the other test workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane_thin():
    return testing.plane_atmosphere_params(
        taumax=1e-4, xfreq_min=-20.0, xfreq_max=20.0,
        spectral_type='monochromatic', chunk_cycles=8)


def _plane_thick():
    # lart_tpu's case at tau 1e3 scatters ~150 times a photon with a tail
    # of thousands, one plain cycle each: cut to tau 30
    return testing.plane_atmosphere_params(nphotons=800, taumax=30.0)


def _stellar_core():
    return Params(nphotons=2000, geometry='spherical_atmosphere', nx=33,
                  ny=33, nz=33, xmax=1, ymax=1, zmax=1, rmax=1.0, rmin=0.6,
                  taumax=1e-3, temperature=1e4, xfreq_min=-20.0,
                  xfreq_max=20.0, source_geometry='stellar_illumination',
                  stellar_radius=20.0, distance_star_to_planet=500.0,
                  stellar_limb_darkening=2, spectral_type='monochromatic',
                  batch_size=1024, chunk_cycles=16)


def _point():
    return Params(nphotons=2000, geometry='', nx=17, ny=17, nz=9, xmax=1,
                  ymax=1, zmax=0.2, tauhomo=0.5, temperature=1e4,
                  xfreq_min=-20.0, xfreq_max=20.0,
                  source_geometry='point_illumination', zs_point=-5.0,
                  spectral_type='voigt', batch_size=1024, chunk_cycles=16)


def _transit():
    return testing.stellar_params(nphotons=400, n=17, rmin=0.4, taumax=10.0)


# name -> (params, the atmosphere destroys, the source is an
# illumination with a flux factor, a stellar peel)
CASES = {
    'plane_thin': (_plane_thin, True, False, False),
    'plane_thick': (_plane_thick, True, False, False),
    'stellar_core': (_stellar_core, True, True, False),
    'point_illumination': (_point, False, True, False),
    'transit': (_transit, True, True, True),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_atmosphere_matches_lart_tpu(name):
    make, destroys, illum, stellar = CASES[name]
    bridge.atmosphere_against_lart_tpu(name, make(), destroys=destroys,
                                       illum=illum, stellar=stellar,
                                       n_runs=NSEEDS)
