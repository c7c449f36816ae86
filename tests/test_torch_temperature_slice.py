"""The per-cell temperature and the 3-D grid files of the port end to end
against lart_tpu on the CPU, by ROADMAP's rules (<N_scatt> within 5%, the
escaped spectra's shapes by chi2/dof < 3, the weight budget to 1e-3).

- examples/emiss_1D_AlII/AlII_ex.in (Al II 1671, the 1-D emissivity,
  density and temperature profiles, 8900 K at the centre to 7100 K at the
  edge, comoving source, recoil) cut to a 21^3 grid and 2000 photons,
  without its observer and tau maps (the transport does not depend on
  them).
- A 17^3 Mg II 2796 sphere whose density, temperature and velocity come
  from HDF5 cubes (a lognormal density, the 1e3-1e5 K temperature cube of
  testing.temperature_cube, a Hubble flow of 50 km/s at the edge written
  as a (z, y, x, 3) velocity cube), at tau 100 from a central point source,
  its band 2790-2810 A (both lines of the doublet) in 800 bins.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lart_tpu_torch import testing

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The plain versions in one thread: their ops are small, and the
    other test workers share the cores (torch's thread pool would spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agree(par, n, weighted=False, min_bins=20):
    """Both packages' drivers on par (lart_tpu's at B = 4096, ROADMAP
    queue 3): the port's RunResult."""
    from lart_tpu import driver as jdriver
    res = bridge.run_port_cpu(par, seed=5)
    jpar = bridge.jax_params(par)
    jpar.batch_size = 4096
    J_j, _, N_j = testing.run_tallies(jdriver.run(jpar, seed=9))
    J_t, _, N_t = testing.run_tallies(res)
    assert not res.meta.uniform_temperature
    assert abs(N_t / N_j - 1.0) < 0.05, (N_t, N_j)
    chi2, bins = testing.spectra_chi2(J_t, J_j, n * res.W_escape,
                                      float(J_j.sum()))
    assert bins >= min_bins and chi2 < 3.0, (chi2, bins)
    w = res.W_escape + res.W_absorb + res.W_oor
    if weighted:
        # the composite weights' sum: Jin holds the births in the band,
        # W_oor the escapes of those outside it
        w_birth = testing.birth_weight(res)
        assert w_birth - 1e-3 < w < w_birth + res.W_oor + 1e-3, (w, w_birth)
    else:
        assert abs(w - 1.0) < 1e-3, w
    return res


def test_alii_profiles_match_lart_tpu():
    n = 2000
    par = testing.source_params('AlII', ROOT, nx=21, ny=21, nz=21,
                                nphotons=n, batch_size=2048,
                                save_peeloff=False, save_sightline_tau=False)
    # the line is ~10 bins wide in AlII_ex.in's automatic 200-bin band
    res = _agree(par, n, weighted=True, min_bins=8)
    assert res.cfg.par.temp_file.endswith('AlII_temp_profile.txt')


def test_mgii_cubes_match_lart_tpu(tmp_path):
    n, N = 2000, 17
    rng = np.random.default_rng(7)
    ax = (np.arange(N) + 0.5) / N * 2.0 - 1.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing='ij')
    v = np.stack([X, Y, Z], axis=-1) * 50.0          # km/s, 50 at r = 1
    files = dict(
        dens_file=testing.write_cube(tmp_path / 'rho.h5',
                                     rng.lognormal(0.0, 0.5, (N, N, N))),
        temp_file=testing.write_cube(tmp_path / 'T.h5',
                                     testing.temperature_cube(N, 7)),
        velo_file=testing.write_cube(tmp_path / 'v.h5', v))
    par = testing.line_params('doublet', tau0=100.0, n=N, nphotons=n,
                              batch=2048, nwavelength=800, **files)
    res = _agree(par, n)
    assert not res.meta.static_medium
