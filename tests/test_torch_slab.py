"""The ported slice as a whole: lart_tpu's make_chunk against
lart_tpu_torch.driver.run on the CPU, on the Neufeld slab (tau0 = 100,
T = 1e4 K, 1e4 photons, B = 4096).

The two packages draw from different generators, so they agree
statistically, by ROADMAP's rules (lart_tpu_torch.testing.spectra_agree):
every photon's weight escapes (to 1e-3 each), <N_scatt> within 5%,
chi2/dof < 3 over the populated Jout bins, and Jmu's angular distribution
to atol 0.02."""

import numpy as np

from lart_tpu_torch import testing

import _torch_jax_bridge as bridge

NPH = 10_000


def test_slab_port_matches_jax():
    par = testing.slab_params(tau0=100.0, nz=101, nphotons=NPH, batch=4096)
    J_j, Jmu_j, N_j = bridge.run_jax_chunks(par, seed=9)
    res = bridge.run_port_cpu(par, seed=9)
    assert res.nphotons == NPH and res.Jmu.shape == (res.meta.nxfreq, 8)
    assert np.all(np.isfinite(res.Jout)) and np.all(res.Jout >= 0.0)
    # weight budget: escaped + outside the frequency grid = launched
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-6
    J_t, Jmu_t, N_t = testing.run_tallies(res)
    # <N_scatt> ~ 5 tau0 for this slab (line-centre tau0 = 100)
    assert 400.0 < N_t < 600.0, N_t
    testing.spectra_agree(J_t, Jmu_t, N_t, J_j, Jmu_j, N_j, NPH, 8)
