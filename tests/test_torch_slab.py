"""The ported slice as a whole: lart_tpu's make_chunk against
lart_tpu_torch.driver.run on the CPU, on the Neufeld slab (tau0 = 100,
T = 1e4 K, 1e4 photons, B = 4096).

The two packages draw from different generators, so they agree
statistically, by ROADMAP's rules (lart_tpu_torch.testing.spectra_agree):
every photon's weight escapes (to 1e-3 each), <N_scatt> within 5%,
chi2/dof < 3 over the populated Jout bins, and Jmu's angular distribution
to atol 0.02."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lart_tpu.grid.cartesian import build_cartesian
from lart_tpu.transport import engine
from lart_tpu_torch import driver, testing

NPH = 10_000


def _run_jax(par, seed, max_chunks=2000):
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg)
    chunk = jax.jit(engine.make_chunk(cfg, meta))
    state = jax.tree.map(jnp.asarray, engine.init_state(par.batch_size))
    state = state._replace(n_launched=jnp.zeros((1,), jnp.int32))
    n_shard = jnp.asarray([[par.nphotons, 0]], jnp.int32)
    key0 = jax.random.PRNGKey(seed)
    J = np.zeros(meta.nxfreq)
    Jmu = np.zeros(meta.nxfreq * par.nmu)
    ns = 0.0
    for i in range(max_chunks):
        state, tl, alive, launched = chunk(
            state, grid, jax.random.fold_in(key0, i), n_shard, None, None)
        J += np.asarray(tl.Jout, np.float64)
        Jmu += np.asarray(tl.Jmu, np.float64)
        ns += float(tl.nscatt_gas)
        if int(alive) == 0 and int(launched) >= par.nphotons:
            return J, Jmu, ns / par.nphotons
    raise AssertionError(f'lart_tpu batch did not drain in {max_chunks} '
                         f'chunks')


def test_slab_port_matches_jax():
    par = testing.slab_params(tau0=100.0, nz=101, nphotons=NPH, batch=4096)
    J_j, Jmu_j, N_j = _run_jax(par, seed=9)
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)     # B = 4096 gains nothing from more
    try:
        res = driver.run(par, device='cpu', seed=9)
    finally:
        torch.set_num_threads(nthreads)
    assert res.nphotons == NPH and res.Jmu.shape == (res.meta.nxfreq, 8)
    assert np.all(np.isfinite(res.Jout)) and np.all(res.Jout >= 0.0)
    # weight budget: escaped + outside the frequency grid = launched
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-6
    J_t, Jmu_t, N_t = testing.run_tallies(res)
    # <N_scatt> ~ 5 tau0 for this slab (line-centre tau0 = 100)
    assert 400.0 < N_t < 600.0, N_t
    testing.spectra_agree(J_t, Jmu_t, N_t, J_j, Jmu_j, N_j, NPH, 8)
