"""The clump slice as a whole on the CPU: lart_tpu_torch's driver.run against
lart_tpu's on two clump media, each package building the same population
from the same seed (seed + 77):

- examples/clump_sphere/clumps_overlap.in (195 overlapping clumps, the
  dense flight and the owner draw), its clumps' tau0 cut from 10 to 2 and
  NPH photons;
- the 40-clump sphere of lart_tpu's tests/test_clump_overlap.py
  (testing.clump_params) through the CSR walker in non-overlap mode
  (clump_dense_max 0).

They draw from different generators, so they agree statistically (ROADMAP's
rules): the weight closes in each package to 1e-3, the mean gas
scatterings per photon agree within 5%, and the escaped spectra's shapes to
chi2/dof < 3 over the populated bins.  A clumpy medium spreads a photon's
scatterings widely (a photon that misses the clumps scatters once, one
that enters one may scatter tens of times): at tau0 10, 3000 photons gave
<N> of 9.7-10.6 over four generator seeds on one population, so the runs
here cut the clumps' depth and take NPH photons, where the spread of <N>
is ~1%.  The port's own A/B: the dense flight and the CSR walker on one
overlapping population agree by the same rules (4000 photons: one seed
gives both the same uniforms); and the peel flux closure
of lart_tpu's tests/test_clump_instruments.py: with optically thin clumps
(tau0 0.5) 4 pi d^2 times the flux an observer on +z peels, over the
photon count, is 1 within 15%.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from lart_tpu import driver as jdriver
from lart_tpu_torch import testing
from lart_tpu_torch.config import Params

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]
NPH = 20_000


def _par(case):
    if case == 'clumps_overlap':
        par = Params.from_namelist(
            str(ROOT / 'examples/clump_sphere/clumps_overlap.in'))
        return dataclasses.replace(par, nphotons=NPH, batch_size=4096,
                                   clump_tau0=2.0)
    return testing.clump_params(nphotons=NPH, batch=4096, clump_dense_max=0)


@pytest.fixture(scope='module', params=['clumps_overlap', 'sphere40_csr'])
def runs(request):
    case = request.param
    par = _par(case)
    port = bridge.run_port_cpu(par, seed=5)
    ref = jdriver.run(bridge.jax_params(par), seed=5)
    return case, {'lart_tpu_torch': port, 'lart_tpu': ref}


def test_weight_closes(runs):
    case, rr = runs
    for name, r in rr.items():
        w = r.W_escape + r.W_absorb + r.W_oor
        assert abs(w - 1.0) < 1e-3, (case, name, r.W_escape, r.W_oor)


def test_scatterings_and_spectra_agree(runs):
    case, rr = runs
    a, b = rr['lart_tpu_torch'], rr['lart_tpu']
    assert a.nscatt_gas > 1.5
    assert abs(a.nscatt_gas / b.nscatt_gas - 1.0) < 0.05, (
        case, a.nscatt_gas, b.nscatt_gas)
    chi2, nb = testing.spectra_chi2(a.Jout, b.Jout, NPH * a.W_escape,
                                    NPH * b.W_escape)
    assert nb > 5 and chi2 < 3.0, (case, chi2, nb)


def test_dense_flight_and_csr_walker_agree():
    """One overlapping population (the 40-clump sphere, overlaps allowed),
    flown by K9's plain version and by K10's.  With one seed both runs
    draw the same uniforms (the flights draw none), so they stay far
    closer than two independent runs: 4000 photons."""
    n = 4000
    out = {}
    for dense_max in (1024, 0):
        par = testing.clump_params(nphotons=n, batch=4096,
                                   clump_allow_overlap=True,
                                   clump_dense_max=dense_max)
        out[dense_max] = bridge.run_port_cpu(par, seed=7)
    a, b = out[1024], out[0]
    for r in (a, b):
        assert abs(r.W_escape + r.W_oor - 1.0) < 1e-3
    assert abs(a.nscatt_gas / b.nscatt_gas - 1.0) < 0.05, (a.nscatt_gas,
                                                           b.nscatt_gas)
    chi2, nb = testing.spectra_chi2(a.Jout, b.Jout, n * a.W_escape,
                                    n * b.W_escape)
    assert nb > 5 and chi2 < 3.0, (chi2, nb)


def test_clump_peel_flux_closes():
    """tests/test_clump_instruments.py:25-57 through the port's chunk loop,
    as that test drives lart_tpu's: optically thin clumps (tau0 0.5), so
    that the +z fluence is close to the angle average, the population of
    seed 42; the raw cubes' sum times 4 pi r^2 over the photon count."""
    from lart_tpu_torch.grid.clump import build_clumps
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.state import init_state
    par = testing.clump_params(nphotons=3000, clump_N_clumps=30,
                               clump_tau0=0.5, xfreq_min=-25.0,
                               xfreq_max=25.0, save_peeloff=True, nxim=17,
                               nyim=17, alpha=(0.0,), beta=(0.0,),
                               distance=100.0)
    cfg = par.resolve()
    meta, cmeta, dev = build_clumps(cfg, seed=42, device='cpu')
    ch = make_chunk(cfg, meta, dev, cmeta)
    st = init_state(par.batch_size, 'cpu')
    jout = sc = dr = 0.0
    for i in range(400):
        tl, alive, launched = ch(st, 7, i * ch.n_cycles, par.nphotons)
        jout += float(tl.Jout.double().sum())
        sc += float(tl.peel.scatt.double().sum())
        dr += float(tl.peel.direc.double().sum())
        if int(launched) >= par.nphotons and int(alive) == 0:
            break
    else:
        raise AssertionError('did not drain')
    assert abs(jout / par.nphotons - 1.0) < 1e-3
    r2 = float((ch.peel.pos[0].double() ** 2).sum())
    tot = (sc + dr) * 4.0 * np.pi * r2 / par.nphotons
    assert 0.85 < tot < 1.15, tot
    assert dr > 0 and sc > 0
