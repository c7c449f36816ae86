"""The shearing box of the port (kernel K5's plain version, the driver, the
CLI) against lart_tpu on the CPU.

A periodic x wrap moves a lane's shear-frame y-velocity vfy_shear by -+
omega_shear, which enters the comoving update as vfy_shear ky with the old
and the new value, and the escape frequency with the old one
(lart_tpu/transport/engine.py:1250-1313, :1406-1409).  The walk draws no
random numbers: one state with lanes next to both x faces goes through
make_fly and through the port, and every lane field, vfy_shear included,
matches to the tolerances of tests/test_torch_fly_cartesian.py.  The
driver runs on tests/test_shear.py's cut of shear.in against lart_tpu
by ROADMAP's statistical rules, and the spectrum broadens over Omega = 0.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
from lart_tpu_torch.transport.state import DEAD

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """The plain versions in one torch thread: under Tier-1's workers the
    default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    # tests/test_shear.py's box: moving (Vexp 1) and sheared
    'moving': lambda: testing.shear_params(),
    # a static sheared box: the shear alone forces the comoving update
    'static': lambda: testing.shear_params(velocity_type='', Vexp=0.0),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_fly_shear_matches_make_fly_lane_by_lane(case):
    cfg, jcfg = bridge.resolve_both(CASES[case]())
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    assert meta.omega_shear == jmeta.omega_shear > 1.0
    assert meta.static_medium == (case == 'static')
    flight = teng.make_fly(cfg, meta, grid)
    assert isinstance(flight, CartesianFlight)
    s0 = testing.shear_state(meta, 20_000, seed=41)
    st, tl, ref, ref_t = bridge.fly_both(
        jeng.make_fly(jcfg, jmeta), jgrid, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps)
    frac, err = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= 1e-4, frac
    bridge.assert_tallies_close(tl, ref_t)
    # lanes wrapped both ways; a completed forced first scattering restarts
    # unsheared, so its vfy_shear is a whole number of jumps since
    moved = st.vfy_shear - s0.vfy_shear
    om = meta.omega_shear
    assert int((moved > 0.5 * om).sum()) > 100
    assert int((moved < -0.5 * om).sum()) > 100
    restarted = (st.phase != DEAD) & (st.wgt < s0.wgt)
    jumps = st.vfy_shear[restarted] / om
    assert int(restarted.sum()) > 100
    assert float((jumps - torch.round(jumps)).abs().max()) < 1e-4
    assert float(tl.Jout.sum()) > 0.0


def test_shear_in_grid_matches_lart_tpu():
    """omega_shear and the maps' binning of shear.in as written equal
    lart_tpu's."""
    from lart_tpu_torch.config import Params
    par = Params.from_namelist(str(ROOT / 'examples' / 'tigress_shear'
                                   / 'shear.in'))
    par.calcP = True
    cfg, jcfg = bridge.resolve_both(par)
    meta, _ = build_cartesian(cfg)
    jmeta, _ = jcart.build_cartesian(jcfg)
    for f in ('omega_shear', 'geometry_JPa', 'nbin_JPa', 'dr_JPa',
              'roff_JPa'):
        assert getattr(meta, f) == getattr(jmeta, f), f
    assert meta.omega_shear == pytest.approx(2.18, abs=0.01)


def test_check_supported_accepts_all_examples_but_ramses():
    """111 of the 112 example namelists resolve and pass check_supported;
    the one refused reads a RAMSES snapshot the repository does not
    hold."""
    from lart_tpu_torch.config import Params
    refused = []
    names = sorted((ROOT / 'examples').rglob('*.in'))
    for p in names:
        cfg = Params.from_namelist(str(p)).resolve()
        try:
            teng.check_supported(cfg)
        except NotImplementedError as e:
            refused.append((p.name, str(e)))
    assert len(names) == 112
    assert [n for n, _ in refused] == ['ramses_snap10.in'], refused


def test_check_supported_follows_lart_tpu_off_cartesian_grids():
    """calcJ and calcPnew are refused by name on an AMR grid, where
    lart_tpu's flight raises (jpa_bin of geometry_JPa 0); calcP runs there
    and on a clump medium, as do calcJ and calcPnew on clumps, binning
    nothing; Omega with xy_periodic is accepted there, its shear unset in
    the grid's meta (omega_shear 0), as in lart_tpu."""
    from lart_tpu_torch.grid.amr import build_amr, make_amr_sphere
    amr = testing.amr_params()
    for flag in ('calcJ', 'calcPnew'):
        cfg = dataclasses.replace(amr, **{flag: True}).resolve()
        with pytest.raises(NotImplementedError,
                           match='calcJ/calcPnew on an AMR grid'):
            teng.check_supported(cfg)
    cfg = dataclasses.replace(amr, calcP=True, Omega=28.0,
                              xy_periodic=True).resolve()
    teng.check_supported(cfg)
    built = build_amr(cfg, data=make_amr_sphere(8, 0))
    assert built.meta.nbin_JPa == 0 and built.meta.omega_shear == 0.0
    cl = testing.clump_params(calcJ=True, calcP=True, calcPnew=True)
    teng.check_supported(cl.resolve())


def _write(path, par, keys, **extra):
    for k, v in extra.items():
        setattr(par, k, v)
    return testing.write_namelist(path, par, keys + tuple(extra))


SHEAR_KEYS = ('nphotons', 'xy_periodic', 'velocity_type', 'Vexp', 'nx', 'ny',
              'nz', 'xmax', 'ymax', 'zmax', 'taumax', 'temperature',
              'distance_unit', 'xfreq_min', 'xfreq_max', 'Omega', 'q',
              'batch_size', 'chunk_cycles', 'fly_substeps', 'iseed')


def test_cli_shear_against_lart_tpu(tmp_path):
    """The CLI on tests/test_shear.py's cut of shear.in (16 x 16 x 33 cut
    to 4 x 4 x 33: the lateral cells only sample the 1 km/s Hubble flow,
    the shear's jump a wrap depends on the box's width, kept; tau 100,
    Omega 60) writes a file that lart_tpu's read_lart reads with the
    sections, shapes and keywords of lart_tpu's own output; against
    lart_tpu's driver.run: <N_scatt> within 5% or 3 sigma of one photon's
    spread (lart_tpu's all-photons table), the spectra by chi^2/dof < 3,
    the weight to 1e-3; the spectrum broader than lart_tpu's at Omega 0
    (tests/test_shear.py)."""
    from lart_tpu import driver as jdriver
    from lart_tpu.analysis import read_lart
    from lart_tpu.io.writer import write_output as jwrite
    from lart_tpu_torch import __main__ as cli
    par = testing.shear_params(nphotons=500, batch=512, nx=4, ny=4,
                               fly_substeps=8)
    par.iseed = 3
    out = tmp_path / 'port.h5'
    nml = _write(tmp_path / 'shear.in', par, SHEAR_KEYS,
                 out_file=str(out))
    assert cli.main([str(nml), '--device', 'cpu']) == 0
    r = read_lart(str(out))

    jpar = bridge.jax_params(dataclasses.replace(par, nphotons=1000,
                                                 batch_size=1024))
    jpar.save_all_photons = True
    jres = jdriver.run(jpar, seed=5)
    spread = float(np.std(np.asarray(jres.allph['nscatt_gas'])))
    jres.allph = None
    ref = tmp_path / 'lart_tpu.h5'
    jwrite(str(ref), jres)
    j = read_lart(str(ref))
    # lart_tpu's own output's sections and keywords
    import h5py
    with h5py.File(out) as f, h5py.File(ref) as g:
        assert sorted(f.keys()) == sorted(g.keys())
        for sec in g.keys():
            assert set(g[sec].attrs) <= set(f[sec].attrs), sec
            for ds in g[sec].keys():
                assert f[sec][ds].shape == g[sec][ds].shape, (sec, ds)

    n = float(r.header['nphotons'])
    assert abs(float(r.header['W_esc']) - 1.0) < 1e-3
    N, Nj = float(r.header['Nsc_gas']), jres.nscatt_gas
    sig = spread * np.sqrt(1.0 / n + 1.0 / jres.nphotons)
    assert abs(N - Nj) <= max(0.05 * Nj, 3.0 * sig), (N, Nj, sig)
    J = r.Jout / r.Jout.sum() * n
    Jj = j.Jout / j.Jout.sum() * jres.nphotons
    p1, p2 = J / J.sum(), Jj / Jj.sum()
    sel = (p1 + p2) > (p1 + p2).max() * 1e-3
    var = (np.maximum(p1, 1e-12) / n + np.maximum(p2, 1e-12)
           / jres.nphotons)
    chi2 = float(np.mean((p1[sel] - p2[sel]) ** 2 / var[sel]))
    assert chi2 < 3.0, chi2
    # broadened over Omega = 0
    jres0 = jdriver.run(bridge.jax_params(dataclasses.replace(
        par, Omega=0.0, nphotons=1000, batch_size=1024)), seed=5)
    rms, rms0 = (testing.spectrum_rms(r.xfreq, r.Jout),
                 testing.spectrum_rms(jres0.xfreq, jres0.Jout))
    assert rms > 1.1 * rms0, (rms, rms0)
