"""The CALCJ / CALCP / CALCPnew maps of the port against lart_tpu on the
CPU, in their three binning geometries (testing.JPA_GEOMETRIES: the z cell
of a slab, the radial bin of a sphere's cell centre, the flat cell of a
box).

The grid's binning and jpa_bin on every cell equal lart_tpu's; one flight
call of K5's plain version deposits J1 and Pnew as make_fly does on the
same state, and one scatter call of K4's Pa as make_scatter does, each to
1e-5 of the map's sum (f32 sums in another order).  The scatter draws its
random numbers from another generator than lart_tpu's: its lanes sit in
the line core (|x| < 0.2, where the u_par sampler's four rounds all but
never fail), so that every lane scatters in both packages and the
deposits do not depend on the draws.  With calcP alone the slab and the
sphere keep K3 and K6, which leave a scattering lane in its own cell.
driver.run's normalized maps match lart_tpu's by testing.map_chi2 on a
cut slab and sphere, with the slab's closure sum(Pa raw rhokap_phys) =
the scattered weight; the CLI writes the sections lart_tpu's read_lart
reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
from lart_tpu_torch.transport.jpa import JpaBins
from lart_tpu_torch.transport.state import AT_SCATTER, FLYING

import _torch_jax_bridge as bridge

CASES = sorted(testing.JPA_GEOMETRIES)
MAP_FIELDS = ('geometry_JPa', 'nbin_JPa', 'dr_JPa', 'roff_JPa')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """The plain versions in one torch thread: under Tier-1's workers the
    default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(case, **kw):
    cfg, jcfg = bridge.resolve_both(testing.jpa_params(case, **kw))
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    return cfg, jcfg, meta, grid, jmeta, jgrid


def _maps_close(got, want, rel=1e-5):
    """The port's f64 map against lart_tpu's f32 one, to rel of its sum."""
    atol = rel * max(float(want.abs().sum()), 1e-30)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def _jax_maps(jt):
    return {k: None if getattr(jt, k) is None
            else torch.as_tensor(np.array(getattr(jt, k), np.float64))
            for k in ('J1', 'Pa', 'Pnew')}


@pytest.mark.parametrize('case', CASES)
def test_binning_and_jpa_bin_match_lart_tpu(case):
    cfg, jcfg, meta, _, jmeta, _ = _both(case)
    assert meta.geometry_JPa == testing.JPA_GEOMETRIES[case]
    for f in MAP_FIELDS:
        assert getattr(meta, f) == getattr(jmeta, f), f
    q = JpaBins.from_config(cfg, meta)
    i, j, k = np.meshgrid(np.arange(meta.nx), np.arange(meta.ny),
                          np.arange(meta.nz), indexing='ij')
    idx = [torch.as_tensor(a.reshape(-1), dtype=torch.int32)
           for a in (i, j, k)]
    zero = jnp.zeros(idx[0].shape, jnp.float32)
    want = np.asarray(jeng.jpa_bin(jcfg, jmeta, (
        zero, zero, zero, *(jnp.asarray(a.numpy()) for a in idx))))
    got = q.bin(*idx).numpy()
    np.testing.assert_array_equal(got, want)
    # every bin holds a cell
    assert len(np.unique(got)) == meta.nbin_JPa


@pytest.mark.parametrize('case', CASES)
def test_flight_deposits_match_make_fly(case):
    cfg, jcfg, meta, grid, jmeta, jgrid = _both(case)
    flight = teng.make_fly(cfg, meta, grid)
    # calcJ and calcPnew send every geometry through K5
    assert isinstance(flight, CartesianFlight)
    ch = teng.make_chunk(cfg, meta, grid)
    s0 = testing.mixed_state(meta, 20_000, seed=53,
                             r_max=1.0 if case == 'sphere' else None)
    nbin = meta.nbin_JPa
    jt0 = jeng.zero_tallies(meta.nxfreq, nmu=cfg.par.nmu, nbin_JPa=nbin,
                            calcJ=True, calcP=True, calcPnew=True)
    js, jt = jax.jit(jeng.make_fly(jcfg, jmeta), static_argnums=3)(
        bridge.state_to_jax(s0), jgrid, jt0, cfg.par.fly_substeps)
    st = testing.clone_state(s0)
    tl = ch.zero_tallies('cpu')
    flight(st, tl, cfg.par.fly_substeps)
    frac, _ = testing.compare_states(st, convert.state_from_jax(js),
                                     rtol=1e-5, atol=1e-6)
    assert frac <= 1e-4, frac
    want = _jax_maps(jt)
    assert tl.J1.shape == want['J1'].shape == (meta.nxfreq * nbin,)
    for k in ('J1', 'Pnew'):
        _maps_close(getattr(tl, k), want[k])
        assert float(want[k].sum()) > 0.0 and \
            int((want[k] > 0).sum()) > min(nbin // 2, 20), k
    # the scatter deposits Pa, the flight nothing there
    assert float(tl.Pa.abs().sum()) == 0.0


# with calcP alone the slab and the sphere keep their fast paths K3 and K6,
# and the sphere's scatter its constant rhokap (rk_const)
PA_CASES = [(c, False) for c in CASES] + [('slab', True), ('sphere', True)]


@pytest.mark.parametrize('case,alone', PA_CASES)
def test_scatter_pa_matches_make_scatter(case, alone):
    over = dict(calcJ=False, calcPnew=False) if alone else {}
    cfg, jcfg, meta, grid, jmeta, jgrid = _both(case, **over)
    ch = teng.make_chunk(cfg, meta, grid)
    assert (ch.scatter_params.rk_const > 0.0) == (alone and case == 'sphere')
    B = 20_000
    s0 = testing.mixed_state(meta, B, seed=61, phases=(AT_SCATTER,),
                             r_max=1.0 if case == 'sphere' else None)
    s0.xfreq.copy_(torch.as_tensor(np.random.default_rng(2).uniform(
        -0.2, 0.2, B), dtype=torch.float32))
    jt0 = jeng.zero_tallies(meta.nxfreq, nbin_JPa=meta.nbin_JPa, calcP=True)
    js, jt = jax.jit(jeng.make_scatter(jcfg, jmeta))(
        bridge.state_to_jax(s0), jgrid, jt0, jax.random.PRNGKey(5))
    st = testing.clone_state(s0)
    tl = ch.zero_tallies('cpu')
    teng.scatter(st, tl, ch.scatter_params, 3, 9)
    ref = convert.state_from_jax(js)
    # every lane scattered in both packages
    assert bool((st.phase == FLYING).all()) and \
        bool((ref.phase == FLYING).all())
    want = _jax_maps(jt)['Pa']
    _maps_close(tl.Pa, want)
    assert float(want.sum()) > 0.0
    torch.testing.assert_close(tl.nscatt_gas, torch.as_tensor(
        float(jt.nscatt_gas)), rtol=1e-5, atol=0)


@pytest.mark.parametrize('case', ['slab', 'sphere'])
def test_fast_paths_write_the_scattering_cell(case):
    """With calcP alone the slab flies K3 and the sphere K6; a lane they
    leave at a scattering stands in the cell its position names (Pa's bin,
    lart_tpu's engine.py:735-745, :990-1000)."""
    cfg = testing.jpa_params(case, calcJ=False, calcPnew=False).resolve()
    meta, grid = build_cartesian(cfg)
    ch = teng.make_chunk(cfg, meta, grid)
    assert type(ch.flight).__name__ == ('SlabParams' if case == 'slab'
                                        else 'SphereFlight')
    st = testing.mixed_state(meta, 20_000, seed=67,
                             r_max=1.0 if case == 'sphere' else None)
    ch.flight(st, ch.zero_tallies('cpu'), cfg.par.fly_substeps)
    at = st.phase == AT_SCATTER
    assert int(at.sum()) > 1000
    cells = testing.cells_of(meta, st.x[at].numpy(), st.y[at].numpy(),
                             st.z[at].numpy())
    for c, want in zip((st.ic, st.jc, st.kc), cells):
        np.testing.assert_array_equal(c[at].numpy(), want)


def _port_runs(par, n_runs, seed=3):
    from lart_tpu_torch import driver
    sub = dataclasses.replace(par, nphotons=par.nphotons // n_runs)
    return [driver.run(sub, device='cpu', seed=seed + i)
            for i in range(n_runs)]


def _maps(r):
    return testing.run_maps(r)


@pytest.mark.parametrize('case', ['slab', 'sphere'])
def test_driver_maps_match_lart_tpu(case):
    """driver.run with the three maps against lart_tpu's driver.run:
    each map by testing.map_chi2 < 3 (J1 summed over frequency, and on the
    sphere over bins; testing.map_keys); on the uniform slab the closure sum(Pa raw rhokap_phys) = the
    scattered weight to f32 rounding; sum Pnew / sum Pa as lart_tpu's
    within 5% or 3 sigma of the port runs' spread (Pnew also counts the
    forced first scatterings' birth rays, which Pa does not:
    test_pnew_estimates_pa_off_the_birth_rays)."""
    from lart_tpu import driver as jdriver
    par = testing.jpa_params(case, nphotons=1200, batch=512)
    runs = _port_runs(par, 4)
    jpar = bridge.jax_params(par)
    jpar.batch_size = 4096
    jres = jdriver.run(jpar, seed=5)
    n_run = runs[0].nphotons
    for k in testing.map_keys(jres.meta):
        chi2 = testing.map_chi2([_maps(r)[k] for r in runs], n_run,
                                [_maps(jres)[k]], jres.nphotons)
        assert chi2 < 3.0, (k, chi2)
    np.testing.assert_allclose(runs[0].r_JPa, jres.r_JPa, rtol=1e-12)
    ratio = np.array([r.Pnew.sum() / r.Pa.sum() for r in runs])
    want = jres.Pnew.sum() / jres.Pa.sum()
    sig = ratio.std(ddof=1) / np.sqrt(len(runs)) \
        * np.sqrt(1.0 + len(runs) * n_run / jres.nphotons)
    assert abs(ratio.mean() - want) <= max(0.05 * want, 3.0 * sig), \
        (ratio, want)
    if case == 'slab':
        for r in runs:
            lhs, rhs = testing.pa_closure(r)
            assert abs(lhs / rhs - 1.0) < 1e-5, (lhs, rhs)


def test_pnew_estimates_pa_off_the_birth_rays(monkeypatch):
    """Pnew sums each segment's d rhoH wgt / rhokap_phys, the expected
    scatterings per atom, Pa the scatterings themselves: off the forced
    first scatterings' birth rays (segments of FFS lanes, which lart_tpu
    deposits too and which end in no scattering of the walk) the two agree
    within 5% or 3 sigma of the runs' spread in the uniform box."""
    from lart_tpu_torch.transport import fly_cartesian as tfly
    cur = {}
    fly_plain, deposit = tfly.fly_plain, tfly.deposit_segments

    def fly_kept(state, tallies, p, max_steps, stats=None):
        cur['s'] = state
        return fly_plain(state, tallies, p, max_steps, stats)

    def flying_only(q, tallies, p, seg_ok, *rest):
        return deposit(q, tallies, p, seg_ok & (cur['s'].phase == FLYING),
                       *rest)
    monkeypatch.setattr(tfly, 'fly_plain', fly_kept)
    monkeypatch.setattr(tfly, 'deposit_segments', flying_only)
    runs = _port_runs(testing.jpa_params('box', nphotons=1200, batch=512),
                      4, seed=11)
    ratio = np.array([r.Pnew.sum() / r.Pa.sum() for r in runs])
    sig = ratio.std(ddof=1) / np.sqrt(len(ratio))
    assert abs(ratio.mean() - 1.0) <= max(0.05, 3.0 * sig), ratio


SLAB_KEYS = ('nphotons', 'temperature', 'taumax', 'xy_periodic', 'nx', 'ny',
             'nz', 'spectral_type', 'source_geometry', 'batch_size',
             'xfreq_min', 'xfreq_max', 'nxfreq', 'calcJ', 'calcP',
             'calcPnew', 'iseed')


@pytest.mark.parametrize('fmt', ['hdf5', 'fits'])
def test_cli_writes_the_maps_that_lart_tpu_reads(tmp_path, fmt):
    """The CLI on the cut slab with the three maps writes Jx_1D, Pa_1D and
    Pa_1D_new with their radius and geom_JPa, which lart_tpu's read_lart
    reads with the shapes of lart_tpu's own output of the same namelist."""
    from lart_tpu import driver as jdriver
    from lart_tpu.analysis import read_lart
    from lart_tpu.io.writer import write_output as jwrite
    from lart_tpu_torch import __main__ as cli
    from lart_tpu_torch.io.iofile import open_read
    par = testing.jpa_params('slab', nphotons=300, batch=512,
                             file_format=fmt)
    par.iseed = 3
    ext = '.h5' if fmt == 'hdf5' else '.fits'
    out = tmp_path / ('port' + ext)
    nml = testing.write_namelist(tmp_path / 'slab.in', par,
                                 SLAB_KEYS + ('file_format',))
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    jres = jdriver.run(bridge.jax_params(par), seed=5)
    ref = tmp_path / ('lart_tpu' + ext)
    jwrite(str(ref), jres)
    r, j = read_lart(str(out)), read_lart(str(ref))
    for k in ('J1', 'Pa', 'Pnew', 'r_JPa'):
        got, want = getattr(r, k), getattr(j, k)
        assert got is not None and got.shape == want.shape, k
        assert np.all(np.isfinite(got)) and float(np.abs(got).sum()) > 0.0
    np.testing.assert_allclose(r.r_JPa, j.r_JPa, rtol=1e-12)
    with open_read(str(out)) as f, open_read(str(ref)) as g:
        for sec in ('Jx_1D', 'Pa_1D', 'Pa_1D_new'):
            assert sorted(f[sec].keys()) == sorted(g[sec].keys()), sec
            assert int(f[sec].attrs['geom_JPa']) == -1
            assert set(g[sec].attrs) <= set(f[sec].attrs), sec
