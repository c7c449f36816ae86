"""The all-photons table of the port (save_all_photons; transport/allph.py)
against lart_tpu on the CPU.

(a) The rows: the impact parameter and the birth and death rows of the
port's plain versions against lart_tpu's impact_parameter and
allph_record_death (lart_tpu/transport/engine.py:172-214) on injected
lanes (inside and outside rmax, grazing the rmax sphere, through the
origin, with Stokes), to rtol 1e-6 and atol 1e-6.
(b) The flights, lane by lane: one call of K5's, K8's, K9's and K10's plain
versions and of make_fly / make_fly_amr / make_fly_clump_dense /
make_fly_clump from one state with a table each (every lane its own id):
an escape and a forced first scattering born in vacuum on a sphere with
Stokes, a plane atmosphere's bottom face, a spherical one's masked core,
line type 8's H-alpha band, a sheared box, the AMR sphere, the dense and
the CSR clump flights.  The flights draw no random numbers: the rows match
to rtol 1e-5, atol 1e-6 on all but the lanes the states' comparison lets
differ.
(c) End to end through both drivers (tests/test_allphotons.py's 17^3 tau 2
sphere with 3000 photons, its AMR sphere and its one-clump sphere): every
id written, rp0 0 for the central point source, rp at most sqrt(3) rmax
and its 95% quantile at most rmax, sum nscatt_gas the run's nscatt_events
to 1e-5 (testing.allph_closures); <nscatt_gas> within 5% or 3 sigma of
lart_tpu's and the histograms of xfreq1, xfreq2 and rp by chi2/dof < 3
(testing.hist_chi2).  With Stokes, on a line-centre source in a sphere at
tau 20, where the forced first scatterings leave exp(-20) of the weight,
sum I = W_esc + W_abs + W_oor to 1e-5 (the rows carry the weight after the
forced first scattering).
(d) The AllPhotons section written and read back through the writer and
read_spectrum, in HDF5 and in FITS.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.grid import amr as jamr
from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, driver, testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.grid import clump as tclump
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport import allph as tallph
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport.state import DEAD, FFS

import _torch_jax_bridge as bridge

RTOL = ATOL = 1e-6


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """The plain versions in one torch thread: under Tier-1's workers the
    default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# (a) the rows
# --------------------------------------------------------------------------

def _lanes(n=4096, seed=5):
    """Injected rays: positions inside and outside the unit sphere, a share
    grazing it (k perpendicular to p at |p| just above 1), a share through
    the origin (k along -p: |m| 0), and a share at the origin."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2.0, 2.0, (3, n))
    k = rng.normal(size=(3, n))
    k /= np.linalg.norm(k, axis=0)
    kind = rng.integers(0, 4, n)
    graze = kind == 1
    u = p[:, graze] / np.linalg.norm(p[:, graze], axis=0)
    p[:, graze] = u * (1.0 + rng.uniform(0.0, 1e-3, graze.sum()))
    t = k[:, graze] - (k[:, graze] * u).sum(0) * u
    k[:, graze] = t / np.linalg.norm(t, axis=0)
    radial = kind == 2
    k[:, radial] = -p[:, radial] / np.linalg.norm(p[:, radial], axis=0)
    p[:, kind == 3] = 0.0
    return [torch.as_tensor(v, dtype=torch.float32) for v in (*p, *k)]


def _close(a, b, msg):
    torch.testing.assert_close(torch.tensor(np.asarray(a, np.float32)),
                               torch.tensor(np.asarray(b, np.float32)),
                               rtol=RTOL, atol=ATOL, msg=msg)


@pytest.mark.parametrize('rmax', (0.0, 1.0))
def test_impact_parameter_matches_lart_tpu(rmax):
    lanes = _lanes()
    mm, m = tallph.impact_parameter(rmax, *lanes)
    jm, jv = jax.jit(lambda *a: jeng.impact_parameter(
        types.SimpleNamespace(rmax=rmax), *a))(
            *(jnp.asarray(v.numpy()) for v in lanes))
    _close(mm, jm, 'rp')
    for a, b in zip(m, jv):
        _close(a, b, 'm')
    # through the origin: 0; outside and aimed away: advanced by nothing
    assert float(mm.min()) < 1e-6


@pytest.mark.parametrize('stokes', (False, True))
def test_birth_and_death_rows_match_lart_tpu(stokes):
    """record_births against the refill's rows (engine.py:2890-2899), and
    record_deaths against allph_record_death, on a mixed state of injected
    rays (every second lane masked, a few without an id)."""
    meta, _ = build_cartesian(testing.sphere_params(n=9).resolve())
    s = testing.mixed_state(meta, 4096, seed=7)
    x, y, z, kx, ky, kz = _lanes(4096, seed=8)
    for f, v in zip(('x', 'y', 'z', 'kx', 'ky', 'kz'), (x, y, z, kx, ky, kz)):
        getattr(s, f).copy_(v)
    s.pid[::97] = -1
    mask = torch.arange(4096) % 2 == 0
    xlab = torch.as_tensor(np.random.default_rng(9).normal(0, 5, 4096),
                           dtype=torch.float32)
    n = 5000
    par = types.SimpleNamespace(rmax=1.0)
    t = tallph.zero_allph(n, stokes, 1.0, 'cpu')
    tallph.record_births(t, mask, s.pid, s.x, s.y, s.z, s.kx, s.ky, s.kz,
                         s.xfreq)
    tallph.record_deaths(t, s, ~mask, xlab)

    def ref(js, m, xl):
        ap = jeng.zero_allph(n, stokes)
        idx = jnp.where(m & (js.pid >= 0), js.pid, n)
        mm0, _ = jeng.impact_parameter(par, js.x, js.y, js.z, js.kx, js.ky,
                                       js.kz)
        ap = ap._replace(rp0=ap.rp0.at[idx].set(mm0, mode='drop'),
                         xfreq1=ap.xfreq1.at[idx].set(js.xfreq, mode='drop'))
        return jeng.allph_record_death(par, ap, js, ~m, xl)
    want = bridge.allph_from_jax(jax.jit(ref)(
        bridge.state_to_jax(s), jnp.asarray(mask.numpy()),
        jnp.asarray(xlab.numpy())))
    got = t.to_host()
    assert set(got) == set(want) == set(tallph.FIELDS + (
        tallph.STOKES if stokes else ()))
    for f in got:
        _close(got[f], want[f], f)
    written = (got['xfreq1'] != 0) | (got['xfreq2'] != 0)
    assert written.sum() > 4000


# --------------------------------------------------------------------------
# (b) the flights, lane by lane
# --------------------------------------------------------------------------

def _sphere():
    return testing.sphere_params(n=17, tau0=2.0, use_stokes=True)


def _plane():
    return testing.plane_atmosphere_params(nz=32, taumax=100.0)


def _core():
    return Params(geometry='spherical_atmosphere', nx=17, ny=17, nz=17,
                  xmax=1, ymax=1, zmax=1, rmax=1.0, rmin=0.5, taumax=30.0,
                  temperature=1e4, velocity_type='hubble', Vexp=100.0,
                  xfreq_min=-40.0, xfreq_max=40.0,
                  source_geometry='stellar_illumination',
                  stellar_radius=10.4, distance_star_to_planet=39.8)


CARTESIAN = {
    # escapes, forced first scatterings born in vacuum (the sphere's
    # corners), the Stokes columns
    'sphere_stokes': (_sphere, None, {}),
    'plane_atmosphere': (_plane, None, dict(atmosphere=True)),
    'core_atmosphere': (_core, 1.0, dict(atmosphere=True)),
    'lyb_band2': (lambda: testing.lyb_params(n=9), 1.0, dict(lyb=True)),
    'shear': (testing.shear_params, None, {}),
}


def _rows_agree(st, tab, ref, jtab, frac_max):
    """The lanes that both packages leave alike, and their rows."""
    frac, _ = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= frac_max, frac
    bad = np.zeros(st.batch, bool)
    for f in tab:
        a, b = tab[f], jtab[f]
        bad |= ~np.isclose(a, b, rtol=1e-5, atol=1e-6)
    assert bad.mean() <= frac_max, (bad.mean(), [
        f for f in tab if not np.allclose(tab[f], jtab[f], 1e-5, 1e-6)])
    return frac


@pytest.mark.parametrize('case', sorted(CARTESIAN))
def test_fly_cartesian_death_rows_match_make_fly(case):
    make, r_max, flags = CARTESIAN[case]
    par = make()
    par.save_all_photons = True
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    flight = teng.make_fly(cfg, meta, grid)
    s0 = testing.shear_state(meta, 8192, seed=41) if case == 'shear' \
        else testing.mixed_state(meta, 8192, seed=41, r_max=r_max)
    if case == 'lyb_band2':
        testing.band2_lanes(s0, seed=42)
    st, tab, ref, jtab = bridge.fly_both_allph(
        jeng.make_fly(jcfg, jmeta), jgrid, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps, bool(par.use_stokes), cfg.par.rmax, **flags)
    _rows_agree(st, tab, ref, jtab, 3e-4)
    died = (s0.phase != DEAD) & (st.phase == DEAD)
    assert int(died.sum()) > 200
    ids = st.pid[died].numpy()
    assert np.all(tab['nscatt_gas'][ids] == st.nsg[died].numpy())
    if case == 'sphere_stokes':
        # born in vacuum: dead with weight 0, at the birth lab frequency
        vac = (s0.phase == FFS) & (st.phase == DEAD)
        assert int(vac.sum()) > 20
        assert np.all(tab['I'][st.pid[vac].numpy()] == 0.0)
        assert np.abs(tab['Q'][ids]).sum() > 0.0


def _amr_grids():
    par = testing.amr_params(save_all_photons=True)
    cfg, jcfg = bridge.resolve_both(par)
    jr = jamr.build_amr(jcfg, data=jamr.make_amr_sphere(16, 1))
    meta, dev = convert.amr_from_jax(jr.meta, jr.dev)
    return cfg, jcfg, jr, meta, dev


def test_fly_amr_death_rows_match_make_fly_amr():
    cfg, jcfg, jr, meta, dev = _amr_grids()
    flight = teng.make_fly(cfg, meta, dev)
    s0 = testing.amr_state(meta, flight.amr, 8192, seed=31)
    st, tab, ref, jtab = bridge.fly_both_allph(
        jeng.make_fly_amr(jcfg, jr.meta), jr.dev, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps, False, jcfg.par.rmax)
    _rows_agree(st, tab, ref, jtab, 2e-3)
    assert int(((s0.phase != DEAD) & (st.phase == DEAD)).sum()) > 200


@pytest.mark.parametrize('dense', (True, False))
def test_fly_clump_death_rows_match_lart_tpu(dense):
    par = testing.clump_params(save_all_photons=True,
                               clump_allow_overlap=dense)
    par.clump_dense_max = 1024 if dense else 0
    cfg, jcfg = bridge.resolve_both(par)
    meta, cmeta, dev = tclump.build_clumps(cfg, seed=99, device='cpu')
    jm, jc, jd = bridge.clump_to_jax(meta, cmeta, dev)
    flight = teng.make_fly(cfg, meta, dev, cmeta)
    assert flight.clump.dense == dense
    s0 = testing.clump_state(meta, flight.clump, 8192, seed=31)
    st, tab, ref, jtab = bridge.fly_both_allph(
        jeng.make_fly(jcfg, jm, cmeta=jc), jd, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps, False, jcfg.par.rmax)
    _rows_agree(st, tab, ref, jtab, 2e-3)
    assert int(((s0.phase != DEAD) & (st.phase == DEAD)).sum()) > 200


# --------------------------------------------------------------------------
# (c) end to end through both drivers
# --------------------------------------------------------------------------

def _allph_sphere(**kw):
    return Params(**dict(dict(
        nphotons=3000, geometry='sphere', rmax=1.0, nx=17, ny=17, nz=17,
        xmax=1, ymax=1, zmax=1, taumax=2.0, temperature=1e4,
        xfreq_min=-30.0, xfreq_max=30.0, save_all_photons=True,
        batch_size=1024, chunk_cycles=16), **kw))


def _one_clump(tmp_path):
    path = str(tmp_path / 'one_clump.h5')
    tclump.save_clumps(path, np.zeros((1, 3)), np.array([1.0]), sphere_R=1.0)
    return Params(nphotons=2000, use_clump_medium=True,
                  clump_input_file=path, clump_tau0=5.0, geometry='sphere',
                  rmax=1.0, temperature=1e4, xfreq_min=-30.0,
                  xfreq_max=30.0, save_all_photons=True, batch_size=256,
                  chunk_cycles=8, refill_every=2)


def _amr(tmp_path):
    path = str(tmp_path / 'ap_amr.h5')
    jamr.write_generic_amr(path, jamr.make_amr_sphere(n_base=8,
                                                      levels_extra=1))
    return Params(nphotons=1200, use_amr_grid=True, amr_file=path,
                  geometry='sphere', rmax=1.0, taumax=2.0, temperature=1e4,
                  xfreq_min=-30.0, xfreq_max=30.0, save_all_photons=True,
                  batch_size=256, chunk_cycles=8, refill_every=2)


RUNS = {'sphere': lambda tmp: _allph_sphere(), 'amr': _amr,
        'one_clump': _one_clump}


@pytest.mark.parametrize('case', sorted(RUNS))
def test_driver_tables_against_lart_tpu(case, tmp_path):
    pytest.importorskip('h5py')
    from lart_tpu import driver as jdriver
    par = RUNS[case](tmp_path)
    res = driver.run(par, device='cpu', seed=3)
    jpar = bridge.jax_params(par)
    jpar.batch_size = 4096
    jres = jdriver.run(jpar, seed=5)
    edges = testing.allph_edges(res.meta.xfreq_min, res.meta.xfreq_max,
                                par.rmax)
    got = testing.allph_summary(res.allph, edges)
    want = testing.allph_summary(jres.allph, edges)
    for r, summ in ((res, got), (jres, want)):
        for k, (v, lim) in testing.allph_closures(r, summ).items():
            assert v <= lim, (case, k, v, lim)
    sig = math.hypot(got['N_spread'] / math.sqrt(got['n']),
                     want['N_spread'] / math.sqrt(want['n']))
    assert abs(got['N'] - want['N']) <= max(0.05 * want['N'], 3.0 * sig)
    for k in edges:
        chi, dof = testing.hist_chi2(got['hist'][k], want['hist'][k])
        assert dof >= 3 and chi < 3.0, (case, k, chi, dof)


def test_stokes_rows_carry_the_budget():
    """A line-centre source in a sphere at tau 20 with Stokes: the forced
    first scatterings leave exp(-20) of the weight, so the rows' weights
    sum to W_esc + W_abs + W_oor, and the Stokes columns are finite and
    written."""
    par = _allph_sphere(nphotons=1500, taumax=20.0, use_stokes=True,
                        spectral_type='monochromatic')
    res = driver.run(par, device='cpu', seed=4)
    ap = res.allph
    w = (res.W_escape + res.W_absorb + res.W_oor) * res.nphotons
    assert abs(ap['I'].sum() - w) <= 1e-5 * w
    assert all(np.isfinite(ap[k]).all() for k in tallph.STOKES)
    assert np.abs(ap['Q']).sum() > 0.0 and np.abs(ap['U']).sum() > 0.0


# --------------------------------------------------------------------------
# (d) the AllPhotons section
# --------------------------------------------------------------------------

@pytest.mark.parametrize('fmt', ('hdf5', 'fits'))
def test_allphotons_section_round_trip(fmt, tmp_path):
    if fmt == 'hdf5':
        pytest.importorskip('h5py')
    from lart_tpu_torch.io.writer import read_spectrum, write_output
    par = _allph_sphere(nphotons=300, use_stokes=True, file_format=fmt)
    res = driver.run(par, device='cpu', seed=6)
    path = str(tmp_path / ('out.h5' if fmt == 'hdf5' else 'out.fits'))
    write_output(path, res)
    ap = read_spectrum(path)['allph']
    assert set(ap) == set(tallph.FIELDS + tallph.STOKES)
    for k, v in ap.items():
        assert v.dtype == np.float32 and v.shape == (300,)
        assert np.array_equal(v, res.allph[k].astype(np.float32)), k
    par.save_all_photons = False
    plain = driver.run(par, device='cpu', seed=6)
    write_output(path, plain)
    assert read_spectrum(path)['allph'] is None
