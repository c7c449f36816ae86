"""The per-cell temperature and the 3-D grid files of lart_tpu_torch against
lart_tpu on the CPU.

- The reader (io/reader.py): read_3d_any / read_velocity_any equal
  lart_tpu's exactly on HDF5 files (a cube in a nested group, velocity
  cubes stored (z, y, x, 3) and (3, z, y, x)).  lart_tpu reads FITS through
  astropy, which is not installed here: the port's FITS read of cubes that
  lart_tpu's minifits writes (plain and gzip, 3-D and 4-D) must equal the
  array written and the HDF5 read of the same array.
- The cube builders: testing.turb_cube and testing.prochaska_dens equal the
  arrays of examples/FeII_turb/mk_turb_cube.py and examples/Prochaska/
  mk_model.py (read back from the file it writes).
- solar_ion_density (grid/ion_data.py) equals lart_tpu's exactly.
- The grid: build_cartesian from HDF5 temperature, density and velocity
  cubes gives lart_tpu's Dfreq, voigt_a, rhokap and vfx, bit for bit.
- On a 17^3 sphere whose temperature is log-uniform between 1e3 and 1e5 K
  cell by cell (testing.temperature_cube: every crossing changes the
  Doppler width by up to 10x), static and in a Hubble flow, for line types
  1 and 2 and with H2: K5's plain walk against make_fly lane by lane
  (integer fields equal, floats to rtol 1e-5 on all but FRAC = 3e-4 of the
  lanes, PR 8's tolerance for the AMR walk, the tallies to 1e-5 of their
  sum); K4's plain scatter against make_scatter by the share of lanes that
  scattered (within 0.01) and two-sample KS tests (p > P_MIN) on the new
  frequency and the turn; its local core-skip threshold against
  make_scatter's local_xcrit lane by lane (rtol 1e-6 plus what an f32 ulp
  of a position does to dl, the distance to the nearest face: xc ~
  dl^(1/3)); K2's births against make_refill (the point
  source in its cell and a uniform_sphere source, each birth at its own
  cell's a and D): KS on the birth frequency and Jin bin by bin to
  Poisson noise; K7's sightline per pair against make_peel's tau_to_edge
  (1e-5) and its cubes to 1e-5 of their sum; K11's maps per ray against
  make_sightline (1e-5).
- The octree's leaves at their own temperature (jellyfish_pt's 8e3 / 3e5 K
  leaves) in the kMulti and kH2 instances of K8: the plain walk against
  make_fly_amr lane by lane (PR 8's tolerance), Jout bin by bin but for
  the few escapes that sit within an ulp of a bin edge (one lane's weight
  in the neighbouring bin).
- check_supported accepts AlII_ex.in, the FeII_turb and the Prochaska
  examples, and still refuses star_planet/*.in by name.
"""

import glob
import importlib.util
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from lart_tpu.grid import amr as jamr
from lart_tpu.grid import cartesian as jcart
from lart_tpu.grid import ion_data as jion
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import peel as jpeel
from lart_tpu.instruments import sightline as jsl
from lart_tpu.io import minifits as jfits
from lart_tpu.io import reader as jreader
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.grid import ion_data as tion
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.instruments import peel as tpeel
from lart_tpu_torch.instruments import sightline as tsl
from lart_tpu_torch.io import reader as treader
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import refill as trefill
from lart_tpu_torch.transport import scatter as tscatter
from lart_tpu_torch.transport.fly_amr import AmrFlight
from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
from lart_tpu_torch.transport.state import (AT_SCATTER, DEAD, FFS, FLYING,
                                            INT_FIELDS, init_state,
                                            zero_tallies)

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]
N = 17
B = 16_000
FRAC = 3e-4
P_MIN = 1e-3
MG = dict(line_id='MgII_2796', wavelength_min=2790.0, wavelength_max=2810.0,
          nwavelength=200, save_Jmu=False)
H2 = dict(h2_model='neufeld', f_H2=0.03, h2_temperature=8000.0,
          xfreq_min=-12.0, xfreq_max=12.0, nxfreq=241, save_Jmu=False)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """The plain versions in one torch thread (under Tier-1's workers the
    default pool oversubscribes the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def tcube(tmp_path_factory):
    """The 17^3 temperature cube, 1e3-1e5 K, as an HDF5 file."""
    d = tmp_path_factory.mktemp('tcube')
    return testing.write_cube(d / 'T17.h5', testing.temperature_cube(N, 3))


def _case(kind, cube, **kw):
    """The T-cube sphere of one kind: static (escape on every face) or
    hubble (Vexp 200 km/s, reflect), line type 1 ('lya'), the Mg II doublet
    ('mg') or Ly-alpha with H2 ('h2')."""
    motion, line = kind.split('_')
    extra = {'lya': {}, 'mg': MG, 'h2': H2}[line]
    if motion == 'static':
        return testing.sphere_params(tau0=100.0, n=N, temp_file=cube,
                                     force_generic_kernel=True,
                                     **extra, **kw)
    return testing.hubble_params(tau0=100.0, n=N, temp_file=cube, **extra,
                                 **kw)


def _grids(par):
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    assert not meta.uniform_temperature
    return cfg, jcfg, meta, grid, jmeta, jgrid


# --------------------------------------------------------------------------
# the reader, the cube builders, the ion densities, the grid
# --------------------------------------------------------------------------

def test_reader_hdf5_matches_lart_tpu(tmp_path):
    rng = np.random.default_rng(1)
    cube = rng.random((5, 6, 7))                       # stored (z, y, x)
    v_last = rng.normal(size=(5, 6, 7, 3))             # (z, y, x, 3)
    v_first = rng.normal(size=(3, 5, 6, 7))            # (3, z, y, x)
    p3, pl, pf = (str(tmp_path / n) for n in ('c.h5', 'vl.h5', 'vf.hdf5'))
    with h5py.File(p3, 'w') as f:
        f.create_group('grid').create_dataset('rho', data=cube)
    for path, v in ((pl, v_last), (pf, v_first)):
        with h5py.File(path, 'w') as f:
            f.create_dataset('scalar', data=np.zeros(3))
            f.create_dataset('velocity', data=v)
    got = treader.read_3d_any(p3)
    assert got.shape == (7, 6, 5) and got.dtype == np.float64
    assert np.array_equal(got, jreader.read_3d_any(p3))
    for path in (pl, pf):
        got = treader.read_velocity_any(path)
        assert got.shape == (7, 6, 5, 3)
        assert np.array_equal(got, jreader.read_velocity_any(path))
    assert np.array_equal(treader.read_velocity_any(pl)[2, 1, 4],
                          v_last[4, 1, 2])
    assert np.array_equal(treader.read_velocity_any(pf)[2, 1, 4],
                          v_first[:, 4, 1, 2])


@pytest.mark.parametrize('ext', ['fits', 'fits.gz'])
def test_reader_fits_reads_what_minifits_writes(tmp_path, ext):
    rng = np.random.default_rng(2)
    cube = rng.random((5, 6, 7)).astype(np.float32)    # (z, y, x)
    v_last = rng.normal(size=(5, 6, 7, 3))
    v_first = rng.normal(size=(3, 5, 6, 7)).astype(np.float32)
    paths = {}
    for name, arr in (('c', cube), ('vl', v_last), ('vf', v_first)):
        paths[name] = str(tmp_path / f'{name}.{ext}')
        jfits.write_hdus(paths[name], [jfits.HDU(data=arr)])
        with h5py.File(str(tmp_path / f'{name}.h5'), 'w') as f:
            f.create_dataset('d', data=arr)
    got = treader.read_3d_any(paths['c'])
    assert np.array_equal(got, cube.T.astype(np.float64))
    assert np.array_equal(got, treader.read_3d_any(str(tmp_path / 'c.h5')))
    for name, want in (('vl', np.transpose(v_last, (2, 1, 0, 3))),
                       ('vf', np.transpose(v_first, (3, 2, 1, 0)))):
        got = treader.read_velocity_any(paths[name])
        assert np.array_equal(got, want.astype(np.float64))
        assert np.array_equal(got, treader.read_velocity_any(
            str(tmp_path / f'{name}.h5')))
    with pytest.raises(ValueError, match='4-D'):
        treader.read_velocity_any(paths['c'])


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cube_builders_equal_the_example_scripts(tmp_path):
    mk = _load('examples/FeII_turb/mk_turb_cube.py', 'mk_turb_cube')
    assert np.array_equal(testing.turb_cube(), mk.make_cube())
    mp = _load('examples/Prochaska/mk_model.py', 'mk_model')
    path = str(tmp_path / 'MgII_a_dens.fits.gz')
    mp.make_dens(path, n=40)
    got = treader.read_3d_any(path)
    want = testing.prochaska_dens(n=40)
    assert np.array_equal(got, want.astype(np.float64))
    assert want.max() > 0.0 and want[20, 20, 20] == 0.0


def test_solar_ion_density_equals_lart_tpu():
    rng = np.random.default_rng(3)
    nH = 10.0 ** rng.uniform(-4, 2, 1000)
    Z = 10.0 ** rng.uniform(-2, 0.5, 1000) * 0.0134
    T = 10.0 ** rng.uniform(0.5, 7, 1000)
    ions = ('H I', 'H  I', 'H+D', 'He I', 'C II', 'C IV', 'N V', 'O VI',
            'Na I', 'Mg II', 'Al II', 'Si II', 'Si IV', 'Ca II', 'Fe II',
            'X IX')
    for ion in ions:
        got = tion.solar_ion_density(nH, Z, T, ion)
        assert np.array_equal(got, jion.solar_ion_density(nH, Z, T, ion))
    assert np.array_equal(tion.cie_xHI(T), jion.cie_xHI(T))


def test_grid_from_temperature_density_and_velocity_cubes(tmp_path, tcube):
    rng = np.random.default_rng(4)
    dens = testing.write_cube(tmp_path / 'rho.h5',
                              rng.lognormal(0.0, 1.0, (N, N, N)))
    velo = testing.write_cube(tmp_path / 'v.h5',
                              rng.normal(0.0, 30.0, (N, N, N, 3)))
    par = testing.sphere_params(tau0=100.0, n=N, temp_file=tcube,
                                dens_file=dens, velo_file=velo, **MG)
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(par)
    assert not meta.static_medium
    for f in ('Dfreq', 'voigt_a', 'rhokap', 'vfx', 'vfy', 'vfz'):
        a = getattr(grid, f).numpy()
        assert np.array_equal(a, np.asarray(getattr(jgrid, f))), f
    for f in ('Dfreq_ref', 'voigt_a_ref', 'taumax', 'tauhomo', 'xfreq_min',
              'dxfreq', 'xcrit', 'uniform_temperature', 'static_medium'):
        assert getattr(meta, f) == getattr(jmeta, f), f
    # the Doppler width spans the cube's sqrt(1e5 / 1e3) = 10x
    assert float(grid.Dfreq.max() / grid.Dfreq.min()) > 5.0


# --------------------------------------------------------------------------
# K5, K4, K2, K7, K11 on the T cube
# --------------------------------------------------------------------------

FLY_KINDS = ('static_lya', 'hubble_lya', 'static_mg', 'hubble_mg',
             'static_h2', 'hubble_h2')


@pytest.mark.parametrize('kind', FLY_KINDS)
def test_fly_cartesian_on_the_temperature_cube(kind, tcube):
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(_case(kind, tcube))
    flight = teng.make_fly(cfg, meta, grid)
    assert isinstance(flight, CartesianFlight)
    assert flight.cell_D is not None
    s0 = testing.mixed_state(meta, B, seed=31)
    st, tl, ref, ref_t = bridge.fly_both(
        jeng.make_fly(jcfg, jmeta), jgrid, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps)
    for f in INT_FIELDS:
        assert torch.equal(getattr(st, f), getattr(ref, f)), f
    frac, err = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= FRAC, (kind, frac)
    bridge.assert_tallies_close(tl, ref_t)
    # a static medium at non-uniform T: a lane that crossed a cell changed
    # its comoving frequency
    kept = (s0.phase == FLYING) & (st.phase != DEAD)
    moved = kept & ((st.ic != s0.ic) | (st.jc != s0.jc) | (st.kc != s0.kc))
    assert int(moved.sum()) > 100
    assert not torch.equal(st.xfreq[moved], s0.xfreq[moved])
    assert int((st.phase == AT_SCATTER).sum()) > \
        int((s0.phase == AT_SCATTER).sum())
    assert float(tl.Jout.sum()) > 0.0


def _scatter_both(par, B_=20_000, seed=3):
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(par)
    p = teng.make_chunk(cfg, meta, grid).scatter_params
    assert p.cell_D is not None
    s0 = testing.line_state(meta, B_, 5, [0.0, -pline_dHK(p)])
    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 0, 'cpu', h2=p.h2 is not None)
    tscatter.scatter(st, tl, p, seed=seed, counter=9)
    js, _ = jax.jit(jeng.make_scatter(jcfg, jmeta))(
        bridge.state_to_jax(s0), jgrid, jeng.zero_tallies(meta.nxfreq),
        jax.random.PRNGKey(11))
    return p, s0, st, convert.state_from_jax(js)


def pline_dHK(p):
    """The doublet's offset at the reference width (0 for other lines)."""
    from lart_tpu_torch.physics import line as pline
    return pline.line_prof(p.line, p.a, p.Dfreq).dx[1]


@pytest.mark.parametrize('kind', ['static_lya', 'hubble_mg', 'static_h2'])
def test_scatter_on_the_temperature_cube(kind, tcube):
    p, s0, st, ref = _scatter_both(_case(kind, tcube))
    out = {}
    for name, o in (('port', st), ('lart_tpu', ref)):
        done = o.phase == FLYING
        out[name] = {
            'done': float(done.float().mean()),
            'xfreq': o.xfreq[done], 'dx': (o.xfreq - s0.xfreq)[done],
            "cos(k, k')": (o.kx * s0.kx + o.ky * s0.ky + o.kz * s0.kz)[done]}
    t, j = out['port'], out['lart_tpu']
    assert t['done'] > 0.5 and abs(t['done'] - j['done']) < 0.01, (t, j)
    for k, v in t.items():
        if isinstance(v, torch.Tensor):
            pv = ks_2samp(v.numpy(), j[k].numpy()).pvalue
            assert pv > P_MIN, (kind, k, pv)


def _closure(fn, name):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))[name]


def test_local_xcrit_on_the_temperature_cube(tcube):
    """The cell-local core-skip threshold cbrt(a rk dl) / 5 with each
    cell's own a (engine.py:1896), at tau0 1e6."""
    par = _case('static_lya', tcube, core_skip=True)
    par.taumax = 1e6
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(par)
    p = tscatter.ScatterParams.from_config(cfg, meta, grid)
    assert p.core_skip == tscatter.CORE_SKIP_LOCAL
    s = testing.mixed_state(meta, 8192, seed=41, phases=(AT_SCATTER,))
    xc, xc2 = tscatter.local_xcrit(s, p)
    jl = _closure(jeng.make_scatter(jcfg, jmeta), 'local_xcrit')
    jxc, jxc2 = (torch.as_tensor(np.array(v)) for v in jax.jit(jl)(
        jgrid, bridge.state_to_jax(s)))
    # dl, the distance to the nearest face, is a difference of two f32
    # positions: an ulp of either (2^-23 |x|, the packages round the face
    # differently) moves it by that much, and xc ~ dl^(1/3) by a third of
    # it relative; beyond that, 1e-6
    dl = None
    for pos, c, amin, d in zip((s.x, s.y, s.z), (s.ic, s.jc, s.kc),
                               (meta.xmin, meta.ymin, meta.zmin),
                               (meta.dx, meta.dy, meta.dz)):
        f = amin + c.double() * d
        dla = torch.minimum(pos.double() - f, f + d - pos.double())
        dl = dla if dl is None else torch.minimum(dl, dla)
    ulp = 2.0 ** -23 * torch.clamp_min(
        torch.stack([s.x.abs(), s.y.abs(), s.z.abs()]).max(0).values, 1.0)
    rel = 1e-6 + 2.0 * ulp / (3.0 * torch.clamp_min(dl, 1e-30))
    assert bool(((xc - jxc).abs() <= rel * jxc).all())
    assert bool(((xc2 - jxc2).abs() <= 2.0 * rel * jxc2).all())
    exact = float((xc == jxc).float().mean())
    assert exact > 0.5, exact
    assert int((xc > 0).sum()) > 1000
    # each cell's own a: the thresholds are not one function of rk dl
    a_of = p.cell_a[p.flat(s)]
    assert float(a_of.max() / a_of.min()) > 5.0


@pytest.mark.parametrize('geometry,line', [('point', 'lya'),
                                           ('uniform_sphere', 'lya'),
                                           ('uniform_sphere', 'mg')])
def test_births_on_the_temperature_cube(geometry, line, tcube):
    Bn = 30_000
    par = _case(f'static_{line}', tcube, source_geometry=geometry,
                source_rmax=0.8)
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(par)
    rp = teng.make_chunk(cfg, meta, grid).refill_params
    assert rp.cell_D is not None
    st = init_state(Bn, 'cpu')
    tl = zero_tallies(meta.nxfreq, 0, 'cpu')
    trefill.refill(st, tl, rp, 3, 0, 10 ** 9)
    js, jt = jax.jit(jeng.make_refill(jcfg, jmeta))(
        jeng.init_state(Bn), jgrid, jeng.zero_tallies(meta.nxfreq, nmu=0),
        jax.random.PRNGKey(4), jnp.asarray([10 ** 9], jnp.int32))
    assert bool((st.phase == FFS).all())
    if geometry == 'point':
        # the source cell's a and D, the ones lart_tpu gathers
        f = rp.ic * N * N + rp.jc * N + rp.kc
        assert rp.a == float(grid.voigt_a.reshape(-1)[f])
        assert rp.D_src == float(grid.Dfreq.reshape(-1)[f])
    else:
        assert len(torch.unique(st.ic * N * N + st.jc * N + st.kc)) > 100
    xt, xj = st.xfreq.numpy(), np.asarray(js.xfreq)
    assert ks_2samp(xt, xj).pvalue > P_MIN
    a, b = tl.Jin.numpy(), np.asarray(jt.Jin)
    assert a.sum() == pytest.approx(Bn, rel=2e-3)
    assert b.sum() == pytest.approx(Bn, rel=2e-3)
    sel = (a + b) > 0
    assert np.sum((a[sel] - b[sel]) ** 2 / (a[sel] + b[sel])) / sel.sum() < 3


PEEL_OBS = dict(save_peeloff=True, nobs=2, nxim=17, nyim=17, dxim=0.15,
                dyim=0.15, distance=1e2, alpha=(0.0, 40.0), beta=(0.0, 30.0))


@pytest.mark.parametrize('kind', ['static_lya', 'hubble_mg'])
def test_peel_on_the_temperature_cube(kind, tcube):
    """K7's sightline per pair against make_peel's tau_to_edge, and the
    resonance cubes (lanes whose lab frequency sits within 1e-6 of a bin
    edge, or whose pair misses the tau tolerance, left out)."""
    par = _case(kind, tcube, **PEEL_OBS)
    par.use_stokes = False
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(par)
    p = teng.make_chunk(cfg, meta, grid).peel
    assert p.grid.cell_D is not None and not p.chord
    jobs_meta, jodev = jobs.build_observers(jcfg)
    pd, pr, _, _ = jpeel.make_peel(jcfg, jmeta, jobs_meta)
    jtau = jax.jit(_closure(pd, 'tau_to_edge'), static_argnums=12)
    max_steps = _closure(pd, 'max_steps')
    s = testing.mixed_state(meta, 4096, seed=61, r_max=1.0)
    rec = testing.peel_record(s, seed=62, line=p.grid.line)
    cell = (s.ic, s.jc, s.kc)
    bad = torch.zeros(s.batch, dtype=torch.bool)
    n_off = n = 0
    for o in range(p.nobs):
        pk, _, _, in_img = tpeel.obs_geometry(p, o, s.x, s.y, s.z)
        xf = tpeel.event_frequency(p, tpeel.RESONANCE, s, rec, pk)[0]
        t = tpeel.tau_to_edge(p, (s.x, s.y, s.z), cell, pk, xf, in_img)
        j = jtau(jgrid, *(jnp.asarray(v.numpy()) for v in (
            s.x, s.y, s.z, *cell, *pk, xf, in_img)), max_steps)
        t = torch.clamp_max(t, tpeel.TAU_STOP)
        j = torch.clamp_max(torch.as_tensor(np.array(j)), tpeel.TAU_STOP)
        off = in_img & ((t - j).abs() > 1e-6 + 1e-5 * j.abs())
        g = p.grid
        xr = (xf.double() + (g.vel_dot(cell, *pk).double() if g.moving
                             else 0.0)) \
            * (tpeel.cell_D(p, cell).double() / g.Dfreq)
        cf = (xr - g.xfreq_min) / g.dxfreq
        edge = in_img & ((cf - torch.round(cf)).abs() * g.dxfreq
                         < 1e-6 * torch.clamp_min(xr.abs(), 1.0))
        bad |= off | edge
        n_off += int(off.sum())
        n += int(in_img.sum())
        assert float(t[in_img].max()) > 1.0
    assert n > 0.2 * p.nobs * s.batch
    assert n_off <= 1e-3 * n, (n_off, n)
    rec.flag.copy_((~bad).to(torch.int32) * tpeel.RESONANCE)
    cubes = p.zero_cubes('cpu')
    tpeel.peel(s, cubes, rec, p, tpeel.RESONANCE)
    line = jcfg.line
    ev = {k: jnp.full((s.batch,), v, jnp.float32)
          for k, v in (('E1', line.E1), ('E2', line.E2), ('E3', line.E3))}
    if p.grid.line.per_lane_E:
        ev = {k: jnp.asarray(getattr(rec, k).numpy())
              for k in ('E1', 'E2', 'E3')}
    ref = jax.jit(lambda c, gr, od, st, a, xa, ux, uy, uz: pr(
        c, gr, od, dict(ev, state=st), a, xa, ux, uy, uz))(
        jpeel.zero_cubes(jcfg, jmeta, jobs_meta), jgrid, jodev,
        bridge.state_to_jax(s), jnp.asarray((~bad).numpy()),
        *(jnp.asarray(getattr(rec, f).numpy())
          for f in ('xatom', 'ux', 'uy', 'uz')))
    want = torch.as_tensor(np.asarray(ref.scatt))
    torch.testing.assert_close(cubes.scatt, want, rtol=0,
                               atol=1e-5 * float(want.abs().sum()))
    assert float(cubes.scatt.sum()) > 0.0


@pytest.mark.parametrize('kind', ['static_lya', 'hubble_mg'])
def test_sightline_maps_on_the_temperature_cube(kind, tcube):
    par = _case(kind, tcube, save_peeloff=True, nobs=1, distance=50.0,
                alpha=(30.0,), beta=(60.0,), nxim=17, nyim=17)
    par.nxfreq = 11 if kind.endswith('lya') else par.nxfreq
    if kind.endswith('mg'):
        par.nwavelength = 11
    par.xyz_symmetry = False
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(par)
    sl = tsl.Sightline.from_config(cfg, meta, grid)
    assert sl.comoving
    got = tsl.maps(sl, tsl.sightline(sl), 0)
    jobs_meta, jodev = jobs.build_observers(jcfg)
    want = jsl.make_sightline(jcfg, jmeta, jobs_meta)(jgrid, jodev, 0)
    for name in ('tau_gas', 'N_gas', 'tau_dust'):
        a = np.asarray(got[name], np.float64)
        b = np.asarray(want[name], np.float64)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        tol = 1e-5 * np.abs(b) + 1e-6 * max(np.abs(b).max(), 1e-30)
        off = np.abs(a - b) > tol
        assert off.sum() <= 1e-3 * a.size, (kind, name, int(off.sum()),
                                            float(np.abs(a - b).max()))
    assert np.asarray(got['tau_gas']).max() > 1.0


# --------------------------------------------------------------------------
# the AMR leaves at their own temperature in the kMulti and kH2 instances
# --------------------------------------------------------------------------

def _jelly(**kw):
    par = Params.from_namelist(
        str(ROOT / 'examples/jellyfish_rmhd/jellyfish_pt.in'))
    par.taumax = 100.0
    for k, v in kw.items():
        setattr(par, k, v)
    return par


@pytest.mark.parametrize('line', ['mg', 'h2'])
def test_fly_amr_leaves_at_their_temperature(line):
    over = dict(MG) if line == 'mg' else dict(H2)
    over.pop('save_Jmu')
    par = _jelly(**over)
    cfg, jcfg = bridge.resolve_both(par)
    teng.check_supported(cfg)
    jr = jamr.build_amr(jcfg, data=testing.jellyfish_amr())
    meta, dev = convert.amr_from_jax(jr.meta, jr.dev)
    assert not meta.uniform_temperature
    flight = teng.make_fly(cfg, meta, dev)
    assert isinstance(flight, AmrFlight)
    assert (flight.line.line_type == 2) == (line == 'mg')
    assert (flight.h2 is not None) == (line == 'h2')
    s0 = testing.amr_state(meta, flight.amr, B, seed=31)
    st, tl, ref, ref_t = bridge.fly_both(
        jeng.make_fly_amr(jcfg, jr.meta), jr.dev, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps)
    for f in INT_FIELDS:
        assert torch.equal(getattr(st, f), getattr(ref, f)), f
    frac, err = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= FRAC, frac
    _tallies_close_but_edge_moves(tl, ref_t, int(FRAC * B))
    kept = (s0.phase == FLYING) & (st.phase != DEAD)
    assert not torch.equal(st.xfreq[kept], s0.xfreq[kept])


def _tallies_close_but_edge_moves(tl, ref, max_moves, rel=1e-5):
    """W_oor and the sums of Jout to `rel`, and Jout bin by bin to `rel`
    of its sum but for at most max_moves escapes whose lab frequency lies
    on a bin edge, within an ulp: each such lane's weight sits in one of
    two adjacent bins (in opposite directions in the two packages)."""
    a, b = tl.Jout.double(), ref.Jout.double()
    atol = rel * max(float(b.abs().sum()), 1.0)
    assert abs(float(a.sum() - b.sum())) <= atol
    assert abs(float(tl.W_oor) - float(ref.W_oor)) <= rel * max(
        abs(float(ref.W_oor)), 1.0)
    d = (a - b).numpy()
    off = np.flatnonzero(np.abs(d) > atol)
    moves = 0
    i = 0
    while i < len(off):
        j = off[i]
        assert i + 1 < len(off) and off[i + 1] == j + 1 \
            and abs(d[j] + d[j + 1]) <= atol, (j, d[off])
        moves += 1
        i += 2
    assert moves <= max_moves, moves


# --------------------------------------------------------------------------
# what check_supported accepts
# --------------------------------------------------------------------------

def test_check_supported_accepts_the_temperature_examples():
    names = (['emiss_1D_AlII/AlII_ex.in']
             + sorted(glob.glob('FeII_turb/*.in', root_dir=ROOT / 'examples'))
             + sorted(glob.glob('Prochaska/*.in', root_dir=ROOT / 'examples')))
    assert len(names) == 12
    for rel in names:
        teng.check_supported(
            Params.from_namelist(str(ROOT / 'examples' / rel)).resolve())
    # the star_planet examples' atmosphere, stellar illumination, stellar
    # peel and line_prof_file are ported too (tests/test_torch_atmosphere.py)
    for path in sorted((ROOT / 'examples/star_planet').glob('*.in')):
        teng.check_supported(Params.from_namelist(str(path)).resolve())
    # a 3-D emissivity cube on the octree: lart_tpu would read it as leaves
    par = testing.amr_params(16, 1, source_geometry='diffuse_emissivity',
                             emiss_file='emiss.fits')
    with pytest.raises(NotImplementedError, match='emiss_file on an AMR'):
        teng.check_supported(par.resolve())
