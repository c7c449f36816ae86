"""The volume and table sources of the port against lart_tpu on the CPU.

Tables: every host builder of physics/sources.py equals lart_tpu's on the
same input to 1e-12 relative (integer arrays exactly): the inverse CDFs
of r exp(-r) and r^2 exp(-r), the deprojected Sersic cumulative for m = 1
and 4, the star file with and without composite bias, the composite bias,
the 1-D emissivity profile spherical and planar, the alias table; the
device tables of build_sources equal lart_tpu's SourceTables (f32, int32)
for every table source.

Births: one plain refill (K2's plain version) of an all-dead batch of 2^16
lanes for each geometry and spectrum against one refill of lart_tpu's on
the same config (its own jax.random draws): the distributions of x, y, z,
r, xfreq and the weight agree by a two-sample KS test (p > 1e-3) and the
weights' means within 3 sigma; every position lies in its support (a
sphere's radius, a cylinder's, the box, the star, the cell or leaf drawn,
up to f32 rounding), and each lane's cells are clip(floor(...)) of its
position exactly.  check_supported names every source it still refuses.

End to end: examples/many_stars/stars1.in (star_file, composite weights,
one observer) cut to a 17^3 cube at tau 10 and 1000 photons through the
port's driver: W_esc + W_oor equals the sum of the birth weights over
nphotons (Jin: every birth falls in the band) to 1e-3, and the peel
image's flux closure 4 pi d^2 F / W_esc is 1 within 3 sigma of its
per-photon spread (testing.PEEL_V_PHOTON).
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from lart_tpu.grid import amr as jamr
from lart_tpu.grid import cartesian as jcart
from lart_tpu.physics import samplers as jsamp
from lart_tpu.physics import sources as jsrc
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import testing
from lart_tpu_torch.grid import amr as tamr
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.physics import samplers as tsamp
from lart_tpu_torch.physics import sources as tsrc
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import refill as trefill
from lart_tpu_torch.transport.state import FFS, init_state, zero_tallies

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
STARS = str(ROOT / 'examples/many_stars/stars_list.txt')
PROFILE = str(ROOT / 'examples/emiss_1D_AlII/AlII_emiss_profile.txt')
N = 1 << 16
RTOL = 1e-12
KS_P = 1e-3


def _close(a, b):
    if b is None:
        assert a is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    if a.dtype.kind in 'iu':
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


@pytest.mark.parametrize('k,rmax', [(1, 3.0), (2, 5.0), (2, 0.7)])
def test_inv_cdf_rexp_matches_lart_tpu(k, rmax):
    for a, b in zip(tsrc.inv_cdf_rexp(k, rmax), jsrc.inv_cdf_rexp(k, rmax)):
        _close(a, b)


@pytest.mark.parametrize('m,rmax', [(1.0, 1.0 / (1.67834607093866 * 0.03)),
                                    (4.0, 3.0)])
def test_sersic_cumulative_matches_lart_tpu(m, rmax):
    got = tsrc.sersic_deprojected_cumulative(m, rmax)
    want = jsrc.sersic_deprojected_cumulative(m, rmax)
    for a, b in zip(got, want):
        _close(a, b)
    assert np.all(np.diff(got[0]) > 0) and got[0][-1] == 1.0


def test_composite_bias_and_alias_table_match_lart_tpu():
    rng = np.random.default_rng(4)
    for n in (7, 1000, 40000):
        prob = rng.exponential(size=n)
        prob[rng.random(n) < 0.3] = 0.0
        for f in (0.1, 0.5):
            for a, b in zip(tsrc._composite_bias(prob, f),
                            jsrc._composite_bias(prob, f)):
                _close(a, b)
        for a, b in zip(tsamp.build_alias_table(prob),
                        jsamp.build_alias_table(prob)):
            _close(a, b)


@pytest.mark.parametrize('method', [0, 1])
def test_read_stars_matches_lart_tpu(method):
    for a, b in zip(tsrc.read_stars(STARS, method, 0.5),
                    jsrc.read_stars(STARS, method, 0.5)):
        _close(a, b)


@pytest.mark.parametrize('spherical,method,xmax', [
    (True, 1, 12.0), (True, 0, 12.0), (False, 1, 12.0), (True, 1, 5.5)])
def test_emiss_profile_matches_lart_tpu(spherical, method, xmax):
    got = tsrc.build_emiss_profile_1d(PROFILE, xmax, spherical, method, 0.3)
    want = jsrc.build_emiss_profile_1d(PROFILE, xmax, spherical, method, 0.3)
    for a, b in zip(got, want):
        _close(a, b)


def _sphere(**over):
    return testing.sphere_params(tau0=10.0, n=17, batch_size=N, **over)


def _amr(**over):
    par = testing.source_params('jellyfish_emiss', ROOT, taumax=10.0,
                                batch_size=N, **over)
    return par, testing.jellyfish_amr()


# name -> (params, AMR leaves or None, the birth weights vary)
CASES = {
    'uniform_sphere': (lambda: _sphere(source_geometry='uniform_sphere',
                                       source_rmax=0.8), None, False),
    'cylinder': (lambda: _sphere(source_geometry='cylinder',
                                 source_rmax=0.6), None, False),
    'uniform': (lambda: _sphere(source_geometry='uniform'), None, False),
    'uniform_xyz_symmetry': (lambda: testing.hubble_params(
        tau0=10.0, n=17, batch_size=N, source_geometry='uniform'), None,
        False),
    'uniform_xy_box': (lambda: _sphere(source_geometry='uniform_xy'), None,
                       False),
    'uniform_xy_disk': (lambda: _sphere(source_geometry='uniform_xy',
                                        source_rmax=0.5), None, False),
    'gaussian': (lambda: _sphere(source_geometry='gaussian',
                                 source_zscale=0.2), None, False),
    'exponential': (lambda: _sphere(source_geometry='exponential',
                                    source_zscale=0.3), None, False),
    'exponential_sphere': (lambda: _sphere(
        source_geometry='exponential_sphere', source_rscale=0.2), None,
        False),
    'sersic4': (lambda: _sphere(source_geometry='sersic', sersic_m=4.0,
                                Reff=0.3), None, False),
    'ssh': (lambda: _sphere(source_geometry='ssh', source_rscale=0.1,
                            velocity_type='ssh', rpeak=0.1, Vpeak=300.0,
                            DeltaV=-50.0, comoving_source=False), None,
            False),
    'star_file': (lambda: _sphere(source_geometry='star_file',
                                  star_file=STARS), None, True),
    'density1': (lambda: _sphere(
        geometry='', source_geometry='diffuse_emissivity',
        emiss_file='density1', velocity_type='ssh', rpeak=0.1,
        Vpeak=300.0, DeltaV=-50.0, density_rscale=0.4), None, True),
    'density2_unbiased': (lambda: _sphere(
        source_geometry='diffuse_emissivity', emiss_file='density2',
        sampling_method=0), None, False),
    'amr_leaves': (_amr, 'amr', True),
    'profile': (lambda: _sphere(source_geometry='diffuse_emissivity',
                                emiss_file=PROFILE, rmax=1.0), None, True),
    'voigt0': (lambda: _sphere(source_geometry='uniform_sphere',
                               spectral_type='voigt0', temperature0=3e4),
               None, False),
    'point_voigt0': (lambda: _sphere(spectral_type='voigt0', voigt_a0=0.01,
                                     Dfreq0=2e11), None, False),
    'continuum_gaussian': (lambda: _sphere(
        source_geometry='uniform_sphere', spectral_type='continuum+gaussian',
        EW_line=5.0, gaussian_FWHM_vel=60.0), None, False),
}


def _setup(name):
    make, amr, weighted = CASES[name]
    made = make()
    par, data = made if amr else (made, None)
    cfg, jcfg = bridge.resolve_both(par)
    hd, jhd = {}, {}
    if data is not None:
        built = tamr.build_amr(cfg, data=data, device='cpu')
        meta, grid = built.meta, built.dev
        hd['emissivity'] = built.emissivity
        jb = jamr.build_amr(jcfg, data=data)
        jmeta, jgrid = jb.meta, jb.dev
        jhd['emissivity'] = jb.emissivity
    else:
        meta, grid = build_cartesian(cfg, host_out=hd)
        jmeta, jgrid = jcart.build_cartesian(jcfg, host_out=jhd)
    return cfg, jcfg, meta, grid, hd, jmeta, jgrid, jhd, weighted


@pytest.mark.parametrize('name', ['star_file', 'density1', 'amr_leaves',
                                  'profile', 'sersic4', 'ssh',
                                  'exponential_sphere'])
def test_device_tables_match_lart_tpu(name):
    cfg, jcfg, meta, _, hd, jmeta, _, jhd, _ = _setup(name)
    got = tsrc.build_sources(cfg, meta, hd, 'cpu')
    want = jsrc.build_sources(jcfg, jmeta, jhd)
    pairs = {'radial': (('p', 'r_p'), ('r', 'r_r')),
             'stars': (('x', 'star_x'), ('y', 'star_y'), ('z', 'star_z'),
                       ('prob', 'star_prob'), ('alias', 'star_alias'),
                       ('wgt', 'star_wgt')),
             'cells': (('prob', 'em_prob'), ('alias', 'em_alias'),
                       ('wgt', 'em_wgt')),
             'profile': (('axis', 'ep_axis'), ('dens', 'ep_prob'),
                         ('prob', 'ep_palias'), ('alias', 'ep_alias'),
                         ('wgt', 'ep_wgt'))}
    pairs['leaves'] = pairs['cells']
    for mine, theirs in pairs[got.kind]:
        a = getattr(got.table, mine) if got.kind == 'radial' \
            else getattr(got, mine)
        b = getattr(want, theirs)
        assert (a is None) == (b is None), mine
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), mine


def _jax_births(jcfg, jmeta, jgrid, jhd, n):
    src = jsrc.build_sources(jcfg, jmeta, jhd)
    refill = jeng.make_refill(jcfg, jmeta)
    s = jeng.init_state(n)._replace(n_launched=jnp.zeros((1,), jnp.int32))
    t = jeng.zero_tallies(jmeta.nxfreq)
    budget = jnp.asarray([[n, 0]], jnp.int32)
    # eagerly: one refill compiles faster op by op than as one program
    with jax.disable_jit():
        s2, _ = refill(s, jgrid, t, jax.random.PRNGKey(11), budget, None,
                       src)
    return s2


def _support(name, cfg, meta, rp, x, y, z):
    """Positions in the support of their source (f32 rounding allowed)."""
    par = cfg.par
    eps = 1e-6
    r = np.sqrt(x * x + y * y + z * z)
    rc = np.hypot(x, y)
    lo = np.array([meta.xmin, meta.ymin, meta.zmin]) - eps
    hi = np.array([meta.xmax, meta.ymax, meta.zmax]) + eps
    pos = np.stack([x, y, z], 1)
    if name in ('uniform_sphere', 'voigt0', 'continuum_gaussian'):
        assert r.max() <= par.source_rmax * (1 + eps)
    elif name in ('exponential_sphere', 'sersic4', 'ssh', 'profile'):
        assert r.max() <= par.source_rmax * (1 + eps)
    elif name in ('cylinder', 'uniform_xy_disk'):
        assert rc.max() <= par.source_rmax * (1 + eps)
    elif name == 'star_file':
        stars = np.loadtxt(STARS)[:, :3].astype(np.float32)
        assert all(np.any(np.all(pos.astype(np.float32) == s_, 1))
                   for s_ in stars)
        assert np.all((pos[:, None, :] == stars[None]).all(2).any(1))
    elif name == 'amr_leaves':
        # each birth in an emitting leaf: the leaf at its position (a face
        # rounded in f32 may hand it to the neighbour)
        il = rp.amr.leaf(rp.amr.find_cell(*(torch.as_tensor(
            v, dtype=torch.float32) for v in (x, y, z)))).numpy()
        em = rp.source.tabs.prob.numpy()
        assert np.all(il >= 0) and np.mean(em[il] > 0) > 1 - 1e-3
    if name in ('uniform_xy_box', 'uniform_xy_disk'):
        assert np.all(z == 0.0)
    if name == 'uniform_xyz_symmetry':
        assert np.all(pos >= 0.0)
    assert np.all((pos >= lo) & (pos <= hi))


@pytest.mark.parametrize('name', list(CASES))
def test_births_match_lart_tpu(name):
    cfg, jcfg, meta, grid, hd, jmeta, jgrid, jhd, weighted = _setup(name)
    rp = trefill.RefillParams.from_config(cfg, meta, grid, host_data=hd)
    s = init_state(N, 'cpu')
    tl = zero_tallies(meta.nxfreq, 0, 'cpu')
    trefill.refill(s, tl, rp, seed=5, counter=3, budget=N)
    assert bool((s.phase == FFS).all())
    js = _jax_births(jcfg, jmeta, jgrid, jhd, N)
    x, y, z = (getattr(s, f).numpy().astype(np.float64) for f in 'xyz')
    _support(name, cfg, meta, rp, x, y, z)
    assert torch.equal(s.bx, s.x) and torch.equal(s.bz, s.z)
    if meta.grid_type == 'amr':
        cell = rp.amr.find_cell(s.x, s.y, s.z)
        assert torch.equal(s.ic, cell) and torch.equal(s.bic, cell)
    else:
        for c, want in zip((s.ic, s.jc, s.kc),
                           testing.cells_of(meta, s.x, s.y, s.z)):
            assert np.array_equal(c.numpy(), want)
    mine = {'x': x, 'y': y, 'z': z, 'r': np.sqrt(x * x + y * y + z * z),
            'xfreq': s.xfreq.numpy(), 'wgt': s.wgt.numpy()}
    jx, jy, jz = (np.asarray(getattr(js, f), np.float64) for f in 'xyz')
    theirs = {'x': jx, 'y': jy, 'z': jz, 'r': np.sqrt(jx * jx + jy * jy
                                                      + jz * jz),
              'xfreq': np.asarray(js.xfreq), 'wgt': np.asarray(js.wgt)}
    for k in mine:
        if np.ptp(theirs[k]) == 0.0:
            assert np.array_equal(mine[k], theirs[k]), k
            continue
        p = stats.ks_2samp(mine[k], theirs[k]).pvalue
        assert p > KS_P, (k, p)
    w1, w2 = mine['wgt'].astype(np.float64), theirs['wgt'].astype(np.float64)
    sig = np.sqrt(w1.var() / N + w2.var() / N)
    assert abs(w1.mean() - w2.mean()) <= 3.0 * sig + 1e-7, (w1.mean(),
                                                              w2.mean())
    assert (w1.std() > 0) == weighted
    # Jin holds the birth weights that fall in the frequency band
    fx = np.floor((np.asarray(mine['xfreq'], np.float64) - meta.xfreq_min)
                  / meta.dxfreq) if meta.static_medium else None
    if fx is not None:
        band = (fx >= 0) & (fx < meta.nxfreq)
        np.testing.assert_allclose(float(tl.Jin.sum()), w1[band].sum(),
                                   rtol=1e-5)


def test_check_supported_names_the_refused_sources():
    ok = ('uniform_sphere', 'sphere', 'uniform_cylinder', 'cylinder',
          'uniform', 'uniform_xy', 'gaussian', 'exponential',
          'exponential_sphere', 'sersic', 'ssh', 'exponential_cylinder',
          'star_file', 'diffuse_emissivity')
    for sg in ok:
        teng.check_supported(testing.sphere_params(
            source_geometry=sg, emiss_file='density1').resolve())
    teng.check_supported(testing.sphere_params(
        source_geometry='diffuse_emissivity', emiss_file='cube.fits'
    ).resolve())
    for st in ('voigt0', 'continuum+gaussian', 'line_prof_file'):
        teng.check_supported(testing.sphere_params(
            spectral_type=st).resolve())
    # the illuminations and a plane atmosphere's 1-D emissivity profile
    # (tests/test_torch_atmosphere.py)
    for over in (dict(source_geometry='plane_illumination'),
                 dict(source_geometry='point_illumination'),
                 dict(source_geometry='stellar_illumination'),
                 dict(source_geometry='diffuse_emissivity', emiss_file=PROFILE,
                      geometry='plane_atmosphere')):
        teng.check_supported(testing.sphere_params(**over).resolve())
    refused = (
        # a 3-D cube is read on a Cartesian grid (io/reader.py), but
        # lart_tpu would read it as the leaves' emissivity on the octree
        (dict(source_geometry='diffuse_emissivity', emiss_file='cube.fits',
              use_amr_grid=True), '3-D FITS/HDF5 emiss_file'),
        (dict(source_geometry='diffuse_emissivity', emiss_file='density2',
              use_amr_grid=True), "'density1'/'density2' on an AMR grid"),
        (dict(source_geometry='diffuse_emissivity', emiss_file='density1',
              use_clump_medium=True), 'clump medium'),
        (dict(source_geometry='ring'), "source_geometry 'ring'"))
    for over, words in refused:
        with pytest.raises(NotImplementedError, match=words):
            teng.check_supported(testing.sphere_params(**over).resolve())


def test_star_file_weights_and_peel_closure():
    n = 1000
    par = testing.source_params('stars1', ROOT, nx=17, ny=17, nz=17,
                                taumax=10.0, nphotons=n, batch_size=2048,
                                nxim=17, nyim=17)
    assert par.sampling_method == 1 and par.geometry.strip() == ''
    res = bridge.run_port_cpu(par, seed=3)
    w_birth = testing.birth_weight(res)
    # composite weights: the budget is the birth weights', not 1
    assert abs(w_birth - 1.0) > 1e-3
    assert abs(res.W_escape + res.W_oor - w_birth) < 1e-3, (
        res.W_escape, res.W_oor, w_birth)
    closure = testing.peel_closure(res)[0]
    assert abs(closure - 1.0) < 3.0 * math.sqrt(testing.PEEL_V_PHOTON / n), \
        closure
