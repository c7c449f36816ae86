"""Exoplanet atmospheres and the illumination sources of the port against
lart_tpu on the CPU.

Tables: read_line_prof and the line_prof_file spectrum's device tables
(physics/sources.py LineProfTable) equal lart_tpu's read_line_prof and
SourceTables' lp_prob, lp_alias, lp_edges, for a wavelength file
(examples/star_planet/line_profile.txt, type 1) and a frequency file
written by numpy (type 0): the host arrays to 1e-12, the f32 and int32
device tables exactly.

Samplers, lane by lane: sample_limb_cost, sample_stellar_illumination and
sample_point_illumination of the port take their uniforms as tensors;
lart_tpu's draw them with jax.random.uniform, which a monkeypatch hands the
same numpy uniforms in call order (no file of lart_tpu changes).  The
acceptance of a round and nrejected are identical but on lanes whose test
lies within 1e-6 of its edge in one of the rounds they drew (computed in
float64 from the same f32 uniforms: the stellar sampler's discriminant
relative to (r.k)^2 and the limb angle's cosine, the point sampler's wall
coordinates relative to the box, the limb test relative to its envelope):
f32 rounding, and XLA's fused multiply-adds where the port rounds each
operation, can flip those.  At most 1e-4 of the lanes may differ.  On the
others the directions and weights agree to 1e-5, the positions to 1e-5 D
(the distance to the star).

Births: one plain refill of 2^16 dead lanes (K2's plain version) against
one lart_tpu refill of the same config: the distributions of position,
direction, xfreq and weight by two-sample KS (p > 1e-3), the means of the
flux factor and nrejected within 3 sigma (the port's per-lane spread),
for stellar (with line_prof_file), point and plane illumination (both
atmospheres) and a plane atmosphere's 1-D emissivity profile.

Flights: K5's plain version against lart_tpu's make_fly on the same
injected state (testing.mixed_state, FFS lanes among them): a plane
atmosphere (its bottom face destroys), a spherical one with a masked core
in a Hubble flow, and star_planet_a090.in cut to 33^3 (its 1-D
temperature and velocity profiles): phases and positions lane by lane,
Jout, W_oor and Jabs2 to 1e-5 of their sums.

Peel: K7's plain version against make_peel's closures: peel_direct and
peel_resonance through a masked core (the sightline opaque), and
peel_direct_stellar on a Cartesian and an AMR grid with the same (cos
theta, vphi) handed to both (limb model 0: cos theta is the uniform
itself), its cubes Direct and Direct0 to 1e-5 of their sums, the pairs
on a pixel or frequency-bin edge left out as in test_torch_peel.py.

check_supported accepts the atmosphere and every star_planet example, the
shearing box and CALCJ/P there, and still names save_all_photons; Ly-beta
with an atmosphere is refused by the config, as lart_tpu's.
"""

import glob
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from lart_tpu.grid import amr as jamr
from lart_tpu.grid import cartesian as jcart
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import peel as jpeel
from lart_tpu.physics import sources as jsrc
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.constants import SPEEDC
from lart_tpu_torch.grid import amr as tamr
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.instruments import peel as tpeel
from lart_tpu_torch.physics import sources as tsrc
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import refill as trefill
from lart_tpu_torch.transport.state import (FFS, INT_FIELDS, init_state,
                                            zero_tallies)

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]
LINE_PROF = str(ROOT / 'examples/star_planet/line_profile.txt')
DENS_PROF = str(ROOT / 'examples/star_planet/dens_profile.txt')
N = 1 << 16
KS_P = 1e-3
EDGE = 1e-6
MAX_DIFF = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The plain versions in one thread (the other test workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feed(monkeypatch, arrays):
    """jax.random.uniform returns `arrays` in call order (each f32, of the
    requested shape)."""
    it = iter(arrays)

    def fake(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        a = next(it)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)
    monkeypatch.setattr(jax.random, 'uniform', fake)


def _u(seed, *shape):
    """f32 uniforms in [1e-12, 1), the port's floor."""
    u = np.random.default_rng(seed).random(shape).astype(np.float32)
    return np.maximum(u, np.float32(1e-12))


# --------------------------------------------------------------------------
# the line-profile file
# --------------------------------------------------------------------------

def _freq_file(tmp_path, cfg):
    """A frequency [Hz] profile around the line centre, type 0."""
    x = np.linspace(-30.0, 25.0, 120)
    nu = SPEEDC / (cfg.line.wavelength0 * 1e-9) + x * cfg.Dfreq_ref
    path = tmp_path / 'prof_nu.txt'
    np.savetxt(path, np.stack([nu[::-1], np.exp(-0.5 * (x[::-1] / 6.0) ** 2)
                               + 0.05], 1))
    return str(path)


@pytest.mark.parametrize('ftype', [0, 1])
def test_line_prof_tables_match_lart_tpu(ftype, tmp_path):
    par = testing.sphere_params(n=5, spectral_type='line_prof_file',
                                line_prof_file=LINE_PROF,
                                line_prof_file_type=1)
    if ftype == 0:
        par.line_prof_file = _freq_file(tmp_path, par.resolve())
        par.line_prof_file_type = 0
    cfg, jcfg = bridge.resolve_both(par)
    got = tsrc.read_line_prof(par.line_prof_file, cfg)
    want = jsrc.read_line_prof(par.line_prof_file, jcfg)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in 'iu':
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    tab = tsrc.LineProfTable.from_config(cfg, 'cpu')
    jmeta = jcart.build_cartesian(jcfg)[0]
    jt = jsrc.build_sources(jcfg, jmeta)
    for mine, theirs in ((tab.prob, jt.lp_prob), (tab.alias, jt.lp_alias),
                         (tab.edges, jt.lp_edges)):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    # the profile's bins span the file's frequencies
    assert np.all(np.diff(got[2]) > 0)


# --------------------------------------------------------------------------
# the samplers, lane by lane
# --------------------------------------------------------------------------

@pytest.mark.parametrize('model', [0, 1, 2, 3])
def test_limb_cost_matches_lart_tpu(model, monkeypatch):
    xi = _u(70 + model, tsrc.N_ROUNDS, 2, N)
    got = tsrc.sample_limb_cost(model, torch.from_numpy(xi)).numpy()
    _feed(monkeypatch, [xi[0, 0]] if model <= 1 else list(xi))
    want = np.asarray(jsrc.sample_limb_cost(jax.random.PRNGKey(0), model,
                                            (N,)))
    if model <= 1:
        # u, or its square root (XLA's sqrt and torch's differ by an ulp)
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
        return
    # the edge: a round's test within 1e-6 of its envelope
    mu = xi[:, 0].astype(np.float64)
    pmax = tsrc.limb_pmax(model)
    c0, c1, c2 = tsrc.LIMB_COEFF
    pdf = mu * (1.5 * mu + 1.0) if model == 2 else \
        (c0 + c1 * mu + c2 * mu * mu) * mu / tsrc.LIMB_NORM / 2.0
    near = (np.abs(xi[:, 1] * pmax - pdf) <= EDGE * pmax).any(0)
    diff = got != want
    assert np.all(near[diff]), int((diff & ~near).sum())
    assert diff.sum() <= MAX_DIFF * N, int(diff.sum())
    assert np.all((got > 0) & (got <= 1))


STARS = {
    # star_planet_a090.in: a 10.4 star at 39.8 lighting rmax 10
    'a090': dict(stellar_radius=10.4, distance_star_to_planet=39.8,
                 rmax=10.0, stellar_limb_darkening=2, seed=91),
    # wasp52b_like.in: the same star lighting rmax 1
    'wasp52b': dict(stellar_radius=10.4, distance_star_to_planet=39.8,
                    rmax=1.0, stellar_limb_darkening=2, seed=92),
    # the polynomial limb law, a star 5 x the planet at 20 of its radii
    'poly': dict(stellar_radius=5.0, distance_star_to_planet=20.0,
                 rmax=1.0, stellar_limb_darkening=3, seed=93),
}


def _stellar_edge(il, xi):
    """Each round's distance to its edges, float64 from the f32 uniforms:
    |det| / (r.k)^2 and |cos_ang| (the acceptance tests)."""
    u = xi.astype(np.float64)
    c1 = np.float32(1.0 - il.cosvt_max)
    t1 = np.float32(1.0 - il.cost_max)
    cosvt = c1 * u[:, 0] + np.float32(il.cosvt_max)
    sinvt = np.sqrt(np.maximum(1 - cosvt ** 2, 0))
    vphi = 2 * np.pi * u[:, 1]
    x0, y0, z0 = sinvt * np.cos(vphi), sinvt * np.sin(vphi), cosvt
    x, y, z = il.Rs * x0, il.Rs * y0, il.Rs * z0 - il.D
    rr = np.sqrt(x * x + y * y + z * z)
    k0 = -np.stack([x, y, z]) / rr
    cost = t1 * u[:, 2] + np.float32(il.cost_max)
    sint = np.sqrt(np.maximum(1 - cost ** 2, 0))
    phi = 2 * np.pi * u[:, 3]
    kr = np.sqrt(np.maximum(k0[0] ** 2 + k0[1] ** 2, 1e-24))
    kx = cost * k0[0] + sint * (k0[2] * k0[0] * np.cos(phi)
                                - k0[1] * np.sin(phi)) / kr
    ky = cost * k0[1] + sint * (k0[2] * k0[1] * np.cos(phi)
                                + k0[0] * np.sin(phi)) / kr
    kz = cost * k0[2] - sint * np.cos(phi) * kr
    rdk = x * kx + y * ky + z * kz
    det = rdk * rdk - (rr * rr - il.rmax ** 2)
    cos_ang = x0 * kx + y0 * ky + z0 * kz
    return np.minimum(np.abs(det) / np.maximum(rdk * rdk, 1e-30),
                      np.abs(cos_ang))


def _near_edge(dist, got_rej, want_rej):
    """Lanes with a round within EDGE of an edge among the rounds either
    package drew."""
    last = np.minimum(np.maximum(got_rej, want_rej), dist.shape[0] - 1)
    r = np.arange(dist.shape[0])[:, None]
    return ((dist <= EDGE) & (r <= last[None, :])).any(0)


def _check_births(got, want, near, D, ff1, sphere=False):
    """nrejected equal but on near-edge lanes (at most MAX_DIFF of them);
    on the others positions to 1e-5 D, directions and weights to 1e-5,
    and the flux factors to 1e-5 of a birth's flux factor ff1.  On the
    sphere (the stellar sampler) the entry point's distance along the ray
    is -r.k - sqrt(det): a grazing ray's is conditioned by sqrt(det) =
    |e.k| at the entry point e, so the position's tolerance adds the f32
    rounding of det (1e-6 D^2) over 2 |e.k|."""
    gr, wr = got[8].numpy(), np.asarray(want[8])
    diff = gr != wr
    assert np.all(near[diff]), int((diff & ~near).sum())
    assert diff.sum() <= MAX_DIFF * N, int(diff.sum())
    ok = ~diff
    pos_tol = np.full(gr.shape, 1e-5 * D)
    if sphere:
        e = np.stack([got[i].numpy().astype(np.float64) for i in range(3)])
        k = np.stack([got[i].numpy().astype(np.float64) for i in (3, 4, 5)])
        ek = np.abs((e * k).sum(0))
        pos_tol += 1e-6 * D * D / (2.0 * np.maximum(ek, 1e-30))
    for i in range(7):
        a = got[i].numpy()[ok]
        b = np.broadcast_to(np.asarray(want[i]), gr.shape)[ok]
        tol = pos_tol[ok] if i < 3 else 1e-5
        assert np.all(np.abs(a - b) <= tol), (i, int((np.abs(a - b)
                                                      > tol).sum()))
    ff_g = got[7].numpy()[ok]
    ff_w = np.broadcast_to(np.asarray(want[7]), gr.shape)[ok]
    np.testing.assert_allclose(ff_g, ff_w, rtol=0, atol=1e-5 * ff1)
    return int(diff.sum()), int(near.sum())


@pytest.mark.parametrize('star', sorted(STARS))
def test_stellar_sampler_matches_lart_tpu(star, monkeypatch):
    kw = dict(STARS[star])
    seed = kw.pop('seed')
    par = Params(source_geometry='stellar_illumination', **kw)
    il = tsrc.Illumination.from_config(
        types.SimpleNamespace(par=par), types.SimpleNamespace(xmax=1.0))
    xi = _u(seed, tsrc.N_ROUNDS, 4, N)
    got = tsrc.sample_stellar_illumination(il, torch.from_numpy(xi))
    _feed(monkeypatch, list(xi))
    want = jsrc.sample_stellar_illumination(jax.random.PRNGKey(0), par,
                                            par.rmax, (N,))
    near = _near_edge(_stellar_edge(il, xi), got[8].numpy(),
                      np.asarray(want[8]))
    n_diff, n_near = _check_births(got, want, near, il.D, il.flux_fac1,
                                   sphere=True)
    # the births start on the atmosphere sphere (f32 cancellation from the
    # star-centred coordinates leaves a jitter of ~1e-6 D) and fly inward
    r = torch.sqrt(got[0] ** 2 + got[1] ** 2 + got[2] ** 2).numpy()
    assert np.quantile(np.abs(r - il.rmax), 0.99) < 1e-4 * il.D
    assert float(got[8].mean()) > 0.0


BOXES = {'below': dict(zs_point=-5.0), 'above': dict(zs_point=3.0)}


def _point_edge(il, xi):
    u = xi.astype(np.float64)
    cost = np.float32(1.0 - il.costm) * u[:, 0] + np.float32(il.costm)
    sint = np.sqrt(np.maximum(1 - cost ** 2, 0))
    phi = 2 * np.pi * u[:, 1]
    d = il.dist_wall / cost
    x, y = d * sint * np.cos(phi), d * sint * np.sin(phi)
    xmin, xmax, ymin, ymax = il.box
    return np.minimum.reduce([np.abs(x - xmin) / xmax, np.abs(x - xmax) / xmax,
                              np.abs(y - ymin) / ymax,
                              np.abs(y - ymax) / ymax])


@pytest.mark.parametrize('side', sorted(BOXES))
def test_point_sampler_matches_lart_tpu(side, monkeypatch):
    par = Params(nx=17, ny=17, nz=9, xmax=1, ymax=1, zmax=0.2,
                 source_geometry='point_illumination', **BOXES[side])
    cfg, jcfg = bridge.resolve_both(par)
    meta = build_cartesian(cfg)[0]
    jmeta = jcart.build_cartesian(jcfg)[0]
    il = tsrc.Illumination.from_config(cfg, meta)
    xi = _u(81 + len(side), tsrc.N_ROUNDS, 2, N)
    got = tsrc.sample_point_illumination(il, torch.from_numpy(xi))
    _feed(monkeypatch, list(xi))
    want = jsrc.sample_point_illumination(jax.random.PRNGKey(0), jcfg.par,
                                          jmeta, (N,))
    near = _near_edge(_point_edge(il, xi), got[8].numpy(),
                      np.asarray(want[8]))
    _check_births(got, want, near, abs(par.zs_point), il.flux_fac1)
    assert np.all(got[2].numpy() == np.float32(il.zface))
    assert np.all(np.sign(got[5].numpy()) == (1 if il.below else -1))


# --------------------------------------------------------------------------
# K2's births against one lart_tpu refill
# --------------------------------------------------------------------------

def _a090_small(**over):
    return testing.source_params('a090', ROOT, nx=17, ny=17, nz=17,
                                 save_peeloff=False, batch_size=N, **over)


BIRTHS = {
    'stellar_line_prof': lambda: _a090_small(),
    'stellar_voigt': lambda: testing.source_params(
        'wasp52b', ROOT, nx=17, ny=17, nz=17, taumax=100.0, batch_size=N),
    'point_illumination': lambda: Params(
        nx=17, ny=17, nz=9, xmax=1, ymax=1, zmax=0.2, tauhomo=0.5,
        temperature=1e4, xfreq_min=-20.0, xfreq_max=20.0,
        source_geometry='point_illumination', zs_point=-5.0,
        spectral_type='voigt', batch_size=N),
    'plane_top': lambda: testing.plane_atmosphere_params(batch_size=N),
    'plane_disk': lambda: testing.source_params(
        'wasp52b', ROOT, nx=17, ny=17, nz=17, taumax=100.0, batch_size=N,
        source_geometry='plane_illumination'),
    'plane_profile': lambda: testing.plane_atmosphere_params(
        batch_size=N, source_geometry='diffuse_emissivity',
        emiss_file=DENS_PROF, zmax=10.0, sampling_method=1),
    'point_line_prof': lambda: _a090_small(source_geometry='point'),
}


def _jax_refill(jcfg, jmeta, jgrid, jhd, n):
    src = jsrc.build_sources(jcfg, jmeta, jhd)
    refill = jeng.make_refill(jcfg, jmeta)
    s = jeng.init_state(n)._replace(n_launched=jnp.zeros((1,), jnp.int32))
    t = jeng.zero_tallies(jmeta.nxfreq, illumination=True)
    with jax.disable_jit():
        s2, t2 = refill(s, jgrid, t, jax.random.PRNGKey(11),
                        jnp.asarray([[n, 0]], jnp.int32), None, src)
    return s2, t2


@pytest.mark.parametrize('name', sorted(BIRTHS))
def test_births_match_lart_tpu(name):
    par = BIRTHS[name]()
    cfg, jcfg = bridge.resolve_both(par)
    hd, jhd = {}, {}
    meta, grid = build_cartesian(cfg, host_out=hd)
    jmeta, jgrid = jcart.build_cartesian(jcfg, host_out=jhd)
    rp = trefill.RefillParams.from_config(cfg, meta, grid, host_data=hd)
    s = init_state(N, 'cpu')
    tl = zero_tallies(meta.nxfreq, 0, 'cpu', illumination=rp.illumination)
    trefill.refill(s, tl, rp, seed=5, counter=3, budget=N)
    assert bool((s.phase == FFS).all())
    js, jt = _jax_refill(jcfg, jmeta, jgrid, jhd, N)
    fields = ('x', 'y', 'z', 'kx', 'ky', 'kz', 'xfreq', 'wgt', 'ic', 'jc',
              'kc')
    for f in fields:
        a = getattr(s, f).numpy().astype(np.float64)
        b = np.asarray(getattr(js, f), np.float64)
        if np.ptp(b) == 0.0 or np.ptp(a) == 0.0:
            assert np.array_equal(a, b), f
            continue
        p = stats.ks_2samp(a, b).pvalue
        assert p > KS_P, (name, f, p)
    if rp.illumination:
        # the flux factor and the rejected draws over the launched lanes
        il = rp.source.illum
        sampler = tsrc.sample_stellar_illumination if il.kind == 'stellar' \
            else tsrc.sample_point_illumination
        from lart_tpu_torch.physics.rng import STREAM_REFILL, uniforms
        xi = uniforms(5, STREAM_REFILL, torch.arange(N), 3,
                      range(trefill.BLOCK_ILLUM,
                            trefill.BLOCK_ILLUM + tsrc.N_ROUNDS))
        lane = sampler(il, xi[:, :il.n_uniforms])
        for i, key in ((7, 'flux_factor'), (8, 'nrejected')):
            v = lane[i].double()
            assert abs(float(v.sum()) - float(getattr(tl, key))) <= \
                1e-5 * float(v.sum())
            sig = float(v.std()) * math.sqrt(2.0 / N)
            got, want = float(getattr(tl, key)) / N, \
                float(getattr(jt, key)) / N
            assert abs(got - want) <= 3.0 * sig + 1e-12, (key, got, want)


# --------------------------------------------------------------------------
# K5: the atmosphere branches of the flight
# --------------------------------------------------------------------------

# name -> (params, the lanes' r_max)
FLIGHTS = {
    'plane': (lambda: testing.plane_atmosphere_params(nz=32, taumax=100.0),
              None),
    'sphere_hubble': (lambda: Params(
        geometry='spherical_atmosphere', nx=17, ny=17, nz=17, xmax=1, ymax=1,
        zmax=1, rmax=1.0, rmin=0.5, taumax=30.0, temperature=1e4,
        velocity_type='hubble', Vexp=100.0, xfreq_min=-40.0,
        xfreq_max=40.0, source_geometry='stellar_illumination',
        stellar_radius=10.4, distance_star_to_planet=39.8), 1.0),
    'a090_33': (lambda: testing.source_params(
        'a090', ROOT, nx=33, ny=33, nz=33, save_peeloff=False), 1.5),
}


@pytest.mark.parametrize('case', sorted(FLIGHTS))
def test_fly_atmosphere_matches_make_fly(case):
    make, r_max = FLIGHTS[case]
    cfg, jcfg = bridge.resolve_both(make())
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    assert meta.atmosphere == (1 if case == 'plane' else 2)
    flight = teng.make_fly(cfg, meta, grid)
    assert flight.atmosphere == meta.atmosphere
    s0 = testing.mixed_state(meta, 8192, seed=41, r_max=r_max)
    steps = 40
    js, jt = jax.jit(jeng.make_fly(jcfg, jmeta), static_argnums=3)(
        bridge.state_to_jax(s0), jgrid,
        jeng.zero_tallies(meta.nxfreq, nmu=8, atmosphere=True), steps)
    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 8, 'cpu', atmosphere=True)
    flight(st, tl, steps)
    ref = convert.state_from_jax(js)
    bad = torch.zeros(st.batch, dtype=torch.bool)
    for f in INT_FIELDS:
        bad |= getattr(st, f) != getattr(ref, f)
    frac, _ = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= 3e-4 and float(bad.float().mean()) <= 3e-4, (case, frac)
    # the destructions happened, and their weight: Jabs2 and Jout to 1e-5
    # of their sums (the lanes that differ may move a lane's deposit)
    moved = float(st.wgt.max()) * frac * st.batch
    for mine, theirs in ((tl.Jabs2, jt.Jabs2), (tl.Jout, jt.Jout)):
        b = torch.as_tensor(np.array(theirs), dtype=torch.float64)
        a = mine.double()
        assert float(b.sum()) > 0.0
        tol = 1e-5 * float(b.sum()) + moved
        assert float((a - b).abs().max()) <= tol
        assert abs(float(a.sum() - b.sum())) <= tol
    assert abs(float(tl.W_oor) - float(jt.W_oor)) <= 1e-5 * max(
        float(jt.W_oor), 1.0) + moved


# --------------------------------------------------------------------------
# K7: the masked walk and the stellar direct peel
# --------------------------------------------------------------------------

# a stellar pair's sightline angles are ~1e-4 rad and carry the f32
# rounding of their tangents (~1e-7 relative, 1e-11 rad) and of the disk
# point (~1e-6 over the observer's distance): 1e-4 of a pixel (3e-9 rad
# and more) holds both
EDGE_PIX = 1e-4


def _tan_edge(p, o, pk):
    """Pairs whose TAN angles (float64) lie within EDGE_PIX of a pixel
    boundary."""
    R = p.rmat.double()[o]
    k = [sum(R[a, b] * pk[b] for b in range(3)) for a in range(3)]
    obs = p.obs_meta
    edge = torch.zeros(pk[0].shape, dtype=torch.bool)
    for ka, dim, n in ((k[0], obs.dxim, obs.nxim), (k[1], obs.dyim,
                                                     obs.nyim)):
        c = torch.atan2(-ka, k[2]) * (180.0 / math.pi) / dim + n / 2.0
        edge |= (c - torch.round(c)).abs() < EDGE_PIX
    return edge


def _freq_edge(g, xr):
    cf = (xr - g.xfreq_min) / g.dxfreq
    return ((cf - torch.round(cf)).abs() * g.dxfreq
            < EDGE * torch.clamp_min(xr.abs(), 1.0))


def _stellar_edge_pairs(p, s, rec):
    """Lanes with a pair on an edge of the stellar peel: its disk point's
    pixel, the sphere test (r.k ~ 0 or det ~ 0) or the newborn's bin,
    float64 from the f32 inputs."""
    Dsp, Rs, Rmax = p.stellar
    cost = rec.limb_cost.double()
    vphi = rec.limb_vphi.double()
    bad = _freq_edge(p.grid, s.xfreq.double())
    for o in range(p.nobs):
        op = p.pos.double()[o]
        k0 = torch.stack([op[0], op[1], op[2] + Dsp])
        d_so = torch.sqrt((k0 ** 2).sum())
        k0 = k0 / d_so
        c0 = Rs / d_so
        cosvt = cost * torch.sqrt(1 - c0 ** 2 + (c0 * cost) ** 2) \
            + c0 * (1 - cost ** 2)
        sinvt = torch.sqrt(torch.clamp_min(1 - cosvt ** 2, 0))
        kr0 = torch.sqrt(k0[0] ** 2 + k0[1] ** 2)
        if kr0 < 1e-11:
            pt = [sinvt * torch.cos(vphi), sinvt * torch.sin(vphi),
                  torch.sign(k0[2]) * cosvt]
        else:
            cp, sp = torch.cos(vphi), torch.sin(vphi)
            pt = [cosvt * k0[0] + sinvt * (k0[2] * k0[0] * cp - k0[1] * sp)
                  / kr0,
                  cosvt * k0[1] + sinvt * (k0[2] * k0[1] * cp + k0[0] * sp)
                  / kr0, cosvt * k0[2] - sinvt * cp * kr0]
        pt = [Rs * pt[0], Rs * pt[1], Rs * pt[2] - Dsp]
        pk = [op[a] - pt[a] for a in range(3)]
        rr = torch.sqrt(pk[0] ** 2 + pk[1] ** 2 + pk[2] ** 2)
        pk = [v / rr for v in pk]
        rdk = sum(pt[a] * pk[a] for a in range(3))
        det = rdk ** 2 - (sum(v * v for v in pt) - Rmax ** 2)
        bad |= _tan_edge(p, o, pk) | (rdk.abs() < 1e-6 * Dsp) \
            | (det.abs() < EDGE * rdk ** 2)
    return bad


def _stellar_ref(jcfg, jmeta, jobs_meta, jgrid, jodev, s, active, u_c, u_v,
                 monkeypatch):
    """peel_direct_stellar of lart_tpu on the port's state, its limb
    sample's two uniforms handed over through jax.random.uniform."""
    pds = jpeel.make_peel(jcfg, jmeta, jobs_meta)[0]
    assert pds.__name__ == 'peel_direct_stellar'
    _feed(monkeypatch, [u_c, u_v])
    zero = jpeel.zero_cubes(jcfg, jmeta, jobs_meta)
    return pds(zero, jgrid, jodev, bridge.state_to_jax(s),
               jnp.asarray(active.numpy()), key=jax.random.PRNGKey(3))


STELLAR_PEELS = {
    # the transit case of lart_tpu's tests at 17^3, limb model 0
    'cartesian': lambda: testing.stellar_params(n=17, rmin=0.4,
                                                stellar_limb_darkening=0),
    'a090_plus_z': lambda: testing.source_params(
        'a090', ROOT, nx=21, ny=21, nz=21, beta=(0.0,), save_direc0=True,
        nxim=33, nyim=33, stellar_limb_darkening=0),
    'amr': lambda: testing.amr_params(
        8, 1, tau0=50.0, **{k: v for k, v in dict(
            testing.stellar_params().__dict__).items()
            if k in ('source_geometry', 'stellar_radius',
                     'distance_star_to_planet', 'save_peeloff',
                     'save_direc0', 'obsx', 'obsy', 'obsz', 'nxim', 'nyim',
                     'xfreq_min', 'xfreq_max')}, stellar_limb_darkening=0),
}


@pytest.mark.parametrize('case', sorted(STELLAR_PEELS))
def test_stellar_peel_matches_make_peel(case, monkeypatch):
    par = STELLAR_PEELS[case]()
    cfg, jcfg = bridge.resolve_both(par)
    B = 4096
    if case == 'amr':
        data = tamr.make_amr_sphere(8, 1)
        built = tamr.build_amr(cfg, data=data, device='cpu')
        meta, grid = built.meta, built.dev
        jb = jamr.build_amr(jcfg, data=data)
        jmeta, jgrid = jb.meta, jb.dev
        p = teng.make_chunk(cfg, meta, grid).peel
        s = testing.amr_state(meta, p.grid.amr, B, 51)
    else:
        meta, grid = build_cartesian(cfg)
        jmeta, jgrid = jcart.build_cartesian(jcfg)
        p = teng.make_chunk(cfg, meta, grid).peel
        s = testing.mixed_state(meta, B, seed=51, r_max=meta.xmax)
    assert p.stellar is not None and p.direct_mode == tpeel.STELLAR
    rec = tpeel.PeelRecord.zeros(B, 'cpu')
    u_c, u_v = _u(52, B), _u(53, B)
    rec.limb_cost.copy_(torch.from_numpy(u_c))
    rec.limb_vphi.copy_(tpeel.TWOPI * torch.from_numpy(u_v))
    bad = _stellar_edge_pairs(p, s, rec)
    assert float(bad.float().mean()) < 0.01
    rec.flag.copy_((~bad).to(torch.int32))
    cubes = p.zero_cubes('cpu')
    stats = {'lanes': B, 'mode': tpeel.STELLAR}
    tpeel.peel_plain(s, cubes, rec, p, tpeel.STELLAR, stats=stats)
    jobs_meta, jodev = jobs.build_observers(jcfg)
    ref = _stellar_ref(jcfg, jmeta, jobs_meta, jgrid, jodev, s, ~bad, u_c,
                       u_v, monkeypatch)
    assert stats['seen'] > 0.05 * B and stats['crossing'] > 0
    for name in ('direc', 'direc0'):
        got, want = getattr(cubes, name), torch.as_tensor(
            np.asarray(getattr(ref, name)))
        atol = 1e-5 * max(float(want.abs().sum()), 1e-30)
        torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=name)
    # attenuation only: Direct <= Direct0 in every bin
    assert bool((cubes.direc <= cubes.direc0 * (1 + 1e-6)).all())
    assert float(cubes.direc.sum()) < float(cubes.direc0.sum())


@pytest.mark.parametrize('mode', ['direct', 'resonance'])
def test_masked_walk_matches_make_peel(mode):
    """The sightline into a masked core is opaque: K7's plain walk against
    make_peel's tau_to_edge closure pair by pair, and the cubes."""
    par = testing.peel_params(Params(
        geometry='spherical_atmosphere', nx=17, ny=17, nz=17, xmax=1, ymax=1,
        zmax=1, rmax=1.0, rmin=0.5, taumax=5.0, temperature=1e4,
        xfreq_min=-20.0, xfreq_max=20.0, spectral_type='voigt',
        source_geometry='stellar_illumination', stellar_radius=10.4,
        distance_star_to_planet=39.8), stokes=False)
    par.save_peeloff, par.source_geometry = True, 'point'
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    p = teng.make_chunk(cfg, meta, grid).peel
    assert p.grid.mask is not None and p.stellar is None
    s = testing.mixed_state(meta, 4096, seed=57, r_max=1.0)
    rec = testing.peel_record(s, seed=58)
    m = tpeel.DIRECT if mode == 'direct' else tpeel.RESONANCE
    jobs_meta, jodev = jobs.build_observers(jcfg)
    pd = jpeel.make_peel(jcfg, jmeta, jobs_meta)[0]
    free = dict(zip(pd.__code__.co_freevars,
                    (c.cell_contents for c in pd.__closure__)))
    jtau = jax.jit(free['tau_to_edge'], static_argnums=12)
    cell = (s.ic, s.jc, s.kc)
    opaque = 0
    for o in range(p.nobs):
        pk, _, _, in_img = tpeel.obs_geometry(p, o, s.x, s.y, s.z)
        xf = tpeel.event_frequency(p, m, s, rec, pk)[0]
        t = tpeel.tau_to_edge(p, (s.x, s.y, s.z), cell, pk, xf, in_img)
        j = torch.as_tensor(np.array(jtau(jgrid, *(jnp.asarray(v.numpy())
                                                   for v in (
            s.x, s.y, s.z, s.ic, s.jc, s.kc, *pk, xf, in_img)),
            free['max_steps'])))
        # the core's opaque 2 x 745.2, before the walk's stop at TAU_STOP
        opaque += int((in_img & (t >= 700.0)).sum())
        t = torch.clamp_max(t, tpeel.TAU_STOP)
        j = torch.clamp_max(j, tpeel.TAU_STOP)
        off = in_img & ((t - j).abs() > 1e-6 + 1e-5 * j.abs())
        assert int(off.sum()) <= 1e-3 * int(in_img.sum()), int(off.sum())
    # a share of the sightlines meets the core
    assert opaque > 0.05 * s.batch


# --------------------------------------------------------------------------
# what check_supported accepts
# --------------------------------------------------------------------------

def test_check_supported_accepts_the_atmosphere_examples():
    names = ['atmosphere/wasp52b_like.in'] + sorted(
        glob.glob('star_planet/*.in', root_dir=ROOT / 'examples'))
    assert len(names) == 15
    for rel in names:
        teng.check_supported(
            Params.from_namelist(str(ROOT / 'examples' / rel)).resolve())
    accepted = 0
    paths = sorted(glob.glob(str(ROOT / 'examples/**/*.in'), recursive=True))
    for path in paths:
        try:
            teng.check_supported(Params.from_namelist(path).resolve())
            accepted += 1
        except NotImplementedError:
            pass
    # all but amr_ramses/ramses_snap10.in, whose snapshot is not in the
    # repository (the shearing box of tigress_shear/shear.in is ported)
    assert (accepted, len(paths)) == (111, 112)
    # the shearing box, the maps, the all-photons table and several
    # devices are ported
    for over in (dict(xy_periodic=True, Omega=1.0), dict(calcJ=True),
                 dict(calcP=True), dict(save_all_photons=True),
                 dict(n_devices=2)):
        teng.check_supported(testing.plane_atmosphere_params(**over)
                             .resolve())
    with pytest.raises(ValueError, match='atmosphere'):
        testing.plane_atmosphere_params(line_id='ly_beta').resolve()


def test_amr_transit_matches_lart_tpu():
    """lart_tpu's test_stellar_illumination_amr end to end through both
    drivers (_torch_jax_bridge.atmosphere_against_lart_tpu): an AMR sphere
    at a base of 8 cells, tau 20, 320 photons (cut from 16 cells, tau 50
    and 800 for the port's plain AMR peel walk on one CPU thread), lit by
    a Lambertian star and seen on +z with Direct0: the budget, <N_scatt>,
    the flux factor, Direct <= Direct0 and the transit depth."""
    par = testing.amr_params(
        8, 1, tau0=20.0, nphotons=320, batch=512, rmax=1.0,
        xfreq_min=-20.0, xfreq_max=20.0,
        source_geometry='stellar_illumination', stellar_radius=2.0,
        distance_star_to_planet=50.0, stellar_limb_darkening=1,
        spectral_type='monochromatic', save_peeloff=True,
        save_peeloff_3D=True, save_direc0=True, obsx=(0.0,), obsy=(0.0,),
        obsz=(2000.0,), nxim=25, nyim=25)
    bridge.atmosphere_against_lart_tpu('amr_transit', par,
                                       tamr.make_amr_sphere(8, 1),
                                       destroys=False, stellar=True)
