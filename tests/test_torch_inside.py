"""The interior all-sky observer and the exponential-cylinder source of the
port against lart_tpu on the CPU: the observers (instruments/observer.py's
interior branch), K7's plain interior mode pair by pair against make_peel's
closures, and K2's plain exponential-cylinder births.

Peel: an observer inside a 17-cell periodic slab (the DDA with its
boundary ops and the cap), inside a 17^3 uniform sphere (the chord cut at
the cap), inside the 16-base AMR sphere (the node walk) and at the centre
of the 17^3 dusty shell of testing.dust_params (the Henyey-Greenstein dust
peel; Stokes is vetoed with an interior observer).  Per (observer, lane)
pair the optical depth to the observer agrees with make_peel's own
tau_to_edge closure with cap = r, min(tau, 110) to rtol 1e-5 + atol 1e-6
(XLA fuses tau + d rho into one FMA; the port's walk stops at tau 110,
peel.TAU_STOP, where no deposit is nonzero), on all but 1e-3 of the pairs; then
the cubes of peel_direct, peel_resonance and peel_dust agree to 1e-5 of
their sum without the lanes of such pairs and of edge pairs, whose HEALPix
pixel changes when the direction moves by 2e-7 in any component (the f32
rounding of either package), or whose lab frequency lies within 1e-6 of
its magnitude (at least 1e-6) of a bin edge: at most 3% of the pairs.

Births: the radius table equals lart_tpu's knot for knot; the radius of
the same uniforms agrees to 1e-6 (torch's and XLA's log and exp differ in
the last bit); 20000 births' cylindrical radius and |z| agree with
lart_tpu's births (its own jax.random draws) by a two-sample KS test at
the 1e-3 level, and with the analytic truncated laws.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special, stats

from lart_tpu.grid import amr as jamr
from lart_tpu.grid import cartesian as jcart
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import peel as jpeel
from lart_tpu.physics import sources as jsrc
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.grid import amr as tamr
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.instruments import healpix as thp
from lart_tpu_torch.instruments import observer as tobs
from lart_tpu_torch.instruments import peel as tpeel
from lart_tpu_torch.physics import sources as tsrc
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import refill as trefill
from lart_tpu_torch.transport.state import FFS, init_state, zero_tallies

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]
B = 2048
TAU_RTOL, TAU_ATOL, TAU_FRAC = 1e-5, 1e-6, 1e-3
EDGE_DIR, EDGE_REL, EDGE_FRAC = 2e-7, 1e-6, 0.03
INSIDE = dict(save_peeloff=True, nside=4, use_stokes=False)

CASES = {
    'slab_periodic': (lambda: testing.slab_params(
        tau0=1e3, nz=17, obsx=(0.1,), obsy=(-0.2,), obsz=(0.05,), **INSIDE),
        None),
    'sphere_chord': (lambda: testing.sphere_params(
        tau0=100.0, n=17, obsx=(0.3,), obsy=(0.1,), obsz=(-0.2,), **INSIDE),
        1.0),
    'amr_sphere': (lambda: testing.amr_params(
        16, 1, tau0=100.0, obsx=(0.2,), obsy=(0.1,), obsz=(-0.1,), **INSIDE),
        1.0),
    'dust_shell': (lambda: testing.dust_params(stokes=False, **INSIDE), 1.0),
}
MODES = {'direct': tpeel.DIRECT, 'resonance': tpeel.RESONANCE,
         'dust': tpeel.DUST}
CASE_MODES = [('slab_periodic', 'direct'), ('slab_periodic', 'resonance'),
              ('sphere_chord', 'direct'), ('sphere_chord', 'resonance'),
              ('amr_sphere', 'resonance'), ('dust_shell', 'dust')]


def test_interior_observers_match_lart_tpu():
    """The first obsx/obsy/obsz triple (a NaN component taken as 0) and
    every further finite triple, identity rotations, HEALPix geometry."""
    nan = float('nan')
    par = testing.sphere_params(n=9, save_peeloff=True, nside=8,
                                obsx=(0.2, nan, 0.1, -0.3),
                                obsy=(nan, 0.0, 0.2, 0.4),
                                obsz=(0.1, 0.0, 0.3, -0.5))
    cfg, jcfg = bridge.resolve_both(par)
    tm, td = tobs.build_observers(cfg)
    jm, jd = jobs.build_observers(jcfg)
    for f in ('nobs', 'nxim', 'nyim', 'dxim', 'dyim', 'distance',
              'steradian_pix', 'inside', 'nside', 'npix'):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.nobs == 3 and tm.npix == 768 and tm.inside
    np.testing.assert_array_equal(tm.pos_host, jm.pos_host)
    np.testing.assert_array_equal(td.pos.numpy(), np.asarray(jd.pos))
    np.testing.assert_array_equal(td.rmat.numpy(), np.asarray(jd.rmat))


def _setup(case):
    """(port cfg, lart_tpu cfg, port meta, lart_tpu meta, lart_tpu grid,
    the port's Peel, a mixed state) of CASES[case]: an AMR grid is built
    by lart_tpu and carried over, a Cartesian one by the port and bridged."""
    make, r_max = CASES[case]
    cfg, jcfg = bridge.resolve_both(make())
    if case == 'amr_sphere':
        jr = jamr.build_amr(jcfg, data=tamr.make_amr_sphere(16, 1))
        meta, grid = convert.amr_from_jax(jr.meta, jr.dev)
        jmeta, jgrid = jr.meta, jr.dev
        p = teng.make_chunk(cfg, meta, grid).peel
        s = testing.amr_state(meta, p.grid.amr, B, seed=71, r_max=r_max)
    else:
        meta, grid = build_cartesian(cfg)
        jmeta, jgrid = jcart.build_cartesian(jcfg)
        p = teng.make_chunk(cfg, meta, grid).peel
        s = testing.mixed_state(meta, B, seed=71, r_max=r_max)
    assert p.obs_meta.inside and p.chord == (case == 'sphere_chord')
    return cfg, jcfg, meta, jmeta, jgrid, p, s


def _closure(fn, name):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))[name]


def _edge(p, mode, s, rec, o):
    """The pairs (o, lane) on an edge: their HEALPix pixel moves when the
    f64 arrival direction moves by EDGE_DIR in a component, or their lab
    frequency lies within EDGE_REL of a bin edge."""
    pos = p.pos.double()[o]
    d = [pos[a] - getattr(s, c).double() for a, c in enumerate('xyz')]
    r = torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    arrive = [-(v / r) for v in d]
    nside = p.obs_meta.nside
    pix = thp.vec2pix_ring(nside, *(v.float() for v in arrive))
    edge = torch.zeros(s.batch, dtype=torch.bool)
    for a in range(3):
        for sgn in (-1.0, 1.0):
            moved = [v + (sgn * EDGE_DIR if b == a else 0.0)
                     for b, v in enumerate(arrive)]
            edge |= thp.vec2pix_ring(nside, *(v.float() for v in moved)) \
                != pix
    pk, _, _, _ = tpeel.obs_geometry(p, o, s.x, s.y, s.z)
    xf = tpeel.event_frequency(p, mode, s, rec, pk)[0].double()
    g = p.grid
    if g.moving:
        xf = xf + g.vel_dot((s.ic, s.jc, s.kc), *pk).double()
    cf = (xf - g.xfreq_min) / g.dxfreq
    edge |= ((cf - torch.round(cf)).abs() * g.dxfreq
             < EDGE_REL * torch.clamp_min(xf.abs(), 1.0)) \
        & (cf > -1.0) & (cf < g.nxfreq + 1.0)
    return edge


@pytest.mark.parametrize('case,mode', CASE_MODES)
def test_interior_peel_matches_make_peel(case, mode):
    cfg, jcfg, meta, jmeta, jgrid, p, s = _setup(case)
    m = MODES[mode]
    rec = testing.peel_record(s, seed=72)
    jobs_meta, jodev = bridge.observers_to_jax(p.obs_meta, p.pos, p.rmat)
    pd, pr, pdust, _ = jpeel.make_peel(jcfg, jmeta, jobs_meta)
    jtau = jax.jit(_closure(pd, 'tau_to_edge'), static_argnums=12)
    max_steps = _closure(pd, 'max_steps')
    assert max_steps == p.max_steps
    cell = (s.ic, s.jc, s.kc)
    pk, r2, _, ok = tpeel.obs_geometry(p, 0, s.x, s.y, s.z)
    cap = tpeel.obs_cap(p, r2)
    xf = tpeel.event_frequency(p, m, s, rec, pk)[0]
    t = tpeel.tau_to_edge(p, (s.x, s.y, s.z), cell, pk, xf, ok, cap=cap)
    j = jtau(jgrid, *(jnp.asarray(v.numpy()) for v in (
        s.x, s.y, s.z, *cell, *pk, xf, ok)), max_steps,
        cap=jnp.asarray(cap.numpy()))
    t = torch.clamp_max(t, tpeel.TAU_STOP)
    j = torch.clamp_max(torch.as_tensor(np.array(j)), tpeel.TAU_STOP)
    off = ok & ((t - j).abs() > TAU_ATOL + TAU_RTOL * j.abs())
    edge = ok & _edge(p, m, s, rec, 0)
    bad = off | edge
    n_off, n_edge = int(off.sum()), int(edge.sum())
    assert int(ok.sum()) > 0.9 * B and float(t[ok].max()) > 0.1
    assert n_off <= TAU_FRAC * B and n_edge <= EDGE_FRAC * B, (n_off,
                                                                n_edge)
    # the cap: a pair's walk stops at the observer, so its tau is below the
    # one to the grid's edge
    t_edge = tpeel.tau_to_edge(p, (s.x, s.y, s.z), cell, pk, xf, ok)
    assert bool((t[ok] <= t_edge[ok] * (1 + 1e-6) + 1e-6).all())
    assert float((t_edge - t)[ok].max()) > 0.1

    rec.flag.copy_((~bad).to(torch.int32) * max(m, 1))
    cubes = p.zero_cubes('cpu')
    tpeel.peel(s, cubes, rec, p, m)
    js = bridge.state_to_jax(s)
    active = jnp.asarray((~bad).numpy())
    zero = jpeel.zero_cubes(jcfg, jmeta, jobs_meta)
    if m == tpeel.DIRECT:
        ref = jax.jit(pd)(zero, jgrid, jodev, js, active)
    elif m == tpeel.DUST:
        ref = jax.jit(pdust)(zero, jgrid, jodev, js, active)
    else:
        line = jcfg.line
        ev = {k: jnp.full((B,), v, jnp.float32)
              for k, v in (('E1', line.E1), ('E2', line.E2),
                           ('E3', line.E3))}
        ref = jax.jit(lambda c, g, od, st, a, xa, ux, uy, uz: pr(
            c, g, od, dict(ev, state=st), a, xa, ux, uy, uz))(
            zero, jgrid, jodev, js, active,
            *(jnp.asarray(getattr(rec, f).numpy())
              for f in ('xatom', 'ux', 'uy', 'uz')))
    for name, cube in cubes.items():
        want = torch.as_tensor(np.asarray(getattr(ref, name)))
        atol = 1e-5 * max(float(want.abs().sum()), 1e-30)
        torch.testing.assert_close(cube, want, rtol=0, atol=atol,
                                   msg=f'{case} {mode} {name} (lanes left '
                                       f'out: tau {n_off}, edge {n_edge})')
    deposited = cubes.direc if m == tpeel.DIRECT else cubes.scatt
    assert float(deposited.sum()) > 0.0
    # the all-sky map is filled from every side
    npix = p.obs_meta.npix
    assert int((deposited.view(-1, npix).sum(0) > 0).sum()) > npix // 2


def _civ(**over):
    par = Params.from_namelist(str(ROOT / 'examples/healpix_CIV/CIV_test.in'))
    for k, v in dict(nx=17, ny=17, nz=9, **over).items():
        setattr(par, k, v)
    return par


def test_exponential_cylinder_table_and_radius():
    par = _civ()
    cfg, jcfg = bridge.resolve_both(par)
    jt = jsrc.build_sources(jcfg, None)
    tt = tsrc.build_sources(cfg, None, device='cpu').table
    assert torch.equal(tt.p, torch.as_tensor(np.asarray(jt.r_p)))
    assert torch.equal(tt.r, torch.as_tensor(np.asarray(jt.r_r)))
    assert tt.n == 2049
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (100_000,), jnp.float32))
    want = np.asarray(jax.jit(lambda k: jsrc.sample_radius_loglog(
        k, jt.r_p, jt.r_r, (100_000,)))(key))
    got = tsrc.sample_radius_loglog(torch.as_tensor(u.copy()), tt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_exponential_cylinder_births_match_lart_tpu():
    n = 20_000
    par = _civ(batch_size=n)
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    rp = trefill.RefillParams.from_config(cfg, meta, grid)
    assert rp.source is not None and rp.source.zexp is not None
    s = init_state(n, 'cpu')
    tl = zero_tallies(meta.nxfreq, 0, 'cpu')
    trefill.refill(s, tl, rp, seed=5, counter=3, budget=n)
    assert bool((s.phase == FFS).all())
    # each birth in its own cell, born where it sits
    cells = testing.cells_of(meta, s.x, s.y, s.z)
    for a, c in enumerate((s.ic, s.jc, s.kc)):
        assert np.array_equal(c.numpy(), np.asarray(cells[a]))
    assert torch.equal(s.bx, s.x) and torch.equal(s.bz, s.z)

    # lart_tpu's births: its refill's gen_position (engine.py:2629-2637)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    src = bridge.sources_to_jax(rp.source.table)
    gen = _closure(jeng.make_refill(jcfg, jmeta), 'gen_position')
    jx, jy, jz, _, _ = jax.jit(lambda k: gen(k, (n,), jgrid, src))(
        jax.random.PRNGKey(11))
    R = [np.hypot(np.asarray(x, np.float64), np.asarray(y, np.float64))
         for x, y in ((s.x, s.y), (jx, jy))]
    Z = [np.abs(np.asarray(z, np.float64)) for z in (s.z, jz)]
    assert stats.ks_2samp(R[0], R[1]).pvalue > 1e-3
    assert stats.ks_2samp(Z[0], Z[1]).pvalue > 1e-3
    p = cfg.par
    rs, rmax, zs = p.source_rscale, p.source_rmax, p.source_zscale

    def cdf_r(r):
        return special.gammainc(2, np.asarray(r) / rs) \
            / special.gammainc(2, rmax / rs)

    def cdf_z(z):
        return (1.0 - np.exp(-np.asarray(z) / zs)) \
            / (1.0 - math.exp(-p.zmax / zs))
    assert stats.kstest(R[0], cdf_r).pvalue > 1e-3
    assert stats.kstest(Z[0], cdf_z).pvalue > 1e-3
    zsign = float((np.asarray(s.z) > 0).mean())
    assert abs(zsign - 0.5) < 4.0 * math.sqrt(0.25 / n)
