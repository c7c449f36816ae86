"""Line type 8, Ly-beta with its H-alpha band, in lart_tpu_torch against
lart_tpu on the CPU: the line's constants, the walk of the H-alpha band
(kernel K5's plain version), the scatter's conversion and the band's dust
(K4's), the conversion and H-alpha dust peels (K7's), and driver.run as a
whole on 17^3 spheres of testing.lyb_params.

- The constants: P_conv is lart_tpu's P_down[1] (3p -> 2s, 0.11834)
  rounded once to f32, each channel's phase weights the catalog's, and
  the profile lart_tpu's Voigt function (rtol 2e-6 at injected x).
- The walk: one numpy-made state, a share of its flying lanes moved to
  the H-alpha band (testing.band2_lanes), through both, lane by lane as
  tests/test_torch_fly_cartesian.py holds the walk, with and without dust;
  Jout, Jout_Ha, W_oor and the bands' W_esc1, W_esc2 to 1e-5 of their sum.
- The scatter on 30000 lanes at a scattering around the line centre, a
  third of them in the H-alpha band: the shares of the scattered lanes,
  the conversions, and with dust the H-alpha band's absorptions, within
  0.01 (binomial sigma < 0.003 a share); KS tests, p > P_MIN, on the
  converted photons' lab frequency and, with dust, the cosine of the
  H-alpha band's dust scatterings (hgg_Ha).
- The peel: the conversion peel (peel_conversion_Ha) and the dust peel
  of both bands, pair by pair optical depths against make_peel's
  tau_to_edge with iband (the H-alpha band's dust-only sightline), and the
  Ha and scattered cubes to 1e-5 of their sum, the edge pairs of
  tests/test_torch_peel.py left out.
- driver.run against lart_tpu's, with and without dust (DGR 1e5: the
  example's 1e-3 makes a dust tau of ~1e-6), one observer on +z: in each,
  W_esc1 + W_abs1 + W_conv = 1 and W_esc2 + W_abs2 = W_conv to 1e-3;
  W_conv / nscatt_gas (nscatt_gas counts every resonance scattering, the
  converting ones too) within 0.02 of P_down[1]; the two-photon spectrum
  integrates to 2 W_conv; the Ly-beta and H-alpha escaped spectra's shapes
  chi2/dof < 3; 4 pi d^2 times the Ha cube's flux over W_esc2 is 1 within
  3 sigma of testing.PEEL_V_PHOTON's spread.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from lart_tpu import driver as jdriver
from lart_tpu.grid import cartesian as jcart
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import peel as jpeel
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.instruments import peel as tpeel
from lart_tpu_torch.physics import line as pline
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import scatter
from lart_tpu_torch.transport.state import (AT_SCATTER, DEAD, FLYING,
                                            zero_tallies)

import _torch_jax_bridge as bridge
from test_torch_peel import TAU_ATOL, TAU_FRAC, TAU_RTOL, _edge

P_MIN = 1e-3
DGR_DUST = 1e5       # dust tau ~0.5 across the tau0 = 30 sphere's radius


def test_lyb_line_consts():
    par = testing.lyb_params(n=5)
    cfg, jcfg = bridge.resolve_both(par)
    lc = pline.LineConsts.from_config(cfg)
    br = jcfg.line.branches[0]
    assert lc.line_type == 8 and lc.nup == 1 and lc.ndown[0] == 2
    assert lc.P_conv == float(np.float32(br.P_down[1]))
    assert lc.P_conv == pytest.approx(0.11834, abs=1e-5)
    assert not lc.per_lane_E and not lc.branch_init
    for k, f in enumerate(('E1', 'E2', 'E3')):
        assert getattr(lc, f)[0][:2] == tuple(getattr(br, f))
    assert (lc.E1s, lc.E2s, lc.E3s) == (br.E1[0], br.E2[0], br.E3[0])
    x = np.random.default_rng(3).uniform(-40.0, 40.0, 4000).astype(
        np.float32)
    a, D = float(np.float32(cfg.voigt_a_ref)), float(np.float32(
        cfg.Dfreq_ref))
    want = np.asarray(jeng.line_profile(jcfg, jnp.asarray(x), jnp.float32(a),
                                        jnp.float32(D)))
    got = pline.line_profile_plain(lc, torch.from_numpy(x), a, D).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def _grids(dust, **kw):
    par = testing.lyb_params(DGR=DGR_DUST if dust else 0.0, **kw)
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    return cfg, jcfg, meta, grid, jmeta, jgrid


@pytest.mark.parametrize('dust', (False, True))
def test_fly_band2_matches_make_fly(dust):
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(dust)
    flight = teng.make_fly(cfg, meta, grid)
    assert flight.lyb and (flight.rhokapD is not None) == dust
    s0 = testing.band2_lanes(testing.mixed_state(meta, 20_000, seed=51,
                                                 r_max=1.0), seed=52)
    b2 = s0.iband == 2
    assert 0.1 < float(b2.float().mean()) < 0.3
    js, jt = jax.jit(jeng.make_fly(jcfg, jmeta), static_argnums=3)(
        bridge.state_to_jax(s0), jgrid,
        jeng.zero_tallies(meta.nxfreq, lyb=True), cfg.par.fly_substeps)
    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 0, 'cpu', lyb=True)
    flight(st, tl, cfg.par.fly_substeps)
    frac, _ = testing.compare_states(st, convert.state_from_jax(js),
                                     rtol=1e-5, atol=1e-6)
    assert frac <= 1e-4, frac
    for f in ('Jout', 'Jout_Ha', 'W_oor', 'W_esc1', 'W_esc2'):
        a = getattr(tl, f)
        b = torch.as_tensor(np.array(getattr(jt, f)))
        atol = 1e-5 * max(float(b.abs().sum()), 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=f)
    # the H-alpha band escaped, and kept its frequency while flying
    assert float(tl.Jout_Ha.sum()) > 0.0 and float(tl.W_esc2) > 0.0
    kept = b2 & (st.phase == FLYING)
    assert torch.equal(st.xfreq[kept], s0.xfreq[kept])
    if not dust:
        # nothing stops the H-alpha band without dust
        assert not bool((b2 & (s0.phase == FLYING)
                         & (st.phase == AT_SCATTER)).any())


def _scatter_both(dust, B=30_000):
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(dust, n=9)
    p = teng.make_chunk(cfg, meta, grid).scatter_params
    s0 = testing.line_state(meta, B, 9, [0.0], width=3.0)
    testing.band2_lanes(s0, seed=10, frac=0.35)
    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 0, 'cpu', lyb=True)
    scatter.scatter(st, tl, p, seed=5, counter=3)
    js, jt = jax.jit(jeng.make_scatter(jcfg, jmeta))(
        bridge.state_to_jax(s0), jgrid,
        jeng.zero_tallies(meta.nxfreq, lyb=True), jax.random.PRNGKey(19))
    return cfg, s0, (st, tl), (convert.state_from_jax(js), jt)


@pytest.mark.parametrize('dust', (False, True))
def test_scatter_lyb_matches_make_scatter(dust):
    cfg, s0, (st, tl), (ref, rt) = _scatter_both(dust)
    b1, b2 = s0.iband == 1, s0.iband == 2
    out = {}
    for name, o, t in (('port', st, tl), ('lart_tpu', ref, rt)):
        done = o.phase == FLYING
        conv = b1 & done & (o.iband == 2)
        cos_turn = o.kx * s0.kx + o.ky * s0.ky + o.kz * s0.kz
        out[name] = {
            'scattered': float((b1 & done).float().mean()),
            'converted': float(conv.float().mean()),
            'W_conv': float(t.W_conv) / s0.batch,
            'resonances': float(t.nscatt_events) / s0.batch,
            'H-alpha dead': float((b2 & (o.phase == DEAD)).float().mean()),
            'H-alpha scattered': float((b2 & done).float().mean()),
            'x converted': (o.xfreq - s0.xfreq)[conv],
            'cos H-alpha': cos_turn[b2 & done]}
    a, b = out['port'], out['lart_tpu']
    assert a['converted'] > 0.02 and a['W_conv'] == pytest.approx(
        a['converted'], rel=1e-4)
    # P_down[1] of the resonance scatterings convert (at 30000 lanes, ~0.006)
    assert abs(a['converted'] / a['resonances'] - 0.11834) < 0.02
    if dust:
        assert a['H-alpha dead'] > 0.05 and a['H-alpha scattered'] > 0.1
    else:
        assert a['H-alpha dead'] == a['H-alpha scattered'] == 0.0
        assert torch.equal(st.xfreq[b2], s0.xfreq[b2])
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            if v.numel():
                pv = ks_2samp(v.numpy(), b[k].numpy()).pvalue
                assert pv > P_MIN, (dust, k, pv)
        else:
            assert abs(v - b[k]) < 0.01, (dust, k, v, b[k])
    if dust:
        wa = [float(getattr(t, f)) for t in (tl, rt)
              for f in ('W_abs1', 'W_abs2')]
        assert wa[1] > 0.0 and abs(wa[1] - wa[3]) < 0.01 * s0.batch


@pytest.mark.parametrize('mode', ('conversion', 'dust'))
def test_peel_lyb_matches_make_peel(mode):
    dust = mode == 'dust'
    cfg, jcfg, meta, grid, jmeta, jgrid = _grids(
        dust, n=9, save_peeloff=True, nobs=1, nxim=17, nyim=17,
        distance=1e3, alpha=(0.0,), beta=(0.0,))
    p = teng.make_chunk(cfg, meta, grid).peel
    assert p.lyb and p.scatter_mode & tpeel.CONVERSION
    jobs_meta, jodev = jobs.build_observers(jcfg)
    m = tpeel.CONVERSION if mode == 'conversion' else tpeel.DUST
    s = testing.band2_lanes(testing.mixed_state(meta, 8192, seed=71,
                                                r_max=1.0), seed=72,
                            frac=0.5)
    rec = testing.peel_record(s, seed=73)
    b2 = s.iband == 2
    pd = jpeel.make_peel(jcfg, jmeta, jobs_meta)
    free = dict(zip(pd[0].__code__.co_freevars,
                    (c.cell_contents for c in pd[0].__closure__)))
    jtau = jax.jit(free['tau_to_edge'], static_argnums=12)
    # pair by pair: the optical depth, and the edge pairs
    cell = (s.ic, s.jc, s.kc)
    pk, _, _, in_img = tpeel.obs_geometry(p, 0, s.x, s.y, s.z)
    xf = tpeel.event_frequency(p, m, s, rec, pk)[0]
    band = torch.ones_like(b2) if m == tpeel.CONVERSION else b2
    t = tpeel.tau_to_edge(p, (s.x, s.y, s.z), cell, pk, xf, in_img,
                          band2=band)
    j = jtau(jgrid, *(jnp.asarray(v.numpy()) for v in (
        s.x, s.y, s.z, s.ic, s.jc, s.kc, *pk, xf, in_img)),
        p.max_steps, None, jnp.asarray(band.numpy().astype(np.int32) + 1))
    t = torch.clamp_max(t, tpeel.TAU_STOP)
    j = torch.clamp_max(torch.as_tensor(np.array(j)), tpeel.TAU_STOP)
    off = in_img & ((t - j).abs() > TAU_ATOL + TAU_RTOL * j.abs())
    edge = in_img & _edge(p, m, s, rec, 0)
    n = int(in_img.sum())
    assert n > 0.2 * s.batch and int(off.sum()) <= TAU_FRAC * n
    assert int(edge.sum()) <= 0.05 * n
    good = ~(off | edge)
    if not dust:
        # the H-alpha photon's sightline is empty without dust
        assert float(t.abs().max()) == 0.0
    rec.flag.copy_(good.to(torch.int32) * m)
    cubes = p.zero_cubes('cpu')
    tpeel.peel(s, cubes, rec, p, m)
    js = bridge.state_to_jax(s)
    active = jnp.asarray(good.numpy())
    zero = jpeel.zero_cubes(jcfg, jmeta, jobs_meta)
    if m == tpeel.DUST:
        ref = jax.jit(pd[2])(zero, jgrid, jodev, js, active)
    else:
        line = jcfg.line.branches[0]
        ev = {'E1': jnp.full((s.batch,), line.E1[1], jnp.float32),
              'E2': jnp.full((s.batch,), line.E2[1], jnp.float32)}
        ref = jax.jit(lambda c, g, od, st, a, ux, uy, uz: pd[3](
            c, g, od, dict(ev, state=st), a, ux, uy, uz))(
            zero, jgrid, jodev, js, active,
            *(jnp.asarray(getattr(rec, f).numpy())
              for f in ('ux', 'uy', 'uz')))
    for name in ('scatt', 'Ha'):
        cube = getattr(cubes, name)
        want = torch.as_tensor(np.array(getattr(ref, name)))
        atol = 1e-5 * max(float(want.abs().sum()), 1e-30)
        torch.testing.assert_close(cube, want, rtol=0, atol=atol,
                                   msg=f'{mode} {name}')
    assert float(cubes.Ha.sum()) > 0.0
    assert (float(cubes.scatt.sum()) > 0.0) == dust


NPH, B = 2000, 2560


@functools.lru_cache(maxsize=None)
def _runs(dust):
    par = dataclasses.replace(
        testing.lyb_params(DGR=DGR_DUST if dust else 0.0, nphotons=NPH,
                           batch=B),
        save_peeloff=True, nobs=1, nxim=17, nyim=17, distance=1e3,
        alpha=(0.0,), beta=(0.0,))
    return {'lart_tpu_torch': bridge.run_port_cpu(par, seed=23),
            'lart_tpu': jdriver.run(bridge.jax_params(par), seed=23)}


@pytest.mark.parametrize('dust', (False, True))
def test_lyb_run_matches_lart_tpu(dust):
    r = _runs(dust)
    for name, res in r.items():
        assert abs(res.W_esc1 + res.W_abs1 + res.W_conv - 1.0) < 1e-3, name
        assert abs(res.W_esc2 + res.W_abs2 - res.W_conv) < 1e-3, name
        assert abs(res.W_conv / res.nscatt_gas - 0.11834) < 0.02, name
        assert res.W_conv > 0.5
        dy = 1.0 / len(res.y_2gam)
        assert float(res.J2gam.sum() * dy) == pytest.approx(
            2.0 * res.W_conv, rel=1e-3)
        assert (res.W_abs2 > 0.0) == dust
        (c,) = testing.peel_closure(res, ('Ha',), res.W_esc2)
        assert abs(c - 1.0) < 3.0 * np.sqrt(testing.PEEL_V_PHOTON / NPH), (
            name, c)
    t, j = r['lart_tpu_torch'], r['lart_tpu']
    for k, w in (('Jout', 'W_esc1'), ('Jout_Ha', 'W_esc2')):
        chi2, nbins = testing.spectra_chi2(getattr(t, k), getattr(j, k),
                                           NPH * getattr(t, w),
                                           NPH * getattr(j, w))
        assert nbins >= 3 and chi2 < 3.0, (dust, k, chi2, nbins)
    p = 0.5 * (t.W_conv + j.W_conv)
    assert abs(t.W_conv - j.W_conv) <= 3.0 * np.sqrt(2.0 * p * (1.0 - p)
                                                     / NPH)
