"""Line types 2 and 4-7 in lart_tpu_torch against lart_tpu on the CPU: the
line's opacity profile, the birth shift of a multi-level line, the
redistribution at a scattering (the plain version of kernel K4's), the
coherent He I weights, recoil, and continuum births.

- The profile (physics/line.py line_profile_plain, csrc/line.cuh's twin)
  against engine.line_profile for every line type at injected x and a, to
  rtol 2e-6: the same Humlicek regions in the same order, an ulp or two of
  XLA's fused multiply-adds in the sums.
- branch_init_shift: B = 1e5 births of each multi-level type.  The packages
  draw from different generators, so the shift values must be the same f32
  numbers in both (exactly), and the counts of each value must follow the
  catalog's probabilities (1/3 for the doublet's K line, P_down, f12 / sum
  f12 times P_down) by a chi-square test, p > P_MIN, in each package.
- The scatter: one numpy-made state of 30000 lanes at a scattering, their
  frequencies around the line's components (testing.line_state), through
  the port's plain scatter and make_scatter: the share of lanes that
  scattered and (types 4, 5) the share that went to a fluorescent branch
  within 0.01 (at 30000 lanes each share's binomial sigma is <= 0.003),
  and two-sample Kolmogorov-Smirnov tests, p > P_MIN, on the new
  frequency, the frequency change, the cosine of the turn and, with
  Stokes, the new Q and U.
- The coherent He I weights at injected xfreq_atom against a float64
  transcription of line_mod.f90 compute_HeI_E_coherent, to 1e-5.
- Recoil, with its constants scaled by RECOIL_SCALE in both packages (as
  written the shift is below an f32 ulp of most frequencies): with and
  without recoil from one state and one seed, the frequencies of each
  package differ by (g0 / D)(1 - cos theta), g0 the hydrogen constant or,
  at a deuterium event of type 7, g_recoil0_D, to 1e-3 of it; the port's
  g0 / D as written is lart_tpu's f32 quotient, exactly.
- Continuum births: the port's refill against make_refill on the Si II
  1193 continuum, KS on the birth frequency (the branch shift is dropped,
  as lart_tpu's continuum drops it) and Jin bin by bin to Poisson noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare, ks_2samp

from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.physics import line as pline
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import refill, scatter
from lart_tpu_torch.transport.state import FFS, FLYING, init_state, \
    zero_tallies

import _torch_jax_bridge as bridge

P_MIN = 1e-3
PROFILE_RTOL = 2e-6
LINE_IDS = ('ly_alpha', 'MgII_2796', 'SiII_1527', 'SiII_1193', 'FeII_UV1',
            'HeI_10833', 'ly_alpha_HD')


def _line_cfgs(line_id, **kw):
    par = testing.sphere_params(n=5, line_id=line_id, D_to_H_ratio=3e-5,
                                **kw)
    cfg, jcfg = bridge.resolve_both(par)
    return cfg, jcfg, pline.LineConsts.from_config(cfg)


@pytest.mark.parametrize('line_id', LINE_IDS)
def test_line_profile_matches_jax(line_id):
    cfg, jcfg, lc = _line_cfgs(line_id)
    D = float(np.float32(cfg.Dfreq_ref))
    q = pline.line_prof(lc, cfg.voigt_a_ref, D)
    rng = np.random.default_rng(3)
    centres = [-d for d in q.dx]
    x = np.concatenate([rng.uniform(-3e3, 3e3, 2000),
                        rng.uniform(-40.0, 40.0, 4000)]
                       + [c + rng.normal(0.0, 3.0, 2000) for c in centres])
    x = x.astype(np.float32)
    for a in (cfg.voigt_a_ref, 1e-3, 0.05):
        a = float(np.float32(a))
        want = np.asarray(jeng.line_profile(jcfg, jnp.asarray(x),
                                            jnp.float32(a), jnp.float32(D)))
        got = pline.line_profile_plain(lc, torch.from_numpy(x), a, D).numpy()
        np.testing.assert_allclose(got, want, rtol=PROFILE_RTOL, atol=0)
        assert np.all(got > 0.0)


def _shift_categories(lc, D):
    """{f32 shift: probability} of a multi-level line's births, the
    shifts from the port's function at the middle of each interval."""
    def at(u0, u1):
        return float(pline.branch_init_shift_plain(
            lc, torch.tensor([u0]), torch.tensor([u1]), D)[0])
    if lc.line_type == 2:
        return {at(1 / 6, 0.5): 1 / 3, at(2 / 3, 0.5): 2 / 3}
    ups = [(0.0, 1.0)] if lc.line_type == 4 else [
        (lc.f_cum[i - 1] if i else 0.0, lc.f_cum[i]) for i in range(lc.nup)]
    out = {}
    for i, (lo, hi) in enumerate(ups):
        nd = max(lc.ndown[i], 1)
        cums = [0.0] + list(lc.P_cum[i][:nd]) if nd > 1 else [0.0, 1.0]
        for j in range(nd):
            pj = cums[j + 1] - cums[j]
            if lc.line_type == 4:
                v = at(0.5 * (cums[j] + cums[j + 1]), 0.5)
            else:
                v = at(0.5 * (lo + hi), 0.5 * (cums[j] + cums[j + 1]))
            out[v] = out.get(v, 0.0) + (hi - lo) * pj
    return out


@pytest.mark.parametrize('line_id', ('MgII_2796', 'SiII_1527', 'SiII_1193',
                                     'FeII_UV1', 'HeI_10833'))
def test_branch_init_shift_matches_jax(line_id):
    cfg, jcfg, lc = _line_cfgs(line_id)
    B = 100_000
    D = float(np.float32(cfg.Dfreq_ref))
    u = np.random.default_rng(7).random((2, B)).astype(np.float32)
    got = pline.branch_init_shift_plain(lc, torch.from_numpy(u[0]),
                                        torch.from_numpy(u[1]), D).numpy()
    want = np.asarray(jeng.branch_init_shift(jcfg, jax.random.PRNGKey(5),
                                             (B,), jnp.float32(D)))
    cats = _shift_categories(lc, D)
    assert len(cats) >= 2 and sum(cats.values()) == pytest.approx(1.0)
    # the same f32 values in both, exactly
    assert set(np.unique(got).tolist()) == set(cats) == set(
        np.unique(want).tolist())
    keys = sorted(cats)
    for sample in (got, want):
        n = np.array([np.sum(sample == k) for k in keys])
        p = chisquare(n, B * np.array([cats[k] for k in keys])).pvalue
        assert p > P_MIN, (line_id, n, p)


def _big_recoil(line, scale):
    """lart_tpu's line with its recoil constants times `scale`."""
    base = type(line)

    class Scaled(base):
        @property
        def g_recoil0(self):
            return base.g_recoil0.fget(self) * scale

        @property
        def g_recoil0_D(self):
            return base.g_recoil0_D.fget(self) * scale
    return Scaled(**{f.name: getattr(line, f.name)
                     for f in dataclasses.fields(line)})


def _scatter_both(case, B=30_000, stokes=False, recoil=None, seed=3,
                  key=11, recoil_scale=1.0):
    """The port's plain scatter and make_scatter from one state; with
    recoil_scale the recoil constants of both are scaled."""
    over = {} if recoil is None else {'recoil': recoil}
    par = testing.line_params(case, n=9, use_stokes=stokes, **over)
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    p = teng.make_chunk(cfg, meta, grid).scatter_params
    if recoil_scale != 1.0:
        lc = p.line
        p = dataclasses.replace(p, line=dataclasses.replace(
            lc, g_recoil0=pline.f32(cfg.line.g_recoil0 * recoil_scale),
            g_recoil0_D=pline.f32(cfg.line.g_recoil0_D * recoil_scale)
            if lc.line_type == 7 else 0.0))
        jcfg = dataclasses.replace(jcfg, line=_big_recoil(jcfg.line,
                                                          recoil_scale))
    q = pline.line_prof(p.line, p.a, p.Dfreq)
    offsets = [-d for d in q.dx[:max(p.line.nup, 2)]]
    s0 = testing.line_state(meta, B, 5, offsets)
    st = testing.clone_state(s0)
    scatter.scatter(st, zero_tallies(meta.nxfreq, 0, 'cpu'), p, seed=seed,
                    counter=9)
    js, _ = jax.jit(jeng.make_scatter(jcfg, jmeta))(
        bridge.state_to_jax(s0), jgrid, jeng.zero_tallies(meta.nxfreq),
        jax.random.PRNGKey(key))
    return p, s0, st, convert.state_from_jax(js)


def _fluorescent_shift(p):
    """Half the first fluorescent branch's shift, in Doppler units."""
    return 0.5 * pline.div32(p.line.Elow_Hz[0][1], p.Dfreq)


@pytest.mark.parametrize('case', sorted(testing.LINE_CASES))
def test_scatter_matches_make_scatter(case):
    stokes = case == 'multiplet'
    p, s0, st, ref = _scatter_both(case, stokes=stokes)
    out = {}
    for name, o in (('port', st), ('lart_tpu', ref)):
        done = o.phase == FLYING
        dx = (o.xfreq - s0.xfreq)[done]
        out[name] = {
            'done': float(done.float().mean()),
            'xfreq': o.xfreq[done], 'dx': dx,
            "cos(k, k')": (o.kx * s0.kx + o.ky * s0.ky + o.kz * s0.kz)[done],
            **({'Q': o.Q[done], 'U': o.U[done]} if stokes else {})}
        if p.line.line_type in (4, 5):
            out[name]['fluorescent'] = float(
                (dx < -_fluorescent_shift(p)).float().mean())
    t, j = out['port'], out['lart_tpu']
    assert t['done'] > 0.9 and abs(t['done'] - j['done']) < 0.01
    if 'fluorescent' in t:
        assert 0.1 < t['fluorescent'] < 0.9
        assert abs(t['fluorescent'] - j['fluorescent']) < 0.01, (t, j)
    for k, v in t.items():
        if isinstance(v, torch.Tensor):
            pv = ks_2samp(v.numpy(), j[k].numpy()).pvalue
            assert pv > P_MIN, (case, k, pv)


def _he_coherent_f64(xa, Dx2, Dx3):
    """line_mod.f90 compute_HeI_E_coherent in float64."""
    D2, D1, D0 = xa, xa + Dx2, xa + Dx3
    pqq = D2 * D0 * D1
    den = 4.0 * ((D2 * D1) ** 2 + 3.0 * (D2 * D0) ** 2 + 5.0 * (D0 * D1) ** 2)
    E1 = (3.0 * (D2 * D0) ** 2 + 7.0 * (D0 * D1) ** 2 + 8.0 * pqq * D1
          + 18.0 * pqq * D0) / den
    E3 = (3.0 * (D2 * D0) ** 2 + 15.0 * (D0 * D1) ** 2 + 8.0 * D2 * pqq
          + 10.0 * pqq * D0) / den
    return E1, 1.0 - E1, E3


def test_he_coherent_weights():
    cfg, _, lc = _line_cfgs('HeI_10833', HeI_coherent=True)
    assert lc.he_coherent
    q = pline.line_prof(lc, cfg.voigt_a_ref, cfg.Dfreq_ref)
    rng = np.random.default_rng(4)
    xa = np.concatenate([rng.uniform(-8.0, 4.0, 20000),
                         rng.uniform(-300.0, 300.0, 2000)]).astype(np.float32)
    got = pline.he_coherent_E(torch.from_numpy(xa), q.dx[1], q.dx[2])
    want = _he_coherent_f64(xa.astype(np.float64), q.dx[1], q.dx[2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    # far from the levels the weights tend to the incoherent sum's
    far = np.abs(xa) > 100.0
    assert np.all(np.abs(got[0].numpy()[far] - want[0][far]) < 1e-5)


RECOIL_SCALE = 1e6


@pytest.mark.parametrize('case', ['multiplet', 'hd'])
def test_recoil_shift(case):
    """As written the shift, (g0 / D)(1 - cos) ~ 1e-7 Doppler widths, is
    below an f32 ulp of most frequencies, so both packages run with the
    constants times RECOIL_SCALE (lart_tpu's through a subclass of its
    Line): each package's frequencies with recoil differ from those without
    by (g0 / D)(1 - cos theta), g0 the hydrogen constant or, at a deuterium
    event of type 7, g_recoil0_D, to 1e-3 of it (on the lanes at |x| < 30,
    where the f32 rounding of the frequency is < 2e-4 of the shift and the
    cosine recovered from the directions good to 1e-6); the deuterium events'
    share agrees within 0.01.  The port's quotients g0 / D as written are
    lart_tpu's f32 quotients, exactly."""
    on = _scatter_both(case, recoil=True, recoil_scale=RECOIL_SCALE)
    off = _scatter_both(case, recoil=False, recoil_scale=RECOIL_SCALE)
    p = on[0]
    g0 = [pline.div32(p.line.g_recoil0, p.Dfreq)]
    if p.line.line_type == 7:
        g0.append(pline.div32(p.line.g_recoil0_D, p.Dfreq))
    shares = []
    for k in (2, 3):      # the port, then lart_tpu
        a, b, s0 = on[k], off[k], on[1]
        done = (a.phase == FLYING) & (b.phase == FLYING)
        cost = (a.kx * s0.kx + a.ky * s0.ky + a.kz * s0.kz)[done].double()
        d = (b.xfreq - a.xfreq)[done].double()
        # lanes whose f32 frequency rounds the shift to < 2e-4 of it
        sel = ((1.0 - cost) > 0.2) & (a.xfreq[done].abs() < 30.0)
        assert int(sel.sum()) > 1000
        ratio = d[sel] / (1.0 - cost[sel])
        near = torch.stack([torch.isclose(ratio, torch.tensor(
            v, dtype=torch.float64), rtol=1e-3, atol=0.0) for v in g0])
        assert bool(near.any(0).all()), (case, k)
        shares.append(float(near[-1].double().mean()))
    if len(g0) > 1:
        assert 0.0 < shares[0] < 0.5 and abs(shares[0] - shares[1]) < 0.01
    # the constants as written: lart_tpu's f32 quotients
    line = on[0].line
    cfg = testing.line_params(case, n=5).resolve()
    want = jnp.float32(cfg.line.g_recoil0) / jnp.float32(p.Dfreq)
    assert pline.div32(pline.f32(cfg.line.g_recoil0), p.Dfreq) == float(want)
    assert line.line_type in (5, 7)


def test_continuum_births_match_make_refill():
    par = testing.line_params('multiplet', n=9, batch=30_000)
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    rp = teng.make_chunk(cfg, meta, grid).refill_params
    assert rp.spectrum == refill.SPECTRUM_CONT and rp.line.branch_init
    B = 30_000
    st = init_state(B, 'cpu')
    tl = zero_tallies(meta.nxfreq, 0, 'cpu')
    refill.refill(st, tl, rp, 3, 0, 10 ** 9)
    js, jt = jax.jit(jeng.make_refill(jcfg, jmeta))(
        jeng.init_state(B), jgrid, jeng.zero_tallies(meta.nxfreq, nmu=0),
        jax.random.PRNGKey(4), jnp.asarray([10 ** 9], jnp.int32))
    assert bool((st.phase == FFS).all())
    xt, xj = st.xfreq.numpy(), np.asarray(js.xfreq)
    for x in (xt, xj):
        assert x.min() >= np.float32(meta.xfreq_min)
        assert x.max() <= np.float32(meta.xfreq_max)
    assert ks_2samp(xt, xj).pvalue > P_MIN
    a, b = tl.Jin.numpy(), np.asarray(jt.Jin)
    assert a.sum() == pytest.approx(B, abs=1) and b.sum() == pytest.approx(
        B, abs=1)
    sel = (a + b) > 0
    assert np.sum((a[sel] - b[sel]) ** 2 / (a[sel] + b[sel])) / sel.sum() < 3


def test_check_supported_names_what_is_not_ported():
    """Ly-beta (line type 8) and H2 pumping are ported: check_supported
    passes them, and every metal-line case, and with the all-photons table;
    a feature still unported is still named."""
    for over in ({'line_id': 'ly_beta'}, {'h2_model': 'neufeld'},
                 {'line_id': 'ly_beta', 'DGR': 1e-3}):
        teng.check_supported(testing.sphere_params(n=5, **over).resolve())
    for case in testing.LINE_CASES:
        teng.check_supported(testing.line_params(case, n=5).resolve())
    teng.check_supported(testing.sphere_params(
        n=5, line_id='ly_beta', save_all_photons=True).resolve())
    cfg = testing.sphere_params(n=5, line_id='ly_beta',
                                checkpoint_file='ck.h5').resolve()
    with pytest.raises(NotImplementedError, match='checkpoint_file'):
        teng.check_supported(cfg)
