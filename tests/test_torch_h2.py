"""H2 pumping of Ly-alpha in lart_tpu_torch against lart_tpu on the CPU: the
Neufeld two-line table, its opacity (row 12: csrc/h2.cuh's plain twin),
the walk (kernel K5's plain version), the scatter's H2 branch (K4's), and
driver.run as a whole.

- h2_init: every constant of the table equals lart_tpu's exactly (both
  are the same f64 arithmetic on the same energy table), with and without
  h2_pure_absorption, turbulence and h2_hi_width.
- h2_kappa and h2_line_weights at injected x and Doppler widths D, with
  and without h2_hi_width, to rtol 2e-6: the same f32 divisions and
  products, an ulp or two of XLA's fused multiply-adds in the Voigt terms
  and the sum.
- The walk on a 17^3 sphere of testing.h2_params: one numpy-made state
  through both, lane by lane, as tests/test_torch_fly_cartesian.py holds
  the walk (1e-4 of the lanes may flip on a last-ulp difference).
- The scatter on 30000 lanes at a scattering, their frequencies around
  the two H2 lines and H I's line centre (f_H2 raised so that both lines
  pump): the shares of the H2 events, of
  the destroyed ones and of each pumped line, and of the scattered lanes,
  within 0.01 (at 30000 lanes each share's binomial sigma is < 0.003);
  a KS test, p > P_MIN, on the new frequency of the scattered lanes; for
  Ly-alpha (line type 1) and H + D Ly-alpha (type 7, the kernels' other
  instance).
- A run with h2_model 'none' equals the bare run, every tally exactly
  (examples/h2_test/check_bit_identity.py's contract), and so does a run
  with H2 on and f_H2 = 0: the H2 draws take Philox blocks of their own.
- driver.run on testing.h2_params (tau0 10, f_H2 raised from 0.03 to 30
  so that the R(6) line next to H I's core destroys ~12% of the photons:
  as written, H2 takes part only past |x| ~ 6.5, where few photons of a
  thin sphere go) against lart_tpu's, NPH photons each at B = 4096 as
  tests/test_torch_lines_slice.py runs them: in each, W_esc + W_oor +
  W_H2abs = 1 to 1e-3; W_H2abs within 3 sigma of its binomial spread; the
  mean scatterings per photon within 5% (a per-photon relative variance
  near 1 gives each mean 1.6%); the escaped spectra's shapes chi2/dof < 3.
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
from lart_tpu.physics import h2 as jh2
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, driver, testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.physics import h2 as ph2
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import scatter
from lart_tpu_torch.transport.state import FLYING, DEAD, zero_tallies

import _torch_jax_bridge as bridge


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The plain versions in one torch thread: under Tier-1's six workers
    torch's default pool oversubscribes the cores (in a whole run
    test_h2_off_draws_as_before took 790 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

P_MIN = 1e-3
KAPPA_RTOL = 2e-6
TABLES = {
    'h2_on': {},
    'pure_absorption_bturb': dict(h2_pure_absorption=True, bturb=5.0),
    'hi_width_300K': dict(h2_hi_width=True, h2_temperature=300.0),
}


def _cfgs(**kw):
    return bridge.resolve_both(testing.h2_params(n=5, **kw))


@pytest.mark.parametrize('table', sorted(TABLES))
def test_h2_init_matches_lart_tpu(table):
    cfg, jcfg = _cfgs(**TABLES[table])
    mine = ph2.h2_setup(cfg)
    want = jeng.h2_setup(jcfg)
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    assert mine.n_lines == 2 and mine.hi_width == cfg.par.h2_hi_width
    h = ph2.H2Consts.from_setup(mine)
    for f in ('dnu', 'strength', 'a_damp', 'p_scat'):
        assert getattr(h, f) == tuple(
            float(np.float32(v)) for v in getattr(want, f if f != 'dnu'
                                                  else 'dnu_Hz'))


@pytest.mark.parametrize('hi_width', (False, True))
def test_h2_opacity_matches_lart_tpu(hi_width):
    cfg, jcfg = _cfgs(h2_hi_width=hi_width)
    h = ph2.H2Consts.from_config(cfg)
    jh = jeng.h2_setup(jcfg)
    rng = np.random.default_rng(5)
    D0 = float(np.float32(cfg.Dfreq_ref))
    centres = [float(np.float32(d) / np.float32(D0)) for d in h.dnu]
    x = np.concatenate([rng.uniform(-300.0, 300.0, 3000),
                        rng.uniform(-15.0, 15.0, 3000)]
                       + [c + rng.normal(0.0, 1.0, 3000) for c in centres])
    x = x.astype(np.float32)
    for D in (D0, float(np.float32(1.7 * D0))):
        xt, xj, Dj = torch.from_numpy(x), jnp.asarray(x), jnp.float32(D)
        got = ph2.h2_kappa_plain(h, xt, D).numpy()
        want = np.asarray(jh2.h2_kappa(jh, xj, Dj))
        np.testing.assert_allclose(got, want, rtol=KAPPA_RTOL, atol=0)
        for g, w in zip(ph2.h2_line_weights_plain(h, xt, D),
                        jh2.h2_line_weights(jh, xj, Dj)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=KAPPA_RTOL, atol=0)
        assert np.all(got > 0.0)
        # each line peaks at its own centre
        for i, c in enumerate(centres):
            w = ph2.h2_line_weights_plain(h, torch.tensor(
                [c * D0 / D, c * D0 / D + 3.0]), D)[i]
            assert float(w[0]) > 10.0 * float(w[1])


def test_fly_h2_matches_make_fly():
    cfg, jcfg = bridge.resolve_both(testing.h2_params(tau0=100.0))
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    flight = teng.make_fly(cfg, meta, grid)
    assert flight.h2 is not None
    s0 = testing.mixed_state(meta, 20_000, seed=41, r_max=1.0)
    # a share of the lanes in the H2 lines' wings
    rng = np.random.default_rng(42)
    pick = torch.as_tensor(rng.random(s0.batch) < 0.3)
    s0.xfreq.copy_(torch.where(pick, torch.as_tensor(
        rng.normal(-7.7, 1.5, s0.batch), dtype=torch.float32), s0.xfreq))
    st, tl, ref, ref_t = bridge.fly_both(
        jeng.make_fly(jcfg, jmeta), jgrid, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps, nmu=0)
    frac, _ = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= 1e-4, frac
    bridge.assert_tallies_close(tl, ref_t)
    # the H2 opacity stopped lanes that H I alone would have let through
    h = ph2.H2Consts.from_config(cfg)
    f = flight.flat(s0.ic, s0.jc, s0.kc)
    k_h2 = flight.rhokap[f] * ph2.h2_kappa_plain(h, s0.xfreq, flight.Dfreq)
    assert float(k_h2[pick].mean()) > float(
        (flight.rhokap[f] * flight.profile(s0.xfreq))[pick].mean())


def _scatter_both(case, B=30_000):
    # f_H2 raised from 0.03 to 100, so that the R(6) line near H I's core
    # (x ~ -1.1, where H I's opacity is 2e4 times its own as written) takes
    # a share of the events too
    over = dict(f_H2=100.0)
    par = testing.h2_params(n=9, **over) if case == 'lya' else \
        testing.line_params('hd', n=9, h2_model='neufeld',
                            h2_temperature=8000.0, D_to_H_ratio=3e-3, **over)
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    p = teng.make_chunk(cfg, meta, grid).scatter_params
    assert p.h2 is not None
    # the H2 lines sit at x = dnu / D
    centres = [float(np.float32(d) / np.float32(p.Dfreq)) for d in p.h2.dnu]
    s0 = testing.line_state(meta, B, 7, centres + [0.0], width=1.5)
    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 0, 'cpu', h2=True)
    scatter.scatter(st, tl, p, seed=5, counter=3)
    jt0 = jeng.zero_tallies(meta.nxfreq)
    js, jt = jax.jit(jeng.make_scatter(jcfg, jmeta))(
        bridge.state_to_jax(s0), jgrid, jt0, jax.random.PRNGKey(13))
    return s0, (st, tl), (convert.state_from_jax(js), jt)


@pytest.mark.parametrize('case', ('lya', 'hd'))
def test_scatter_h2_matches_make_scatter(case):
    s0, (st, tl), (ref, rt) = _scatter_both(case)
    B = s0.batch
    out = {}
    for name, o, t in (('port', st, tl), ('lart_tpu', ref, rt)):
        pump = np.asarray(t.W_H2pump, np.float64)
        dead = o.phase == DEAD
        done = o.phase == FLYING
        h2sc = float(t.W_H2scat)
        out[name] = {'pumped': float(pump.sum()) / B,
                     'line 2': float(pump[1] / max(pump.sum(), 1e-30)),
                     'destroyed': float(dead.float().mean()),
                     'H2 scattered': h2sc / B,
                     'scattered': float(done.float().mean()),
                     'xfreq': o.xfreq[done]}
        assert abs(float(t.W_H2abs) - float(dead.sum())) < 1e-3 * B
    a, b = out['port'], out['lart_tpu']
    assert 0.05 < a['pumped'] < 0.95 and 0.05 < a['destroyed']
    assert 0.0 < a['line 2'] < 1.0 and a['H2 scattered'] > 0.0
    for k in ('pumped', 'line 2', 'destroyed', 'H2 scattered', 'scattered'):
        assert abs(a[k] - b[k]) < 0.01, (case, k, a[k], b[k])
    pv = ks_2samp(a['xfreq'].numpy(), b['xfreq'].numpy()).pvalue
    assert pv > P_MIN, (case, pv)


def _tallies(res):
    out = {k: getattr(res, k) for k in ('Jin', 'Jout', 'nscatt_gas',
                                         'nscatt_events', 'W_oor')}
    out['Jabs'] = res.Jabs
    return out


def test_h2_off_draws_as_before():
    """h2_model 'none' is the bare run, and H2 on with f_H2 = 0 (no H2
    opacity) draws every other uniform as the run without H2, so every
    tally agrees exactly.  The bare run takes the generic walk, as H2 does
    (force_generic_kernel; without core-skip, whose threshold the sphere's
    fast path takes from its constant opacity)."""
    common = dict(tau0=10.0, n=9, nphotons=200, batch=256, xfreq_min=-12.0,
                  xfreq_max=12.0, nxfreq=241, save_Jmu=False,
                  force_generic_kernel=True)
    bare = driver.run(testing.sphere_params(**common), device='cpu', seed=21)
    for over in (dict(h2_model='none'),
                 dict(h2_model='neufeld', f_H2=0.0, h2_temperature=8000.0)):
        res = driver.run(testing.sphere_params(**common, **over),
                         device='cpu', seed=21)
        for k, v in _tallies(bare).items():
            w = _tallies(res)[k]
            assert np.array_equal(np.asarray(v), np.asarray(w)), (over, k)
        assert (res.W_H2pump is None) == (over.get('h2_model') == 'none')


NPH = 4000


@functools.lru_cache(maxsize=None)
def _runs():
    par = testing.h2_params(tau0=10.0, nphotons=NPH, batch=4096, f_H2=30.0)
    return {'lart_tpu_torch': bridge.run_port_cpu(par, seed=17),
            'lart_tpu': jdriver.run(bridge.jax_params(par), seed=17)}


def test_h2_run_matches_lart_tpu():
    r = _runs()
    for name, res in r.items():
        w = res.W_escape + res.W_oor + res.W_H2abs
        assert abs(w - 1.0) < 1e-3, (name, res.W_escape, res.W_oor,
                                     res.W_H2abs)
        assert res.W_H2abs > 0.05 and res.W_H2pump.sum() >= res.W_H2abs
    t, j = r['lart_tpu_torch'], r['lart_tpu']
    p = 0.5 * (t.W_H2abs + j.W_H2abs)
    assert abs(t.W_H2abs - j.W_H2abs) <= 3.0 * np.sqrt(
        2.0 * p * (1.0 - p) / NPH), (t.W_H2abs, j.W_H2abs)
    assert t.nscatt_gas == pytest.approx(j.nscatt_gas, rel=0.05)
    chi2, nbins = testing.spectra_chi2(t.Jout, j.Jout, NPH * t.W_escape,
                                       NPH * j.W_escape)
    assert nbins >= 5 and chi2 < 3.0, (chi2, nbins)
