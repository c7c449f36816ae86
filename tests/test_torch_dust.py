"""Dust in lart_tpu_torch against lart_tpu on the CPU: the pure math of the
dust's phase functions (injected uniforms, to f32 tolerance) and the dust
branch of the scatter's plain version (kernel K4's) against make_scatter.

The math: rand_henyey_greenstein, build_alias_table, the Mueller tables'
sample_cost (fed the very uniforms that lart_tpu's sample_cost draws from
its key) and interp_S, each to 1e-6 (XLA contracts a multiply feeding an
add into one FMA; the port rounds twice, an ulp of values of order 1-10).

The scatter: the two packages draw from different generators, so one
numpy-made state of lanes at a scattering in the dusty shell of
testing.dust_params goes through both and the outcomes agree
statistically: the shares of dust events, absorptions and dust
scatterings within 0.01, two-sample Kolmogorov-Smirnov tests (p > 1e-3) on
the dust-scattered lanes' new k_z, their cosine of turn and (Mueller) their
Stokes Q and U, the Jabs spectra's chi2/dof < 3 and nscatt_dust within 2%;
under use_reduced_wgt (with HG) nothing is absorbed and a dust-scattered
lane keeps its weight times the albedo (to 1e-6)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from lart_tpu.grid import cartesian as jcart
from lart_tpu.physics import mueller as jmueller
from lart_tpu.physics import samplers as jsamplers
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.physics import mueller as tmueller
from lart_tpu_torch.physics import samplers as tsamplers
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import scatter
from lart_tpu_torch.transport.state import (AT_SCATTER, DEAD, FLYING,
                                            LANE_FIELDS, zero_tallies)

import _torch_jax_bridge as bridge

TOL = 1e-6
P_MIN = 1e-3
TABLES = ('mueller_Lyalpha.dat', 'mueller_1548.dat')


@pytest.mark.parametrize('g', [0.0, 0.6761, -0.3])
def test_henyey_greenstein_matches_jax(g):
    xi = np.random.default_rng(1).random(100_000).astype(np.float32)
    xi[:3] = (1e-12, 0.5, 1.0 - 2.0 ** -24)
    want = np.asarray(jsamplers.rand_henyey_greenstein(jnp.asarray(xi), g))
    got = tsamplers.rand_henyey_greenstein(torch.from_numpy(xi), g).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_alias_table_matches_jax():
    rng = np.random.default_rng(2)
    meta, t = tmueller.load_mueller(TABLES[0])
    pdf = 0.5 * (t['S11'][:-1] + t['S11'][1:])
    for p in (pdf / pdf.sum(), rng.random(37), np.ones(8)):
        prob, alias = tsamplers.build_alias_table(p)
        jprob, jalias = jsamplers.build_alias_table(p)
        np.testing.assert_array_equal(prob, jprob)
        np.testing.assert_array_equal(alias, jalias)


@pytest.mark.parametrize('table', TABLES)
def test_mueller_sample_cost_matches_jax(table):
    jmeta, jdev = jmueller.load_mueller(table)
    t = tmueller.MuellerTable.load(table)
    assert t.n == jmeta.n and t.dcos == jmeta.dcos
    for f in ('coss', 'S11', 'S12', 'S33', 'S34'):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(jdev, f)))
    np.testing.assert_array_equal(t.prob.numpy(), np.asarray(jdev.bin_prob))
    np.testing.assert_array_equal(t.alias.numpy(), np.asarray(jdev.bin_alias))
    shape = (200_000,)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jmueller.sample_cost(key, jdev, shape))
    # the uniforms of sample_cost (mueller.py:84, :90) and alias_sample
    k1, k2 = jax.random.split(key)
    xi = np.asarray(jax.random.uniform(k1, (2,) + shape, jnp.float32))
    u = np.asarray(jax.random.uniform(k2, shape, jnp.float32))
    got = tmueller.sample_cost(t, *(torch.from_numpy(v) for v in (xi[0],
                                                                   xi[1], u)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the draw follows S11: its histogram against the table's bin weights
    hist = np.histogram(want, bins=np.asarray(jdev.coss))[0]
    pdf = np.asarray(jdev.S11)
    p = 0.5 * (pdf[:-1] + pdf[1:])
    exp = p / p.sum() * shape[0]
    assert np.sum((hist - exp) ** 2 / exp) / len(exp) < 2.0


@pytest.mark.parametrize('table', TABLES)
def test_mueller_interp_matches_jax(table):
    jmeta, jdev = jmueller.load_mueller(table)
    t = tmueller.MuellerTable.load(table)
    rng = np.random.default_rng(3)
    cost = np.concatenate([[-1.0, 1.0], np.asarray(jdev.coss),
                           rng.uniform(-1.0, 1.0, 10_000)]).astype(np.float32)
    want = jmueller.interp_S(jdev, jmeta, jnp.asarray(cost))
    got = tmueller.interp_S(t, torch.from_numpy(cost))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def _scatter_both(stokes, reduced=False, B=30_000):
    par = testing.dust_params(stokes=stokes, use_reduced_wgt=reduced)
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    p = teng.make_chunk(cfg, meta, grid).scatter_params
    assert p.dust == (scatter.DUST_MUELLER if stokes else scatter.DUST_HG)
    s0 = testing.dust_state(meta, grid, B, seed=71 + stokes + 2 * reduced,
                            xmax=2.5)
    if reduced:
        s0.wgt.copy_(torch.as_tensor(np.random.default_rng(5).uniform(
            0.5, 1.0, B), dtype=torch.float32))
    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 0, 'cpu')
    scatter.scatter(st, tl, p, seed=3, counter=9)
    js, jt = jax.jit(jeng.make_scatter(jcfg, jmeta))(
        bridge.state_to_jax(s0), jgrid, jeng.zero_tallies(meta.nxfreq),
        jax.random.PRNGKey(11 + stokes))
    return p, s0, st, tl, convert.state_from_jax(js), \
        convert.tallies_from_jax(jt)


def _outcomes(s0, out):
    """(absorbed, dust-scattered, resonance-scattered) masks: a dust
    scattering keeps xfreq, a resonance one moves it."""
    flying = out.phase == FLYING
    same = out.xfreq == s0.xfreq
    return out.phase == DEAD, flying & same, flying & ~same


@pytest.mark.parametrize('stokes', [False, True], ids=['hg', 'mueller'])
def test_dust_scatter_matches_make_scatter(stokes):
    p, s0, st, tl, ref, ref_t = _scatter_both(stokes)
    B = s0.batch
    shares = {}
    for name, out, t in (('port', st, tl), ('lart_tpu', ref, ref_t)):
        ab, dsc, res = _outcomes(s0, out)
        # every lane's fate: absorbed, scattered, or still at a scattering
        assert bool((ab | dsc | res | (out.phase == AT_SCATTER)).all())
        shares[name] = (float(t.nscatt_dust) / B, float(ab.sum()) / B,
                        float(dsc.sum()) / B)
        # only the scattered lanes turned; dust keeps the lane's place
        for f in ('x', 'y', 'z', 'ic', 'jc', 'kc'):
            assert torch.equal(getattr(out, f), getattr(s0, f)), f
    (d_t, a_t, s_t), (d_j, a_j, s_j) = shares['port'], shares['lart_tpu']
    assert 0.2 < d_t < 0.8 and a_t > 0.05 and s_t > 0.05, shares
    for u, v in zip(shares['port'], shares['lart_tpu']):
        assert abs(u - v) < 0.01, shares
    assert float(tl.nscatt_dust) == pytest.approx(float(ref_t.nscatt_dust),
                                                  rel=0.02)

    def turned(out):
        dsc = _outcomes(s0, out)[1]
        cos = (out.kx * s0.kx + out.ky * s0.ky + out.kz * s0.kz)[dsc]
        return {'kz': out.kz[dsc], 'cos(k, k\')': cos,
                **({'Q': out.Q[dsc], 'U': out.U[dsc]} if stokes else {})}
    a, b = turned(st), turned(ref)
    for k in a:
        pv = ks_2samp(a[k].numpy(), b[k].numpy()).pvalue
        assert pv > P_MIN, (k, pv)
    # the absorbed spectra (unit weights: counts) at the lab frequency
    ja, jb = tl.Jabs.double(), ref_t.Jabs.double()
    assert float(ja.sum()) == pytest.approx(a_t * B, abs=0.5)
    sel = (ja + jb) > 0
    assert int(sel.sum()) >= 5
    chi2 = float(((ja - jb)[sel] ** 2 / (ja + jb)[sel]).sum()) / int(sel.sum())
    assert chi2 < 3.0, chi2
    # the lanes that neither scattered nor were absorbed are untouched
    for out in (st, ref):
        keep = out.phase == AT_SCATTER
        for f in LANE_FIELDS:
            assert torch.equal(getattr(out, f)[keep], getattr(s0, f)[keep])


def test_reduced_weight_absorbs_nothing():
    p, s0, st, tl, ref, ref_t = _scatter_both(False, reduced=True)
    for out in (st, ref):
        ab, dsc, _ = _outcomes(s0, out)
        assert not bool(ab.any()) and int(dsc.sum()) > 500
        torch.testing.assert_close(out.wgt[dsc],
                                   s0.wgt[dsc] * np.float32(p.albedo),
                                   rtol=TOL, atol=0.0)
        assert torch.equal(out.wgt[~dsc], s0.wgt[~dsc])
    # every dust event deposits wgt (1 - albedo) into Jabs, on the axis
    ratio = float(tl.Jabs.sum()) / float(tl.nscatt_dust)
    assert ratio == pytest.approx(1.0 - p.albedo, rel=1e-4)
    assert float(tl.nscatt_dust) == pytest.approx(float(ref_t.nscatt_dust),
                                                  rel=0.02)


def test_stokes_dust_without_a_table_raises(monkeypatch):
    """use_stokes with dust and no table: as make_scatter, a RuntimeError."""
    cfg = testing.dust_params(stokes=True).resolve()
    assert os.path.basename(cfg.par.scatt_mat_file) == TABLES[0]
    monkeypatch.setattr(cfg.par, 'scatt_mat_file', '')
    monkeypatch.setattr(tmueller, 'default_mueller_file', lambda *a: None)
    with pytest.raises(RuntimeError, match='Mueller'):
        tmueller.MuellerTable.for_config(cfg)


def test_gaussian_birth_matches_jax():
    """K2's Gaussian spectrum (engine.py:2799-2803): the births follow
    lart_tpu's (KS on xfreq), and each is xfreq0 + N(0, 1) sigma / vtherm
    with the normal from the lane's block-2 uniforms (Box-Muller)."""
    from lart_tpu_torch.physics.rng import STREAM_REFILL, uniforms
    from lart_tpu_torch.transport import refill
    from lart_tpu_torch.transport.state import init_state
    par = testing.dust_params(gaussian_sigma_vel=200.0, xfreq0=0.0)
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    p = teng.make_chunk(cfg, meta, grid).refill_params
    assert p.spectrum == refill.SPECTRUM_GAUSS
    assert p.sigma_x == pytest.approx(200.0 / cfg.vtherm, rel=1e-12)
    B = 50_000
    st = init_state(B, 'cpu')
    refill.refill(st, zero_tallies(meta.nxfreq, 0, 'cpu'), p, seed=11,
                  counter=0, budget=10 ** 9)
    js, _ = jax.jit(jeng.make_refill(jcfg, jmeta))(
        jeng.init_state(B), jgrid, jeng.zero_tallies(meta.nxfreq),
        jax.random.PRNGKey(4), jnp.asarray([10 ** 9], jnp.int32))
    pv = ks_2samp(st.xfreq.numpy(), np.asarray(js.xfreq)).pvalue
    assert pv > P_MIN, pv
    w = uniforms(11, STREAM_REFILL, torch.arange(B), 0, 2)
    want = tsamplers.box_muller(w[0], w[1]) * np.float32(p.sigma_x)
    torch.testing.assert_close(st.xfreq, want, rtol=0, atol=0)
