"""lart_tpu_torch refill / fly / scatter against lart_tpu's, on the CPU.

fly draws no random numbers, so it is compared lane by lane on one
numpy-made state with lanes in every phase: fields to rtol 1e-5 (atol
1e-6), at most 1e-4 of the lanes may differ where an f32 hit/escape
decision or a bin edge flips on a last-ulp difference of the two CPU
libraries' exp/cos, and the tallies to 1e-5 of their sum.  refill and
scatter draw from different generators (Philox here, threefry in JAX), so
they are held to exact counts and invariants and, for the sampled values,
to two-sample Kolmogorov-Smirnov tests (p > 1e-3) and accepted fractions
within 0.01."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import fly_slab, refill, scatter
from lart_tpu_torch.transport.state import (AT_SCATTER, DEAD, FFS, FLYING,
                                            LANE_FIELDS, BatchState,
                                            init_state, zero_tallies)

import _torch_jax_bridge as bridge

P_MIN = 1e-3


def _setup(**kw):
    cfg = testing.slab_params(**kw).resolve()
    meta, _ = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(cfg)
    return cfg, meta, jmeta, jgrid


def _jax_tallies(meta, nmu=8):
    return jeng.zero_tallies(meta.nxfreq, nmu=nmu)


def test_fly_matches_jax_lane_by_lane():
    cfg, meta, jmeta, jgrid = _setup(tau0=1e4)
    B = 20_000
    s0 = testing.mixed_state(meta, B, seed=5)
    jfly = jax.jit(jeng.make_fly_uniform_slab(cfg, jmeta),
                   static_argnums=3)
    js, jt = jfly(bridge.state_to_jax(s0), jgrid, _jax_tallies(meta),
                  cfg.par.fly_substeps)
    ref = convert.state_from_jax(js)
    ref_t = convert.tallies_from_jax(jt)

    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 8, 'cpu')
    ch = teng.make_chunk(cfg, meta)
    fly_slab.fly(st, tl, ch.slab_params, ch.fly_substeps)

    # The two H(x, a) agree to rtol 2e-5 (test_torch_voigt), so a flight
    # length does too, and x and y, which wrap with a floor-mod after a
    # lateral path that can reach 1e6 box widths (grazing far-wing
    # photons), are held to 2e-5 of that path (unbounded where kz == 0);
    # the other fields to rtol 1e-5.
    z0 = torch.where(s0.phase == FFS, s0.bz, s0.z).double()
    kz = ref.kz.double()
    lateral = torch.nan_to_num((ref.z.double() - z0).abs() / kz.abs()
                               * torch.sqrt(1.0 - kz * kz), nan=np.inf)
    for f in ('x', 'y'):
        a, b = getattr(st, f), getattr(ref, f)
        tol = 1e-6 + 1e-5 * b.abs().double() + 2e-5 * lateral
        assert bool(((a - b).abs().double() <= tol).all()), f
        a.copy_(b)
    frac, err = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= 1e-4, frac
    assert not bool(((st.phase == FLYING) | (st.phase == FFS)).any())
    # every phase took part: escapes, FFS restarts and scatterings
    assert int((st.phase == DEAD).sum()) > int((s0.phase == DEAD).sum())
    assert int((st.phase == AT_SCATTER).sum()) > \
        int((s0.phase == AT_SCATTER).sum())
    for f in ('Jout', 'Jmu', 'W_oor'):
        a, b = getattr(tl, f), getattr(ref_t, f)
        atol = 1e-5 * max(float(b.abs().sum()), 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=f)
    assert float(ref_t.W_oor) > 0.0 and float(tl.Jout.sum()) > 0.0


def test_refill_launch_count_and_lanes():
    cfg, meta, _, _ = _setup()
    ch = teng.make_chunk(cfg, meta)
    p = ch.refill_params
    s0 = testing.mixed_state(meta, 4000, seed=3)
    n_dead = int((s0.phase == DEAD).sum())
    for budget in (10 ** 6, n_dead // 3, 0):
        st = testing.clone_state(s0)
        st.n_launched.fill_(5)
        tl = zero_tallies(meta.nxfreq, 8, 'cpu')
        refill.refill(st, tl, p, seed=1, counter=2, budget=budget + 5)
        launched = (s0.phase == DEAD) & (st.phase == FFS)
        n = min(n_dead, budget)
        assert int(launched.sum()) == n
        assert int(st.n_launched[0]) == 5 + n
        assert int(((st.phase != s0.phase) & ~launched).sum()) == 0
        # lanes that were not launched are untouched
        keep = ~launched
        for f in LANE_FIELDS:
            torch.testing.assert_close(getattr(st, f)[keep],
                                       getattr(s0, f)[keep], rtol=0, atol=0)
        if n == 0:
            continue
        L = launched
        assert torch.all(st.x[L] == p.xs) and torch.all(st.z[L] == p.zs)
        assert torch.all(st.kc[L] == p.kc) and torch.all(st.wgt[L] == 1.0)
        norm = st.kx[L] ** 2 + st.ky[L] ** 2 + st.kz[L] ** 2
        torch.testing.assert_close(norm, torch.ones_like(norm), rtol=0,
                                   atol=1e-6)
        for f in ('x', 'y', 'z', 'kx', 'ky', 'kz', 'ic', 'jc', 'kc',
                  'xfreq'):
            assert torch.equal(getattr(st, 'b' + f)[L], getattr(st, f)[L])
        assert torch.all(st.tau_run[L] == 0.0)
        assert torch.all((st.tau_target[L] > 0.0) & (st.tau_target[L] < 1.0))
        fx = torch.floor((st.xfreq[L] - p.xfreq_min) / p.dxfreq)
        assert float(tl.Jin.sum()) == float(((fx >= 0) & (fx < p.nxfreq)
                                             ).sum())


def test_refill_distributions_match_jax():
    cfg, meta, jmeta, jgrid = _setup()
    B = 100_000
    st = init_state(B, 'cpu')
    ch = teng.make_chunk(cfg, meta)
    refill.refill(st, zero_tallies(meta.nxfreq, 8, 'cpu'),
                  ch.refill_params, seed=11, counter=0, budget=10 ** 9)
    jrefill = jax.jit(jeng.make_refill(cfg, jmeta))
    js, jt = jrefill(jeng.init_state(B), jgrid, _jax_tallies(meta),
                     jax.random.PRNGKey(4), jnp.asarray([10 ** 9], jnp.int32))
    assert int(st.n_launched[0]) == int(js.n_launched[0]) == B
    assert bool((st.phase == FFS).all()) and bool((js.phase == FFS).all())
    for f in ('kz', 'xfreq', 'tau_target'):
        p = ks_2samp(getattr(st, f).numpy(), np.asarray(getattr(js, f))
                     ).pvalue
        assert p > P_MIN, (f, p)
    phi_t = torch.atan2(st.ky, st.kx).numpy()
    phi_j = np.arctan2(np.asarray(js.ky), np.asarray(js.kx))
    assert ks_2samp(phi_t, phi_j).pvalue > P_MIN
    # the Jin tallies agree to Poisson noise bin by bin
    tl = zero_tallies(meta.nxfreq, 8, 'cpu')
    refill.refill(init_state(B, 'cpu'), tl, ch.refill_params, 11, 0, 10 ** 9)
    a, b = tl.Jin.numpy(), np.asarray(jt.Jin)
    assert a.sum() == pytest.approx(b.sum(), abs=50)
    sel = (a + b) > 0
    chi2 = np.sum((a[sel] - b[sel]) ** 2 / (a[sel] + b[sel])) / sel.sum()
    assert chi2 < 3.0, chi2


@pytest.mark.parametrize('x', [0.0, 3.0, 30.0])
def test_scatter_matches_jax(x):
    cfg, meta, jmeta, jgrid = _setup()
    B = 200_000
    s0 = testing.mixed_state(meta, B, seed=int(x) + 7)
    rng = np.random.default_rng(int(x))
    at = rng.random(B) < 0.95
    s0.phase.copy_(torch.where(torch.from_numpy(at), AT_SCATTER, s0.phase))
    sign = np.where(rng.random(B) < 0.5, -1.0, 1.0).astype(np.float32)
    s0.xfreq.copy_(torch.from_numpy(np.float32(x) * sign))
    at_t = s0.phase == AT_SCATTER

    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 8, 'cpu')
    ch = teng.make_chunk(cfg, meta)
    scatter.scatter(st, tl, ch.scatter_params, seed=3, counter=9)

    jscatter = jax.jit(jeng.make_scatter(cfg, jmeta))
    js, jt = jscatter(bridge.state_to_jax(s0), jgrid, _jax_tallies(meta),
                      jax.random.PRNGKey(int(x) + 1))
    ref = convert.state_from_jax(js)

    # lanes that were not at a scattering are untouched by both
    for f in LANE_FIELDS:
        for out in (st, ref):
            assert torch.equal(getattr(out, f)[~at_t], getattr(s0, f)[~at_t])

    acc_t = at_t & (st.phase == FLYING)
    acc_j = at_t & (ref.phase == FLYING)
    assert bool(((st.phase == AT_SCATTER) | (st.phase == FLYING))[at_t].all())
    frac_t = float(acc_t.sum()) / float(at_t.sum())
    frac_j = float(acc_j.sum()) / float(at_t.sum())
    assert abs(frac_t - frac_j) < 0.01, (frac_t, frac_j)
    assert float(tl.nscatt_events) == float(acc_t.sum())
    assert float(tl.nscatt_gas) == pytest.approx(float(st.wgt[acc_t].sum()),
                                                 rel=1e-5)

    def cos_turn(out, acc):
        return (out.kx * s0.kx + out.ky * s0.ky + out.kz * s0.kz)[acc]

    for name, a, b in (
            ('xfreq', st.xfreq[acc_t] * torch.from_numpy(sign)[acc_t],
             ref.xfreq[acc_j] * torch.from_numpy(sign)[acc_j]),
            ('cos(k, k\')', cos_turn(st, acc_t), cos_turn(ref, acc_j)),
            ('tau_target', st.tau_target[acc_t], ref.tau_target[acc_j])):
        p = ks_2samp(a.numpy(), b.numpy()).pvalue
        assert p > P_MIN, (name, x, p)
    norm = st.kx ** 2 + st.ky ** 2 + st.kz ** 2
    torch.testing.assert_close(norm[acc_t], torch.ones_like(norm[acc_t]),
                               rtol=0, atol=1e-5)


def test_wrappers_raise_off_the_cpu_and_gpu():
    """A wrapper takes its plain version only for a CPU tensor; any other
    device goes to the kernel, whose checks refuse a non-CUDA tensor."""
    from lart_tpu_torch.kernels import build as kb
    t = torch.zeros(4, device='meta')
    with pytest.raises(ValueError, match='kernel needs CUDA'):
        kb.require_cuda('voigt_h', t)
    with pytest.raises(RuntimeError, match='failed to launch'):
        kb.check(2, 'voigt_h')
    assert isinstance(init_state(8, 'cpu'), BatchState)

