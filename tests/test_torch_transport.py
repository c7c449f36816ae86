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

import dataclasses

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
    cfg, jcfg = bridge.resolve_both(testing.slab_params(**kw))
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    return cfg, jcfg, meta, jmeta, jgrid, grid


def _jax_tallies(meta, nmu=8):
    return jeng.zero_tallies(meta.nxfreq, nmu=nmu)


def test_fly_matches_jax_lane_by_lane():
    cfg, jcfg, meta, jmeta, jgrid, grid = _setup(tau0=1e4)
    B = 20_000
    s0 = testing.mixed_state(meta, B, seed=5)
    jfly = jax.jit(jeng.make_fly_uniform_slab(jcfg, jmeta),
                   static_argnums=3)
    js, jt = jfly(bridge.state_to_jax(s0), jgrid, _jax_tallies(meta),
                  cfg.par.fly_substeps)
    ref = convert.state_from_jax(js)
    ref_t = convert.tallies_from_jax(jt)

    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 8, 'cpu')
    ch = teng.make_chunk(cfg, meta, grid)
    assert isinstance(ch.flight, fly_slab.SlabParams)
    fly_slab.fly(st, tl, ch.flight, ch.fly_substeps)

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
    cfg, _, meta, _, _, grid = _setup()
    ch = teng.make_chunk(cfg, meta, grid)
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
    cfg, jcfg, meta, jmeta, jgrid, grid = _setup()
    B = 100_000
    st = init_state(B, 'cpu')
    ch = teng.make_chunk(cfg, meta, grid)
    refill.refill(st, zero_tallies(meta.nxfreq, 8, 'cpu'),
                  ch.refill_params, seed=11, counter=0, budget=10 ** 9)
    jrefill = jax.jit(jeng.make_refill(jcfg, jmeta))
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
    cfg, jcfg, meta, jmeta, jgrid, grid = _setup()
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
    ch = teng.make_chunk(cfg, meta, grid)
    scatter.scatter(st, tl, ch.scatter_params, seed=3, counter=9)

    jscatter = jax.jit(jeng.make_scatter(jcfg, jmeta))
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



CORE_SKIP = {
    # the uniform-sphere fast path: rk is the constant sphere_rho
    'local_sphere': lambda: testing.sphere_params(tau0=1e6, n=17,
                                                  core_skip=True),
    'global_sphere': lambda: testing.sphere_params(
        tau0=1e6, n=17, core_skip=True, core_skip_global=True),
    # the generic walk in a moving medium: rk is the cell's rhokap gather
    'local_hubble': lambda: testing.hubble_params(tau0=1e6, n=17,
                                                  core_skip=True),
}


@pytest.mark.parametrize('case', sorted(CORE_SKIP))
def test_scatter_core_skip_matches_jax(case):
    """Core-skip boosts the perpendicular atom speed of in-core lanes
    (|x| < xcrit); the outgoing frequency and direction of those lanes
    follow lart_tpu's distributions."""
    cfg, jcfg = bridge.resolve_both(CORE_SKIP[case]())
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    ch = teng.make_chunk(cfg, meta, grid)
    p = ch.scatter_params
    assert p.core_skip == (scatter.CORE_SKIP_GLOBAL if 'global' in case
                           else scatter.CORE_SKIP_LOCAL)
    assert (p.rhokap is not None) == (case == 'local_hubble')
    B = 200_000
    s0 = testing.mixed_state(meta, B, seed=17, r_max=1.0)
    rng = np.random.default_rng(17)
    at = torch.from_numpy(rng.random(B) < 0.95)
    s0.phase.copy_(torch.where(at, AT_SCATTER, s0.phase))
    s0.xfreq.copy_(torch.from_numpy(rng.uniform(-3.0, 3.0, B)
                                    .astype(np.float32)))
    at_t = s0.phase == AT_SCATTER
    xc, _ = scatter.local_xcrit(s0, p)
    assert bool((xc > 0.0).any())
    core = at_t & (s0.xfreq.abs() < xc)
    assert float(core.float().mean()) > 0.05

    st = testing.clone_state(s0)
    scatter.scatter(st, zero_tallies(meta.nxfreq, 8, 'cpu'), p, seed=3,
                    counter=9)
    js, _ = jax.jit(jeng.make_scatter(jcfg, jmeta))(
        bridge.state_to_jax(s0), jgrid, _jax_tallies(meta),
        jax.random.PRNGKey(5))
    ref = convert.state_from_jax(js)

    def cos_turn(out):
        return out.kx * s0.kx + out.ky * s0.ky + out.kz * s0.kz

    acc_t, acc_j = st.phase == FLYING, ref.phase == FLYING
    for sel, what in ((core, 'in core'), (at_t & ~core, 'out of core')):
        for name, f in (('xfreq', lambda o: o.xfreq),
                        ('cos(k, k\')', cos_turn)):
            a = f(st)[sel & acc_t].numpy()
            b = f(ref)[sel & acc_j].numpy()
            pv = ks_2samp(a, b).pvalue
            assert pv > P_MIN, (case, what, name, pv)
    # the boost widens the in-core redistribution: the same draws without
    # core-skip move the in-core lanes less (sqrt(-log xi) against
    # sqrt(xcrit^2 - log xi)) and leave the other lanes as they are
    off = testing.clone_state(s0)
    scatter.scatter(off, zero_tallies(meta.nxfreq, 8, 'cpu'),
                    dataclasses.replace(p, core_skip=scatter.CORE_SKIP_OFF),
                    seed=3, counter=9)
    assert torch.equal(off.phase, st.phase)
    moved = acc_t & ~core
    # (to the last ulp: torch's CPU log/sqrt may take their vector or their
    # scalar path for one element, as the threads split the batch)
    torch.testing.assert_close(off.xfreq[moved], st.xfreq[moved],
                               rtol=1e-6, atol=1e-6)
    dx_on = (st.xfreq - s0.xfreq).abs()[core & acc_t]
    dx_off = (off.xfreq - s0.xfreq).abs()[core & acc_t]
    assert float(dx_on.mean()) > 1.05 * float(dx_off.mean())


def test_refill_moving_medium_matches_jax():
    """A point source in a moving medium (comoving_source false): the lane
    flies at the comoving frequency x - v(source cell).k; Jin counts the
    lab frequency."""
    over = dict(xs_point=0.31, ys_point=0.17, zs_point=0.05)
    cfg, jcfg = bridge.resolve_both(
        testing.hubble_params(tau0=100.0, n=17, **over))
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    ch = teng.make_chunk(cfg, meta, grid)
    v = ch.refill_params.v_src
    assert all(c > 0.5 for c in v) and not ch.refill_params.comoving_source
    B = 100_000
    st, tl = init_state(B, 'cpu'), zero_tallies(meta.nxfreq, 8, 'cpu')
    refill.refill(st, tl, ch.refill_params, seed=11, counter=0,
                  budget=10 ** 9)
    js, jt = jax.jit(jeng.make_refill(jcfg, jmeta))(
        jeng.init_state(B), jgrid, _jax_tallies(meta),
        jax.random.PRNGKey(4), jnp.asarray([10 ** 9], jnp.int32))
    assert int(st.n_launched[0]) == int(js.n_launched[0]) == B
    for f in ('xfreq', 'kz'):
        pv = ks_2samp(getattr(st, f).numpy(),
                      np.asarray(getattr(js, f))).pvalue
        assert pv > P_MIN, (f, pv)
    a, b = tl.Jin.numpy(), np.asarray(jt.Jin)
    assert a.sum() == pytest.approx(b.sum(), abs=50)
    sel = (a + b) > 0
    assert np.sum((a[sel] - b[sel]) ** 2 / (a[sel] + b[sel])) / sel.sum() < 3

    # the same draws from a comoving source are the unshifted frequencies:
    # x_moving = x_draw - u1 exactly, u1 = v(source cell) . k in f32
    cfg_c = testing.hubble_params(tau0=100.0, n=17, comoving_source=True,
                                  **over).resolve()
    ch_c = teng.make_chunk(cfg_c, meta, grid)
    st_c = init_state(B, 'cpu')
    tl_c = zero_tallies(meta.nxfreq, 8, 'cpu')
    refill.refill(st_c, tl_c, ch_c.refill_params, 11, 0, 10 ** 9)
    for f in ('kx', 'ky', 'kz', 'bkx', 'bky', 'bkz'):
        assert torch.equal(getattr(st, f), getattr(st_c, f)), f
    u1 = v[0] * st.kx + v[1] * st.ky + v[2] * st.kz
    assert float(u1.abs().max()) > 1.0
    assert torch.equal(st.xfreq, st_c.xfreq - u1)
    assert torch.equal(st.bxfreq, st.xfreq)
    # Jin at the lab frequency x_moving + u1: the draw to within rounding,
    # so its histogram is the draws' (up to a lane on a bin edge)
    torch.testing.assert_close(st.xfreq + u1, st_c.xfreq, rtol=0,
                               atol=1e-5)
    ix = torch.floor((st_c.xfreq - meta.xfreq_min) / meta.dxfreq).long()
    ok = (ix >= 0) & (ix < meta.nxfreq)
    hist = torch.bincount(ix[ok], minlength=meta.nxfreq).float()
    assert float((tl.Jin - hist).abs().sum()) <= 1e-4 * B


ACCEPTED = {
    'sphere/t4tau7.in': {},
    'vel_effect/t4NHI2_20_V0000.in': {},
    'vel_effect/t4NHI2_20_V0200.in': {},
    'slab/t1tau6.in': dict(force_generic_kernel=True),
    'slab_peel/t1tau4.in': {},
    'sphere_peel/t4tau4_peel.in': {},
    'vel_effect_peel/t4NHI2_20_V0200_peel.in': {},
    'DL2008/DL20e_dust.in': {},
    'DL2008/DL20e.in': {},
    'DL2008/DL19e.in': {},
    'ly_beta_sphere/t4tau1e4.in': {},
    'ly_beta_sphere/t4tau1e4_dust.in': {},
    'h2_test/h2_on.in': {},
}


@pytest.mark.parametrize('example', sorted(ACCEPTED))
def test_check_supported_accepts_the_slice(example):
    """The examples of this slice pass the check at their full size, and
    build a chunk with the flight of lart_tpu's make_fly dispatch (cut to
    a 17^3 grid to build here)."""
    from pathlib import Path

    from lart_tpu_torch.config import Params
    from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
    from lart_tpu_torch.transport.fly_slab import SlabParams
    from lart_tpu_torch.transport.fly_sphere import SphereFlight
    path = Path(__file__).resolve().parents[1] / 'examples' / example
    par = Params.from_namelist(str(path))
    for k, v in ACCEPTED[example].items():
        setattr(par, k, v)
    teng.check_supported(par.resolve())
    if par.nx > 1:
        par.nx = par.ny = par.nz = 17
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg)
    flight = teng.make_chunk(cfg, meta, grid).flight
    want = {'sphere/t4tau7.in': SphereFlight,
            'sphere_peel/t4tau4_peel.in': SphereFlight,
            'slab_peel/t1tau4.in': SlabParams}.get(example, CartesianFlight)
    assert type(flight) is want, (example, type(flight))


OUT_OF_SLICE = {
    'save_all_photons': dict(save_all_photons=True),
    'n_devices > 1': dict(n_devices=2),
    # lart_tpu's AMR sightline has no interior branch
    'save_sightline_tau': dict(save_sightline_tau=True, save_peeloff=True,
                               nside=4, use_amr_grid=True),
    'out_merge': dict(out_merge=True),
    # the maps run on Cartesian grids; on an AMR grid lart_tpu's flight
    # raises for calcJ and calcPnew (jpa_bin of geometry_JPa 0)
    'calcJ/calcP/calcPnew': dict(calcJ=True, use_amr_grid=True),
    # ported: the shear wrap in K5
    'shearing box': dict(xy_periodic=True, Omega=1.0),
    # the 3-D grid files are read (io/reader.py); a 3-D emissivity cube on
    # the octree or the clumps is not: lart_tpu would read it as leaves or
    # clumps
    '3-D density file': dict(use_amr_grid=True,
                             source_geometry='diffuse_emissivity',
                             emiss_file='emiss.fits'),
    '3-D velocity file': dict(use_clump_medium=True,
                              source_geometry='diffuse_emissivity',
                              emiss_file='emiss.h5'),
}


# the features that were out of the slice and are ported now: accepted
PORTED = {'shearing box', 'save_all_photons', 'n_devices > 1'}


@pytest.mark.parametrize('feature', sorted(OUT_OF_SLICE))
def test_check_supported_raises_out_of_the_slice(feature):
    par = testing.sphere_params(n=9)
    for k, v in OUT_OF_SLICE[feature].items():
        setattr(par, k, v)
    if feature in PORTED:
        teng.check_supported(par.resolve())
        return
    key = feature.split(' ')[0].split('/')[0]
    with pytest.raises(NotImplementedError, match=key):
        teng.check_supported(par.resolve())


def test_mixed_state_cells_on_a_3d_grid():
    """Each lane's cell is the clamped floor of its position on any grid;
    the old rule (ic = jc = 0) put most lanes of a 3-D grid in a cell that
    does not hold them, and on the slab, where nx = ny = 1, the two agree."""
    for par in (testing.hubble_params(n=17), testing.sphere_params(n=17),
                testing.slab_params()):
        meta, _ = build_cartesian(par.resolve())
        for r_max in (None, 1.0):
            st = testing.mixed_state(meta, 20_000, seed=3, r_max=r_max)
            for pre in ('', 'b'):
                pos = [getattr(st, pre + a).double() for a in 'xyz']
                cells = [getattr(st, pre + c) for c in ('ic', 'jc', 'kc')]
                for p, c, amin, d, n in zip(
                        pos, cells, (meta.xmin, meta.ymin, meta.zmin),
                        (meta.dx, meta.dy, meta.dz),
                        (meta.nx, meta.ny, meta.nz)):
                    assert bool(((c >= 0) & (c < n)).all())
                    lo = amin + c.double() * d
                    assert bool(((p >= lo - 1e-6) & (p <= lo + d + 1e-6))
                                .all())
                if r_max is not None:
                    r = torch.sqrt(pos[0] ** 2 + pos[1] ** 2 + pos[2] ** 2)
                    assert float(r.max()) <= r_max + 1e-6
            old_wrong = (st.ic != 0) | (st.jc != 0)
            if meta.nx == 1:
                assert not bool(old_wrong.any())
            else:
                assert float(old_wrong.float().mean()) > 0.5


@pytest.mark.parametrize('geometry', ['sphere', 'slab'])
def test_dust_routes_as_lart_tpu(geometry):
    """With dust a uniform static sphere keeps the chord flight (K6 adds
    sphere_rhoD; the scatter takes the sphere's constants), while a slab
    leaves its fast path for the walk (engine.py:663) and the scatter
    gathers rhokap and rhokapD there."""
    from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
    from lart_tpu_torch.transport.fly_sphere import SphereFlight
    par = (testing.sphere_params(n=9, DGR=50.0) if geometry == 'sphere'
           else testing.slab_params(nz=9, DGR=50.0))
    cfg, jcfg = bridge.resolve_both(par)
    meta, grid = build_cartesian(cfg)
    jmeta, _ = jcart.build_cartesian(jcfg)
    assert meta.has_dust
    ch = teng.make_chunk(cfg, meta, grid)
    p = ch.scatter_params
    assert p.dust == scatter.DUST_HG
    if geometry == 'sphere':
        assert jeng.uniform_sphere_fastpath(jcfg, jmeta)
        assert type(ch.flight) is SphereFlight
        assert ch.flight.sphere_rhoD == meta.sphere_rhoD > 0.0
        assert p.rk_const == meta.sphere_rho and \
            p.rkD_const == meta.sphere_rhoD and p.rhokapD is None
    else:
        assert not jeng.uniform_slab_fastpath(jcfg, jmeta)
        assert type(ch.flight) is CartesianFlight
        assert ch.flight.rhokapD is not None and p.rhokapD is not None
        assert p.rk_const < 0.0
