"""The port's clump medium against lart_tpu's, on the CPU.

The populations: examples/clump_sphere/clumps_overlap.in and
examples/bicone/bicone_clump.in as written (their seed iseed + 77, as both
drivers draw it), a 1.48M-clump sphere at the scale of the reference's
clump_fcov1 run (R 1, f_cov 1, radius 9.5e-4, N_HI 1e18), and the 40-clump
sphere of lart_tpu's tests/test_clump_overlap.py (testing.clump_params),
static, with clump_sigma_v, with clump_temperature 9e4 and with dust,
and a dense sphere of 1000 clumps whose rays cross more chords than K9's
list holds (K9's second path, which the card's tests hold to the plain
version).

build_clumps must equal lart_tpu's exactly (meta, ClumpMeta, every device
array and the CSR table), and clump_find its lookup (dense and CSR) on
every point.  The plain flights (K9's and K10's) must match
make_fly_clump_dense and make_fly_clump lane by lane after one call of
fly_substeps steps: float fields to rtol 1e-5 (atol 1e-6), integer fields
equal, on all but FRAC of the lanes (2e-3: lart_tpu's XLA sums the
(B, N) chord terms and its cumulative sums in an order of its own, which
even changes from run to run with its threads; a last-ulp change of a
sum can flip one bisection round, or whether a forced first scattering's
target, set within 1e-5 of the ray's total depth, is reached), tallies
to 1e-5 of their sum.  The owner draw, fed the uniforms of the very
jax.random key clump_sample_owner draws, must pick lart_tpu's clump on
all but 1e-3 of the lanes; the clump sightline tau of K7's plain version
must match make_peel's tau_to_edge closure to rtol 1e-5 (atol 1e-6) on all
but 1e-3 of the pairs; and with scatter_rounds 0 (no resonance accepted,
so make_scatter draws nothing that decides a lane) K4's plain frame shift
in and out of the owner clump must equal make_scatter's on every lane.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.grid import clump as jclump
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import peel as jpeel
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.grid import clump as tclump
from lart_tpu_torch.instruments import peel as tpeel
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import refill as trefill
from lart_tpu_torch.transport import scatter as tscatter
from lart_tpu_torch.transport.flight import ClumpGrid
from lart_tpu_torch.transport.fly_clump import (CHORDS, K_MAX, ClumpFlight,
                                               crossed_chords)
from lart_tpu_torch.transport.state import (AT_SCATTER, DEAD, FFS, FLYING,
                                            init_state, zero_tallies)

import _torch_jax_bridge as bridge
from test_torch_amr import ROOT, _closure

B = 2048
FRAC = 2e-3


def _example(rel, **over):
    par = Params.from_namelist(str(ROOT / 'examples' / rel))
    for k, v in over.items():
        setattr(par, k, v)
    return par


POPULATIONS = {
    'clumps_overlap': lambda: _example('clump_sphere/clumps_overlap.in'),
    'bicone_clump': lambda: _example('bicone/bicone_clump.in'),
    # the scale of the reference's clump_fcov1 run (1.48M clumps)
    'fcov1': lambda: testing.clump_params(
        clump_N_clumps=-1.0, clump_f_cov=1.0, clump_radius=9.5e-4,
        clump_tau0=-1.0, clump_NHI=1e18),
}


@pytest.mark.parametrize('name', sorted(POPULATIONS))
def test_build_clumps_equals_lart_tpu(name):
    par = POPULATIONS[name]()
    cfg, jcfg = bridge.resolve_both(par)
    seed = par.iseed + 77
    meta, cmeta, dev = tclump.build_clumps(cfg, seed=seed, device='cpu')
    # lart_tpu's population, carried over by convert.clump_from_jax
    jm, jc, jd = convert.clump_from_jax(*jclump.build_clumps(jcfg, seed=seed))
    assert dataclasses.asdict(meta) == dataclasses.asdict(jm)
    assert dataclasses.asdict(cmeta) == dataclasses.asdict(jc)
    for f in jclump.ClumpDevice._fields:
        a, b = getattr(dev, f), getattr(jd, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    assert dev.table.shape == (cmeta.cg_n ** 3, cmeta.K)
    if name == 'fcov1':
        assert cmeta.n_clumps > 1_400_000 and cmeta.cg_n == 192


def _par(**kw):
    return testing.clump_params(**kw)


def _build(dense_max=1024, **kw):
    """(port cfg, lart_tpu cfg, the port's meta/cmeta/device, lart_tpu's) of
    the 40-clump sphere with kw: one population (seed 99) for both."""
    par = _par(**kw)
    par.clump_dense_max = dense_max
    cfg, jcfg = bridge.resolve_both(par)
    meta, cmeta, dev = tclump.build_clumps(cfg, seed=99, device='cpu')
    return cfg, jcfg, meta, cmeta, dev, bridge.clump_to_jax(meta, cmeta, dev)


@pytest.mark.parametrize('dense', [True, False])
def test_clump_find_matches_lart_tpu(dense):
    cfg, jcfg, meta, cmeta, dev, (jm, jc, jd) = _build(
        dense_max=1024 if dense else 0, clump_allow_overlap=True,
        clump_N_clumps=120)
    cl = ClumpGrid.from_meta(cfg, meta, cmeta, dev)
    assert cl.dense == dense
    s = testing.clump_state(meta, cl, 8192, seed=3)
    got = cl.find(s.x, s.y, s.z)
    want = jeng.clump_find(jd, jm, *(jnp.asarray(v.numpy())
                                     for v in (s.x, s.y, s.z)),
                           dense_max=cfg.par.clump_dense_max)
    assert torch.equal(got, torch.as_tensor(np.array(want)))
    assert int((got >= 0).sum()) > 2000 and int((got < 0).sum()) > 2000


FLY_CASES = {
    'dense_overlap': dict(clump_allow_overlap=True),
    'dense': {},
    'csr_overlap': dict(dense_max=0, clump_allow_overlap=True),
    'csr': dict(dense_max=0),
    'dense_sigma_v': dict(clump_sigma_v=30.0, clump_allow_overlap=True),
    'csr_sigma_v': dict(dense_max=0, clump_sigma_v=30.0),
    'csr_overlap_T9e4': dict(dense_max=0, clump_allow_overlap=True,
                             clump_temperature=9e4, clump_sigma_v=20.0),
    'dense_T9e4_dust': dict(clump_temperature=9e4, DGR=1e-2),
    'csr_dust': dict(dense_max=0, DGR=1e-2),
    # 1000 clumps of radius 0.2 (f_cov 30): many rays cross more chords
    # than K9's list holds
    'dense_many_chords': dict(clump_allow_overlap=True, clump_N_clumps=1000,
                              clump_radius=0.2, clump_tau0=0.3),
}


@pytest.mark.parametrize('case', sorted(FLY_CASES))
def test_fly_clump_matches_lart_tpu(case):
    cfg, jcfg, meta, cmeta, dev, (jm, jc, jd) = _build(**FLY_CASES[case])
    flight = teng.make_fly(cfg, meta, dev, cmeta)
    assert isinstance(flight, ClumpFlight)
    assert flight.clump.dense == (cfg.par.clump_dense_max > 0)
    s0 = testing.clump_state(meta, flight.clump, B, seed=31)
    if case == 'dense_many_chords':
        over = crossed_chords(flight, s0) > CHORDS
        assert float(over.float().mean()) > 0.3
    st, tl, ref, ref_t = bridge.fly_both(
        jeng.make_fly(jcfg, jm, cmeta=jc), jd, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps)
    frac, err = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= FRAC, frac
    bridge.assert_tallies_close(tl, ref_t)
    # every branch took part: escapes, FFS restarts and scatterings
    assert int((st.phase == DEAD).sum()) > int((s0.phase == DEAD).sum())
    assert int((st.phase == AT_SCATTER).sum()) > \
        int((s0.phase == AT_SCATTER).sum())
    restarted = (s0.phase == FFS) & (st.phase != FFS) & (st.wgt != s0.wgt)
    assert int(restarted.sum()) > 50
    sc = (s0.phase == FLYING) & (st.phase == AT_SCATTER)
    if flight.clump.overlap:
        # K9 leaves the owner to K4; K10 to K4 too, where the lane crossed
        # a cell first (one that scatters in its first cell keeps its ic)
        if flight.clump.dense:
            assert bool((st.ic[sc] == -1).all())
    else:
        assert int((st.ic[sc] >= 0).sum()) > 0.9 * int(sc.sum())
    assert float(tl.Jout.sum()) > 0.0


@pytest.mark.parametrize('case', ['dense', 'csr', 'dense_sigma_v_T9e4',
                                  'csr_sigma_v_dust'])
def test_owner_draw_matches_clump_sample_owner(case):
    over = dict(clump_allow_overlap=True, clump_N_clumps=120)
    if 'sigma_v' in case:
        over.update(clump_sigma_v=30.0)
    if 'T9e4' in case:
        over.update(clump_temperature=9e4)
    if 'dust' in case:
        over.update(DGR=1e-2)
    cfg, jcfg, meta, cmeta, dev, (jm, jc, jd) = _build(
        dense_max=0 if case.startswith('csr') else 1024, **over)
    cl = ClumpGrid.from_meta(cfg, meta, cmeta, dev)
    s = testing.clump_state(meta, cl, 8192, seed=5, in_frac=0.8,
                            edge_frac=0.1)
    key = jax.random.PRNGKey(17)
    want = jeng.clump_sample_owner(jcfg, jm, jc, jd, bridge.state_to_jax(s),
                                   key)
    xi = torch.as_tensor(np.array(jax.random.uniform(key, (s.batch,))))
    got = tscatter.clump_owner_plain(
        cl, tscatter.ScatterParams.from_config(cfg, meta, dev,
                                               cmeta=cmeta).line,
        (s.x, s.y, s.z), (s.kx, s.ky, s.kz), s.xfreq, xi)
    want = torch.as_tensor(np.asarray(want))
    assert int((got != want).sum()) <= 1e-3 * s.batch
    # points in two or more clumps: the draw picks among them
    assert int((got >= 0).sum()) > 0.5 * s.batch
    assert len(torch.unique(got)) > 50


@pytest.mark.parametrize('case', ['dense_overlap', 'csr_moving_T9e4'])
def test_peel_tau_matches_make_peel(case):
    """K7's clump sightline (peel.py:86-170), pair by pair, from lanes in
    the vacuum, in clumps and on their surfaces to two observers."""
    over = dict(save_peeloff=True, nobs=2, nxim=17, nyim=17, dxim=0.15,
                dyim=0.15, distance=1e2, alpha=(0.0, 40.0),
                beta=(0.0, 30.0), clump_allow_overlap=True)
    if case != 'dense_overlap':
        over.update(dense_max=0, clump_sigma_v=30.0, clump_temperature=9e4)
    cfg, jcfg, meta, cmeta, dev, (jm, jc, jd) = _build(**over)
    p = teng.make_chunk(cfg, meta, dev, cmeta).peel
    assert p.grid.clump is not None and p.max_steps == 3 * cmeta.cg_n + 8
    jobs_meta, _ = jobs.build_observers(jcfg)
    pd = jpeel.make_peel(jcfg, jm, jobs_meta, cmeta=jc)[0]
    jtau = jax.jit(_closure(pd, 'tau_to_edge'), static_argnums=12)
    assert _closure(pd, 'max_steps') == p.max_steps
    s = testing.clump_state(meta, p.grid.clump, 4096, seed=43)
    n_off = n = 0
    for o in range(p.nobs):
        pk, _, _, in_img = tpeel.obs_geometry(p, o, s.x, s.y, s.z)
        t = tpeel.tau_to_edge(p, (s.x, s.y, s.z), (s.ic, s.jc, s.kc), pk,
                              s.xfreq, in_img)
        j = jtau(jd, *(jnp.asarray(v.numpy()) for v in (
            s.x, s.y, s.z, s.ic, s.jc, s.kc, *pk, s.xfreq, in_img)),
            p.max_steps)
        t = torch.clamp_max(t, tpeel.TAU_STOP)
        j = torch.clamp_max(torch.as_tensor(np.array(j)), tpeel.TAU_STOP)
        n_off += int((in_img & ((t - j).abs() > 1e-6 + 1e-5 * j.abs()))
                     .sum())
        n += int(in_img.sum())
        assert float(t[in_img].max()) > 1.0
    assert n > 0.3 * p.nobs * s.batch
    assert n_off <= 1e-3 * n, (n_off, n)


@pytest.mark.parametrize('case', ['non_overlap_moving', 'overlap_T9e4',
                                  'overlap_moving'])
def test_scatter_clump_frame_matches_make_scatter(case):
    """K4's clump branch on the lanes that stay AT_SCATTER in both packages
    (one u_par round, which a lane fails with a probability of its own):
    the frequency moved into the owner's frame and units and back,
    ((x - u) r_loc) / r_loc + u, which is not x in its last bits, with
    the owner from the flight (non-overlap) or, on a population without
    overlaps, from a draw with one clump to pick."""
    over = dict(scatter_rounds=1, clump_N_clumps=120)
    if 'moving' in case:
        over.update(clump_sigma_v=40.0)
    if 'T9e4' in case:
        over.update(clump_temperature=9e4)
    cfg, jcfg, meta, cmeta, dev, (jm, jc, jd) = _build(**over)
    if 'non_overlap' not in case:
        # the non-overlapping population walked in overlap mode
        cfg.par.clump_allow_overlap = jcfg.par.clump_allow_overlap = True
    p = tscatter.ScatterParams.from_config(cfg, meta, dev, cmeta=cmeta)
    assert p.clump is not None and p.clump.shift
    s0 = testing.clump_state(meta, p.clump, 8192, seed=9, in_frac=0.9,
                             edge_frac=0.0)
    s0.xfreq.copy_(torch.where(s0.xfreq.abs() > 30.0, s0.xfreq * 0.01,
                               s0.xfreq))
    st = testing.clone_state(s0)
    tscatter.scatter_plain(st, zero_tallies(meta.nxfreq, 0, 'cpu'), p, 7,
                           11)
    js, _ = jax.jit(jeng.make_scatter(jcfg, jm, cmeta=jc))(
        bridge.state_to_jax(s0), jd, bridge.tallies_to_jax(
            zero_tallies(meta.nxfreq, 0, 'cpu')), jax.random.PRNGKey(1))
    ref = convert.state_from_jax(js)
    at = s0.phase == AT_SCATTER
    stay = at & (st.phase == AT_SCATTER) & (ref.phase == AT_SCATTER)
    assert int(stay.sum()) > 100
    assert torch.equal(st.ic[at], ref.ic[at])
    torch.testing.assert_close(st.xfreq[stay], ref.xfreq[stay], rtol=0.0,
                               atol=0.0)
    assert int((st.xfreq[stay] != s0.xfreq[stay]).sum()) > 10
    assert torch.equal(st.xfreq[~at], s0.xfreq[~at])


def test_refill_births_in_the_source_clump():
    """K2's plain version: each launched lane in lart_tpu's clump of the
    source (clump_find), launched FFS; the source at a clump's centre, the
    clumps moving, the source's spectrum a lab-frame one."""
    for dense in (True, False):
        cfg, jcfg, meta, cmeta, dev, (jm, jc, jd) = _build(
            dense_max=1024 if dense else 0, clump_sigma_v=30.0,
            comoving_source=False)
        for f in ('x', 'y', 'z'):
            setattr(cfg.par, f + 's_point', float(getattr(dev, f)[3]))
        p = trefill.RefillParams.from_config(cfg, meta, dev, cmeta)
        s = init_state(512, 'cpu')
        tl = zero_tallies(meta.nxfreq, 0, 'cpu')
        trefill.refill(s, tl, p, seed=3, counter=1, budget=300)
        want = int(jeng.clump_find(jd, jm, *(
            jnp.full((1,), v, jnp.float32) for v in (p.xs, p.ys, p.zs)),
            dense_max=cfg.par.clump_dense_max)[0])
        launched = s.phase == FFS
        assert want == 3 and int(launched.sum()) == 300
        assert bool((s.ic[launched] == want).all())
        assert bool((s.bic[launched] == want).all())
        # a lab-frame source in a moving clump: xfreq - u1 differs by lane
        u1 = p.clump.vel_dot(s.ic.long(), s.kx, s.ky, s.kz)
        assert float(u1[launched].abs().max()) > 0.1
        assert float(tl.Jin.sum()) == 300.0


def test_check_supported_on_clumps():
    par = _par()
    teng.check_supported(par.resolve())
    cfg, jcfg, meta, cmeta, dev, _ = _build(h2_model='neufeld', f_H2=0.03)
    with pytest.raises(NotImplementedError, match='H2 pumping on a clump'):
        teng.make_chunk(cfg, meta, dev, cmeta)
    # sight-line maps on clumps are ported (K11), and the source geometries;
    # an emissivity drawn from the gas opacity is not (lart_tpu hands
    # build_sources no rhokap on a clump medium)
    teng.check_supported(_par(save_sightline_tau=True,
                              save_peeloff=True).resolve())
    teng.check_supported(_par(source_geometry='exponential_sphere').resolve())
    par = _par(source_geometry='diffuse_emissivity', emiss_file='density2')
    with pytest.raises(NotImplementedError, match='clump medium'):
        teng.check_supported(par.resolve())


def test_csr_overlap_caps_the_candidates():
    """A population whose CSR rows exceed the overlap walker's register
    sort is refused by name, not truncated."""
    cfg, jcfg, meta, cmeta, dev, _ = _build(dense_max=0,
                                            clump_allow_overlap=True)
    big = dataclasses.replace(cmeta, K=K_MAX + 1)
    with pytest.raises(ValueError, match='candidates a CSR cell'):
        ClumpFlight.from_clumps(cfg, meta, big, dev)
    ClumpFlight.from_clumps(cfg, meta, cmeta, dev)


def test_save_and_load_clumps_round_trip(tmp_path):
    """save_clumps writes what lart_tpu's load_clumps reads, and the
    port's load_clumps reads lart_tpu's file; a population from that file
    builds the same device arrays in both packages."""
    pytest.importorskip('h5py')
    par = _par(clump_sigma_v=30.0)
    cfg = par.resolve()
    meta, cmeta, dev = tclump.build_clumps(cfg, seed=5, device='cpu')
    pos = torch.stack([dev.x, dev.y, dev.z], 1).numpy()
    vel = torch.stack([dev.vx, dev.vy, dev.vz], 1).numpy() * 10.0
    path = str(tmp_path / 'pop_clumps.h5')
    tclump.save_clumps(path, pos, dev.radius.numpy(), rhokap=dev.rhokap.numpy(),
                       vel=vel, sphere_R=1.0, attrs={'F_VOL': cmeta.f_vol})
    ref = jclump.load_clumps(path)
    np.testing.assert_array_equal(ref['pos'], pos.astype(np.float64))
    np.testing.assert_array_equal(ref['vel'], vel.astype(np.float64))
    assert ref['attrs']['N_CLUMPS'] == cmeta.n_clumps
    jpath = str(tmp_path / 'ref_clumps.h5')
    jclump.save_clumps(jpath, pos, dev.radius.numpy(),
                       rhokap=dev.rhokap.numpy(), vel=vel)
    got = tclump.load_clumps(jpath)
    for k in ('pos', 'vel', 'radius', 'rhokap'):
        np.testing.assert_array_equal(got[k], jclump.load_clumps(jpath)[k])
    par.clump_input_file = jpath
    cfg, jcfg = bridge.resolve_both(par)
    _, c2, d2 = tclump.build_clumps(cfg, device='cpu')
    _, jc2, jd2 = jclump.build_clumps(jcfg)
    assert c2.n_clumps == cmeta.n_clumps
    for f in ('x', 'rhokap', 'vx', 'table'):
        assert np.array_equal(getattr(d2, f).numpy(),
                              np.asarray(getattr(jd2, f))), f
