"""Peel-off (kernel K7's plain version) against lart_tpu's make_peel on the
CPU: injected states on a 17-cell periodic slab, a 17^3 Hubble sphere
folded by reflection (xyz_symmetry), the same sphere unfolded (escape on
every face, as examples/vel_effect_peel), a 17^3 uniform sphere (the
chord) and the 17^3 dusty expanding shell of testing.dust_params (the
walk adds rhokapD; the dust peel through the Mueller table with Stokes,
Henyey-Greenstein without), each seen by two observers (one on the +z
axis, one oblique).

Per (observer, lane) pair, the optical depth to the edge is held against
make_peel's own tau_to_edge closure on the same direction and frequency:
min(tau, 110) to rtol 1e-5 + atol 1e-6 (XLA fuses tau + d rho into one
FMA, the plain version rounds twice; the port's walk stops at tau
peel.TAU_STOP = 110, where lart_tpu walks on, and the deposit exp(-min(tau,
700)) is 0 in f32 beyond it).  At most 1e-3 of the pairs may miss it, where a near tie between
two faces sends the walks through different cells.

The cubes of peel_direct, peel_resonance and peel_dust (with and without
Stokes) agree to 1e-5 of their sum.  Lanes are left out of that comparison, and
counted, when a pair misses the tau tolerance or lies on an edge, where
the f32 rounding of either package (XLA fuses the rotation into the
observer frame and the frequency shifts into FMAs) moves the deposit into
the next pixel or bin: computed in float64 from the same f32 inputs, the
sightline's angle within EDGE_RAD = 3e-7 rad of a pixel boundary (an ulp
of an f32 unit vector's component near 0.5 is 6e-8, and an oblique
observer's rotation sums three of them), or the lab frequency, on the
grid, within EDGE_REL = 1e-6 of its magnitude (at least 1e-6) of a bin
edge.  The pixels of these 33 x 33 images span ~1e-4 rad, so 1-2% of the
pairs are edge pairs (at most EDGE_FRAC = 3%); with no band the cubes of
three of the four cases miss the tolerance."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.grid import cartesian as jcart
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import peel as jpeel
from lart_tpu_torch import testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.instruments import peel as tpeel
from lart_tpu_torch.transport import engine as teng

import _torch_jax_bridge as bridge

B = 8192
EDGE_RAD, EDGE_REL, EDGE_FRAC = 3e-7, 1e-6, 0.03
TAU_RTOL, TAU_ATOL, TAU_FRAC = 1e-5, 1e-6, 1e-3

CASES = {
    'slab17': (lambda: testing.peel_params(
        testing.slab_params(tau0=1e4, nz=17)), None),
    'hubble17_reflect': (lambda: testing.peel_params(
        testing.hubble_params(tau0=100.0, n=17), stokes=False), 1.0),
    'hubble17_escape': (lambda: testing.peel_params(
        testing.hubble_params(tau0=100.0, n=17, xyz_symmetry=False)), 1.0),
    'sphere17_chord': (lambda: testing.peel_params(
        testing.sphere_params(tau0=100.0, n=17)), 1.0),
    'shell17_dust': (lambda: testing.peel_params(testing.dust_params()),
                     1.0),
    'shell17_dust_hg': (lambda: testing.peel_params(
        testing.dust_params(stokes=False), stokes=False), 1.0),
}
MODES = {'direct': tpeel.DIRECT, 'resonance': tpeel.RESONANCE,
         'dust': tpeel.DUST}
# every grid in the modes of a dust-free run; the dusty shell in each mode
# (the Mueller dust peel with Stokes, and Henyey-Greenstein without)
CASE_MODES = ([(c, m) for c in sorted(CASES) if c != 'shell17_dust_hg'
               for m in ('direct', 'resonance')]
              + [('shell17_dust', 'dust'), ('shell17_dust_hg', 'dust')])


def _setup(case):
    make, r_max = CASES[case]
    cfg, jcfg = bridge.resolve_both(make())
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    p = teng.make_chunk(cfg, meta, grid).peel
    assert p.chord == (case == 'sphere17_chord')
    assert p.lab_source == case.startswith('hubble')
    assert (p.grid.rhokapD is not None) == case.startswith('shell')
    jobs_meta, jodev = jobs.build_observers(jcfg)
    return cfg, jcfg, meta, jmeta, jgrid, p, jobs_meta, jodev, r_max


def _edge(p, mode, s, rec, o):
    """The pairs (o, lane) on an edge: their TAN angles or lab frequency,
    computed in float64 from the same f32 inputs, near a pixel boundary or
    a bin edge (the rule of the module docstring)."""
    d = {f: getattr(s, f).double() for f in ('x', 'y', 'z', 'xfreq', 'kx',
                                              'ky', 'kz')}
    pos = p.pos.double()[o]
    R = p.rmat.double()[o]
    pk = [pos[a] - d[c] for a, c in enumerate('xyz')]
    r = torch.sqrt(pk[0] ** 2 + pk[1] ** 2 + pk[2] ** 2)
    pk = [v / r for v in pk]
    k = [sum(R[a, b] * pk[b] for b in range(3)) for a in range(3)]
    obs = p.obs_meta
    edge = torch.zeros(s.batch, dtype=torch.bool)
    for ka, dim, n in ((k[0], obs.dxim, obs.nxim), (k[1], obs.dyim,
                                                     obs.nyim)):
        c = torch.atan2(-ka, k[2]) * (180.0 / math.pi) / dim + n / 2.0
        edge |= (c - torch.round(c)).abs() * dim * (math.pi / 180.0) \
            < EDGE_RAD
    r64 = tpeel.PeelRecord(**{f: getattr(rec, f).double() if f != 'flag'
                              else rec.flag for f in tpeel.PEEL_RECORD_FIELDS})
    s64 = _State(**d, ic=s.ic, jc=s.jc, kc=s.kc)
    xf = tpeel.event_frequency(p, mode, s64, r64, pk)[0]
    g = p.grid
    xr = xf + g.vel_dot((s.ic, s.jc, s.kc), *pk) if g.moving else xf
    cf = (xr - g.xfreq_min) / g.dxfreq
    edge |= ((cf - torch.round(cf)).abs() * g.dxfreq
             < EDGE_REL * torch.clamp_min(xr.abs(), 1.0)) \
        & (cf > -1.0) & (cf < g.nxfreq + 1.0)
    return edge


class _State:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _jax_tau_closure(jcfg, jmeta, jobs_meta):
    """make_peel's tau_to_edge and max_steps, as its peel_direct sees them."""
    pd = jpeel.make_peel(jcfg, jmeta, jobs_meta)[0]
    free = dict(zip(pd.__code__.co_freevars,
                    (c.cell_contents for c in pd.__closure__)))
    return jax.jit(free['tau_to_edge'], static_argnums=12), free['max_steps']


def _excluded_lanes(case, mode, s, rec, p, jtau, max_steps, jgrid):
    """Lanes with a pair off the tau tolerance or on an edge; returns the
    mask and the two counts (pairs)."""
    cell = (s.ic, s.jc, s.kc)
    bad = torch.zeros(s.batch, dtype=torch.bool)
    n_tau = n_edge = n_pairs = 0
    for o in range(p.nobs):
        pk, _, _, in_img = tpeel.obs_geometry(p, o, s.x, s.y, s.z)
        xf = tpeel.event_frequency(p, mode, s, rec, pk)[0]
        t = tpeel.tau_to_edge(p, (s.x, s.y, s.z), cell, pk, xf, in_img)
        j = jtau(jgrid, *(jnp.asarray(v.numpy()) for v in (
            s.x, s.y, s.z, s.ic, s.jc, s.kc, *pk, xf, in_img)), max_steps)
        t = torch.clamp_max(t, tpeel.TAU_STOP)
        j = torch.clamp_max(torch.as_tensor(np.array(j)), tpeel.TAU_STOP)
        off = in_img & ((t - j).abs() > TAU_ATOL + TAU_RTOL * j.abs())
        edge = in_img & _edge(p, mode, s, rec, o)
        bad |= off | edge
        n_tau += int(off.sum())
        n_edge += int(edge.sum())
        n_pairs += int(in_img.sum())
    assert n_pairs > 0.2 * p.nobs * s.batch, n_pairs
    assert n_tau <= TAU_FRAC * n_pairs, (case, n_tau, n_pairs)
    assert n_edge <= EDGE_FRAC * n_pairs, (case, n_edge, n_pairs)
    return bad, n_tau, n_edge


@pytest.mark.parametrize('case,mode', CASE_MODES)
def test_peel_matches_make_peel(case, mode):
    (cfg, jcfg, meta, jmeta, jgrid, p, jobs_meta, jodev,
     r_max) = _setup(case)
    m = MODES[mode]
    s = testing.mixed_state(meta, B, seed=61, r_max=r_max)
    rec = testing.peel_record(s, seed=62)
    jtau, max_steps = _jax_tau_closure(jcfg, jmeta, jobs_meta)
    assert max_steps == p.max_steps
    bad, n_tau, n_edge = _excluded_lanes(case, m, s, rec, p, jtau,
                                         max_steps, jgrid)
    # the flag a lane's event gets: launched (direct), or K4's kind
    rec.flag.copy_((~bad).to(torch.int32) * max(m, 1))

    cubes = p.zero_cubes('cpu')
    tpeel.peel(s, cubes, rec, p, m)

    pd, pr, pdust, _ = jpeel.make_peel(jcfg, jmeta, jobs_meta)
    js = bridge.state_to_jax(s)
    active = jnp.asarray((~bad).numpy())
    zero = jpeel.zero_cubes(jcfg, jmeta, jobs_meta)
    if m == tpeel.DIRECT:
        ref = jax.jit(pd)(zero, jgrid, jodev, js, active)
    elif m == tpeel.DUST:
        # the record holds the lane's own direction, triad and Stokes
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
                                       f'out: tau {n_tau}, edge {n_edge})')
    deposited = cubes.direc if m == tpeel.DIRECT else cubes.scatt
    assert float(deposited.sum()) > 0.0


# the cubes each component of a pair's deposits goes into (peel() w_out)
PAIR_CUBES = {(tpeel.DIRECT, False): (('direc', 0),),
              (tpeel.DIRECT, True): (('direc', 0), ('I', 0)),
              (tpeel.RESONANCE, False): (('scatt', 0),),
              (tpeel.RESONANCE, True): (('scatt', 0), ('I', 0), ('Q', 1),
                                        ('U', 2), ('V', 3))}
PAIR_CUBES.update({(tpeel.DUST, st): v for (m, st), v in PAIR_CUBES.items()
                   if m == tpeel.RESONANCE})


@pytest.mark.parametrize('case,mode', CASE_MODES)
def test_pair_outputs_and_work_add_up(case, mode):
    """The plain version's per-pair outputs (what the card's check holds
    K7 to, pair by pair) add up to its cubes, and its work counts (K7's
    bound in chip_smoke.py) agree with the pairs, bins and cells it used."""
    make, r_max = CASES[case]
    cfg = make().resolve()
    meta, grid = build_cartesian(cfg)
    p = teng.make_chunk(cfg, meta, grid).peel
    m = MODES[mode]
    s = testing.mixed_state(meta, 2048, seed=63, r_max=r_max)
    rec = testing.peel_record(s, seed=64)
    rec.flag.copy_(torch.as_tensor(
        np.random.default_rng(65).random(s.batch) < 0.8,
        dtype=torch.int32) * max(m, 1))
    n = p.nobs * s.batch
    tau = torch.full((n,), -1.0)
    bins = torch.full((n,), -1, dtype=torch.int32)
    w = torch.zeros((4, n))
    cubes = p.zero_cubes('cpu')
    stats = {}
    tpeel.peel_plain(s, cubes, rec, p, m, tau, bins, w.view(-1),
                     stats=stats)
    dep = bins >= 0
    assert stats['pairs'] == int(dep.sum()) > 0
    assert stats['bins'] == int(torch.unique(bins[dep]).numel())
    assert 0 < stats['seen'] <= int((rec.flag != 0).sum())
    assert bool((tau[dep] >= 0.0).all())
    comps = PAIR_CUBES[(m, p.stokes)]
    for name, c in comps:
        cube = getattr(cubes, name)
        want = torch.zeros_like(cube).index_add_(0, bins[dep].long(),
                                                 w[c][dep])
        torch.testing.assert_close(cube, want, rtol=1e-6, atol=1e-6 * float(
            want.abs().sum()), msg=f'{case} {mode} {name}')
    used = max(c for _, c in comps) + 1
    assert bool((w[used:] == 0.0).all()) and bool((w[:, ~dep] == 0.0).all())
    if p.chord:
        assert stats['cells'] == 0
    else:
        # every walking pair reads its own cell first
        g = p.grid
        lanes = torch.arange(n) % s.batch
        start = g.flat(s.ic[lanes[dep]], s.jc[lanes[dep]], s.kc[lanes[dep]])
        ncell = meta.nx * meta.ny * meta.nz
        assert int(torch.unique(start).numel()) <= stats['cells'] <= ncell
