"""K7 where its deposits crowd into few bins, as the CPU can check it: the
plain peel of a crowded state (every lane within a small square of one
cell, at one frequency: a few dozen bins, or a few hundred for a
resonance, take the batch's deposits) against lart_tpu's make_peel, in
mode direct, resonance with Stokes and dust (the Mueller table with
Stokes).  The tolerances are tests/test_torch_peel.py's: each
pair's min(tau, 110) against make_peel's tau_to_edge closure to rtol 1e-5
+ atol 1e-6 on all but 1e-3 of the pairs, then the cubes to 1e-5 of their
sum without the lanes of such pairs and of edge pairs (at most 3%).  A
thick crowded state (line centre in the slab's centre cell) deposits 0 at
every pair whose walk stops at peel.TAU_STOP, as lart_tpu's walk to 745.2
does.  The kernel itself runs on the card (chip_smoke.py
phase2_peel_hot, tests/test_torch_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.instruments import peel as jpeel
from lart_tpu_torch import testing
from lart_tpu_torch.instruments import peel as tpeel

import _torch_jax_bridge as bridge
import test_torch_peel as tp

B = 2048


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def crowded(meta, cell, xfreq, seed):
    """testing.hot_state's lanes in `cell` at xfreq, moved to within 0.05
    cell widths of the cell's centre in x and y and 1e-3 in z."""
    s = testing.hot_state(meta, B, seed, cell=cell, xfreq=xfreq)
    rng = np.random.default_rng([seed, 5])
    for ax, (f, half) in enumerate(zip('xyz', (0.05, 0.05, 1e-3))):
        lo = (meta.xmin, meta.ymin, meta.zmin)[ax]
        d = (meta.dx, meta.dy, meta.dz)[ax]
        getattr(s, f).copy_(torch.as_tensor(
            lo + (cell[ax] + 0.5 + rng.uniform(-half, half, B)) * d,
            dtype=torch.float32))
    return s


# (test_torch_peel case, mode, cell, xfreq): the 17-cell slab's top cell in
# the wing (tau ~0.3), the dusty shell's cell on the +z side of the shell
# at the line's centre in the outflow's frame
CROWDS = {
    'slab, direct': ('slab17', 'direct', (0, 0, 16), 8.0),
    'slab, resonance, Stokes': ('slab17', 'resonance', (0, 0, 16), 8.0),
    'shell, dust, Stokes': ('shell17_dust', 'dust', (8, 8, 15), 15.5),
}


def _compare(case, mode, s, seed):
    """The plain peel of `s` against make_peel's (tests/test_torch_peel.py
    test_peel_matches_make_peel's rule); returns the plain cubes, the
    distinct bins of the pairs that deposit and the lanes compared."""
    (cfg, jcfg, meta, jmeta, jgrid, p, jobs_meta, jodev,
     _) = tp._setup(case)
    m = tp.MODES[mode]
    rec = testing.peel_record(s, seed=seed + 1)
    jtau, max_steps = tp._jax_tau_closure(jcfg, jmeta, jobs_meta)
    bad, _, _ = tp._excluded_lanes(case, m, s, rec, p, jtau, max_steps,
                                   jgrid)
    rec.flag.copy_((~bad).to(torch.int32) * max(m, 1))
    cubes = p.zero_cubes('cpu')
    n = p.nobs * B
    tau = torch.full((n,), -1.0)
    bins = torch.full((n,), -1, dtype=torch.int32)
    w = torch.zeros((4 * n,))
    tpeel.peel(s, cubes, rec, p, m, tau, bins, w)
    pd, pr, pdust, _ = jpeel.make_peel(jcfg, jmeta, jobs_meta)
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
        want = torch.as_tensor(np.array(getattr(ref, name)))
        atol = 1e-5 * max(float(want.abs().sum()), 1e-30)
        torch.testing.assert_close(cube, want, rtol=0, atol=atol,
                                   msg=f'{case} {mode} {name}')
    dep = bins >= 0
    return cubes, torch.unique(bins[dep]), tau[dep], w.view(4, n)[:, dep], \
        int((~bad).sum())


@pytest.mark.parametrize('crowd', sorted(CROWDS))
def test_crowded_peel_matches_make_peel(crowd):
    """The batch's deposits crowd into a few bins (a few dozen at a birth
    or a dust event), and the plain cubes there agree with make_peel's."""
    case, mode, cell, x = CROWDS[crowd]
    meta = tp._setup(case)[2]
    s = crowded(meta, cell, x, seed=71)
    cubes, bins, tau, w, lanes = _compare(case, mode, s, seed=71)
    assert lanes > 0.9 * B
    # at least 8 pairs a bin on average (a resonance spreads its photons
    # over the atoms' thermal velocities, a few hundred bins)
    assert 1 <= bins.numel() <= 2 * B / 8, bins.numel()
    deposited = cubes.direc if mode == 'direct' else cubes.scatt
    assert float(deposited.sum()) > 0.0
    assert bool((tau < tpeel.TAU_STOP).any())


def test_thick_crowd_deposits_zero_past_tau_stop():
    """Line centre in the slab's centre cell (tau ~5e3 to either face): the
    walks stop at TAU_STOP, every such pair's deposits are 0, and the
    cubes still agree with make_peel's, whose walks go on to 745.2."""
    meta = tp._setup('slab17')[2]
    s = crowded(meta, (0, 0, 8), 0.0, seed=73)
    _, _, tau, w, _ = _compare('slab17', 'resonance', s, seed=73)
    stop = tau >= tpeel.TAU_STOP
    assert float(stop.float().mean()) > 0.9
    assert bool((w[:, stop] == 0.0).all())
