"""The port's uniform-sphere chord flight (plain version of kernel K6)
against lart_tpu's make_fly_uniform_sphere, lane by lane on the CPU.

The flight draws no random numbers, so one numpy-made state with lanes in
every phase, inside the sphere and in the vacuum corners of its 17^3 box,
goes through both.  Tolerances as in
test_torch_transport.test_fly_matches_jax_lane_by_lane: lane fields to
rtol 1e-5 (atol 1e-6), at most 1e-4 of the lanes may differ where an f32
hit/escape decision, a bin edge or a position that cancels near zero moves
on a last-ulp difference of the two CPU Voigt functions, and the tallies to
1e-5 of their sum.  B = 100000 lanes, so that the fraction of differing
lanes (2e-5 to 3e-5 over seeds) is measured well inside its bound."""

import numpy as np
import torch

from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport.fly_sphere import SphereFlight, sphere_chord
from lart_tpu_torch.transport.state import AT_SCATTER, DEAD, FFS, FLYING

import _torch_jax_bridge as bridge


def _setup(**kw):
    cfg, jcfg = bridge.resolve_both(testing.sphere_params(**kw))
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    return cfg, jcfg, meta, grid, jmeta, jgrid


def test_fly_sphere_matches_jax_lane_by_lane():
    cfg, jcfg, meta, grid, jmeta, jgrid = _setup(tau0=100.0, n=17)
    flight = teng.make_fly(cfg, meta, grid)
    assert isinstance(flight, SphereFlight) and meta.sphere_R == 1.0
    s0 = testing.mixed_state(meta, 100_000, seed=41)
    st, tl, ref, ref_t = bridge.fly_both(
        jeng.make_fly(jcfg, jmeta), jgrid, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps)

    frac, err = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= 1e-4, frac
    bridge.assert_tallies_close(tl, ref_t)
    assert not bool(((st.phase == FLYING) | (st.phase == FFS)).any())

    # escapes, FFS restarts and scatterings all occur, also of lanes that
    # start in the vacuum corners and enter the sphere (t_in > 0)
    assert int((st.phase == DEAD).sum()) > int((s0.phase == DEAD).sum())
    restarted = (s0.phase == FFS) & (st.wgt != s0.wgt)
    assert int(restarted.sum()) > 0
    r0 = torch.sqrt(s0.x ** 2 + s0.y ** 2 + s0.z ** 2)
    sc = (s0.phase == FLYING) & (st.phase == AT_SCATTER)
    assert int((sc & (r0 > 1.0)).sum()) > 0 and int((sc & (r0 < 1.0)).sum())
    # a new scatter point lies in the sphere, in the cell its index names
    new = (s0.phase != AT_SCATTER) & (st.phase == AT_SCATTER)
    r = torch.sqrt(st.x ** 2 + st.y ** 2 + st.z ** 2)[new]
    assert float(r.max()) <= 1.0 + 1e-5
    cells = testing.cells_of(meta, st.x.numpy(), st.y.numpy(), st.z.numpy())
    at = new.numpy()
    for c, name in zip(cells, ('ic', 'jc', 'kc')):
        np.testing.assert_array_equal(c[at], getattr(st, name).numpy()[at])
    assert float(tl.Jout.sum()) > 0.0


def test_sphere_chord_geometry():
    """Chords of rays from outside, inside and missing the sphere."""
    cfg, _, meta, grid, _, _ = _setup(tau0=10.0, n=9)
    p = teng.make_fly(cfg, meta, grid)
    f = torch.float32
    x = torch.tensor([-2.0, 0.0, 0.5, -2.0], dtype=f)
    y = torch.tensor([0.0, 0.0, 0.0, 1.5], dtype=f)
    z = torch.zeros(4, dtype=f)
    kx = torch.tensor([1.0, 1.0, -1.0, 1.0], dtype=f)
    zero = torch.zeros(4, dtype=f)
    t_in, t_out = sphere_chord(p, x, y, z, kx, zero, zero)
    torch.testing.assert_close(t_in, torch.tensor([1.0, 0.0, 0.0, 0.0]))
    torch.testing.assert_close(t_out, torch.tensor([3.0, 1.0, 1.5, 0.0]))
