"""The port's generic Cartesian flight (plain version of kernel K5) against
lart_tpu's make_fly, lane by lane on the CPU.

The walk draws no random numbers, so one numpy-made state with lanes in
every phase goes through both, on three grids: a 17^3 Hubble-flow sphere
folded by xyz_symmetry (reflect on all three axes, comoving frequency
updates), a 17^3 static sphere with force_generic_kernel (escape), the
Neufeld slab with force_generic_kernel (periodic x/y), and the dusty
expanding shell of testing.dust_params (the opacity adds rhokapD).  Tolerances as in
test_torch_transport.test_fly_matches_jax_lane_by_lane: lane fields to
rtol 1e-5 (atol 1e-6), at most 1e-4 of the lanes may differ where an f32
hit/cross decision or a bin edge flips on a last-ulp difference of the two
CPU libraries' exp/cos (or of XLA's reciprocal for a division by a
constant), and the tallies to 1e-5 of their sum."""

import numpy as np
import pytest
import torch

from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
from lart_tpu_torch.transport.state import (AT_SCATTER, DEAD, FFS, FLYING,
                                            zero_tallies)

import _torch_jax_bridge as bridge

B = 20_000
CASES = {
    'hubble17_reflect': lambda: testing.hubble_params(tau0=100.0, n=17),
    'sphere17_escape': lambda: testing.sphere_params(
        tau0=100.0, n=17, force_generic_kernel=True),
    'slab_periodic': lambda: testing.slab_params(
        tau0=1e4, force_generic_kernel=True),
    # the dusty expanding shell: rhokap H(x, a) + rhokapD a cell
    'shell17_dust': lambda: testing.dust_params(),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_fly_cartesian_matches_jax_lane_by_lane(case):
    cfg, jcfg = bridge.resolve_both(CASES[case]())
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    flight = teng.make_fly(cfg, meta, grid)
    assert isinstance(flight, CartesianFlight)
    s0 = testing.mixed_state(meta, B, seed=31)
    st, tl, ref, ref_t = bridge.fly_both(
        jeng.make_fly(jcfg, jmeta), jgrid, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps)

    frac, err = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= 1e-4, frac
    bridge.assert_tallies_close(tl, ref_t)

    # every branch took part: escapes, FFS restarts, scatterings, and the
    # boundary op of the grid (reflections flip a direction component;
    # periodic crossings put a lane on the opposite face)
    assert int((st.phase == DEAD).sum()) > int((s0.phase == DEAD).sum())
    assert int((st.phase == AT_SCATTER).sum()) > \
        int((s0.phase == AT_SCATTER).sum())
    restarted = (s0.phase == FFS) & (st.phase != FFS) & (st.wgt != s0.wgt)
    assert int(restarted.sum()) > 0
    kept = (s0.phase == FLYING) & (st.phase != DEAD)
    flipped = kept & ((st.kx * s0.kx < 0) | (st.ky * s0.ky < 0)
                      | (st.kz * s0.kz < 0))
    assert (int(flipped.sum()) > 0) == (meta.bc_x == 'reflect'), case
    if meta.static_medium:
        # no comoving shifts: a lane that kept flying kept its frequency
        assert torch.equal(st.xfreq[kept], s0.xfreq[kept])
    else:
        assert not torch.equal(st.xfreq[kept], s0.xfreq[kept])
    assert float(tl.Jout.sum()) > 0.0


def test_fly_cartesian_cells_stay_consistent():
    """After a walk every lane still flying or scattering sits in the cell
    its index names (to one cell at a face), on the reflected grid."""
    cfg = testing.hubble_params(tau0=30.0, n=17).resolve()
    meta, grid = build_cartesian(cfg)
    flight = teng.make_fly(cfg, meta, grid)
    st = testing.mixed_state(meta, 5000, seed=4)
    tl = zero_tallies(meta.nxfreq, 8, 'cpu')
    for _ in range(3):
        flight(st, tl, 8)
    live = (st.phase == FLYING) | (st.phase == AT_SCATTER)
    for pos, c, amin, d, n in ((st.x, st.ic, meta.xmin, meta.dx, meta.nx),
                               (st.y, st.jc, meta.ymin, meta.dy, meta.ny),
                               (st.z, st.kc, meta.zmin, meta.dz, meta.nz)):
        lo = amin + c[live].double() * d
        p = pos[live].double()
        assert bool(((c[live] >= 0) & (c[live] < n)).all())
        assert bool(((p >= lo - 1e-5) & (p <= lo + d + 1e-5)).all())
    # weight budget: escaped in range + outside the grid + still in flight
    w = float(tl.Jout.sum() + tl.W_oor)
    assert np.isfinite(w) and w > 0.0
