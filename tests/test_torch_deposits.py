"""The maps' deposits as the CPU can check them: the wrappers' block plans
(which map gets a block copy in shared memory and which takes the warp
level alone, from JpaBins.sizes; a launch asks for 8 bytes of dynamic
shared memory a slot), and the plain deposits of a hot-bin state (every lane in
one cell: the bins that serialized the kernels' atomics) against a numpy
f64 sum.  The kernels themselves run on the card (chip_smoke.py
phase2_shear's hot_bins and jabs_hot, tests/test_torch_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from lart_tpu_torch import testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport import fly_cartesian, scatter
from lart_tpu_torch.transport.engine import make_chunk
from lart_tpu_torch.transport.jpa import (BLOCK_COPY_BYTES, block_plan,
                                          deposit_scatterings,
                                          deposit_segments)
from lart_tpu_torch.transport.state import AT_SCATTER, FFS, FLYING

TINY = np.float32(1e-30)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chunk(par):
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device='cpu')
    return meta, make_chunk(cfg, meta, grid)


# (geometry, overrides): the three binnings of testing.jpa_params, a slab
# whose J1 does not fit beside Pnew, and a flat-cell box of 17^3 = 4913
# bins, above the 4096 f64 bins of BLOCK_COPY_BYTES
GEOMETRIES = {
    'slab': ('slab', {}),
    'sphere': ('sphere', {}),
    'box': ('box', {}),
    'slab, 130 frequency bins': ('slab', dict(nxfreq=130)),
    'box 17^3': ('box', dict(nx=17, ny=17, nz=17)),
}


@pytest.mark.parametrize('case', sorted(GEOMETRIES))
def test_block_plan_and_shared_bytes(case):
    """Each map of K5 (Pnew first, then J1) and K4 (Pa) gets a block copy
    of all its bins where they fit in what the maps before it left of
    BLOCK_COPY_BYTES, else 0 (the warp level alone), so that a launch's
    dynamic shared memory, 8 bytes a slot, stays within the cap."""
    geo, over = GEOMETRIES[case]
    meta, ch = chunk(testing.jpa_params(geo, batch=256, **over))
    tl = ch.zero_tallies('cpu')
    n_j1, n_pa, n_pnew = ch.flight.jpa.sizes(meta.nxfreq)
    assert (n_j1, n_pa, n_pnew) == ch.jpa
    pnew = n_pnew if 8 * n_pnew <= BLOCK_COPY_BYTES else 0
    j1 = n_j1 if 8 * (n_j1 + pnew) <= BLOCK_COPY_BYTES else 0
    plan5 = fly_cartesian.deposit_plan(ch.flight, tl)
    assert plan5 == (pnew, j1)
    pa = n_pa if 8 * n_pa <= BLOCK_COPY_BYTES else 0
    plan4 = scatter.deposit_plan(ch.scatter_params, tl)
    assert plan4 == pa
    expect = {'slab': (33, 2640, 33), 'sphere': (9, 720, 9),
              'box': (729, 0, 729), 'slab, 130 frequency bins': (33, 0, 33),
              'box 17^3': (0, 0, 0)}[case]
    assert (*plan5, plan4) == expect
    assert 8 * sum(plan5) <= BLOCK_COPY_BYTES
    # without the maps' tensors the launch asks for no block copy
    none = dataclasses.replace(tl, J1=None, Pa=None, Pnew=None)
    assert fly_cartesian.deposit_plan(ch.flight, none) == (0, 0)
    assert scatter.deposit_plan(ch.scatter_params, none) == 0


def test_block_plan_jabs_and_priority():
    """A map takes a copy only where all of it fits what the maps before it
    left; K4's Jabs takes no block copy (one f32 atomic an absorption in
    every instance), so a dusty launch with the Pa map plans Pa alone and
    one without it nothing."""
    cap = BLOCK_COPY_BYTES
    assert block_plan(cap // 8, 1) == (cap // 8, 0)
    assert block_plan(cap // 8 + 1, 100) == (0, 100)
    assert block_plan(0, cap // 8) == (0, cap // 8)
    assert block_plan(10, 121) == (10, 121)
    meta, ch = chunk(testing.dust_params(batch=256))
    assert scatter.deposit_plan(ch.scatter_params,
                                ch.zero_tallies('cpu')) == 0
    meta, ch = chunk(testing.dust_params(batch=256, calcP=True))
    assert scatter.deposit_plan(ch.scatter_params,
                                ch.zero_tallies('cpu')) == meta.nbin_JPa


def numpy_bins(q, ic, jc, kc):
    return q.bin(torch.as_tensor(ic), torch.as_tensor(jc),
                 torch.as_tensor(kc)).numpy()


@pytest.mark.parametrize('geo', ['slab', 'sphere', 'box'])
def test_plain_deposits_of_a_hot_bin_state(geo):
    """deposit_scatterings and deposit_segments on a state whose lanes all
    sit in the centre cell (and, for J1, in one frequency bin): each map
    equals the numpy f64 sum of the same f32 deposits."""
    meta, ch = chunk(testing.jpa_params(geo, batch=4096))
    q = ch.flight.jpa
    xc = meta.xfreq_min + (meta.nxfreq // 2 + 0.5) * meta.dxfreq
    s = testing.hot_state(meta, 4096, 7, 'cpu', xfreq=xc)
    # a tenth of the lanes elsewhere, so the maps have more than one bin
    spread = testing.mixed_state(meta, 4096, 8, 'cpu')
    other = torch.arange(4096) % 10 == 0
    for f in ('ic', 'jc', 'kc', 'xfreq'):
        getattr(s, f).copy_(torch.where(other, getattr(spread, f),
                                        getattr(s, f)))
    tl = ch.zero_tallies('cpu')
    f32 = np.float32
    rng = np.random.default_rng(3)
    n = 4096
    rk = torch.as_tensor(rng.uniform(0.0, 2.0, n), dtype=torch.float32)
    rk[:7] = 0.0                             # cells without gas
    D = torch.as_tensor(rng.uniform(0.8, 1.2, n) * meta.Dfreq_ref,
                        dtype=torch.float32)
    cell = (s.ic, s.jc, s.kc)
    bins = numpy_bins(q, s.ic.numpy(), s.jc.numpy(), s.kc.numpy())
    assert np.bincount(bins).max() >= 0.85 * n    # the hot bin

    do_res = s.phase == AT_SCATTER
    deposit_scatterings(q, tl, do_res, cell, s.wgt, rk, D)
    rkp = rk.numpy() * D.numpy() / f32(q.cross0)
    ok = do_res.numpy() & (rkp > 0)
    val = s.wgt.numpy() / np.maximum(rkp, TINY)
    want = np.zeros(q.nbin)
    np.add.at(want, bins[ok], val[ok].astype(np.float64))
    np.testing.assert_allclose(tl.Pa.numpy(), want, rtol=1e-12, atol=0)

    seg_ok = (s.phase == FLYING) | (s.phase == FFS)
    ratio = (D / f32(meta.Dfreq_ref)).to(torch.float32)
    d_adv = torch.as_tensor(rng.uniform(0.0, 0.1, n), dtype=torch.float32)
    rhoH = torch.as_tensor(rng.uniform(0.0, 5.0, n), dtype=torch.float32)
    p = ch.flight
    deposit_segments(q, tl, p, seg_ok, cell, s.xfreq, ratio, d_adv, rhoH,
                     s.wgt, rk, D)
    xr = s.xfreq.numpy() * ratio.numpy()
    ix = np.floor((xr - f32(p.xfreq_min)) / f32(p.dxfreq))
    okf = seg_ok.numpy() & (ix >= 0) & (ix < p.nxfreq)
    j1 = np.zeros(p.nxfreq * q.nbin)
    key = (np.clip(ix, 0, p.nxfreq - 1).astype(np.int64) * q.nbin + bins)
    np.add.at(j1, key[okf], (d_adv.numpy() * s.wgt.numpy())[okf]
              .astype(np.float64))
    np.testing.assert_allclose(tl.J1.numpy(), j1, rtol=1e-12, atol=0)
    assert np.count_nonzero(j1) < 0.2 * n                 # a few hot bins
    ok = seg_ok.numpy()
    pn = (d_adv.numpy() * rhoH.numpy() * s.wgt.numpy()
          / np.maximum(rkp, TINY))
    pnew = np.zeros(q.nbin)
    np.add.at(pnew, bins[ok], pn[ok].astype(np.float64))
    np.testing.assert_allclose(tl.Pnew.numpy(), pnew, rtol=1e-12, atol=0)
