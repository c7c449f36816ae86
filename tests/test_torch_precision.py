"""The port's f32 in-chunk tallies against a per-cycle f64 flush, and the
f32 scatter-add error at a production deposit count (the port's
counterpart of tests/test_precision.py).

The chunk draws from Philox keyed by (seed, cycle index), so one 32-cycle
chunk and 32 one-cycle chunks from the same state run the identical
histories: the states must be bitwise equal, and the tallies differ only
by their summation in f32 within a chunk against f64 after every cycle.
The sphere has CALCJ, CALCP and CALCPnew on, the deposit-heaviest mode
(one deposit a flight step and lane into J1 and Pnew, one a scattering
into Pa).  The kernels' f32 atomics are held to the same bounds on the card
(chip_smoke.py phase 2, B = 131072).
"""

import numpy as np
import torch

from lart_tpu_torch import testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.transport.engine import make_chunk
from lart_tpu_torch.transport.state import LANE_FIELDS

MAPS = ('Jout', 'Jin', 'J1', 'Pa', 'Pnew')


def test_chunk_f32_vs_cycle_flushed_f64():
    par = Params(nphotons=1 << 30, geometry='sphere', rmax=1.0,
                 nx=33, ny=33, nz=33, taumax=1e4, temperature=1e4,
                 core_skip=True, calcJ=True, calcP=True, calcPnew=True,
                 xfreq_min=-40.0, xfreq_max=40.0, nxfreq=129,
                 batch_size=1 << 12, fly_substeps=8, scatter_rounds=4,
                 chunk_cycles=32, refill_every=4)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s1, prod, s2, acc = testing.chunk_vs_cycles(par)
    finally:
        torch.set_num_threads(n)
    # tally precision cannot leak into the transport
    for f in LANE_FIELDS:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    checked = 0
    for k in MAPS:
        a, b = prod[k], acc[k]
        if not b.any():
            continue        # no escape yet at tau0 = 1e4: nothing to bound
        checked += 1
        assert abs(a.sum() - b.sum()) / b.sum() < 2e-5, (k, a.sum(),
                                                         b.sum())
        assert np.abs(a - b).max() / b.max() < 5e-5, k
    # the three maps (raw Pa and Pnew are ~1e-12: wgt over rhokap D /
    # cross0) and Jin were checked
    assert checked >= 4, checked


def test_index_add_error_at_production_scale():
    """2^25 deposits (2^17 lanes x 32 cycles x 8 steps) into 64 bins,
    weights U(0.3, 1): f32 index_add_ against the f64 sum."""
    n_dep, n_bins = 1 << 25, 64
    rng = np.random.default_rng(0)
    w = rng.uniform(0.3, 1.0, n_dep).astype(np.float32)
    b = rng.integers(0, n_bins, n_dep)
    f32 = torch.zeros(n_bins, dtype=torch.float32).index_add_(
        0, torch.from_numpy(b), torch.from_numpy(w))
    f64 = np.bincount(b, weights=w.astype(np.float64), minlength=n_bins)
    rel = np.abs(f32.double().numpy() - f64) / f64
    # ~5e5 adds a bin; far below the Monte Carlo noise (~1e-3)
    assert rel.max() < 3e-4, rel.max()


def test_equal_deposits_into_one_bin_need_f64():
    """Why the J1, Pa and Pnew maps sum in f64: a chunk's Pa deposits in a
    uniform medium are equal (wgt over one rhokap_phys), and 2^17 of them
    (B = 4096 x 32 cycles) into one bin round alike in f32, 1.05e-3 of the
    sum (2.0e-2 at B = 131072), far beyond the 2e-5 bound; in f64 the
    error is the f32 deposits' own rounding, nil."""
    n = 1 << 17
    w = torch.full((n,), 0.7310586, dtype=torch.float32)
    idx = torch.zeros(n, dtype=torch.long)
    exact = n * float(w[0])
    f32 = float(torch.zeros(1).index_add_(0, idx, w))
    f64 = float(torch.zeros(1, dtype=torch.float64).index_add_(
        0, idx, w.double()))
    assert abs(f32 - exact) / exact > 2e-5
    assert abs(f64 - exact) / exact < 1e-12
    cfg = Params(nphotons=10, geometry='sphere', rmax=1.0, nx=9, ny=9, nz=9,
                 taumax=10.0, calcJ=True, calcP=True, calcPnew=True
                 ).resolve()
    meta, grid = build_cartesian(cfg)
    tl = make_chunk(cfg, meta, grid).zero_tallies('cpu')
    assert all(getattr(tl, k).dtype == torch.float64
               for k in ('J1', 'Pa', 'Pnew'))
