"""Top-level simulation driver of the port.

Counterpart of prepare / run (lart_tpu/driver.py:50-377): resolve the
config, build the grid, then loop chunks of refill/fly/scatter cycles on
one device, adding each chunk's f32 tallies into f64 accumulators on the
host, and normalize.  One host read per chunk: the tallies and the
loop-control scalars travel back together.

Tail control as in lart_tpu (driver.py:218-269): once the photon budget is
launched, chunks grow by the drain factor (boost), and the batch shrinks
to 4096 and then 512 lanes as it drains, compacting the alive lanes on the
device with index_select.  The boost is capped at MAX_BOOST, not at
lart_tpu's 256x: every cycle costs its kernel launches (on the CPU, its
whole plain computation) whether lanes are alive or not, so the cycles a
long last chunk runs after its last photon died are paid for, while a
chunk's one host read costs little.  PERF.md holds the runs that compare
caps of 8, 256 and 1024: on an H100 they differ by less than the spread
of the tail's length from run to run, and on the CPU 8 is the fastest.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from lart_tpu.config import Params

from .grid.cartesian import build_cartesian
from .tally import RunResult, normalize
from .transport.engine import check_supported, make_chunk
from .transport.state import DEAD, BatchState, Tallies, init_state
from .utils.device import resolve_device

SHRINK_LADDER = (4096, 512)
MAX_BOOST = 8


class Prepared:
    """Everything run() builds before the chunk loop, exposed so a
    benchmark drives the production path without repeating the set-up."""

    __slots__ = ('cfg', 'meta', 'grid', 'device', 'budget', 'seed', 'state',
                 'chunk', 'cycle')

    def run_chunk(self, n_cycles: Optional[int] = None):
        """Advance the batch by one chunk; returns device tensors
        (tallies, alive, launched)."""
        n = n_cycles or self.chunk.n_cycles
        out = self.chunk(self.state, self.seed, self.cycle, self.budget, n)
        self.cycle += n
        return out


def prepare(par: Params, *, seed: Optional[int] = None,
            device=None) -> Prepared:
    cfg = par.resolve()
    check_supported(cfg)
    dev = resolve_device(device)
    meta, grid = build_cartesian(cfg, device=dev)
    p = Prepared()
    p.cfg, p.meta, p.grid, p.device = cfg, meta, grid, dev
    p.chunk = make_chunk(cfg, meta)
    p.budget = int(cfg.par.nphotons)
    p.seed = int(seed if seed is not None else cfg.par.iseed)
    p.state = init_state(cfg.par.batch_size, dev)
    p.cycle = 0
    return p


def chunk_to_host(tallies: Tallies, alive, launched) -> dict:
    """One device->host copy of a chunk's tallies and control scalars."""
    parts = [tallies.Jin, tallies.Jout, tallies.Jmu,
             torch.stack([tallies.nscatt_gas, tallies.nscatt_events,
                          tallies.W_oor]),
             torch.stack([alive, launched])]
    flat = torch.cat([t.reshape(-1).double() for t in parts]).cpu().numpy()
    n = tallies.Jin.numel()
    nmu = tallies.Jmu.numel()
    s = flat[2 * n + nmu:]
    return {'Jin': flat[:n], 'Jout': flat[n:2 * n],
            'Jmu': flat[2 * n:2 * n + nmu], 'nscatt_gas': s[0],
            'nscatt_events': s[1], 'W_oor': s[2], 'alive': int(s[3]),
            'launched': int(s[4])}


def compact_shrink(state: BatchState, B_new: int) -> BatchState:
    """The alive lanes first, truncated to B_new lanes (the caller knows
    that at most B_new are alive); stays on the device."""
    order = torch.argsort((state.phase == DEAD).to(torch.int8), stable=True)
    return state.select(order[:B_new])


def run(par: Params, *, seed: Optional[int] = None, device=None,
        progress: Optional[Callable[[int, int, int], None]] = None,
        max_chunks: int = 1_000_000) -> RunResult:
    """Run a Monte Carlo transport simulation on `device` ('cuda' when
    None; raises if CUDA is missing).

    progress : optional callback(launched, nphotons, alive)"""
    p = prepare(par, seed=seed, device=device)
    cfg, meta = p.cfg, p.meta
    par = cfg.par
    B = par.batch_size
    nphotons = p.budget
    acc = {'Jin': np.zeros(meta.nxfreq), 'Jout': np.zeros(meta.nxfreq),
           'Jabs': np.zeros(meta.nxfreq), 'nscatt_gas': 0.0,
           'nscatt_dust': 0.0, 'nscatt_events': 0.0, 'W_oor': 0.0}
    if par.save_Jmu:
        acc['Jmu'] = np.zeros(meta.nxfreq * par.nmu)

    t0 = time.time()
    cur_B, boost = B, 1
    for _ in range(max_chunks):
        h = chunk_to_host(*p.run_chunk(par.chunk_cycles * boost))
        for k in ('Jin', 'Jout', 'Jmu', 'nscatt_gas', 'nscatt_events',
                  'W_oor'):
            if k in acc:
                acc[k] += h[k]
        alive, launched = h['alive'], h['launched']
        if progress is not None:
            progress(launched, nphotons, alive)
        if launched >= nphotons and alive == 0:
            break
        if launched >= nphotons:
            # budget launched: lengthen chunks by the drain factor and
            # shrink the batch down the ladder
            boost = int(np.clip(B // max(alive, 1), 1, MAX_BOOST))
            for Bt in SHRINK_LADDER:
                if cur_B > Bt and alive <= Bt:
                    p.state = compact_shrink(p.state, Bt)
                    cur_B = Bt
    else:
        raise RuntimeError(f'batch did not drain in {max_chunks} chunks')
    return normalize(cfg, meta, acc, nphotons, exetime_s=time.time() - t0)

