"""Top-level simulation driver of the port.

Counterpart of prepare / run (lart_tpu/driver.py:50-377): resolve the
config, build the grid (Cartesian, the AMR octree from par.amr_file or
from a leaf list passed in memory, or the clump population with its CSR
grid, from the seed (seed or iseed) + 77 as lart_tpu's, written to
<out>_clumps.h5 with save_clump_info), then loop chunks of refill/fly/scatter
cycles on one device, adding each chunk's f32 tallies into f64
accumulators on the host (an atmosphere's Jabs2, an illumination's flux
factor and rejected draws, and the CALCJ/CALCP/CALCPnew maps J1, Pa and
Pnew among them; driver.py:176-181), and normalize.  One host read per chunk: the
tallies and the loop-control scalars travel back together.  The peel-off
cubes (up to millions of bins) stay on the device: each chunk's f32 cubes
are added into f64 accumulators there, as lart_tpu adds them on the host
(driver.py:182-195, :324-335; a stellar source's Direct0 with
save_direc0 too), and the host reads them once at the end.  So does the
all-photons table of save_all_photons (transport/allph.py): one table on
the device for the whole run, written in place by the kernels, copied to
the host once at the end where lart_tpu adds each chunk's table
(driver.py:169-170, :306-313).
With save_sightline_tau and observers, the sight-line maps of every
observer (instruments/sightline.py, kernel K11) are computed after the
transport on the same device (driver.py:370-376) and ride in the result.

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
In the drain the flights also take up to MAX_STEP_BOOST times
fly_substeps crossings a cycle, by the batch's lanes over the alive ones:
a lane left alone that flies far (a far-wing photon streaming nearly
along x through a shearing box's periodic x and y, ~1 / |kz| crossings)
then needs as many fewer cycles, each of which costs its launches
however few lanes fly (shear.in as written drained for 276 s on an H100
with fly_substeps a cycle: PERF.md, PR 14).  lart_tpu keeps fly_substeps;
a flight that stops at the step limit resumes the next cycle, so only
the cycle indices of the tail's draws change, not their law.  Once the
budget is launched the chunks run without their refills (and the direct
peels after them), which would launch nothing: the same results, a
launch fewer every refill_every cycles of the tail.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from .config import Params
from .grid.amr import build_amr
from .grid.cartesian import build_cartesian
from .grid.clump import build_clumps, save_clumps
from .instruments.sightline import make_maps
from .tally import RunResult, normalize
from .transport.engine import check_supported, make_chunk
from .transport.state import (DEAD, H2_SCALARS, ILLUM_SCALARS,
                              JPA_TALLIES, LYB_SCALARS, BatchState, Tallies,
                              init_state)
from .utils.device import resolve_device

SHRINK_LADDER = (4096, 512)
MAX_BOOST = 8
MAX_STEP_BOOST = 64


class Prepared:
    """Everything run() builds before the chunk loop, exposed so a
    benchmark drives the production path without repeating the set-up."""

    __slots__ = ('cfg', 'meta', 'grid', 'cmeta', 'device', 'budget', 'seed',
                 'state', 'chunk', 'cycle')

    def run_chunk(self, n_cycles: Optional[int] = None,
                  fly_substeps: Optional[int] = None,
                  refill_on: bool = True):
        """Advance the batch by one chunk (its flights fly_substeps
        crossings a cycle, the config's by default; without refills where
        refill_on is False); returns device tensors (tallies, alive,
        launched)."""
        n = n_cycles or self.chunk.n_cycles
        out = self.chunk(self.state, self.seed, self.cycle, self.budget, n,
                         fly_substeps, refill_on)
        self.cycle += n
        return out


def prepare(par: Params, *, seed: Optional[int] = None, device=None,
            amr_data: Optional[dict] = None,
            clump_seed: Optional[int] = None) -> Prepared:
    """Resolve, build the grid (the octree with use_amr_grid: from
    par.amr_file, or from the leaf dict amr_data, grid.amr.build_amr's
    data; the clumps with use_clump_medium, from clump_seed, else from
    (seed or iseed) + 77), the chunk and an empty batch on `device`."""
    cfg = par.resolve()
    check_supported(cfg)
    dev = resolve_device(device)
    cmeta = None
    # what a table source is built from (lart_tpu's host_data,
    # driver.py:83-97): the Cartesian grid's host rhokap, the AMR grid's
    # emissivity column; nothing on a clump medium
    host_data = {}
    if cfg.par.use_clump_medium:
        if clump_seed is None:
            clump_seed = (seed or cfg.par.iseed) + 77
        meta, cmeta, grid = build_clumps(cfg, seed=clump_seed, device=dev)
        if cfg.par.save_clump_info:
            _save_clump_info(cfg, grid, cmeta)
    elif cfg.par.use_amr_grid:
        # build_amr sets rmax and the box on cfg.par (driver.py:78-81)
        built = build_amr(cfg, data=amr_data, device=dev)
        meta, grid = built.meta, built.dev
        if built.emissivity is not None:
            host_data['emissivity'] = built.emissivity
    else:
        meta, grid = build_cartesian(cfg, device=dev, host_out=host_data)
    p = Prepared()
    p.cfg, p.meta, p.grid, p.cmeta, p.device = cfg, meta, grid, cmeta, dev
    p.chunk = make_chunk(cfg, meta, grid, cmeta, host_data)
    p.budget = int(cfg.par.nphotons)
    p.seed = int(seed if seed is not None else cfg.par.iseed)
    p.state = init_state(cfg.par.batch_size, dev)
    p.cycle = 0
    return p


def _save_clump_info(cfg, grid, cmeta) -> None:
    """write_clumps_info as lart_tpu's driver writes it (driver.py:60-77):
    the population beside the output file, velocities in km/s."""
    import os
    from .config import vtherm_total
    from .io.writer import output_filename
    par = cfg.par
    base, _ = os.path.splitext(output_filename(par))

    def host(*ts):
        return np.stack([t.cpu().numpy() for t in ts], axis=1)
    T_cl = par.clump_temperature if par.clump_temperature > 0 \
        else par.temperature
    save_clumps(base + '_clumps.h5', host(grid.x, grid.y, grid.z),
                grid.radius.cpu().numpy(), rhokap=grid.rhokap.cpu().numpy(),
                vel=host(grid.vx, grid.vy, grid.vz)
                * vtherm_total(par, cfg.line, T_cl),
                sphere_R=par.rmax, rmin=max(par.rmin, 0.0),
                attrs={'F_VOL': cmeta.f_vol, 'F_COV': cmeta.f_cov})


# the optional tallies (line type 8, H2, an atmosphere, an illumination,
# the CALCJ/CALCP/CALCPnew maps) in the order chunk_to_host reads
EXTRA_TALLIES = ('Jout_Ha', 'Jabs_Ha') + LYB_SCALARS + H2_SCALARS \
    + ('W_H2pump', 'Jabs2') + ILLUM_SCALARS + JPA_TALLIES


def chunk_to_host(tallies: Tallies, alive, launched) -> dict:
    """One device->host copy of a chunk's tallies and control scalars
    (the optional ones of line type 8, H2, an atmosphere, an illumination
    and the J1, Pa and Pnew maps where the chunk has them)."""
    extra = [(k, getattr(tallies, k)) for k in EXTRA_TALLIES
             if getattr(tallies, k) is not None]
    parts = [tallies.Jin, tallies.Jout, tallies.Jabs, tallies.Jmu,
             torch.stack([tallies.nscatt_gas, tallies.nscatt_events,
                          tallies.W_oor, tallies.nscatt_dust]),
             torch.stack([alive, launched])] + [t for _, t in extra]
    flat = torch.cat([t.reshape(-1).double() for t in parts]).cpu().numpy()
    n = tallies.Jin.numel()
    nmu = tallies.Jmu.numel()
    s = flat[3 * n + nmu:]
    out = {'Jin': flat[:n], 'Jout': flat[n:2 * n],
           'Jabs': flat[2 * n:3 * n], 'Jmu': flat[3 * n:3 * n + nmu],
           'nscatt_gas': s[0], 'nscatt_events': s[1], 'W_oor': s[2],
           'nscatt_dust': s[3], 'alive': int(s[4]), 'launched': int(s[5])}
    at = 6
    for k, t in extra:
        m = t.numel()
        out[k] = s[at] if t.dim() == 0 else s[at:at + m]
        at += m
    return out


def compact_shrink(state: BatchState, B_new: int) -> BatchState:
    """The alive lanes first, truncated to B_new lanes (the caller knows
    that at most B_new are alive); stays on the device."""
    order = torch.argsort((state.phase == DEAD).to(torch.int8), stable=True)
    return state.select(order[:B_new])


def run(par: Params, *, seed: Optional[int] = None, device=None,
        progress: Optional[Callable[[int, int, int], None]] = None,
        max_chunks: int = 1_000_000,
        amr_data: Optional[dict] = None,
        clump_seed: Optional[int] = None) -> RunResult:
    """Run a Monte Carlo transport simulation on `device` ('cuda' when
    None; raises if CUDA is missing).

    progress : optional callback(launched, nphotons, alive)
    amr_data : with use_amr_grid, the leaf list in memory in place of
        par.amr_file (build_amr's data: x, y, z, level, nH, T, ...)
    clump_seed : with use_clump_medium, the population's seed in place of
        (seed or iseed) + 77"""
    p = prepare(par, seed=seed, device=device, amr_data=amr_data,
                clump_seed=clump_seed)
    cfg, meta = p.cfg, p.meta
    par = cfg.par
    B = par.batch_size
    nphotons = p.budget
    acc = {'Jin': np.zeros(meta.nxfreq), 'Jout': np.zeros(meta.nxfreq),
           'Jabs': np.zeros(meta.nxfreq), 'nscatt_gas': 0.0,
           'nscatt_dust': 0.0, 'nscatt_events': 0.0, 'W_oor': 0.0}
    if par.save_Jmu:
        acc['Jmu'] = np.zeros(meta.nxfreq * par.nmu)
    # line type 8's, H2's, an atmosphere's and an illumination's tallies,
    # and the J1, Pa and Pnew maps (driver.py:163-181, :295-317)
    extra = {k: v for k, v in p.chunk.zero_tallies('cpu').__dict__.items()
             if k in EXTRA_TALLIES and v is not None}
    for k, v in extra.items():
        acc[k] = np.zeros(v.numel()) if v.dim() else 0.0
    peel = p.chunk.peel
    peel_acc = {} if peel is None else {
        'peel_' + k: torch.zeros_like(v, dtype=torch.float64)
        for k, v in peel.zero_cubes(p.device).items()}

    t0 = time.time()
    cur_B, boost, steps, launched = B, 1, par.fly_substeps, 0
    for _ in range(max_chunks):
        # once the budget is launched a refill launches nothing: the drain
        # leaves out its launches (host time, most of a tail's cycle)
        out = p.run_chunk(par.chunk_cycles * boost, steps,
                          launched < nphotons)
        if peel is not None:
            for k, cube in out[0].peel.items():
                peel_acc['peel_' + k] += cube
        h = chunk_to_host(*out)
        for k in ('Jin', 'Jout', 'Jabs', 'Jmu', 'nscatt_gas',
                  'nscatt_dust', 'nscatt_events', 'W_oor', *extra):
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
            steps = par.fly_substeps * int(np.clip(cur_B // max(alive, 1),
                                                   1, MAX_STEP_BOOST))
    else:
        raise RuntimeError(f'batch did not drain in {max_chunks} chunks')
    acc.update({k: v.cpu().numpy() for k, v in peel_acc.items()})
    if p.chunk.allph is not None:
        acc['allph'] = p.chunk.allph.to_host()
    res = normalize(cfg, meta, acc, nphotons, exetime_s=time.time() - t0,
                    obs_meta=None if peel is None else peel.obs_meta)
    if par.save_sightline_tau and peel is not None:
        res.sightline = make_maps(cfg, meta, p.grid, p.cmeta)
    return res

