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

Inside a process group of W ranks (parallel/distributed.py; one process a
rank, spawned by parallel/launch.run_ranks or started with the LART_*
variables) each rank runs this loop on its own device, as lart_tpu runs
its chunk on each device of its mesh (driver.py:99-118, :218-269): its
share of the photon budget (shard_budget), its first photon id
(RefillParams.pid_base) and its own Philox key (parallel/mesh.py).  Each
chunk's flat tally buffer is all-reduced (parallel/reduce.py, PERF.md row
20), so every rank sees the same tallies, alive and launched counts and
takes the same decisions: the boost scales as (B * W) // alive, the drain
shrinks once alive <= Bt * W, dealing the survivors of every rank
round-robin over the ranks (reduce.shrink, lart_tpu's _compact_shrink).
The peel cubes and the all-photons table are summed onto rank 0 at the
end; rank 0 alone reports progress, writes save_clump_info, the
metrics_file rows and the sight-line maps, and returns the result.
metrics_file gets one JSONL row a chunk (driver.py:337-352);
profile_dir one torch.profiler trace a rank of the first profile_chunks
chunks, where lart_tpu takes jax.profiler's (driver.py:212-215, :362-363).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .config import Params
from .grid.amr import build_amr
from .grid.cartesian import build_cartesian
from .grid.clump import build_clumps, save_clumps
from .instruments.sightline import make_maps
from .parallel import distributed
from .parallel.mesh import pid_bases, rank_seeds, shard_budget
from .parallel.reduce import all_reduce_chunk, reduce_to_root, shrink
from .tally import RunResult, normalize
from .transport.engine import check_supported, make_chunk
from .transport.state import (H2_SCALARS, ILLUM_SCALARS, JPA_TALLIES,
                              LYB_SCALARS, Tallies, init_state)
from .utils.device import resolve_device

SHRINK_LADDER = (4096, 512)
MAX_BOOST = 8
MAX_STEP_BOOST = 64


class Prepared:
    """Everything run() builds before the chunk loop, exposed so a
    benchmark drives the production path without repeating the set-up."""

    __slots__ = ('cfg', 'meta', 'grid', 'cmeta', 'device', 'budget', 'seed',
                 'state', 'chunk', 'cycle', 'rank', 'world')

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
    (seed or iseed) + 77), the chunk and an empty batch on `device`.  In a
    process group of W ranks the batch is this rank's, with its share of
    the budget, its first photon id and its own seed (every rank builds
    the same grid and clump population); n_devices must be 0 or W."""
    cfg = par.resolve()
    check_supported(cfg)
    world, rank = distributed.process_count(), distributed.process_index()
    if cfg.par.n_devices not in (0, world):
        raise ValueError(
            f'n_devices {cfg.par.n_devices} in a run of {world} rank(s): '
            'several ranks run through the CLI, parallel.launch.run_ranks '
            'or one process a rank with the LART_* variables')
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
        if cfg.par.save_clump_info and rank == 0:
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
    budgets = shard_budget(cfg.par.nphotons, world)
    if world > 1:
        rp = dataclasses.replace(p.chunk.refill_params,
                                 pid_base=int(pid_bases(budgets)[rank]))
        p.chunk = dataclasses.replace(p.chunk, refill_params=rp)
    p.rank, p.world = rank, world
    p.budget = int(budgets[rank])
    p.seed = rank_seeds(int(seed if seed is not None else cfg.par.iseed),
                        world)[rank]
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


def chunk_flat(tallies: Tallies, alive, launched) -> torch.Tensor:
    """A chunk's tallies and control scalars as one flat f64 device
    buffer, in the order chunk_to_host reads (the optional ones of line
    type 8, H2, an atmosphere, an illumination and the J1, Pa and Pnew
    maps where the chunk has them)."""
    parts = [tallies.Jin, tallies.Jout, tallies.Jabs, tallies.Jmu,
             torch.stack([tallies.nscatt_gas, tallies.nscatt_events,
                          tallies.W_oor, tallies.nscatt_dust]),
             torch.stack([alive, launched])]
    parts += [getattr(tallies, k) for k in EXTRA_TALLIES
              if getattr(tallies, k) is not None]
    return torch.cat([t.reshape(-1).double() for t in parts])


def chunk_to_host(tallies: Tallies, alive, launched,
                  reduce: bool = True) -> dict:
    """One device->host copy of a chunk's chunk_flat buffer, summed over
    the ranks of a process group unless reduce is False, as a dict."""
    flat = chunk_flat(tallies, alive, launched)
    flat = all_reduce_chunk(flat) if reduce else flat.cpu().numpy()
    n = tallies.Jin.numel()
    nmu = tallies.Jmu.numel()
    s = flat[3 * n + nmu:]
    out = {'Jin': flat[:n], 'Jout': flat[n:2 * n],
           'Jabs': flat[2 * n:3 * n], 'Jmu': flat[3 * n:3 * n + nmu],
           'nscatt_gas': s[0], 'nscatt_events': s[1], 'W_oor': s[2],
           'nscatt_dust': s[3], 'alive': int(s[4]), 'launched': int(s[5])}
    at = 6
    for k in EXTRA_TALLIES:
        t = getattr(tallies, k)
        if t is None:
            continue
        m = t.numel()
        out[k] = s[at] if t.dim() == 0 else s[at:at + m]
        at += m
    return out


class PrintProgress:
    """A progress callback that prints launched photons and alive lanes at
    most every `every_s` seconds (picklable, for the ranks of run_ranks)."""

    def __init__(self, every_s: float = 10.0):
        self.every_s, self.last = every_s, time.time()

    def __call__(self, launched: int, nphotons: int, alive: int) -> None:
        now = time.time()
        if now - self.last > self.every_s:
            print(f"{launched:.5e} photons launched, {alive} lanes alive",
                  flush=True)
            self.last = now


def run(par: Params, *, seed: Optional[int] = None, device=None,
        progress: Optional[Callable[[int, int, int], None]] = None,
        max_chunks: int = 1_000_000,
        amr_data: Optional[dict] = None,
        clump_seed: Optional[int] = None) -> Optional[RunResult]:
    """Run a Monte Carlo transport simulation on `device` ('cuda' when
    None; raises if CUDA is missing).  In a process group the run is the
    group's: each rank calls this on its own device, and rank 0 gets the
    result, the others None.

    progress : optional callback(launched, nphotons, alive), on rank 0
    amr_data : with use_amr_grid, the leaf list in memory in place of
        par.amr_file (build_amr's data: x, y, z, level, nH, T, ...)
    clump_seed : with use_clump_medium, the population's seed in place of
        (seed or iseed) + 77"""
    p = prepare(par, seed=seed, device=device, amr_data=amr_data,
                clump_seed=clump_seed)
    cfg, meta = p.cfg, p.meta
    par = cfg.par
    B, world, root = par.batch_size, p.world, p.rank == 0
    nphotons = int(par.nphotons)
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

    metrics = open(par.metrics_file, 'a') \
        if par.metrics_file.strip() and root else None
    prof = _start_profile(p.device) if par.profile_dir.strip() else None
    t0 = time.time()
    cur_B, boost, steps, launched = B, 1, par.fly_substeps, 0
    try:
        for ci in range(max_chunks):
            t_chunk = time.time()
            # once the budget is launched a refill launches nothing: the
            # drain leaves out its launches (host time, most of a tail's
            # cycle)
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
            if prof is not None and ci + 1 >= max(par.profile_chunks, 1):
                _stop_profile(prof, par.profile_dir, p.rank)
                prof = None
            if metrics is not None:
                # one row a chunk with the north-star rate (driver.py:
                # 337-352)
                dt = time.time() - t_chunk
                metrics.write(json.dumps({
                    'chunk': ci, 'wall_s': dt,
                    'nscatt_gas': float(h['nscatt_gas']),
                    'scatt_per_s': float(h['nscatt_gas']) / max(dt, 1e-12),
                    'alive': alive, 'launched': launched,
                    'batch': cur_B * world}) + '\n')
                metrics.flush()
            if progress is not None and root:
                progress(launched, nphotons, alive)
            if launched >= nphotons and alive == 0:
                break
            if launched >= nphotons:
                # budget launched: lengthen chunks by the drain factor and
                # shrink the batch down the ladder
                boost = int(np.clip(B * world // max(alive, 1), 1,
                                    MAX_BOOST))
                for Bt in SHRINK_LADDER:
                    if cur_B > Bt and alive <= Bt * world:
                        p.state = shrink(p.state, Bt)
                        cur_B = Bt
                steps = par.fly_substeps * int(np.clip(
                    cur_B * world // max(alive, 1), 1, MAX_STEP_BOOST))
        else:
            raise RuntimeError(f'batch did not drain in {max_chunks} chunks')
    finally:
        if metrics is not None:
            metrics.close()
        if prof is not None:
            _stop_profile(prof, par.profile_dir, p.rank)
    # the peel cubes and the table, summed onto rank 0
    sums = reduce_to_root(list(peel_acc.values())
                          + ([p.chunk.allph.table]
                             if p.chunk.allph is not None else []))
    acc.update({k: v.numpy() for k, v in zip(peel_acc, sums)})
    if p.chunk.allph is not None:
        acc['allph'] = dict(zip(p.chunk.allph.fields,
                                sums[-1].numpy().astype(np.float64)))
    if not root:
        return None
    res = normalize(cfg, meta, acc, nphotons, exetime_s=time.time() - t0,
                    obs_meta=None if peel is None else peel.obs_meta)
    res.nprocs = world
    if par.save_sightline_tau and peel is not None:
        res.sightline = make_maps(cfg, meta, p.grid, p.cmeta)
    return res


def _start_profile(device):
    """A started torch.profiler over the host and, on a GPU, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, rank: int) -> None:
    """Stop the profiler and write its trace as <profile_dir>/
    trace_rank<rank>.json (Chrome trace format)."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f'trace_rank{rank}.json'))
