"""Chunk loop of the persistent photon batch: refill -> fly -> scatter.

Counterpart of make_chunk / cycle (lart_tpu/transport/engine.py:2992,
:3054).  The JAX chunk is one jitted fori_loop; here the host loops over
the cycles and launches one kernel per step (K2 every refill_every-th
cycle, then K3 and K4), all on the current stream.  Nothing inside the
loop reads a value back, so the host runs ahead of the device; the only
synchronisation is the caller's read of (tallies, alive, launched) once
per chunk.

Only the Neufeld-slab path is ported: uniform_slab_fastpath must hold and
`check_supported` names whatever else a config asks for.
"""

from __future__ import annotations

import dataclasses

from .fly_slab import SlabParams, fly
from .refill import RefillParams, refill
from .scatter import ScatterParams, scatter
from .state import DEAD, BatchState, zero_tallies


def uniform_slab_fastpath(cfg, meta) -> bool:
    """True when the medium is one constant-opacity static slab, periodic
    in x and y and escaping on z (engine.py:651-668)."""
    par = cfg.par
    return (meta.grid_type == 'cartesian'
            and meta.static_medium and meta.uniform_temperature
            and meta.rho_uniform > 0.0
            and meta.nx == 1 and meta.ny == 1
            and meta.bc_x == 'periodic' and meta.bc_y == 'periodic'
            and meta.bc_z == 'escape'
            and not meta.has_dust and not meta.atmosphere
            and meta.omega_shear == 0.0
            and cfg.line.line_type != 8
            and par.h2_model.strip().lower() in ('', 'none')
            and not (par.calcJ or par.calcPnew)
            and not par.save_all_photons)


def check_supported(cfg, meta=None) -> None:
    """Raise NotImplementedError naming every requested feature that
    lart_tpu_torch does not port yet."""
    par = cfg.par
    missing = [name for name, on in (
        ('use_amr_grid (AMR backend)', par.use_amr_grid),
        ('use_clump_medium (clump backend)', par.use_clump_medium),
        ('force_generic_kernel (generic DDA flight)',
         par.force_generic_kernel),
        (f'line_type {cfg.line.line_type} (only 1)', cfg.line.line_type != 1),
        ('dust (DGR > 0)', par.DGR > 0.0),
        ('h2_model', par.h2_model.strip().lower() not in ('', 'none')),
        ('peel-off observers', par.save_peeloff or par.nobs > 0),
        ('use_stokes', par.use_stokes),
        ('calcJ/calcP/calcPnew', par.calcJ or par.calcP or par.calcPnew),
        ('save_all_photons', par.save_all_photons),
        ('checkpoint_file/resume_checkpoint',
         bool(par.checkpoint_file.strip()) or par.resume_checkpoint),
        ('n_devices > 1', par.n_devices > 1),
        ('core_skip', par.core_skip), ('recoil', par.recoil),
        ('out_merge', par.out_merge),
        ('save_input_grid', par.save_input_grid),
        ('save_sightline_tau', par.save_sightline_tau),
        ('metrics_file', bool(par.metrics_file.strip())),
        ('profile_dir', bool(par.profile_dir.strip())),
        ('source_geometry other than point',
         par.source_geometry.strip().lower() not in ('point', '')),
        ('spectral_type other than voigt/monochromatic',
         par.spectral_type.strip().lower() not in ('voigt',
                                                   'monochromatic'))) if on]
    if meta is not None and not missing and \
            not uniform_slab_fastpath(cfg, meta):
        missing.append('a medium other than the uniform static xy-periodic '
                       'slab (generic DDA / sphere flights)')
    if missing:
        raise NotImplementedError('lart_tpu_torch does not port yet: '
                                  + '; '.join(missing))


@dataclasses.dataclass(frozen=True)
class Chunk:
    """chunk(state, seed, cycle0, budget, n_cycles) runs n_cycles cycles
    from global cycle index cycle0 and returns (tallies, alive, launched)
    as device tensors; the state is advanced in place.  The cycle index is
    the Philox counter of the refill and scatter draws, so a run is
    reproducible from (seed, cycle index) whatever the device."""
    refill_params: RefillParams
    slab_params: SlabParams
    scatter_params: ScatterParams
    n_cycles: int
    refill_every: int
    fly_substeps: int
    nxfreq: int
    nmu: int

    def __call__(self, state: BatchState, seed: int, cycle0: int,
                 budget: int, n_cycles=None):
        tallies = zero_tallies(self.nxfreq, self.nmu, state.device)
        for j in range(n_cycles or self.n_cycles):
            i = cycle0 + j
            if j % self.refill_every == 0:
                refill(state, tallies, self.refill_params, seed, i, budget)
            fly(state, tallies, self.slab_params, self.fly_substeps)
            scatter(state, tallies, self.scatter_params, seed, i)
        alive = (state.phase != DEAD).sum()
        return tallies, alive, state.n_launched[0]


def make_chunk(cfg, meta) -> Chunk:
    check_supported(cfg, meta)
    par = cfg.par
    return Chunk(refill_params=RefillParams.from_config(cfg, meta),
                 slab_params=SlabParams.from_config(cfg, meta),
                 scatter_params=ScatterParams.from_config(cfg, meta),
                 n_cycles=par.chunk_cycles,
                 refill_every=max(1, par.refill_every),
                 fly_substeps=par.fly_substeps, nxfreq=meta.nxfreq,
                 nmu=par.nmu if par.save_Jmu else 0)
