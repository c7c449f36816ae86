"""Chunk loop of the persistent photon batch: refill -> fly -> scatter.

Counterpart of make_chunk / cycle (lart_tpu/transport/engine.py:2992,
:3054).  The JAX chunk is one jitted fori_loop; here the host loops over
the cycles and launches one kernel per step (K2 every refill_every-th
cycle, then the flight and K4), all on the current stream.  Nothing inside
the loop reads a value back, so the host runs ahead of the device; the
only synchronisation is the caller's read of (tallies, alive, launched)
once per chunk.

With save_peeloff the cycle also peels (kernel K7, instruments/peel.py):
right after a refill, the newborn photons to every observer (the direct
peel, engine.py:2909-2913; for a stellar_illumination source the stellar
direct peel, mode STELLAR, peel.py:700-836), and right after the scatter, each resonance
and dust scattering with its pre-scatter direction (:2207-2218, :2342-2347)
and, for line type 8, each conversion's H-alpha photon (:2205-2222), every
kind in one launch; both read the PeelRecord that K2 and K4 fill, and
deposit into the chunk's f32 cubes.

The flight follows lart_tpu's make_fly (engine.py:1057-1066): a clump
medium takes the dense clump flight K9 where the population has at most
clump_dense_max clumps, else the CSR clump walker K10; an AMR grid
takes the octree walk K8; force_generic_kernel the generic Cartesian walk
K5; otherwise the
uniform slab takes K3, the uniform sphere K6, and every other Cartesian
grid K5; line type 8, H2 pumping, the shearing box and the calcJ and
calcPnew maps always fly K5, as lart_tpu sends them off both fast paths
(engine.py:651-668, :854-868).  With calcJ, calcP or calcPnew on a grid
that bins them (nbin_JPa > 0: Cartesian grids; lart_tpu's AMR and clump
metas leave it 0, so there the flags run and write no map) the chunk's
tallies carry the J1, Pa and Pnew maps: K5 adds each segment's J1 and
Pnew, K4 each resonance scattering's Pa (transport/jpa.py).  With
save_all_photons the chunk holds the run's all-photons table
(transport/allph.py; make_chunk, engine.py:3029-3031): one table on the
device for the whole run, zeroed once, which every chunk's tallies carry
and K2, K4 and the flights write in place (birth and death rows); it keeps
the runs off both fast paths, as lart_tpu's does (engine.py:668, :868).
`check_supported` names whatever a config asks for that is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..instruments.peel import Peel, PeelRecord, peel
from ..physics.h2 import h2_on
from ..physics.line import LINE_TYPES
from .allph import AllPhotons, zero_allph
from .fly_amr import AmrFlight
from .fly_cartesian import CartesianFlight
from .fly_clump import ClumpFlight
from .fly_slab import SlabParams
from .fly_sphere import SphereFlight
from .jpa import JpaBins
from ..physics.sources import emiss_kind
from .refill import GEOMETRIES, SPECTRA, RefillParams, refill
from .scatter import ScatterParams, scatter
from .state import DEAD, BatchState, zero_tallies

# the ported source geometries: every one of gen_position's, and the
# illuminations (engine.py:2577-2719)
SOURCES = tuple(GEOMETRIES)


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
            and cfg.line.line_type != 8 and not h2_on(par)
            and not (par.calcJ or par.calcPnew)
            and not par.save_all_photons)


def uniform_sphere_fastpath(cfg, meta) -> bool:
    """True when the medium is one constant-opacity static sphere in vacuum
    (build_cartesian's detection; engine.py:854-868)."""
    par = cfg.par
    return (meta.grid_type == 'cartesian'
            and meta.static_medium and meta.uniform_temperature
            and meta.sphere_R > 0.0 and meta.sphere_rho > 0.0
            and meta.bc_x == 'escape' and meta.bc_y == 'escape'
            and meta.bc_z == 'escape'
            and not meta.atmosphere and meta.omega_shear == 0.0
            and cfg.line.line_type != 8 and not h2_on(par)
            and not (par.calcJ or par.calcPnew)
            and not par.save_all_photons)


def check_supported(cfg, meta=None) -> None:
    """Raise NotImplementedError naming every requested feature that
    lart_tpu_torch does not port yet."""
    par = cfg.par
    amr = par.use_amr_grid
    clump = par.use_clump_medium
    sg = par.source_geometry.strip().lower()
    st = par.spectral_type.strip().lower()
    emiss = emiss_kind(par) if sg == 'diffuse_emissivity' else None
    missing = [name for name, on in (
        ("amr_type 'ramses' (the RAMSES snapshot reader)",
         amr and par.amr_type.strip().lower() == 'ramses'),
        # lart_tpu's clump flights carry no H2 opacity (its scatter would
        # draw H2 events the flights never saw)
        ('H2 pumping on a clump medium', clump and h2_on(par)),
        (f'line_type {cfg.line.line_type} (only 1, 2 and 4-8)',
         cfg.line.line_type not in LINE_TYPES),
        # lart_tpu's AMR flight bins them with jpa_bin, which raises on
        # the AMR meta's geometry_JPa 0 (engine.py:603, :1604-1606)
        ('calcJ/calcPnew on an AMR grid', amr and (par.calcJ
                                                  or par.calcPnew)),
        ('checkpoint_file/resume_checkpoint',
         bool(par.checkpoint_file.strip()) or par.resume_checkpoint),
        ('out_merge', par.out_merge),
        ('save_input_grid', par.save_input_grid),
        # lart_tpu's AMR sightline has no interior branch: its rays would
        # be TAN rays of width 0 (ROADMAP queue 3)
        ('save_sightline_tau with an interior observer (nside > 0) on an '
         'AMR grid', par.save_sightline_tau and par.save_peeloff
         and par.nside > 0 and amr),
        (f'source_geometry {sg!r}', sg not in SOURCES),
        (f'spectral_type {st!r}', st not in SPECTRA),
        # lart_tpu would read the cube as a column of leaves or clumps
        # (sources.py:264-270)
        ('a 3-D FITS/HDF5 emiss_file on an AMR grid or a clump medium',
         emiss == 'grid' and (amr or clump)),
        # lart_tpu hands build_sources no rhokap there (driver.py:90-95)
        ("emiss_file 'density1'/'density2' on an AMR grid or a clump "
         'medium', emiss in ('density1', 'density2') and (amr or clump))
    ) if on]
    if meta is not None:
        missing += [name for name, on in (
            (f'grid_type {meta.grid_type!r}',
             meta.grid_type not in ('cartesian', 'amr', 'clump')),) if on]
    if missing:
        raise NotImplementedError('lart_tpu_torch does not port yet: '
                                  + '; '.join(missing))


def make_fly(cfg, meta, grid, cmeta=None) -> Callable:
    """The flight of lart_tpu's make_fly (engine.py:1057-1066), as a
    callable flight(state, tallies, max_steps): on a clump medium (grid a
    ClumpDevice, cmeta its ClumpMeta) K9 or K10, on an AMR grid (grid an
    AmrDevice) the octree walk K8."""
    if meta.grid_type == 'clump':
        return ClumpFlight.from_clumps(cfg, meta, cmeta, grid)
    if meta.grid_type == 'amr':
        return AmrFlight.from_amr(cfg, meta, grid)
    if not cfg.par.force_generic_kernel:
        if uniform_slab_fastpath(cfg, meta):
            return SlabParams.from_config(cfg, meta)
        if uniform_sphere_fastpath(cfg, meta):
            return SphereFlight.from_config(cfg, meta, grid)
    return CartesianFlight.from_config(cfg, meta, grid)


@dataclasses.dataclass(frozen=True)
class Chunk:
    """chunk(state, seed, cycle0, budget, n_cycles, fly_substeps,
    refill_on) runs n_cycles cycles from global cycle index cycle0, the
    flights taking at most fly_substeps crossings a cycle
    (self.fly_substeps by default), and returns (tallies, alive, launched)
    as device tensors; the state is advanced in place.  refill_on False
    leaves out the refills and their direct peels, which launch nothing
    once the budget is launched.  The cycle index is
    the Philox counter of the refill and scatter draws, so a run is
    reproducible from (seed, cycle index) whatever the device."""
    refill_params: RefillParams
    flight: Callable     # SlabParams, Sphere-, Cartesian-, Amr- or ClumpFlight
    scatter_params: ScatterParams
    n_cycles: int
    refill_every: int
    fly_substeps: int
    nxfreq: int
    nmu: int
    peel: Optional[Peel] = None     # the observers of save_peeloff
    lyb: bool = False               # line type 8: the H-alpha tallies
    h2: bool = False                # H2 pumping: its tallies
    atmosphere: bool = False        # an exoplanet atmosphere: Jabs2
    jpa: tuple = (0, 0, 0)          # the sizes of J1, Pa and Pnew
    allph: Optional[AllPhotons] = None   # save_all_photons: the run's table

    def zero_tallies(self, device):
        """The chunk's zero tallies: those of its line, H2, atmosphere,
        illumination and CALCJ/CALCP/CALCPnew maps."""
        return zero_tallies(self.nxfreq, self.nmu, device, self.lyb,
                            self.h2, self.atmosphere,
                            self.refill_params.illumination, self.jpa)

    def __call__(self, state: BatchState, seed: int, cycle0: int,
                 budget: int, n_cycles=None, fly_substeps=None,
                 refill_on: bool = True):
        tallies = self.zero_tallies(state.device)
        tallies.allph = self.allph
        steps = fly_substeps or self.fly_substeps
        p, rec = self.peel, None
        if p is not None:
            tallies.peel = p.zero_cubes(state.device)
            rec = PeelRecord.zeros(state.batch, state.device)
        for j in range(n_cycles or self.n_cycles):
            i = cycle0 + j
            if refill_on and j % self.refill_every == 0:
                refill(state, tallies, self.refill_params, seed, i, budget,
                       rec)
                if p is not None:
                    peel(state, tallies.peel, rec, p, p.direct_mode)
            self.flight(state, tallies, steps)
            scatter(state, tallies, self.scatter_params, seed, i, rec)
            if p is not None:
                peel(state, tallies.peel, rec, p, p.scatter_mode)
        alive = (state.phase != DEAD).sum()
        return tallies, alive, state.n_launched[0]


def make_chunk(cfg, meta, grid, cmeta=None, host_data=None) -> Chunk:
    """The chunk of a grid (on a clump medium grid is the ClumpDevice and
    cmeta its ClumpMeta); host_data holds what a table source is built
    from (physics/sources.py build_sources: the Cartesian grid's host
    'rhokap', the AMR grid's 'emissivity')."""
    check_supported(cfg, meta)
    par = cfg.par
    sphere = uniform_sphere_fastpath(cfg, meta)
    jpa = JpaBins.from_config(cfg, meta)
    flight = make_fly(cfg, meta, grid, cmeta)
    return Chunk(refill_params=RefillParams.from_config(cfg, meta, grid,
                                                        cmeta, host_data),
                 flight=flight,
                 scatter_params=ScatterParams.from_config(cfg, meta, grid,
                                                          sphere, cmeta),
                 n_cycles=par.chunk_cycles,
                 refill_every=max(1, par.refill_every),
                 fly_substeps=par.fly_substeps, nxfreq=meta.nxfreq,
                 nmu=par.nmu if par.save_Jmu else 0,
                 peel=Peel.from_config(cfg, meta, grid, sphere, cmeta),
                 lyb=cfg.line.line_type == 8, h2=h2_on(par),
                 atmosphere=bool(meta.atmosphere),
                 jpa=jpa.sizes(meta.nxfreq) if jpa else (0, 0, 0),
                 allph=zero_allph(int(par.nphotons), bool(par.use_stokes),
                                  par.rmax, flight.rhokap.device)
                 if par.save_all_photons else None)
