"""Peeling-off to external observers (kernel K7), with and without Stokes.

Counterpart of make_peel's peel_direct, peel_resonance and peel_dust
(lart_tpu/instruments/peel.py:62, :446-654) with their sightline optical
depth: the lockstep DDA tau_to_edge_cart (:176-356) on a Cartesian grid,
or the chord through the uniform sphere (:367-382) where the sphere fast
path applies; the opacity of a cell is rhokap times the line's profile
(physics/line.py) plus the dust's rhokapD (:232-233).  lart_tpu's chord
evaluates the profile with Python floats, so its offsets and damping
parameters are f64 quotients rounded once (line_prof_f64), where the walk's
are f32 quotients.  At a photon's birth (direct) and at each resonance or
dust scattering, every observer receives the lane's weight times the
escape probability exp(-tau) along the sightline from the event to the
grid's edge, over 4 pi r^2, times (at a scattering) the phase function
toward the observer (the dipole phase of the event's E1, E2, E3, per
event for line types 2, 4, 5 and 6); the deposit goes into (nobs, nxfreq,
nxim, nyim) spectral image cubes at the TAN pixel of the sightline and the
lab-frequency bin of the peeled frequency.  With use_stokes a scattering
also deposits the detector-frame Stokes I, Q, U, V from the lane's Stokes
vector and reference triad (peeling_resonance_stokes_outside).  A dust
scattering peels at the lane's own (comoving) frequency with the
Henyey-Greenstein phase (1 - g^2) / (1 + g^2 - 2 g cos)^1.5 / 4 pi, or with
use_stokes through the Mueller table: S11..S34 at the angle to the
observer, the Stokes vector into the scattering plane and then into the
detector frame (peeling_dust_[no]stokes_outside, :577-654).  With recoil
a resonance peels at xfreq - (g_recoil0 / D)(1 - cos theta) (:513-514):
lart_tpu takes the hydrogen constant g_recoil0 for every event, a
deuterium scattering of line type 7 too, and so does the port.

The lanes come from a PeelRecord that the cycle's kernels fill right
before: K2 refill flags the lanes it launched (the direct peel reads their
newborn state), and K4 scatter marks each lane's event, EVENT_RESONANCE or
EVENT_DUST, and keeps its pre-scatter direction, triad and Stokes vector
with, at a resonance, the event's atom velocity and xfreq_atom (the peel
reads those and the lane's unchanged position, cell, frequency and its
weight).  Modes RESONANCE and DUST peel the events of their kind; K7 takes
both kinds in one launch, mode SCATTERED = RESONANCE | DUST, each pair by
its lane's kind.  The walk follows the transport's boundary ops (escape,
periodic, reflect) and, in a moving medium or at non-uniform temperature,
its comoving frequency updates ((x + u1) D1) / D2 - u2; at non-uniform
temperature a cell's opacity takes its own damping and Doppler width, and
the event's bin and recoil the event cell's D (peel.py:225-226, :336-340,
:434-436, :486); it stops after 2 (nx + ny + nz) + 8 crossings or where
tau reaches TAU_STOP = 110, beyond which exp(-tau) is 0 in f32 and no
deposit changes (lart_tpu walks on to 745.2, so a pair's tau is then >=
110, not the whole sightline's).  The walk draws no random numbers.

With H2 pumping the sightline's opacity adds rhokap times the H2
multiplier (:229-231).  For line type 8 (Ly-beta) the record marks a
scattering that converts to H-alpha EVENT_CONVERSION: instead of the
resonance, the peel casts the newborn H-alpha photon (peel_conversion_Ha,
:656-694), emitted at the atom's line centre, so its frequency toward the
observer is the atom velocity's projection alone, with no recoil, the
dipole phase of the conversion channel's E1, E2, and the dust-only
sightline of the H-alpha band (rhokapD R_Ha, :234-241; none without dust,
where the walk is skipped); it deposits into the Ha cube.  A dust event of
a lane in the H-alpha band peels with hgg_Ha along that dust-only
sightline at its own frequency, already a lab one (freq_bin, :430-441),
into the Ha cube (:577-651); its band is the lane's, which a dust event
keeps.  With line type 8, lart_tpu's g is a per-lane f32 array, so both
bands' Henyey-Greenstein constants are f32 operations on the f32 g, where
without it they are f64 ones rounded once.

On the octree AMR grid the sightline walks node by node as the flight
K8 does (peel.py:242-290: the exit face, the neighbor hop, the descent),
with each leaf's opacity and, at non-uniform temperature, its damping and
Doppler width, which also set the event's lab-frequency bin and recoil.
On a clump medium (peel.py:86-170, :358-363) the sightline walks the CSR
grid cell by cell, at most 3 cg_n + 8 cells: a cell's optical depth is the
sum of its candidates' chord overlaps, clipped to the cell segment plus
1e-6 R, each clump at its local frequency of the peel's frequency (its
velocity over r_loc); the event's bin and recoil take the clumps' Doppler
width D_cl and the event clump's velocity.  lart_tpu hands the sightline a
resonance's frequency in the owner's units and treats it as global; the
port follows.  A dust event on clumps peels at the frequency K4's record
keeps in xatom, the lane's in the owner's units.

An interior all-sky observer (nside > 0; peel.py:394-415) bins a pair at
the HEALPix RING pixel (healpix.vec2pix_ring) of its arrival direction -pk,
drops a pair within r^2 <= 1e-12 of the observer, and caps the sightline
at the distance r to the observer (the raytrace_to_dist contract): the DDA
and AMR walks end with a partial step at the cap, the chord is cut there.
The flat bin is (o nxfreq + ixf) npix + ipix, as the TAN one with nxim =
npix, nyim = 1.  Clumps, Stokes and line type 8 with an interior observer
are vetoed (config.py:494-503).

In a spherical atmosphere (peel.py:326-333) the Cartesian sightline that
enters a masked core cell is opaque: its optical depth becomes 2 x 745.2
and the walk ends (the crossing is taken even where an interior
observer's cap ends the step, as lart_tpu takes it).

A stellar_illumination source peels its newborn photons in mode STELLAR
(peel_direct_stellar, peel.py:700-836; the reference's
peeling_direct_stellar_illumination1, stellar_illumination.f90:953-1164)
in place of DIRECT: each (observer, lane) pair builds the point of the
stellar disk facing the observer from the lane's one limb-darkened
surface sample (cos theta, vphi) that K2 wrote into the record, takes the
TAN pixel of the star-point to observer ray, and, where that ray crosses
the atmosphere sphere (lart_tpu's corrected test r.k < 0 and det >= 0),
walks it from its entry point (the entry cell clip(floor) on a Cartesian
grid, amr_find_cell on the AMR grid, 0 on clumps) at the newborn's lab
frequency shifted into the entry cell's comoving frame; it deposits 1 /
d_so^2 exp(-min(tau, 700)) into Direct (and I with Stokes), and the
unattenuated 1 / d_so^2 into Direct0 with save_direc0, at the lab
frequency bin of the newborn.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..kernels import build as kbuild
from ..physics import line as pline
from ..physics import mueller as pmueller
from ..transport.flight import (BIG, FlightConsts, capped_step, chord_det,
                                comoving, div, doppler_ratio, f32, fma)
from ..transport.fly_amr import AmrFlight, exit_face, hop
from ..transport.fly_clump import ClumpFlight
from ..transport.fly_cartesian import _cross_axis, _face_dist
from ..transport.fly_sphere import sphere_chord
from ..transport.scatter import (DUST_OFF, EVENT_CONVERSION, EVENT_DUST,
                                 EVENT_RESONANCE, dust_mode)
from .healpix import vec2pix_ring
from .observer import build_observers

RAD2DEG = 180.0 / math.pi
TWOPI = 2.0 * math.pi
FOURPI = 4.0 * math.pi
TAU_HUGE = 745.2
# a sightline ends once tau >= TAU_STOP: exp(-110) underflows f32 to 0, so
# no deposit of the pair can be nonzero; its tau is then >= 110 (lart_tpu
# walks on to 745.2)
TAU_STOP = 110.0
# modes; a scatter mode peels the lanes whose record flag, K4's kind of
# event, it has a bit of; STELLAR peels a stellar source's newborns
DIRECT, RESONANCE, DUST, CONVERSION = (0, EVENT_RESONANCE, EVENT_DUST,
                                       EVENT_CONVERSION)
SCATTERED = RESONANCE | DUST | CONVERSION
STELLAR = 8

# order of the record's pointer table (csrc/lart.cuh unpack_record)
PEEL_RECORD_FIELDS = ('flag', 'kx', 'ky', 'kz', 'mx', 'my', 'mz', 'nnx',
                      'nny', 'nnz', 'Q', 'U', 'V', 'xatom', 'ux', 'uy',
                      'uz', 'E1', 'E2', 'E3', 'limb_cost', 'limb_vphi')
CUBE_FIELDS = ('scatt', 'direc', 'I', 'Q', 'U', 'V', 'Ha', 'direc0')
# the fewest full warps a streaming multiprocessor that K7 packs its pairs
# into (where under half the lanes are peeled) must get: fewer leave the
# walks' gathers' latency unhidden
PACK_WARPS_PER_SM = 2
# K7's first pass (csrc/peel.cu peel_select_kernel) runs for a mode where
# the count it last sampled would pack the walk, and on every
# SAMPLE_EVERY-th call of the mode to sample the count
SAMPLE_EVERY = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(eq=False)
class PeelRecord:
    """One cycle's peel lanes: flag (int32) and the f32 event fields."""
    flag: torch.Tensor
    kx: torch.Tensor
    ky: torch.Tensor
    kz: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    mz: torch.Tensor
    nnx: torch.Tensor
    nny: torch.Tensor
    nnz: torch.Tensor
    Q: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    xatom: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    E1: torch.Tensor    # a resonance's phase weights, line types 2, 4-6
    E2: torch.Tensor
    E3: torch.Tensor
    # a stellar source's newborn: its limb-darkened surface sample (cos
    # theta, vphi), which K2 draws and every observer's pair reads
    limb_cost: torch.Tensor
    limb_vphi: torch.Tensor

    @classmethod
    def zeros(cls, batch: int, device) -> 'PeelRecord':
        return cls(**{f: torch.zeros((batch,), device=device,
                                     dtype=torch.int32 if f == 'flag'
                                     else torch.float32)
                      for f in PEEL_RECORD_FIELDS})

    @functools.cached_property
    def pointers(self):
        ptrs = [getattr(self, f).data_ptr() for f in PEEL_RECORD_FIELDS]
        return (ctypes.c_void_p * len(ptrs))(*ptrs)


@dataclasses.dataclass(eq=False)
class PeelCubes:
    """Flat (nobs*nxfreq*nxim*nyim,) f32 cubes of one chunk (PeelCubes,
    lart_tpu/instruments/peel.py:35-45); I, Q, U, V with use_stokes, Ha
    (the H-alpha band) with line type 8."""
    scatt: torch.Tensor
    direc: torch.Tensor
    I: Optional[torch.Tensor] = None
    Q: Optional[torch.Tensor] = None
    U: Optional[torch.Tensor] = None
    V: Optional[torch.Tensor] = None
    Ha: Optional[torch.Tensor] = None
    direc0: Optional[torch.Tensor] = None   # the unattenuated stellar disk

    def items(self):
        """(name, tensor) of the cubes present."""
        return [(f, getattr(self, f)) for f in CUBE_FIELDS
                if getattr(self, f) is not None]


class PeelParams(ctypes.Structure):
    """csrc/peel.cu struct PeelParams, field for field."""
    _fields_ = [('obs_pos', _P), ('obs_rmat', _P),
                ('scatt', _P), ('direc', _P), ('I', _P), ('Q', _P),
                ('U', _P), ('V', _P), ('Ha', _P), ('direc0', _P),
                ('tau_out', _P),
                ('bin_out', _P), ('w_out', _P),
                ('nobs', _I), ('nxim', _I), ('nyim', _I), ('nxfreq', _I),
                ('max_steps', _I), ('chord', _I), ('stokes', _I),
                ('lab_source', _I), ('dust', _I), ('dxim', _F), ('dyim', _F),
                ('hg_num', _F),
                ('hg_1pg2', _F), ('hg_2g', _F),
                ('mueller', pmueller.MuellerC), ('recoil', _I),
                ('chord_prof', pline.LineProfC), ('hg_num_Ha', _F),
                ('hg_1pg2_Ha', _F), ('hg_2g_Ha', _F), ('inside', _I),
                ('nside', _I), ('star_D', _F), ('star_R', _F),
                ('atm_R', _F), ('atm_R2', _F)]


def hg_consts(g: float, f32_ops: bool):
    """(1 - g^2, 1 + g^2, 2 g) of the Henyey-Greenstein peel: in f64 and
    rounded once where lart_tpu's g is a Python float, else f32 operations
    on the f32 g (line type 8's per-lane array)."""
    if not f32_ops:
        return pline.f32(1.0 - g * g), pline.f32(1.0 + g * g), \
            pline.f32(2.0 * g)
    g = np.float32(g)
    g2 = g * g
    return (float(np.float32(1.0) - g2), float(np.float32(1.0) + g2),
            float(np.float32(2.0) * g))


@dataclasses.dataclass(frozen=True, eq=False)
class Peel:
    """The constants of K7 for one config: the grid it walks (the flights'
    FlightConsts, with the line's constants), and the observers."""
    grid: FlightConsts
    obs_meta: object             # observer.ObserverSetMeta
    pos: torch.Tensor            # (nobs, 3) f32
    rmat: torch.Tensor           # (nobs, 3, 3) f32, grid -> observer
    chord: bool                  # uniform sphere: tau is one chord
    stokes: bool
    lab_source: bool             # moving medium, comoving_source false
    max_steps: int
    dust: int = DUST_OFF
    hgg: float = 0.0             # Henyey-Greenstein g of the dust peel
    mueller: Optional[pmueller.MuellerTable] = None   # DUST_MUELLER
    recoil: bool = False
    chord_prof: Optional[pline.LineProf] = None   # the chord's profile
    hgg_Ha: float = 0.0          # line type 8: the H-alpha band's g
    # a stellar_illumination source: (distance to the star, its radius,
    # the atmosphere's radius) of the stellar direct peel, and whether it
    # fills Direct0 (save_direc0)
    stellar: Optional[tuple] = None
    direc0: bool = False
    # K7's list of the lanes to peel on each (device, batch): lane_list
    _lanes: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @classmethod
    def from_config(cls, cfg, meta, grid, uniform_sphere: bool, cmeta=None
                    ) -> Optional['Peel']:
        """None without save_peeloff; `uniform_sphere` is
        engine.uniform_sphere_fastpath(cfg, meta) (lart_tpu takes the chord
        there whatever the flight); on a clump medium grid is the
        ClumpDevice and cmeta its ClumpMeta."""
        obs = build_observers(cfg, grid.rhokap.device)
        if obs is None:
            return None
        obs_meta, odev = obs
        max_steps = 2 * (meta.nx + meta.ny + meta.nz) + 8
        if meta.grid_type == 'clump':
            fc = ClumpFlight.from_clumps(cfg, meta, cmeta, grid)
            max_steps = 3 * cmeta.cg_n + 8
        elif meta.grid_type == 'amr':
            fc = AmrFlight.from_amr(cfg, meta, grid)
        else:
            fc = FlightConsts.from_config(cfg, meta, grid)
        dust = dust_mode(cfg, meta)
        par = cfg.par
        stellar = None
        if par.source_geometry.strip().lower() == 'stellar_illumination':
            stellar = (par.distance_star_to_planet, par.stellar_radius,
                       par.rmax if par.rmax > 0
                       else min(meta.xmax, meta.ymax, meta.zmax))
        return cls(grid=fc, obs_meta=obs_meta,
                   pos=odev.pos.contiguous(),
                   rmat=odev.rmat.reshape(-1, 3, 3).contiguous(),
                   chord=bool(uniform_sphere),
                   stokes=bool(cfg.par.use_stokes),
                   lab_source=not cfg.par.comoving_source and fc.moving,
                   max_steps=max_steps,
                   dust=dust, hgg=float(cfg.par.hgg),
                   mueller=pmueller.MuellerTable.for_config(
                       cfg, grid.rhokap.device) if dust else None,
                   recoil=bool(cfg.par.recoil),
                   chord_prof=pline.line_prof_f64(
                       cfg.line, meta.voigt_a_ref, meta.Dfreq_ref),
                   hgg_Ha=float(cfg.par.hgg_Ha), stellar=stellar,
                   direc0=stellar is not None and bool(par.save_direc0))

    @property
    def lyb(self) -> bool:
        """Line type 8: conversions and the H-alpha band peel too."""
        return self.grid.line.line_type == 8

    @property
    def direct_mode(self) -> int:
        """The mode that peels K2's newborns: STELLAR for a stellar
        source, else DIRECT."""
        return DIRECT if self.stellar is None else STELLAR

    @property
    def scatter_mode(self) -> int:
        """The mode that peels K4's events: the resonances, with dust the
        dust events, with line type 8 the conversions."""
        return (RESONANCE | (DUST if self.dust else 0)
                | (CONVERSION if self.lyb else 0))

    def hg(self, band2: bool = False):
        """(1 - g^2, 1 + g^2, 2 g) of a band's Henyey-Greenstein peel."""
        return hg_consts(self.hgg_Ha if band2 else self.hgg, self.lyb)

    def device_tensors(self):
        return ((self.pos, self.rmat) + self.grid.device_tensors()
                + (self.mueller.tensors() if self.mueller else ()))

    @property
    def nobs(self) -> int:
        return self.obs_meta.nobs

    @property
    def n_bins(self) -> int:
        o = self.obs_meta
        return o.nobs * self.grid.nxfreq * o.nxim * o.nyim

    def zero_cubes(self, device) -> PeelCubes:
        def z():
            return torch.zeros((self.n_bins,), dtype=torch.float32,
                               device=device)
        st = self.stokes
        return PeelCubes(scatt=z(), direc=z(), I=z() if st else None,
                         Q=z() if st else None, U=z() if st else None,
                         V=z() if st else None,
                         Ha=z() if self.lyb else None,
                         direc0=z() if self.direc0 else None)

    @functools.cached_property
    def _c_params(self) -> PeelParams:
        c = PeelParams()
        o = self.obs_meta
        c.obs_pos, c.obs_rmat = self.pos.data_ptr(), self.rmat.data_ptr()
        c.nobs, c.nxim, c.nyim = o.nobs, o.nxim, o.nyim
        c.nxfreq, c.max_steps = self.grid.nxfreq, self.max_steps
        c.chord, c.stokes = int(self.chord), int(self.stokes)
        c.lab_source, c.dust = int(self.lab_source), self.dust
        c.dxim, c.dyim = o.dxim, o.dyim
        c.hg_num, c.hg_1pg2, c.hg_2g = self.hg()
        c.hg_num_Ha, c.hg_1pg2_Ha, c.hg_2g_Ha = self.hg(True)
        if self.mueller is not None:
            c.mueller = self.mueller.c_struct
        c.recoil = int(self.recoil)
        c.chord_prof = self.chord_prof.c_struct
        c.inside, c.nside = int(o.inside), o.nside
        if self.stellar is not None:
            c.star_D, c.star_R, c.atm_R = self.stellar
            c.atm_R2 = self.stellar[2] * self.stellar[2]
        return c

    def lane_list(self, state) -> 'LaneList':
        """K7's LaneList for the state's device and batch."""
        key = (state.device, state.batch)
        if key not in self._lanes:
            self._lanes[key] = LaneList(state.batch, state.device)
        return self._lanes[key]

    def c_params(self, cubes: PeelCubes, pair_out=None) -> PeelParams:
        """The C struct with this call's cube pointers (the launch copies
        it); pair_out, when given, is (tau_out, bin_out, w_out) of peel()."""
        c = self._c_params
        for f in CUBE_FIELDS:
            t = getattr(cubes, f)
            setattr(c, f, None if t is None else t.data_ptr())
        for f, t in zip(('tau_out', 'bin_out', 'w_out'), pair_out or
                        (None,) * 3):
            setattr(c, f, None if t is None else t.data_ptr())
        return c


def packs(c: int, batch: int, nobs: int, min_pack: int) -> bool:
    """Whether K7 packs the walks of c peeled lanes of `batch` into full
    warps (csrc/peel.cu peel_kernel takes the same test on the card)."""
    return 2 * c < batch and c * nobs >= min_pack


@dataclasses.dataclass(eq=False)
class PassGate:
    """Whether K7's first pass runs for one mode: `packs`, what the count
    last read says (True before any), `calls` so far, and the pinned
    `count` that a sampling call's copy lands in, with the `event` after
    it (None once read)."""
    packs: bool = True
    calls: int = 0
    count: Optional[torch.Tensor] = None
    event: Optional[torch.cuda.Event] = None


class LaneList:
    """K7's list of the lanes to peel on one (device, batch) (csrc/peel.cu
    peel_select_kernel): `order`, B lanes and two counts, zeroed once; a
    launch with the list counts into order[B + parity] and zeroes the
    other count for the next, which takes the other parity.  For each mode
    a PassGate: the first pass runs where the count last read packs, or
    none has been read, and on every SAMPLE_EVERY-th call, which copies
    its count to pinned memory behind the launch; a later call reads it
    once its event has passed, never waiting for it."""

    def __init__(self, batch: int, device):
        self.order = torch.zeros((batch + 2,), dtype=torch.int32,
                                 device=device)
        self.parity = 0
        self.gates = {}

    def take(self, mode: int, nobs: int, min_pack: int) -> tuple:
        """(order or None, parity, sample) of this call's launch in
        `mode`; sample(stream), where not None, follows the launch."""
        B = len(self.order) - 2
        g = self.gates.get(mode)
        if g is None:
            g = self.gates[mode] = PassGate(count=torch.zeros(
                (1,), dtype=torch.int32, pin_memory=True))
        if g.event is not None and g.event.query():
            g.packs = packs(int(g.count[0]), B, nobs, min_pack)
            g.event = None
        sample = g.calls % SAMPLE_EVERY == 0 and g.event is None
        g.calls += 1
        if not (g.packs or sample):
            return None, 0, None
        parity = self.parity
        self.parity = 1 - parity

        def copy(stream):
            g.count.copy_(self.order[B + parity:B + parity + 1],
                          non_blocking=True)
            g.event = torch.cuda.Event()
            g.event.record(stream)
        return self.order, parity, copy if sample else None


def n_components(p: Peel, mode: int) -> int:
    """The deposits a pair of `mode` makes at its bin (csrc/peel.cu
    PeelDep and peel_add): a birth's Direct (and I with Stokes) and,
    stellar with save_direc0, Direct0; a scattering's scatt (and I) and,
    with Stokes, Q, U, V (a conversion's or an H-alpha band dust event's
    Ha alone, its key past the other cubes' n_bins)."""
    if mode in (DIRECT, STELLAR):
        return 2 if mode == STELLAR and p.direc0 else 1
    return 4 if p.stokes else 1



# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def obs_geometry(p: Peel, o: int, x, y, z):
    """Unit direction pk toward observer o, r^2, the flat pixel and whether
    the pair is in the image (obs_geometry, peel.py:394-425): the TAN pixel
    of an external observer, or for an interior one the HEALPix RING pixel
    of the arrival direction -pk, a pair within r^2 <= 1e-12 of the
    observer dropped (its 1/r^2 weight diverges)."""
    obs = p.obs_meta
    pkx, pky, pkz = p.pos[o, 0] - x, p.pos[o, 1] - y, p.pos[o, 2] - z
    r2 = pkx * pkx + pky * pky + pkz * pkz
    r = torch.sqrt(torch.clamp_min(r2, 1e-30))
    pkx, pky, pkz = pkx / r, pky / r, pkz / r
    if obs.inside:
        ipix = vec2pix_ring(obs.nside, -pkx, -pky, -pkz)
        return (pkx, pky, pkz), r2, ipix.long(), r2 > np.float32(1e-12)
    return (pkx, pky, pkz), r2, *tan_pixel(p, o, pkx, pky, pkz)


def tan_pixel(p: Peel, o: int, pkx, pky, pkz):
    """(flat TAN pixel, whether it is in the image) of the unit directions
    pk toward external observer o (peel.py:416-425)."""
    obs = p.obs_meta
    R = p.rmat[o]
    kx = R[0, 0] * pkx + R[0, 1] * pky + R[0, 2] * pkz
    ky = R[1, 0] * pkx + R[1, 1] * pky + R[1, 2] * pkz
    kz = R[2, 0] * pkx + R[2, 1] * pky + R[2, 2] * pkz
    ix = torch.floor(div(torch.atan2(-kx, kz) * RAD2DEG, obs.dxim)
                     + obs.nxim / 2.0).to(torch.int32)
    iy = torch.floor(div(torch.atan2(-ky, kz) * RAD2DEG, obs.dyim)
                     + obs.nyim / 2.0).to(torch.int32)
    in_img = (ix >= 0) & (ix < obs.nxim) & (iy >= 0) & (iy < obs.nyim)
    img = (torch.clamp(ix, 0, obs.nxim - 1) * obs.nyim
           + torch.clamp(iy, 0, obs.nyim - 1))
    return img, in_img


def obs_cap(p: Peel, r2):
    """The sightline's cap: for an interior observer the distance to it
    (the tau integration stops there), else None."""
    if not p.obs_meta.inside:
        return None
    return torch.sqrt(torch.clamp_min(r2, 1e-30))


def cell_D(p: Peel, cell):
    """The Doppler width of the event cells: the reference float, the
    clumps' (f32) on a clump medium, or per lane on a Cartesian or AMR grid
    at non-uniform temperature."""
    g = p.grid
    if g.clump is not None:
        return f32(g.clump.D_cl)
    if g.amr is None:
        return g.cell_a_D(g.flat(*cell))[1]
    return g.amr.a_D(g.amr.leaf(cell[0]), g.a_ref, g.Dfreq)[1]


def lab_freq(p: Peel, cell, k, xf):
    """The lab frequency in reference Doppler units of the comoving
    frequency xf at the cells `cell` along k: (xf + u.k) D / D_ref."""
    g = p.grid
    xr = xf + g.vel_dot(cell, *k) if g.moving else xf
    return xr * (g.clump.d_ratio if g.clump is not None
                 else doppler_ratio(cell_D(p, cell), g.Dfreq))


def freq_bin(p: Peel, cell, pk, xf, band2=None):
    """Lab-frequency bin of the comoving frequency xf at the event cell,
    seen along pk, at the cell's Doppler width (freq_bin, peel.py:430-441);
    where the mask band2 is set, xf is a lab frequency already."""
    g = p.grid
    xr = lab_freq(p, cell, pk, xf)
    if band2 is not None:
        xr = torch.where(band2, xf, xr)
    ixf = torch.floor(div(xr - g.xfreq_min, g.dxfreq)).to(torch.int32)
    return ixf, (ixf >= 0) & (ixf < g.nxfreq)


def tau_to_edge(p: Peel, pos, cell, k, xf, active, stats=None, band2=None,
                cap=None):
    """Optical depth from pos along k to the grid's edge for the `active`
    lanes (0 elsewhere): the chord through the uniform sphere, or the
    lockstep DDA of tau_to_edge_cart with its early exit; where the mask
    band2 is set, the H-alpha band's dust-only opacity (0 without dust, and
    nothing walked).  With cap (per pair, an interior observer's distance)
    the integration stops at that path length instead of the edge (the
    raytrace_to_dist contract, peel.py:176-183): the chord is cut there
    (:378-380), the DDA and AMR walks end with a partial step.  stats, a
    dict, gains the count of cell crossings walked under 'crossings' and
    marks the cells walked in its 'visited' mask."""
    g = p.grid
    if band2 is not None and g.rhokapD is None:
        active = active & ~band2
        band2 = None
    if p.chord:
        rho = (g.sphere_rho * pline.line_profile_q(g.line, p.chord_prof, xf)
               + g.sphere_rhoD)
        t_in, t_out = sphere_chord(g, *pos, *k)
        if cap is not None:
            t_out = torch.minimum(t_out, torch.maximum(cap, t_in))
            t_in = torch.minimum(t_in, t_out)
        return torch.where(active, (t_out - t_in) * rho,
                           torch.zeros_like(xf))
    if g.amr is not None:
        return _tau_amr(p, pos, cell[0], k, xf, active, stats, band2, cap)
    if g.clump is not None:
        # clumps with an interior observer are vetoed (config.py:494-503)
        assert cap is None
        return _tau_clump(p, pos, k, xf, active, stats)
    # the walk runs on the live pairs only, compacted after every crossing
    tau = torch.zeros_like(xf)
    idx = active.nonzero().squeeze(1)
    pos, cell, k = ([v[idx] for v in vs] for vs in (pos, cell, k))
    xf, acc = xf[idx], tau[idx]
    b2 = None if band2 is None else band2[idx]
    cap = None if cap is None else cap[idx]
    trav = torch.zeros_like(acc)
    for _ in range(p.max_steps):
        if idx.numel() == 0:
            break
        flat = g.flat(*cell)
        if stats is not None:
            stats['crossings'] = stats.get('crossings', 0) + idx.numel()
            _visit(stats, g, flat)
        rho = g.opacity(flat, xf, b2)
        t = [_face_dist(pos[a], k[a], cell[a], g.amin[a], g.d[a])
             if g.walk[a] else torch.full_like(xf, BIG) for a in range(3)]
        dmin = torch.minimum(torch.minimum(t[0], t[1]), t[2])
        axis = torch.where(dmin == t[0], 0, torch.where(dmin == t[1], 1, 2))
        dstep, hit_cap = capped_step(dmin, cap, trav)
        acc = acc + dstep * rho
        trav = trav + dstep
        npos = [fma(dmin, k[a], pos[a]) for a in range(3)]
        ncell, ndir = list(cell), list(k)
        esc = torch.zeros_like(xf, dtype=torch.bool)
        for a in range(3):
            c2, p2, k2, e = _cross_axis(g, a, cell[a], npos[a], k[a])
            ca = axis == a
            ncell[a] = torch.where(ca, c2, cell[a])
            npos[a] = torch.where(ca, p2, npos[a])
            ndir[a] = torch.where(ca, k2, k[a])
            esc = esc | (ca & e)
        if g.mask is not None:
            # a sightline into the masked core is opaque (peel.py:326-333)
            acc = torch.where(~esc & g.masked(g.flat(*ncell)),
                              torch.full_like(acc, 2.0 * TAU_HUGE), acc)
        if g.moving or not g.uniform_temperature:
            # the comoving update at each cell's D (peel.py:336-340)
            zero = torch.zeros_like(xf)
            u1 = g.vel_dot(cell, *k) if g.moving else zero
            u2 = g.vel_dot(ncell, *ndir) if g.moving else zero
            D1 = g.cell_a_D(flat)[1]
            D2 = g.cell_a_D(g.flat(*ncell))[1]
            xf = torch.where(esc, xf, comoving(xf, u1, D1, D2, u2))
        done = esc | hit_cap | ~(acc < TAU_STOP)
        tau[idx[done]] = acc[done]
        keep = ~done
        idx, xf, acc, trav = idx[keep], xf[keep], acc[keep], trav[keep]
        if b2 is not None:
            b2 = b2[keep]
        if cap is not None:
            cap = cap[keep]
        pos, cell, k = ([v[keep] for v in vs] for vs in (npos, ncell, ndir))
    tau[idx] = acc      # the pairs still live after max_steps
    return tau


def _tau_amr(p: Peel, pos, ic, k, xf, active, stats=None, band2=None,
             cap=None):
    """tau_to_edge's AMR sightline (peel.py:242-290): node by node, the
    exit face, the neighbor hop and the descent of the flight (K8), with
    its comoving update in a moving medium or at non-uniform temperature,
    to the cap where one is given; stats as in tau_to_edge, the cells being
    leaves, and its mask 'nodes' marks the nodes walked."""
    g = p.grid
    amr = g.amr
    update = g.moving or not amr.uniform_temperature
    tau = torch.zeros_like(xf)
    idx = active.nonzero().squeeze(1)
    pos, k = ([v[idx] for v in vs] for vs in (pos, k))
    ic, xf, acc = ic[idx], xf[idx], tau[idx]
    b2 = None if band2 is None else band2[idx]
    cap = None if cap is None else cap[idx]
    trav = torch.zeros_like(acc)
    for _ in range(p.max_steps):
        if idx.numel() == 0:
            break
        il = amr.leaf(ic)
        if stats is not None:
            stats['crossings'] = stats.get('crossings', 0) + idx.numel()
            _visit(stats, g, il)
            if 'nodes' not in stats:
                stats['nodes'] = torch.zeros(amr.dev.ncells, dtype=torch.bool,
                                             device=ic.device)
            stats['nodes'][ic.long()] = True
        a_c, D_c = amr.a_D(il, g.a_ref, g.Dfreq)
        rho = g.leaf_opacity(il, xf, a_c, D_c, b2)
        box = g.node_box(ic)
        dmin, axis, face = exit_face(pos, k, box)
        dstep, hit_cap = capped_step(dmin, cap, trav)
        acc = acc + dstep * rho
        trav = trav + dstep
        npos = [torch.where(axis == a, box[a] + torch.where(
            k[a] > 0, box[3], -box[3]), fma(dmin, k[a], pos[a]))
            for a in range(3)]
        _, esc, icn = hop(g, ic, face, npos)
        if update:
            il2 = amr.leaf(icn)
            D2 = amr.a_D(il2, g.a_ref, g.Dfreq)[1]
            xf = torch.where(esc, xf, comoving(
                xf, g.leaf_vel_dot(il, *k), D_c, D2,
                g.leaf_vel_dot(il2, *k)))
        done = esc | hit_cap | ~(acc < TAU_STOP)
        tau[idx[done]] = acc[done]
        keep = ~done
        idx, xf, acc, ic = idx[keep], xf[keep], acc[keep], icn[keep]
        trav = trav[keep]
        if b2 is not None:
            b2 = b2[keep]
        if cap is not None:
            cap = cap[keep]
        pos, k = [v[keep] for v in npos], [v[keep] for v in k]
    tau[idx] = acc      # the pairs still live after max_steps
    return tau


def _tau_clump(p: Peel, pos, k, xf, active, stats=None):
    """tau_to_edge's clump sightline (peel.py:86-170): CSR cell by cell,
    each cell's candidates' chord overlaps clipped to the cell segment (plus
    the nudge) at their local frequencies, summed in table order, to the
    cube's faces, tau TAU_STOP or max_steps cells; stats as in tau_to_edge, the
    cells being the candidate clumps read, and its mask 'csr' marks the CSR
    cells walked."""
    g = p.grid
    cl = g.clump
    tau = torch.zeros_like(xf)
    idx = active.nonzero().squeeze(1)
    pos, k = [v[idx] for v in pos], [v[idx] for v in k]
    xf, acc = xf[idx], tau[idx]
    for _ in range(p.max_steps):
        if idx.numel() == 0:
            break
        cell, t_cell = cl.cell_exit(pos, k)
        t_end = t_cell + cl.eps_peel
        if stats is not None:
            stats['crossings'] = stats.get('crossings', 0) + idx.numel()
            if 'csr' not in stats:
                stats['csr'] = torch.zeros(cl.cg_n ** 3, dtype=torch.bool,
                                           device=xf.device)
            stats['csr'][cell] = True
        dtau = torch.zeros_like(xf)
        for q in range(cl.K):
            cand = cl.candidate(cell, q)
            qx, qy, qz, qr2 = cl.centre(cand)
            eb, edet = chord_det(pos[0] - qx, pos[1] - qy, pos[2] - qz, *k,
                                 qr2)
            sq = torch.sqrt(torch.clamp_min(edet, 0.0))
            t0 = torch.minimum(torch.clamp_min(-eb - sq, 0.0), t_end)
            t1 = torch.minimum(torch.clamp_min(-eb + sq, 0.0), t_end)
            u = cl.vel_dot(cand, *k, form='div') if cl.moving else None
            kq = cl.kappa(g.line, cand, cl.local_x(xf, u))
            ok = (cand >= 0) & (edet > 0.0)
            if stats is not None:
                _visit(stats, g, cand[ok])
            dtau = fma(torch.where(ok, kq, torch.zeros_like(kq)), t1 - t0,
                       dtau)
        acc = acc + dtau
        pos = [fma(t_end, k[a], pos[a]) for a in range(3)]
        out = ((torch.abs(pos[0]) >= cl.R) | (torch.abs(pos[1]) >= cl.R)
               | (torch.abs(pos[2]) >= cl.R))
        done = out | ~(acc < TAU_STOP)
        tau[idx[done]] = acc[done]
        keep = ~done
        idx, xf, acc = idx[keep], xf[keep], acc[keep]
        pos, k = [v[keep] for v in pos], [v[keep] for v in k]
    tau[idx] = acc      # the pairs still live after max_steps
    return tau


def _visit(stats, g, flat):
    """Mark the flat cells (AMR: the leaves, a gap's -1 left out) in
    stats['visited'], a mask of the grid."""
    if 'visited' not in stats:
        stats['visited'] = torch.zeros(g.rhokap.numel(), dtype=torch.bool,
                                       device=g.rhokap.device)
    stats['visited'][flat[flat >= 0]] = True


def _add(cube, idx, ok, w):
    cube.index_add_(0, idx, torch.where(ok, w, torch.zeros_like(w)))


def event_frequency(p: Peel, kind: int, s, rec: PeelRecord, pk):
    """The comoving frequency toward the observer along pk of an event of
    `kind` (DIRECT, RESONANCE, DUST or CONVERSION), and at a scattering the
    observer direction in the event's frame: (xf, cost, cosp, sinp); the
    last three are None at a birth, and cosp, sinp without Stokes at a dust
    event.  The H-alpha photon of a conversion leaves the atom's line
    centre: its frequency is the atom velocity's projection alone, with no
    recoil (peel.py:680-682), its azimuth the geometric one."""
    cell = (s.ic, s.jc, s.kc)
    if kind == DIRECT:
        xf = s.xfreq
        if p.lab_source:
            # comoving-source convention (peel.py:453-459)
            g = p.grid
            xf = s.xfreq + g.vel_dot(cell, s.kx, s.ky, s.kz) \
                - g.vel_dot(cell, *pk)
        return xf, None, None, None
    cost = rec.kx * pk[0] + rec.ky * pk[1] + rec.kz * pk[2]
    sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
    zero, one = torch.zeros_like(cost), torch.ones_like(cost)
    if p.stokes and kind != CONVERSION:
        # azimuth relative to the (m, n) triad
        sint_safe = torch.clamp_min(sint, 1e-20)
        cosp = (pk[0] * rec.mx + pk[1] * rec.my + pk[2] * rec.mz) / sint_safe
        sinp = (pk[0] * rec.nnx + pk[1] * rec.nny
                + pk[2] * rec.nnz) / sint_safe
        cosp = torch.where(sint == 0.0, one, cosp)
        sinp = torch.where(sint == 0.0, zero, sinp)
    elif kind == DUST:
        # the HG phase needs no azimuth; dust scatters coherently (on a
        # clump medium at the record's frequency in the owner's units)
        return _dust_x(p, s, rec), cost, None, None
    else:
        # azimuth from the propagation-vector geometry
        rho1 = torch.sqrt(torch.clamp_min(1.0 - rec.kz * rec.kz, 0.0)) * sint
        inv = 1.0 / torch.clamp_min(rho1, 1e-20)
        cosp = torch.where(rho1 == 0.0, one, inv * (cost * rec.kz - pk[2]))
        sinp = torch.where(rho1 == 0.0, zero,
                           inv * (rec.kx * pk[1] - pk[0] * rec.ky))
    if kind == DUST:
        return _dust_x(p, s, rec), cost, cosp, sinp
    if kind == CONVERSION:
        return ((rec.ux * cosp + rec.uy * sinp) * sint + rec.uz * cost, cost,
                cosp, sinp)
    xf = rec.xatom + (rec.ux * cosp + rec.uy * sinp) * sint + rec.uz * cost
    if p.recoil:
        # the hydrogen constant for every event, as lart_tpu's peel, over
        # the cell's Doppler width
        D = cell_D(p, cell)
        g0D = pline.div32(p.grid.line.g_recoil0, D) if not isinstance(
            D, torch.Tensor) else torch.full_like(D, p.grid.line.g_recoil0) / D
        xf = xf - g0D * (1.0 - cost)
    return xf, cost, cosp, sinp


def _dust_x(p: Peel, s, rec: PeelRecord):
    """A dust event's frequency: the lane's, or on a clump medium the
    record's (the lane's in the owner's units before K4 shifted it back)."""
    return rec.xatom if p.grid.clump is not None else s.xfreq


def detector_qu(p: Peel, o: int, rec: PeelRecord, cosp, sinp, Qobs, Uobs):
    """(Q, U) of the scattering plane rotated into observer o's detector
    frame by the peel frame's normal vector (peel.py:540-550, :621-630)."""
    pnx = -sinp * rec.mx + cosp * rec.nnx
    pny = -sinp * rec.my + cosp * rec.nny
    pnz = -sinp * rec.mz + cosp * rec.nnz
    R = p.rmat[o]
    cosg = -(R[0, 0] * pnx + R[0, 1] * pny + R[0, 2] * pnz)
    sing = R[1, 0] * pnx + R[1, 1] * pny + R[1, 2] * pnz
    cos2g = 2.0 * cosg * cosg - 1.0
    sin2g = 2.0 * cosg * sing
    return cos2g * Qobs + sin2g * Uobs, -sin2g * Qobs + cos2g * Uobs


def scatter_deposits(p: Peel, kind: int, o: int, rec: PeelRecord, cost,
                     cosp, sinp, atten, r2, wgt, band2=None):
    """The deposits of a scattering toward observer o, by cube: scatt, and
    with Stokes I, Q, U, V (peel.py:526-561 resonance, :600-648 dust); a
    conversion's, and a dust event's of the H-alpha band (the mask band2),
    go to Ha (:642-651, :689-693)."""
    cost2 = cost * cost
    lc = p.grid.line
    E1, E2, E3 = (rec.E1, rec.E2, rec.E3) if lc.per_lane_E \
        else (lc.E1s, lc.E2s, lc.E3s)
    if kind == CONVERSION:
        # the dipole phase of the 3p -> 2s channel
        phase = 0.75 * lc.E1[0][1] * (cost2 + 1.0) + lc.E2[0][1]
        return {'Ha': phase / (FOURPI * r2) * atten * wgt}
    if not p.stokes:
        if kind == RESONANCE:
            phase = 0.75 * E1 * (cost2 + 1.0) + E2
            return {'scatt': phase / (FOURPI * r2) * atten * wgt}

        def hg_phase(num, one_p, two_g):
            den = torch.pow(one_p - two_g * cost, 1.5)
            return div(torch.full_like(den, num) / den, FOURPI)
        w = hg_phase(*p.hg()) / r2 * atten * wgt
        if band2 is None:
            return {'scatt': w}
        w2 = hg_phase(*p.hg(True)) / r2 * atten * wgt
        zero = torch.zeros_like(w)
        return {'scatt': torch.where(band2, zero, w),
                'Ha': torch.where(band2, w2, zero)}
    cos2p = 2.0 * cosp * cosp - 1.0
    sin2p = 2.0 * cosp * sinp
    Q0 = cos2p * rec.Q + sin2p * rec.U
    U0 = -sin2p * rec.Q + cos2p * rec.U
    if kind == RESONANCE:
        S22 = 0.75 * E1 * (cost2 + 1.0)
        S11 = S22 + E2
        S12 = 0.75 * E1 * (cost2 - 1.0)
        S33 = 1.5 * E1 * cost
        S44 = 1.5 * E3 * cost
        Iobs = div(S11 + S12 * Q0, FOURPI)
        Qobs = div(S12 + S22 * Q0, FOURPI)
        Uobs = div(S33 * U0, FOURPI)
        Vobs = div(S44 * rec.V, FOURPI)
    else:
        S11, S12, S33, S34 = pmueller.interp_S(p.mueller, cost)
        Iobs = div(S11 + S12 * Q0, TWOPI)
        Qobs = div(S12 + S11 * Q0, TWOPI)
        Uobs = div(S33 * U0 + S34 * rec.V, TWOPI)
        Vobs = div(-S34 * U0 + S33 * rec.V, TWOPI)
    Qdet, Udet = detector_qu(p, o, rec, cosp, sinp, Qobs, Uobs)
    w = atten / r2 * wgt
    wI = w * Iobs
    return {'scatt': wI, 'I': wI, 'Q': w * Qdet, 'U': w * Udet,
            'V': w * Vobs}


def peel_plain(state, cubes: PeelCubes, rec: PeelRecord, p: Peel,
               mode: int, tau_out=None, bin_out=None, w_out=None,
               stats=None) -> None:
    """Plain PyTorch peel of the flagged lanes into `cubes`, in place
    (tau_out, bin_out, w_out as in peel()).  stats, a dict, gains the work
    the call needed: the flagged lanes with a pair in an image ('seen';
    'seen_dust' of them at a dust event, 'seen_conv' at a conversion),
    the pairs that walk ('pairs'),
    their cell crossings ('crossings'), the distinct grid cells read
    ('cells': those walked and, in a moving medium, the event cells of the
    pairs in an image) and the distinct cube bins deposited into
    ('bins')."""
    if mode == STELLAR:
        peel_stellar_plain(state, cubes, rec, p, tau_out, bin_out, w_out,
                           stats)
        return
    s = state
    g = p.grid
    B = s.batch
    cell = (s.ic, s.jc, s.kc)
    obs = p.obs_meta
    seen = torch.zeros(B, dtype=torch.bool, device=s.device)
    seen_dust = torch.zeros_like(seen)
    seen_conv = torch.zeros_like(seen)
    bins = []
    kinds = (DIRECT,) if mode == DIRECT else tuple(
        k for k in (RESONANCE, DUST, CONVERSION) if mode & k)
    # a dust event keeps its lane's band; a conversion's photon is H-alpha
    lane_b2 = s.iband == 2 if p.lyb else None
    all_b2 = torch.ones_like(seen)

    def put(out, c, ok, w):
        if out is not None:
            sl = slice((c * p.nobs + o) * B, (c * p.nobs + o + 1) * B)
            out[sl] = torch.where(ok, w, out[sl])

    for o in range(p.nobs):
        pk, r2, img, in_img = obs_geometry(p, o, s.x, s.y, s.z)
        cap = obs_cap(p, r2)
        for kind in kinds:
            flag = rec.flag != 0 if kind == DIRECT else rec.flag == kind
            if kind in (DUST, CONVERSION) and not bool(flag.any()):
                continue
            xf, cost, cosp, sinp = event_frequency(p, kind, s, rec, pk)
            b2 = lane_b2 if kind == DUST else None
            ixf, okf = freq_bin(p, cell, pk, xf, b2)
            act = flag & in_img
            tau = tau_to_edge(p, (s.x, s.y, s.z), cell, pk, xf, act & okf,
                              stats, all_b2 if kind == CONVERSION else b2,
                              cap)
            atten = torch.exp(-torch.clamp_max(tau, 700.0))
            idx = ((o * g.nxfreq + torch.clamp(ixf, 0, g.nxfreq - 1)).long()
                   * (obs.nxim * obs.nyim) + img)
            ok = act & okf
            if stats is not None:
                seen |= act
                if kind == DUST:
                    seen_dust |= act
                if kind == CONVERSION:
                    seen_conv |= act
                stats['pairs'] = stats.get('pairs', 0) + int(ok.sum())
                bins.append(idx[ok])
                if g.moving:
                    _visit(stats, g, g.flat(*(c[act] for c in cell)))
            put(tau_out, 0, ok, tau)
            if bin_out is not None:
                sl = slice(o * B, (o + 1) * B)
                bin_out[sl] = torch.where(ok, idx, bin_out[sl].long()).to(
                    bin_out.dtype)
            if kind == DIRECT:
                w = atten / (FOURPI * r2) * s.wgt
                _add(cubes.direc, idx, ok, w)
                if p.stokes:
                    _add(cubes.I, idx, ok, w)
                put(w_out, 0, ok, w)
                continue
            dep = scatter_deposits(p, kind, o, rec, cost, cosp, sinp, atten,
                                   r2, s.wgt, b2)
            for name, w in dep.items():
                _add(getattr(cubes, name), idx, ok, w)
            # a pair's first deposit: scatt, or Ha (at most one is not 0)
            first = [dep[n] for n in ('scatt', 'Ha') if n in dep]
            put(w_out, 0, ok, first[0] if len(first) == 1
                else first[0] + first[1])
            for c, name in enumerate(('Q', 'U', 'V'), 1):
                if name in dep:
                    put(w_out, c, ok, dep[name])
    if stats is not None:
        stats['seen'] = int(seen.sum())
        stats['seen_dust'] = int(seen_dust.sum())
        stats['seen_conv'] = int(seen_conv.sum())
        stats['bins'] = int(torch.unique(torch.cat(bins)).numel()) \
            if bins else 0
        stats['cells'] = int(stats.pop('visited').sum()) \
            if 'visited' in stats else 0
        stats['nodes'] = int(stats.pop('nodes').sum()) \
            if 'nodes' in stats else 0
        stats['csr'] = int(stats.pop('csr').sum()) if 'csr' in stats else 0


def entry_cells(p: Peel, ex, ey, ez):
    """The cells of the entry points (ex, ey, ez) of the stellar peel
    (peel.py:790-802): clip(floor) per axis on a Cartesian grid,
    amr_find_cell's node on the AMR grid (j, k 0), 0 on clumps."""
    g = p.grid
    if g.amr is not None:
        ic = g.amr.find_cell(ex, ey, ez)
        zero = torch.zeros_like(ic)
        return ic, zero, zero.clone()
    if g.clump is not None:
        zero = torch.zeros_like(ex, dtype=torch.int32)
        return zero, zero.clone(), zero.clone()
    return tuple(torch.clamp(torch.floor(div(v - np.float32(a), d)), 0,
                             n - 1).to(torch.int32)
                 for v, a, d, n in zip((ex, ey, ez), g.amin, g.d, g.n))


def peel_stellar_plain(s, cubes: PeelCubes, rec: PeelRecord, p: Peel,
                       tau_out=None, bin_out=None, w_out=None,
                       stats=None) -> None:
    """Plain PyTorch stellar direct peel (mode STELLAR, peel.py:709-836) of
    the lanes K2 launched: tau_out, bin_out, w_out and stats as in
    peel_plain ('seen' counts the pairs in an image and the band,
    'crossing' those of them whose ray crosses the atmosphere)."""
    g = p.grid
    B = s.batch
    obs = p.obs_meta
    Dsp, Rs, Rmax = p.stellar
    cell = (s.ic, s.jc, s.kc)
    flag = rec.flag != 0
    # the newborn's lab frequency in reference Doppler units, its bin
    xr = lab_freq(p, cell, (s.kx, s.ky, s.kz), s.xfreq)
    ixf = torch.floor(div(xr - g.xfreq_min, g.dxfreq)).to(torch.int32)
    okf = (ixf >= 0) & (ixf < g.nxfreq)
    # the one surface sample of each photon, shared by the observers
    cost = rec.limb_cost
    cosvp, sinvp = torch.cos(rec.limb_vphi), torch.sin(rec.limb_vphi)
    update = g.clump is None and (g.moving or not (
        g.uniform_temperature if g.amr is None
        else g.amr.uniform_temperature))
    seen = crossing = 0
    bins = []
    for o in range(p.nobs):
        ox, oy, oz = p.pos[o, 0], p.pos[o, 1], p.pos[o, 2]
        # the star -> observer axis, the star at (0, 0, -D)
        k0x, k0y, k0z = ox, oy, oz + Dsp
        d_so2 = k0x * k0x + k0y * k0y + k0z * k0z
        d_so = torch.sqrt(d_so2)
        k0x, k0y, k0z = k0x / d_so, k0y / d_so, k0z / d_so
        cosvt0 = torch.full_like(d_so, Rs) / d_so
        c0c = cosvt0 * cost
        cosvt = cost * torch.sqrt(1.0 - cosvt0 * cosvt0 + c0c * c0c) \
            + cosvt0 * (1.0 - cost * cost)
        sinvt = torch.sqrt(torch.clamp_min(1.0 - cosvt * cosvt, 0.0))
        kr0 = torch.sqrt(torch.clamp_min(k0x * k0x + k0y * k0y, 0.0))
        pol = kr0 < 1e-11
        kr0s = torch.clamp_min(kr0, 1e-11)
        xx = torch.where(pol, sinvt * cosvp,
                         cosvt * k0x + sinvt * (k0z * k0x * cosvp
                                                - k0y * sinvp) / kr0s)
        yy = torch.where(pol, sinvt * sinvp,
                         cosvt * k0y + sinvt * (k0z * k0y * cosvp
                                                + k0x * sinvp) / kr0s)
        zz = torch.where(pol, torch.sign(k0z) * cosvt,
                         cosvt * k0z - sinvt * cosvp * kr0)
        xx, yy, zz = Rs * xx, Rs * yy, Rs * zz - Dsp
        pkx, pky, pkz = ox - xx, oy - yy, oz - zz
        rr = torch.sqrt(pkx * pkx + pky * pky + pkz * pkz)
        pk = (pkx / rr, pky / rr, pkz / rr)
        img, in_img = tan_pixel(p, o, *pk)
        # the atmosphere sphere's crossing (lart_tpu's corrected test)
        r_dot_k = xx * pk[0] + yy * pk[1] + zz * pk[2]
        rr2 = xx * xx + yy * yy + zz * zz
        det = r_dot_k * r_dot_k - (rr2 - Rmax * Rmax)
        crosses = (r_dot_k < 0.0) & (det >= 0.0)
        dist = -r_dot_k - torch.sqrt(torch.clamp_min(det, 0.0))
        entry = (xx + pk[0] * dist, yy + pk[1] * dist, zz + pk[2] * dist)
        ecell = entry_cells(p, *entry)
        xf_in = xr
        if update:
            # the lab frequency into the entry cell's comoving frame
            u2 = g.vel_dot(ecell, *pk) if g.moving else 0.0
            xf_in = div(xr * g.Dfreq, cell_D(p, ecell)) - u2
        act = flag & in_img
        ok = act & okf
        walk = ok & crosses
        tau = tau_to_edge(p, entry, ecell, pk, xf_in, walk, stats)
        atten = torch.where(crosses, torch.exp(-torch.clamp_max(tau, 700.0)),
                            torch.ones_like(tau))
        w0 = torch.full_like(d_so2, 1.0) / d_so2
        w = w0 * atten
        idx = ((o * g.nxfreq + torch.clamp(ixf, 0, g.nxfreq - 1)).long()
               * (obs.nxim * obs.nyim) + img)
        _add(cubes.direc, idx, ok, w)
        if cubes.direc0 is not None:
            _add(cubes.direc0, idx, ok, w0.expand_as(w))
        if p.stokes:
            _add(cubes.I, idx, ok, w)
        if tau_out is not None:
            sl = slice(o * B, (o + 1) * B)
            tau_out[sl] = torch.where(ok, tau, tau_out[sl])
            bin_out[sl] = torch.where(ok, idx, bin_out[sl].long()).to(
                bin_out.dtype)
            w_out[sl] = torch.where(ok, w, w_out[sl])
        seen += int(ok.sum())
        crossing += int(walk.sum())
        bins.append(idx[ok])
    if stats is not None:
        stats['seen'] = seen
        stats['crossing'] = crossing
        stats['pairs'] = crossing
        stats['bins'] = int(torch.unique(torch.cat(bins)).numel())
        stats['cells'] = int(stats.pop('visited').sum()) \
            if 'visited' in stats else 0
        stats['nodes'] = int(stats.pop('nodes').sum()) \
            if 'nodes' in stats else 0
        stats['csr'] = int(stats.pop('csr').sum()) if 'csr' in stats else 0


@functools.lru_cache(maxsize=None)
def min_pack(device) -> int:
    """The fewest pairs K7 packs into full warps on `device` (a CUDA
    device): PACK_WARPS_PER_SM warps of 32 on each of its streaming
    multiprocessors."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return PACK_WARPS_PER_SM * 32 * sms


def peel(state, cubes: PeelCubes, rec: PeelRecord, p: Peel, mode: int,
         tau_out=None, bin_out=None, w_out=None) -> None:
    """Peel the flagged lanes to every observer, in place: kernel K7 for a
    CUDA state, the plain version for a CPU state.  Mode DIRECT peels the
    lanes whose flag is set, STELLAR those of a stellar source with their
    record's surface sample; a scatter mode (RESONANCE, DUST, CONVERSION or
    a union of them, SCATTERED all three) the lanes whose flag, K4's kind
    of event, it has a bit of.
    tau_out (nobs*B f32), bin_out (nobs*B int32) and w_out (4*nobs*B f32),
    given together or not at all, receive the optical depth (>= TAU_STOP,
    not the whole sightline's, where the walk stopped there), the flat cube
    index and the deposits of each (observer, lane) pair that deposits:
    pair t = o*B + lane gets its scatt (scattering), Ha (conversion, the
    H-alpha band's dust event) or direc (direct) deposit at w_out[t] and, in a scattering with Stokes, its Q, U, V
    deposits at w_out[t + c*nobs*B], c = 1, 2, 3.  On the card K7 makes
    two launches where its LaneList runs the first pass (off the chord;
    each counted in LAUNCHES), one elsewhere."""
    if state.device.type == 'cpu':
        peel_plain(state, cubes, rec, p, mode, tau_out, bin_out, w_out)
        return
    out = () if tau_out is None else (tau_out, bin_out, w_out)
    kbuild.require_cuda('peel', state.x, rec.flag, *p.device_tensors(),
                        *(t for _, t in cubes.items()), *out)
    name = 'peel_stellar' if mode == STELLAR else 'peel'
    n = p.nobs * state.batch
    assert n < 2 ** 31, f'K7: {n} pairs do not fit an int32 index'
    # a deposit's key, the flat cube bin (+ n_bins for Ha), is an int32
    ha = p.lyb and mode not in (DIRECT, STELLAR)
    assert (2 if ha else 1) * p.n_bins < 2 ** 31, \
        f'K7: {p.n_bins} cube bins do not fit an int32 key'
    order, parity, sample = (None, 0, None) if p.chord else \
        p.lane_list(state).take(mode, p.nobs, min_pack(state.device))
    stream = torch.cuda.current_stream(state.device)
    kbuild.check(kbuild.library().lart_peel(
        state.lane_pointers, rec.pointers, state.batch, mode,
        ctypes.byref(p.grid.c_grid_params),
        ctypes.byref(p.c_params(cubes, out)), n_components(p, mode),
        None if order is None else order.data_ptr(), parity,
        min_pack(state.device), stream.cuda_stream), name)
    kbuild.LAUNCHES[name] += 1 if order is None else 2
    if sample is not None:
        sample(stream)
