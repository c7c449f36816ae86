"""Resonant scattering and dust events (kernel K4).

Counterpart of make_scatter / scatter (lart_tpu/transport/engine.py:1838,
:2087) for line types 1, 2, 4, 5, 6, 7 and 8, with and without H2
pumping: redistribute
(:1931-2086, physics/line.py), rand_resonance_cost with the event's E1,
phi = 2 pi xi, the perpendicular atom velocity with the core-skip boost
(:2197-2205) scaled by the redistribution's perp_scale, xfreq_new, with
recoil xfreq_new - (g0 / D)(1 - cos theta) (:2224-2229), rotate_direction
(:1854) and the next optical depth.

With use_stokes (:2165-2190, :2231-2265, :2486-2496) the azimuth is drawn
by rejection from 1 + (S12/S11)(Q cos 2phi + U sin 2phi) over
scatter_rounds rounds (a lane that fails them stays AT_SCATTER, as one that
fails the u_par rounds does), and the direction, the reference triad
(m, n) and the Stokes vector turn together; the triad is re-orthonormalized
against f32 drift in lart_tpu's order.

With dust (DGR > 0) an event is a dust event with probability
kap_D / (kap_HI + kap_D), kap_HI = rk H(x, a) and kap_D the cell's rhokapD
(the constants sphere_rho and sphere_rhoD on the uniform-sphere fast path;
:2111-2142).  A dust event absorbs with probability 1 - albedo (the lane
dies and its weight goes to Jabs at the lab frequency of its cell), unless
use_reduced_wgt, where nothing is absorbed: the lane's weight times
1 - albedo goes to Jabs and the scattered lane keeps the weight times the
albedo (:2278-2281, :2341, :2446-2447).  A dust scattering keeps xfreq and
turns the direction by Henyey-Greenstein with the resonance branch's
azimuth (:2330-2333), or, with use_stokes, by the tabulated Mueller matrix:
cos(theta) from physics.mueller.sample_cost, the azimuth by rejection as
above with the table's S12/S11 (a lane that fails stays AT_SCATTER), the
triad turned without re-orthonormalization and the Stokes vector through
S11, S12, S33, S34 (:2282-2328).  nscatt_dust sums the weight of every
dust event, absorptions included (:2373-2377).

With peel-off on, the scatter writes a PeelRecord: the kind of each lane's
event (1 a resonance scattering, 2 a dust scattering, 0 neither), the
pre-scatter direction (with use_stokes also the triad and Stokes vector)
and, at a resonance, this event's xfreq_atom and atom velocity
(:2207-2218) and, for line types 2, 4, 5 and 6, its phase weights E1, E2,
E3, which the peel (kernel K7) reads right after.  A dust peel
reads the lane's weight after the scatter, which under use_reduced_wgt is
already the weight times the albedo that lart_tpu peels with (:2342-2347).

At non-uniform temperature the damping a and Doppler width D of the
lane's cell (engine.py:2107-2108; a Cartesian cell's, gathered from the
grid's per-cell arrays, or an AMR leaf's) replace the reference ones in
the local core-skip's a rk dl, the event split, the profile, the
redistribution (every line type's offsets dnu / D), H2's x_h2 and ratio,
the recoil, and the lab frequency (x + u) D / Dfreq_ref of Jabs and of a
conversion's H-alpha photon.

On the octree AMR grid a lane's cell is an octree node: rhokap, rhokapD
and the velocities are its leaf's (none in a gap cell), and the local
core-skip's dl is the distance to the node's nearest face (:1880-1887).

On a clump medium (engine.py:2087-2105, :2533-2540) a lane's cell is its
clump: in overlap mode the scatter first draws the owner among the clumps
containing the point, opacity-weighted at each clump's local frequency
(clump_sample_owner, csrc/clump.cuh), from the first uniform of Philox
block 4 rounds + 7, after every block an earlier slice draws, so the other
grids draw as before; in non-overlap mode the flight's clump is the owner.
Then, in a moving medium or where the clumps' temperature is not the
reference one, the lane's frequency moves into the owner's frame and
Doppler units, (x - u) r_loc, before the event split, and back, x' / r_loc
+ u' with u' along the new direction, afterwards, on every lane that was
AT_SCATTER; the profile, the redistribution, the recoil and Jabs take the
clumps' a_cl and D_cl, the event split each clump's rhokap and rhokapD.  A
dust event's record keeps the lane's frequency in the owner's units for the
peel (xatom), as lart_tpu peels it before the shift back.

Core-skip (local_xcrit, :1872-1905): a lane with |x| < xcrit draws its
perpendicular speed as sqrt(xcrit^2 - log xi).  core_skip_global takes the
grid's xcrit; the local one is cbrt(a rk dl) / 5 where a rk dl > 1, dl the
distance to the nearest face of the lane's cell and rk the cell's rhokap,
or the constant sphere_rho on the uniform-sphere fast path (the scatter
point may sit in a voxel just outside the voxelized ball).

scatter_rounds rejection rounds of the u_par sampler run per call; a lane
still rejected stays AT_SCATTER and retries next cycle.  Uniforms come
from Philox stream STREAM_SCATTER at counter (lane, counter, block): block
r feeds round r, block `rounds` the angles, block rounds + 1 the next tau,
and with use_stokes block rounds + 2 + r the azimuth round r.  The dust
draws come after every block a lane without dust may draw: block
D = 2 rounds + 2 the event split, the absorption and the HG cos(theta),
block D + 1 the Mueller cos(theta), block D + 2 + r its azimuth round r.  So
a run without dust draws as before; a dust scattering reuses block
`rounds` (HG's azimuth) and rounds + 1 (its next tau).  Core-skip draws
nothing new.  A line of type 2 to 7 draws its upper level and downward
branch from block 3 rounds + 4, after the last Mueller azimuth block, so
a Ly-alpha run draws as before.

H2 pumping (engine.py:2111-2150, :2383-2435, :2480-2485): an event is an
H2 one with probability kap_H2 / (kap_HI + kap_H2 + kap_D), kap_H2 = rk
times the H2 multiplier; the dust split then runs on the rest.  An H2
event picks its line by the two lines' weights, is destroyed with
probability 1 - p_scat of that line (the lane dies, W_H2abs), else draws
u_par on the H2 line (x_h2 = (x - dnu / D) ratio, that line's damping;
a lane that fails the rounds stays AT_SCATTER), an isotropic direction
and the frequency x_h2' / ratio + dnu / D; W_H2pump sums the weight of
every H2 event by line, W_H2scat and nscatt_gas that of the scattered
ones.  Its uniforms take the blocks after every block an earlier slice
draws: H = 3 rounds + 5 the split, the line, the destruction and the
cosine, H + 1 the azimuth, the atom's perpendicular angle and speed,
H + 2 + r its u_par round r; so a run without H2 draws as before.

With calcP on a grid that bins it (transport/jpa.py), each resonance
scattering (a Ly-beta conversion too) in a cell with rhokap_phys =
rhokap D / cross0 > 0 adds wgt / rhokap_phys to Pa at the bin of its cell
(engine.py:2541-2547); rhokap is then the grid's, on the uniform-sphere
fast path too, whose constant sphere_rho only the event split and the
core-skip take.

Line type 8 (Ly-beta; engine.py:2053-2065, :2143-2150, :2270-2372,
:2510-2528): a resonance redistributes as type 1 and converts to H-alpha
with probability P_down[1] (the first uniform of block 3 rounds + 4,
physics/line.py); a conversion takes no recoil, and sets the lane's band
to 2 with the lab frequency (x_new - x_atom) + u.k of the new direction,
W_conv summing its weight.  A lane of the H-alpha band only meets dust:
its events are dust events with albedo_Ha and hgg_Ha, an absorption
going to Jabs_Ha at its (lab) frequency; W_abs1 and W_abs2 sum each
band's absorbed weight.  The peel record marks a conversion
EVENT_CONVERSION (the peel then casts the newborn H-alpha photon, not the
resonance).

With save_all_photons (tallies.allph, transport/allph.py) each resonance
scattering adds one to the lane's nsg and each dust scattering one to its
nsd (events, not weight), and a lane absorbed by dust or destroyed by H2
writes its death row from its state before the event at the lab frequency
(x + u) D / D_ref of its cell (engine.py:2455-2480).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..kernels import build as kbuild
from ..physics import h2 as ph2
from ..physics import line as pline
from ..physics import mueller as pmueller
from ..physics import samplers
from ..physics.rng import STREAM_SCATTER, uniforms
from .allph import count_events, record_deaths
from .flight import (AllPhC, AmrC, AmrGrid, ClumpC, ClumpGrid, JpaC, div,
                     doppler_ratio, dot3, f32, freq_floor, recip32)
from .jpa import JpaBins, block_plan, deposit_scatterings
from .state import AT_SCATTER, DEAD, FLYING, BatchState, Tallies

TINY = 1e-30
CORE_SKIP_OFF, CORE_SKIP_LOCAL, CORE_SKIP_GLOBAL = 0, 1, 2
DUST_OFF, DUST_HG, DUST_MUELLER = 0, 1, 2
# the record's kind of event (PeelRecord.flag)
EVENT_RESONANCE, EVENT_DUST, EVENT_CONVERSION = 1, 2, 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def dust_mode(cfg, meta) -> int:
    """How dust scatters in a config: not at all, by Henyey-Greenstein, or
    with use_stokes by the Mueller table (engine.py:1845-1852)."""
    if not meta.has_dust:
        return DUST_OFF
    return DUST_MUELLER if cfg.par.use_stokes else DUST_HG


class ScatterC(ctypes.Structure):
    """csrc/scatter_lya.cu struct ScatterParams, field for field."""
    _fields_ = [('rhokap', _P), ('rhokapD', _P), ('vfx', _P), ('vfy', _P),
                ('vfz', _P), ('nscatt_gas', _P), ('nscatt_events', _P),
                ('Jabs', _P), ('nscatt_dust', _P),
                ('mueller', pmueller.MuellerC),
                ('rounds', _I), ('stokes', _I), ('core_skip', _I),
                ('dust', _I), ('reduced_wgt', _I), ('nxfreq', _I),
                ('n', _I * 3), ('a', _F), ('xcrit', _F), ('xcrit2', _F),
                ('rk_const', _F), ('rkD_const', _F), ('albedo', _F),
                ('one_m_albedo', _F),
                ('hgg', _F), ('xfreq_min', _F), ('dxfreq', _F),
                ('amin', _F * 3), ('d', _F * 3), ('Dfreq', _F),
                ('recoil', _I), ('line', pline.LineC), ('h2', ph2.H2C),
                ('Jabs_Ha', _P), ('W_conv', _P), ('W_abs1', _P),
                ('W_abs2', _P), ('W_H2abs', _P), ('W_H2scat', _P),
                ('W_H2pump', _P), ('albedo_Ha', _F),
                ('one_m_albedo_Ha', _F), ('hgg_Ha', _F), ('amr', AmrC),
                ('clump', ClumpC), ('cell_a', _P), ('cell_D', _P),
                ('jpa', JpaC), ('allph', AllPhC)]


@dataclasses.dataclass(frozen=True, eq=False)
class ScatterParams:
    a: float          # Voigt damping parameter (uniform temperature)
    rounds: int       # rejection rounds per call
    stokes: bool = False       # use_stokes: azimuth, triad and Stokes
    core_skip: int = CORE_SKIP_OFF
    xcrit: float = 0.0         # core_skip_global's threshold and its square
    xcrit2: float = 0.0
    rk_const: float = -1.0     # > 0: sphere_rho on the sphere fast path
    rkD_const: float = 0.0     #   and sphere_rhoD there
    # the flat grid where the scatter gathers it: local core-skip or dust,
    # off the sphere fast path
    rhokap: Optional[torch.Tensor] = None
    n: tuple = (1, 1, 1)
    amin: tuple = (0.0, 0.0, 0.0)
    d: tuple = (1.0, 1.0, 1.0)
    dust: int = DUST_OFF
    albedo: float = 0.0
    hgg: float = 0.0
    reduced_wgt: bool = False
    rhokapD: Optional[torch.Tensor] = None   # flat, dust off the sphere
    vel: Optional[tuple] = None   # flat velocities for Jabs, moving medium
    mueller: Optional[pmueller.MuellerTable] = None   # DUST_MUELLER
    xfreq_min: float = 0.0     # the Jabs frequency bins
    dxfreq: float = 1.0
    nxfreq: int = 0
    line: Optional[pline.LineConsts] = None   # the line (from_config)
    Dfreq: float = 1.0         # Doppler width of every cell (Hz)
    recoil: bool = False
    h2: Optional[ph2.H2Consts] = None   # H2 pumping
    albedo_Ha: float = 0.0     # line type 8: the H-alpha band's dust
    hgg_Ha: float = 0.0
    amr: Optional[AmrGrid] = None   # the octree: the arrays are per leaf
    clump: Optional[ClumpGrid] = None   # the clumps: the arrays per clump
    # a Cartesian grid at non-uniform temperature: each cell's damping and
    # Doppler width, flat; None at uniform temperature
    cell_a: Optional[torch.Tensor] = None
    cell_D: Optional[torch.Tensor] = None
    # the Pa map (calcP on a grid that bins it): rhokap is then the grid's,
    # also on the sphere fast path, whose voxels Pa divides by
    jpa: Optional[JpaBins] = None

    @classmethod
    def from_config(cls, cfg, meta, grid=None, uniform_sphere=False,
                    cmeta=None) -> 'ScatterParams':
        """Constants of a config that engine.check_supported accepted;
        `uniform_sphere` is engine.uniform_sphere_fastpath(cfg, meta); on a
        clump medium grid is the ClumpDevice and cmeta its ClumpMeta."""
        par = cfg.par
        mode = CORE_SKIP_OFF
        if par.core_skip:
            mode = CORE_SKIP_GLOBAL if par.core_skip_global \
                else CORE_SKIP_LOCAL
        dust = dust_mode(cfg, meta)
        h2 = ph2.H2Consts.from_config(cfg)
        gather = (mode == CORE_SKIP_LOCAL or dust or h2 is not None) \
            and not uniform_sphere
        jpa = JpaBins.from_config(cfg, meta)
        if jpa is not None and not jpa.Pa:
            jpa = None
        lt8 = cfg.line.line_type == 8
        amr = AmrGrid.from_meta(meta, grid) if meta.grid_type == 'amr' \
            else None
        clump = ClumpGrid.from_meta(cfg, meta, cmeta, grid) \
            if meta.grid_type == 'clump' else None

        def flat(t):
            return t.reshape(-1).contiguous()
        cart_T = meta.grid_type == 'cartesian' and grid is not None \
            and grid.Dfreq is not None
        vel = None
        # the velocities of Jabs, a conversion's lab frequency and a death
        # row's
        if (dust or lt8 or par.save_all_photons) and not meta.static_medium:
            vel = (grid.vx, grid.vy, grid.vz) if clump is not None else \
                tuple(flat(v) for v in (grid.vfx, grid.vfy, grid.vfz))
        return cls(a=float(meta.voigt_a_ref),
                   rounds=int(par.scatter_rounds),
                   stokes=bool(par.use_stokes), core_skip=mode,
                   xcrit=float(meta.xcrit), xcrit2=float(meta.xcrit2),
                   rk_const=float(meta.sphere_rho) if uniform_sphere
                   else -1.0,
                   rkD_const=float(meta.sphere_rhoD) if uniform_sphere
                   else 0.0,
                   rhokap=flat(grid.rhokap) if gather or jpa else None,
                   n=(meta.nx, meta.ny, meta.nz),
                   amin=(meta.xmin, meta.ymin, meta.zmin),
                   d=(meta.dx, meta.dy, meta.dz),
                   dust=dust, albedo=float(par.albedo), hgg=float(par.hgg),
                   reduced_wgt=bool(par.use_reduced_wgt),
                   rhokapD=flat(grid.rhokapD) if dust and gather else None,
                   vel=vel,
                   mueller=pmueller.MuellerTable.for_config(
                       cfg, grid.rhokap.device) if dust else None,
                   xfreq_min=meta.xfreq_min, dxfreq=meta.dxfreq,
                   nxfreq=meta.nxfreq,
                   line=pline.LineConsts.from_config(cfg),
                   Dfreq=float(meta.Dfreq_ref), recoil=bool(par.recoil),
                   h2=h2, albedo_Ha=float(par.albedo_Ha),
                   hgg_Ha=float(par.hgg_Ha), amr=amr, clump=clump,
                   cell_a=flat(grid.voigt_a) if cart_T else None,
                   cell_D=flat(grid.Dfreq) if cart_T else None, jpa=jpa)

    @property
    def dust_block(self) -> int:
        """The first Philox block of the dust draws."""
        return 2 * self.rounds + 2

    @property
    def h2_block(self) -> int:
        """The first Philox block of the H2 draws."""
        return 3 * self.rounds + 5

    @property
    def owner_block(self) -> int:
        """The Philox block of the clump owner draw (overlap mode)."""
        return 4 * self.rounds + 7

    @property
    def lyb(self) -> bool:
        """Line type 8: Ly-beta with its H-alpha band."""
        return self.line.line_type == 8

    def one_m_albedo(self, band2: bool = False) -> float:
        """1 - albedo of a band, rounded as lart_tpu rounds it: in f64
        and once to f32 where the albedo is a Python float, in f32 from the
        f32 albedo where line type 8 makes it a per-lane array."""
        a = self.albedo_Ha if band2 else self.albedo
        if not self.lyb:
            return pline.f32(1.0 - a)
        return float(np.float32(1.0) - np.float32(a))

    def flat(self, s: BatchState) -> torch.Tensor:
        """The lanes' flat cell index, clamped like jnp.take mode='clip'
        (on the AMR grid, the leaf of the lane's node, -1 in a gap; on a
        clump medium its clump, -1 in the vacuum)."""
        if self.clump is not None:
            return s.ic.long()
        if self.amr is not None:
            return self.amr.leaf(s.ic)
        nx, ny, nz = self.n
        f = (s.ic.long() * ny + s.jc) * nz + s.kc
        return torch.clamp(f, 0, nx * ny * nz - 1)

    def gather(self, arr: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """arr at the lanes' cells f = flat(s) (0 in an AMR gap or in the
        vacuum between clumps)."""
        if self.clump is not None:
            return self.clump.gather(arr, f)
        return arr[f] if self.amr is None else self.amr.gather(arr, f, 0.0)

    def lane_a_D(self, s: BatchState):
        """(damping, Doppler width) of each lane's cell: the reference
        floats, or per-lane tensors on a Cartesian or AMR grid at
        non-uniform temperature; the clumps' own on a clump medium."""
        if self.clump is not None:
            return f32(self.clump.a_cl), f32(self.clump.D_cl)
        if self.cell_D is not None:
            f = self.flat(s)
            return self.cell_a[f], self.cell_D[f]
        if self.amr is None:
            return self.a, self.Dfreq
        return self.amr.a_D(self.amr.leaf(s.ic), self.a, self.Dfreq)

    def vel_dot(self, s: BatchState) -> torch.Tensor:
        """u . k of each lane's cell along its direction (moving medium;
        a clump's in reference units, cell_velocity_dot)."""
        if self.clump is not None:
            return self.clump.vel_dot(s.ic.long(), s.kx, s.ky, s.kz, 'scale')
        f = self.flat(s)
        return (self.gather(self.vel[0], f) * s.kx
                + self.gather(self.vel[1], f) * s.ky
                + self.gather(self.vel[2], f) * s.kz)

    def device_tensors(self):
        out = tuple(t for t in (self.rhokap, self.rhokapD, self.cell_a,
                                self.cell_D) if t is not None)
        out += self.vel or ()
        out += () if self.amr is None else self.amr.dev.tensors()
        out += () if self.clump is None else self.clump.dev.tensors()
        return out + (self.mueller.tensors() if self.mueller else ())

    @functools.cached_property
    def _c_params(self) -> ScatterC:
        c = ScatterC()
        for f in ('rhokap', 'rhokapD', 'cell_a', 'cell_D'):
            t = getattr(self, f)
            setattr(c, f, None if t is None else t.data_ptr())
        if self.vel is not None:
            c.vfx, c.vfy, c.vfz = (v.data_ptr() for v in self.vel)
        if self.mueller is not None:
            c.mueller = self.mueller.c_struct
        c.rounds, c.stokes, c.core_skip = (self.rounds, int(self.stokes),
                                           self.core_skip)
        c.dust, c.reduced_wgt, c.nxfreq = (self.dust, int(self.reduced_wgt),
                                           self.nxfreq)
        c.n[:], c.amin[:], c.d[:] = self.n, self.amin, self.d
        for f in ('a', 'xcrit', 'xcrit2', 'rk_const',
                  'rkD_const', 'albedo', 'hgg', 'xfreq_min', 'dxfreq',
                  'Dfreq'):
            setattr(c, f, getattr(self, f))
        c.recoil = int(self.recoil)
        c.line = self.line.c_struct
        c.one_m_albedo = self.one_m_albedo()
        if self.h2 is not None:
            c.h2 = self.h2.c_struct
        if self.amr is not None:
            c.amr = self.amr.c_struct
        if self.clump is not None:
            c.clump = self.clump.c_struct
        c.albedo_Ha, c.hgg_Ha = self.albedo_Ha, self.hgg_Ha
        c.one_m_albedo_Ha = self.one_m_albedo(True)
        return c

    def c_params(self, tallies: Tallies) -> ScatterC:
        """The C struct with this call's tally pointers (the launch copies
        it, so the next call may overwrite them)."""
        c = self._c_params
        for f in ('nscatt_gas', 'nscatt_events', 'Jabs', 'nscatt_dust') \
                + self.tally_fields:
            setattr(c, f, getattr(tallies, f).data_ptr())
        if self.jpa is not None:
            c.jpa = self.jpa.c_struct(tallies)
        c.allph = AllPhC() if tallies.allph is None \
            else tallies.allph.c_struct
        return c

    @property
    def tally_fields(self) -> tuple:
        """The tallies of line type 8 and H2 this scatter adds to."""
        return ((('Jabs_Ha', 'W_conv', 'W_abs1', 'W_abs2') if self.lyb
                 else ())
                + (('W_H2abs', 'W_H2scat', 'W_H2pump') if self.h2 else ()))


def local_xcrit(s: BatchState, p: ScatterParams):
    """(xcrit, xcrit^2) of every lane (engine.py:1872-1905)."""
    if p.core_skip == CORE_SKIP_GLOBAL:
        return (torch.full_like(s.x, p.xcrit),
                torch.full_like(s.x, p.xcrit2))
    if p.amr is not None:
        # the distance to the node's nearest face (engine.py:1880-1887)
        d = p.amr.dev
        c = torch.clamp(s.ic.long(), 0, d.ncells - 1)
        dl = d.node_ch[c] - torch.maximum(torch.maximum(
            torch.abs(s.x - d.node_cx[c]), torch.abs(s.y - d.node_cy[c])),
            torch.abs(s.z - d.node_cz[c]))
    else:
        dl = None
        for pos, c, amin, d in zip((s.x, s.y, s.z), (s.ic, s.jc, s.kc),
                                   p.amin, p.d):
            f = amin + c.to(torch.float32) * d
            dla = torch.minimum(pos - f, f + d - pos)
            dl = dla if dl is None else torch.minimum(dl, dla)
    if p.rk_const > 0.0:
        rk = torch.full_like(s.x, p.rk_const)
    else:
        rk = p.gather(p.rhokap, p.flat(s))
    atau = p.lane_a_D(s)[0] * rk * torch.clamp_min(dl, 0.0)
    # torch has no cbrt: the f64 cube root rounded to f32
    cbrt = torch.pow(atau.double(), 1.0 / 3.0).float()
    xc = torch.where(atau > 1.0, div(cbrt, 5.0), torch.zeros_like(atau))
    return xc, xc * xc


def rotate_direction(kx, ky, kz, cost, sint, cosp, sinp):
    """New unit direction from scattering angles about (kx, ky, kz)."""
    near_pole = torch.abs(kz) >= 0.99999999999
    kr = torch.sqrt(torch.clamp_min(kx * kx + ky * ky, TINY))
    nkx = cost * kx + sint * (kz * kx * cosp - ky * sinp) / kr
    nky = cost * ky + sint * (kz * ky * cosp + kx * sinp) / kr
    nkz = cost * kz - sint * cosp * kr
    kx2 = torch.where(near_pole, sint * cosp, nkx)
    ky2 = torch.where(near_pole, sint * sinp, nky)
    kz2 = torch.where(near_pole, torch.where(kz > 0, cost, -cost), nkz)
    norm = torch.rsqrt(kx2 * kx2 + ky2 * ky2 + kz2 * kz2)
    return kx2 * norm, ky2 * norm, kz2 * norm


def azimuth_rounds(s: BatchState, S12o, u_rounds):
    """The azimuth by rejection from 1 + S12o (Q cos 2phi + U sin 2phi),
    one round per block of u_rounds (rounds, 4, B): (accepted, phi)."""
    pmag = torch.sqrt(s.Q * s.Q + s.U * s.U)
    acc = torch.zeros_like(s.x, dtype=torch.bool)
    phi = torch.zeros_like(s.x)
    for v in u_rounds:
        phi_p = samplers.TWOPI * v[0]
        prand = (1.0 + torch.abs(S12o) * pmag) * v[1]
        pcomp = 1.0 + S12o * (s.Q * torch.cos(2.0 * phi_p)
                              + s.U * torch.sin(2.0 * phi_p))
        take = ~acc & (prand <= pcomp)
        phi = torch.where(take, phi_p, phi)
        acc = acc | take
    return acc, phi


def scatter_plain(state: BatchState, tallies: Tallies, p: ScatterParams,
                  seed: int, counter: int, record=None) -> None:
    """Plain PyTorch scatter of every AT_SCATTER lane, in place; fills
    `record` (a PeelRecord) when it is given."""
    s = state
    lanes = torch.arange(s.batch, dtype=torch.int64, device=s.device)
    at_sc = s.phase == AT_SCATTER
    zero = torch.zeros_like(s.wgt)
    is_dust = is_h2 = torch.zeros_like(at_sc)
    lc = p.line
    b2 = s.iband == 2 if p.lyb else None
    cl = p.clump
    if cl is not None:
        clump_frame_in(s, p, seed, counter, lanes, at_sc)
    # the cell's damping and Doppler width; D / Dfreq_ref, 1 at uniform T
    a_c, D_c = p.lane_a_D(s)
    ratio = cl.d_ratio if cl is not None else doppler_ratio(D_c, p.Dfreq)
    if p.dust or p.h2 is not None:
        if p.rk_const > 0.0:
            rk = torch.full_like(s.x, p.rk_const)
            kap_D = torch.full_like(s.x, p.rkD_const)
        else:
            f = p.flat(s)
            rk = p.gather(p.rhokap, f)
            kap_D = p.gather(p.rhokapD, f) if p.dust else None
        kap_HI = rk * pline.line_profile_plain(lc, s.xfreq, a_c, D_c)
    if p.h2 is not None:
        # the H2 event split (engine.py:2121-2130)
        hu = uniforms(seed, STREAM_SCATTER, lanes, counter, p.h2_block)
        kap_H2 = rk * ph2.h2_kappa_plain(p.h2, s.xfreq, D_c)
        ktot = kap_HI + kap_H2
        if p.dust:
            ktot = ktot + kap_D
        is_h2 = at_sc & (hu[0] * torch.clamp_min(ktot, TINY) <= kap_H2)
    ud = None
    if p.dust:
        ud = uniforms(seed, STREAM_SCATTER, lanes, counter, p.dust_block)
        is_dust = at_sc & ~is_h2 & (
            ud[0] <= kap_D / torch.clamp_min(kap_HI + kap_D, TINY))
    if p.lyb:
        # every event of the H-alpha band is a dust event
        is_dust = torch.where(b2, at_sc, is_dust)
        is_h2 = is_h2 & ~b2
    is_res = at_sc & ~is_dust & ~is_h2
    u = uniforms(seed, STREAM_SCATTER, lanes, counter, range(p.rounds + 2))
    sel = None if lc.line_type == 1 else uniforms(
        seed, STREAM_SCATTER, lanes, counter, 3 * p.rounds + 4)
    red = pline.redistribute_plain(lc, s.xfreq, a_c, D_c,
                                   u[:p.rounds], sel, is_res)
    acc, uz, xfreq_atom = red.acc, red.uz, red.xatom
    E1, E2, E3 = red.E1, red.E2, red.E3

    xi = u[p.rounds]
    cost = samplers.rand_resonance_cost(xi[0], E1)
    cost2 = cost * cost
    sint = torch.sqrt(torch.clamp_min(1.0 - cost2, 0.0))
    if p.stokes:
        # the line's scattering matrix; the azimuth by rejection
        S22 = 0.75 * E1 * (cost2 + 1.0)
        S11 = S22 + E2
        S12 = 0.75 * E1 * (cost2 - 1.0)
        S33 = 1.5 * E1 * cost
        S44 = 1.5 * E3 * cost
        acc_phi, phi = azimuth_rounds(
            s, S12 / torch.clamp_min(S11, TINY),
            uniforms(seed, STREAM_SCATTER, lanes, counter,
                     range(p.rounds + 2, 2 * p.rounds + 2)))
        acc = acc & acc_phi
    else:
        phi = samplers.TWOPI * xi[1]
    do_res = is_res & acc
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    phi2 = samplers.TWOPI * xi[2]
    boost = torch.zeros_like(s.xfreq)
    if p.core_skip != CORE_SKIP_OFF:
        xcrit, xcrit2 = local_xcrit(s, p)
        boost = torch.where(torch.abs(s.xfreq) < xcrit, xcrit2, boost)
    uxy = torch.sqrt(boost - torch.log(xi[3]))
    ux = uxy * torch.cos(phi2) * red.perp
    uy = uxy * torch.sin(phi2) * red.perp
    xfreq_new = xfreq_atom + uz * cost + (ux * cosp + uy * sinp) * sint
    conv = red.conv if p.lyb else None
    if p.recoil:
        # (g0 / D)(1 - cos theta), g0 / D an f32 division (engine.py:2228);
        # none at a conversion
        g0 = torch.as_tensor(red.g0, dtype=torch.float32, device=s.device)
        Dt = D_c if isinstance(D_c, torch.Tensor) else torch.full(
            (), D_c, device=s.device)
        shifted = xfreq_new - (g0 / Dt) * (1.0 - cost)
        xfreq_new = shifted if conv is None else torch.where(
            conv, xfreq_new, shifted)
    tau_next = -torch.log(torch.clamp_min(u[p.rounds + 1, 0], 1e-12))

    turned = ('kx', 'ky', 'kz') + (('mx', 'my', 'mz', 'nnx', 'nny', 'nnz',
                                    'Q', 'U', 'V') if p.stokes else ())
    if p.stokes:
        new = stokes_turn(s, cost, sint, cosp, sinp, S11, S12, S22, S33, S44)
    else:
        new = rotate_direction(s.kx, s.ky, s.kz, cost, sint, cosp, sinp)
    dust_sc = absorbed = torch.zeros_like(at_sc)
    if p.dust:
        dust_sc, absorbed, dust_new = dust_event(s, tallies, p, seed,
                                                 counter, ud, is_dust, cosp,
                                                 sinp, b2, ratio)
    h2_sc = h2_destroy = torch.zeros_like(at_sc)
    if p.h2 is not None:
        h2_sc, h2_destroy, h2_new = h2_event(s, tallies, p, seed, counter,
                                             hu, is_h2, D_c)
    if tallies.allph is not None:
        # absorbed or destroyed: the death rows from the state before the
        # event, at the lab frequency of the lane's cell (engine.py:
        # 2455-2464)
        xl = s.xfreq if p.vel is None else s.xfreq + p.vel_dot(s)
        record_deaths(tallies.allph, s, absorbed | h2_destroy, xl * ratio)
    res_kind = torch.full_like(s.phase, EVENT_RESONANCE)
    if conv is not None:
        res_kind = torch.where(conv, EVENT_CONVERSION, res_kind)
    kind = torch.where(do_res, res_kind,
                       torch.where(dust_sc, EVENT_DUST, 0))

    if record is not None:
        # the event as the peel sees it: before the turn
        record.flag.copy_(kind.to(torch.int32))
        for f in turned:
            getattr(record, f).copy_(getattr(s, f))
        if cl is not None:
            # a dust event peels at the lane's frequency in the owner's units
            xfreq_atom = torch.where(dust_sc, s.xfreq, xfreq_atom)
        for f, v in (('xatom', xfreq_atom), ('ux', ux), ('uy', uy),
                     ('uz', uz)):
            getattr(record, f).copy_(v)
        if lc.per_lane_E:
            for f, v in (('E1', E1), ('E2', E2), ('E3', E3)):
                getattr(record, f).copy_(torch.where(do_res, v, 0.0))

    for name, v in zip(turned, new):
        cur = getattr(s, name)
        v = torch.where(do_res, v, cur)
        if p.dust and name in dust_new:
            v = torch.where(dust_sc, dust_new[name], v)
        if p.h2 is not None and name in h2_new:
            v = torch.where(h2_sc, h2_new[name], v)
        cur.copy_(v)
    done = do_res | dust_sc | absorbed | h2_sc | h2_destroy
    s.phase.copy_(torch.where(absorbed | h2_destroy, DEAD,
                              torch.where(done, FLYING, s.phase))
                  .to(torch.int32))
    xf = torch.where(do_res, xfreq_new, s.xfreq)
    if p.h2 is not None:
        xf = torch.where(h2_sc, h2_new['xfreq'], xf)
    if conv is not None:
        # 3p -> 2s: the H-alpha photon's lab frequency along the new
        # direction (engine.py:2510-2528)
        did_conv = do_res & conv
        u_new = p.vel_dot(s) if p.vel is not None else zero
        xf = torch.where(did_conv, (xfreq_new - xfreq_atom + u_new) * ratio,
                         xf)
        s.iband.copy_(torch.where(did_conv, 2, s.iband).to(torch.int32))
        tallies.W_conv += torch.where(did_conv, s.wgt, zero).sum()
    s.xfreq.copy_(xf)
    if p.dust and p.reduced_wgt:
        s.wgt.copy_(torch.where(dust_sc, s.wgt * dust_new['albedo'], s.wgt))
    s.tau_target.copy_(torch.where(done, tau_next, s.tau_target))
    s.tau_run.copy_(torch.where(done, torch.zeros_like(s.tau_run),
                                s.tau_run))
    tallies.nscatt_gas += torch.where(do_res, s.wgt, zero).sum()
    tallies.nscatt_events += do_res.sum(dtype=torch.float32)
    if tallies.allph is not None:
        count_events(s, do_res, dust_sc)
    if p.jpa is not None:
        # the resonance scatterings per atom, at the scattering cell
        # (engine.py:2541-2547); a conversion counts as one
        deposit_scatterings(p.jpa, tallies, do_res, (s.ic, s.jc, s.kc),
                            s.wgt, p.rhokap[p.flat(s)], D_c)
    if cl is not None and cl.shift:
        # back into global units along the new direction (engine.py:
        # 2533-2540), on every lane that was AT_SCATTER
        u_out = cl.vel_dot(s.ic.long(), s.kx, s.ky, s.kz, 'scale')
        s.xfreq.copy_(torch.where(
            at_sc, s.xfreq * recip32(cl.r_loc) + u_out, s.xfreq))


def clump_owner_plain(cl: ClumpGrid, lc, pos, k, xfreq, xi) -> torch.Tensor:
    """clump_sample_owner (engine.py:487-545) at the points pos along k at
    the global frequencies xfreq, with the uniforms xi: the first clump
    whose running sum of opacities (index order, each clump at its local
    frequency, 0 where it does not contain the point) reaches xi times the
    total, over all clumps (dense; no gas: the first containing clump, else
    -1) or over the CSR cell's candidates (no gas: the first candidate)."""
    d = cl.dev
    if cl.dense:
        cands = torch.arange(cl.n, device=xfreq.device)[None, :].expand(
            xfreq.shape[0], cl.n)
        qx, qy, qz, qr2 = d.x[None, :], d.y[None, :], d.z[None, :], \
            d.r2[None, :]
    else:
        _, cell = cl.csr_cell(*pos)
        cands = torch.stack([cl.candidate(cell, q) for q in range(cl.K)], 1)
        qx, qy, qz, qr2 = cl.centre(cands)
    ex, ey, ez = (v[:, None] - c for v, c in zip(pos, (qx, qy, qz)))
    contains = dot3(ex, ex, ey, ey, ez, ez) < qr2
    if not cl.dense:
        contains = contains & (cands >= 0)
    if cl.moving:
        u = cl.vel_dot(cands, *(v[:, None] for v in k), form='div')
        kq = cl.kappa(lc, cands, cl.local_x(xfreq[:, None], u))
    else:
        # one profile a lane: every clump sees the same local frequency
        prof = pline.line_profile_plain(lc, cl.local_x(xfreq), f32(cl.a_cl),
                                        f32(cl.D_cl))[:, None]
        kq = cl.gather(d.rhokap, cands) * prof
        if cl.has_dust:
            kq = kq + cl.gather(d.rhokapD, cands)
    kq = torch.where(contains, kq, torch.zeros_like(kq))
    cum = _running_sum(kq)
    tot = cum[:, -1]
    pick = torch.argmax((cum >= (xi * tot)[:, None]).to(torch.int8), dim=1)
    owner = torch.gather(cands, 1, pick[:, None])[:, 0]
    if cl.dense:
        first = torch.argmax(contains.to(torch.int8), dim=1)
        none = torch.where(contains.any(dim=1), first, torch.full_like(first,
                                                                       -1))
    else:
        none = cands[:, 0]
    return torch.where(tot > 0.0, owner, none).to(torch.int32)


def _running_sum(kq: torch.Tensor) -> torch.Tensor:
    """The running sums of kq (B, m) along its columns in index order, one
    f32 add at a time."""
    out, acc = [], torch.zeros_like(kq[:, 0])
    for j in range(kq.shape[1]):
        acc = acc + kq[:, j]
        out.append(acc)
    return torch.stack(out, 1)


def clump_frame_in(s: BatchState, p: ScatterParams, seed: int, counter: int,
                   lanes, at_sc) -> None:
    """The clump branch before the event split (engine.py:2087-2105): the
    owner drawn in overlap mode, then the lane's frequency in the owner's
    frame and Doppler units, on the AT_SCATTER lanes."""
    cl = p.clump
    if cl.overlap:
        # the AT_SCATTER lanes only: a lane's draw depends on no other
        idx = at_sc.nonzero().squeeze(1)
        xi = uniforms(seed, STREAM_SCATTER, lanes[idx], counter,
                      p.owner_block)[0]
        sub = [v[idx] for v in (s.x, s.y, s.z, s.kx, s.ky, s.kz, s.xfreq)]
        s.ic[idx] = clump_owner_plain(cl, p.line, sub[:3], sub[3:6], sub[6],
                                      xi)
    if cl.shift:
        u_in = cl.vel_dot(s.ic.long(), s.kx, s.ky, s.kz, 'scale')
        s.xfreq.copy_(torch.where(at_sc, cl.local_x(s.xfreq, u_in), s.xfreq))


def h2_event(s: BatchState, tallies: Tallies, p: ScatterParams, seed: int,
             counter: int, hu, is_h2, D: float):
    """The H2 branch of the plain scatter (engine.py:2383-2435) on the
    pre-scatter state, hu the uniforms of block h2_block: W_H2abs,
    W_H2scat, W_H2pump and the scattered weight in nscatt_gas are tallied
    here; returns (scattered, destroyed, the scattered lanes' new
    direction and frequency by field name).  D is the cells' Doppler
    width."""
    lanes = torch.arange(s.batch, dtype=torch.int64, device=s.device)
    h = p.h2
    hv = uniforms(seed, STREAM_SCATTER, lanes, counter, p.h2_block + 1)
    zero = torch.zeros_like(s.wgt)
    w0, w1 = ph2.h2_line_weights_plain(h, s.xfreq, D)
    sel2 = hu[1] * torch.clamp_min(w0 + w1, TINY) > w0

    def pick(v):
        return torch.where(sel2, v[1], v[0])
    destroy = is_h2 & (hu[2] > pick(h.p_scat))
    sc = is_h2 & ~destroy
    ratio = ph2.h2_ratio(h, D)
    dx_l = div(pick(h.dnu), D)
    x_h2 = (s.xfreq - dx_l) * ratio
    env = samplers.vz_envelope(x_h2, pick(h.a_damp))
    acc, uz = torch.zeros_like(sc), zero
    for v in uniforms(seed, STREAM_SCATTER, lanes, counter,
                      range(p.h2_block + 2, p.h2_block + 2 + p.rounds)):
        acc, uz = samplers.vz_round_xi(v, env, acc, uz, sc)
    sc = sc & acc
    cost = 2.0 * hu[3] - 1.0
    sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
    phi = samplers.TWOPI * hv[0]
    phi2 = samplers.TWOPI * hv[1]
    uxy = torch.sqrt(-torch.log(hv[2]))
    ux, uy = uxy * torch.cos(phi2), uxy * torch.sin(phi2)
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    x_new = (x_h2 - uz) + uz * cost + (ux * cosp + uy * sinp) * sint
    new = dict(zip(('kx', 'ky', 'kz'), rotate_direction(
        s.kx, s.ky, s.kz, cost, sint, cosp, sinp)))
    new['xfreq'] = div(x_new, ratio) + dx_l
    tallies.W_H2abs += torch.where(destroy, s.wgt, zero).sum()
    tallies.W_H2scat += torch.where(sc, s.wgt, zero).sum()
    tallies.W_H2pump.index_add_(0, sel2.long(),
                                torch.where(is_h2, s.wgt, zero))
    tallies.nscatt_gas += torch.where(sc, s.wgt, zero).sum()
    return sc, destroy, new


def dust_event(s: BatchState, tallies: Tallies, p: ScatterParams, seed: int,
               counter: int, ud, is_dust, cosp, sinp, b2=None, ratio=1.0):
    """The dust branch of the plain scatter (engine.py:2270-2381) on the
    pre-scatter state: Jabs (and, line type 8, Jabs_Ha, W_abs1, W_abs2 of
    the bands; b2 marks the H-alpha band's lanes) and nscatt_dust are
    tallied here; returns (scattered, absorbed, the scattered lanes' new
    direction, and with Stokes triad and Stokes vector, by field name, with
    the albedo of each lane under 'albedo').  ratio is D / Dfreq_ref of the
    lanes' cells."""
    if b2 is None:
        albedo, one_m = p.albedo, p.one_m_albedo()
    else:
        def band(v1, v2):
            return torch.where(b2, float(np.float32(v2)),
                               float(np.float32(v1))).to(torch.float32)
        albedo = band(p.albedo, p.albedo_Ha)
        one_m = band(p.one_m_albedo(), p.one_m_albedo(True))
    if p.reduced_wgt:
        absorbed = torch.zeros_like(is_dust)
    else:
        absorbed = is_dust & (ud[1] > albedo)
    dust_sc = is_dust & ~absorbed
    if p.dust == DUST_MUELLER:
        lanes = torch.arange(s.batch, dtype=torch.int64, device=s.device)
        D = p.dust_block
        um = uniforms(seed, STREAM_SCATTER, lanes, counter, D + 1)
        cost = pmueller.sample_cost(p.mueller, um[0], um[1], um[2])
        sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
        S11, S12, S33, S34 = pmueller.interp_S(p.mueller, cost)
        accp, phi = azimuth_rounds(
            s, S12 / torch.clamp_min(S11, TINY),
            uniforms(seed, STREAM_SCATTER, lanes, counter,
                     range(D + 2, D + 2 + p.rounds)))
        dust_sc = dust_sc & accp
        new = mueller_turn(s, cost, sint, torch.cos(phi), torch.sin(phi),
                           S11, S12, S33, S34)
    else:
        cost = samplers.rand_henyey_greenstein(ud[2], p.hgg)
        if b2 is not None:
            cost = torch.where(b2, samplers.rand_henyey_greenstein(
                ud[2], p.hgg_Ha), cost)
        sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
        new = dict(zip(('kx', 'ky', 'kz'),
                       rotate_direction(s.kx, s.ky, s.kz, cost, sint, cosp,
                                        sinp)))
    new['albedo'] = albedo
    # Jabs at the lab frequency of the lane's cell (a clump's: x_loc + u in
    # reference units, times D_cl / Dfreq_ref, as lart_tpu)
    xlab = s.xfreq
    if p.vel is not None:
        xlab = s.xfreq + p.vel_dot(s)
    xlab = xlab * ratio
    zero = torch.zeros_like(s.wgt)
    wab = s.wgt * one_m if p.reduced_wgt else s.wgt
    absorbing = is_dust & (absorbed | p.reduced_wgt)
    if b2 is None:
        _bin_add(tallies.Jabs, p, xlab, torch.where(absorbing, wab, zero))
    else:
        # the H-alpha band's frequency is a lab one already
        _bin_add(tallies.Jabs, p, xlab,
                 torch.where(absorbing & ~b2, wab, zero))
        _bin_add(tallies.Jabs_Ha, p, s.xfreq,
                 torch.where(absorbing & b2, wab, zero))
        tallies.W_abs1 += torch.where(absorbing & ~b2, wab, zero).sum()
        tallies.W_abs2 += torch.where(absorbing & b2, wab, zero).sum()
    tallies.nscatt_dust += torch.where(is_dust, s.wgt, zero).sum()
    return dust_sc, absorbed, new


def _bin_add(J, p: ScatterParams, xlab, w) -> None:
    """Add w into the spectrum J at the bins of the lab frequencies xlab,
    the lanes off the frequency grid left out."""
    fx, ina = freq_floor(p, xlab)
    J.index_add_(0, torch.clamp(fx, 0, p.nxfreq - 1).long(),
                 torch.where(ina, w, torch.zeros_like(w)))


def mueller_turn(s: BatchState, cost, sint, cosp, sinp, S11, S12, S33, S34):
    """The triad and the Stokes vector after a Mueller dust scattering, by
    field name (engine.py:2309-2328): turned by phi about k and by theta in
    the (k, m) plane, not re-orthonormalized."""
    out = {}
    for a in 'xyz':
        m, n, k = (getattr(s, f) for f in ('m' + a, 'nn' + a, 'k' + a))
        p_ = cosp * m + sinp * n
        out['nn' + a] = cosp * n - sinp * m
        out['m' + a] = cost * p_ - sint * k
        out['k' + a] = sint * p_ + cost * k
    c2p = 2.0 * cosp * cosp - 1.0
    s2p = 2.0 * sinp * cosp
    Q0 = c2p * s.Q + s2p * s.U
    U0 = -s2p * s.Q + c2p * s.U
    I1 = torch.clamp_min(S11 + S12 * Q0, TINY)
    out['Q'] = (S12 + S11 * Q0) / I1
    out['U'] = (S33 * U0 + S34 * s.V) / I1
    out['V'] = (-S34 * U0 + S33 * s.V) / I1
    return out


def stokes_turn(s: BatchState, cost, sint, cosp, sinp, S11, S12, S22, S33,
                S44):
    """(k, m, n, Q, U, V) after the scattering: the triad turned by phi
    about k and by theta in the (k, m) plane, re-orthonormalized (k
    normalized, m := m - (m.k) k normalized, n = k x m), and the Stokes
    vector through the scattering matrix (engine.py:2231-2265)."""
    px = cosp * s.mx + sinp * s.nnx
    py = cosp * s.my + sinp * s.nny
    pz = cosp * s.mz + sinp * s.nnz
    mx = cost * px - sint * s.kx
    my = cost * py - sint * s.ky
    mz = cost * pz - sint * s.kz
    kx = sint * px + cost * s.kx
    ky = sint * py + cost * s.ky
    kz = sint * pz + cost * s.kz
    knorm = torch.rsqrt(kx * kx + ky * ky + kz * kz)
    kx, ky, kz = kx * knorm, ky * knorm, kz * knorm
    mk = mx * kx + my * ky + mz * kz
    mx, my, mz = mx - mk * kx, my - mk * ky, mz - mk * kz
    mnorm = torch.rsqrt(torch.clamp_min(mx * mx + my * my + mz * mz, TINY))
    mx, my, mz = mx * mnorm, my * mnorm, mz * mnorm
    nx = ky * mz - kz * my
    ny = kz * mx - kx * mz
    nz = kx * my - ky * mx
    cos2p = 2.0 * cosp * cosp - 1.0
    sin2p = 2.0 * sinp * cosp
    Q0 = cos2p * s.Q + sin2p * s.U
    U0 = -sin2p * s.Q + cos2p * s.U
    I1 = torch.clamp_min(S11 + S12 * Q0, TINY)
    return (kx, ky, kz, mx, my, mz, nx, ny, nz, (S12 + S22 * Q0) / I1,
            (S33 * U0) / I1, (S44 * s.V) / I1)


def deposit_plan(p: ScatterParams, tallies: Tallies) -> int:
    """K4's block plan (jpa.block_plan): the slots of the block copy of Pa
    (f64, nbin), 0 where it does not fit or without the map.  Jabs takes
    one atomic an absorption in every instance."""
    if p.jpa is None or tallies.Pa is None:
        return 0
    return block_plan(p.jpa.sizes(p.nxfreq)[1])[0]


def scatter(state: BatchState, tallies: Tallies, p: ScatterParams,
            seed: int, counter: int, record=None) -> None:
    """Scatter every AT_SCATTER lane, in place: kernel K4 for a CUDA state,
    the plain version for a CPU state.  `record`, a PeelRecord of the
    batch's size, receives the events for the peel."""
    if state.device.type == 'cpu':
        scatter_plain(state, tallies, p, seed, counter, record)
        return
    kbuild.require_cuda('scatter_lya', tallies.nscatt_gas,
                        tallies.nscatt_events, tallies.Jabs,
                        tallies.nscatt_dust, state.x, *p.device_tensors(),
                        *(getattr(tallies, f) for f in p.tally_fields),
                        *(() if record is None else (record.flag,)),
                        *(p.jpa.tallies(tallies) if p.jpa else ()),
                        *(tallies.allph.tensors()
                          if tallies.allph is not None else ()))
    kbuild.check(kbuild.library().lart_scatter_lya(
        state.lane_pointers, None if record is None else record.pointers,
        state.batch, seed & 0xFFFFFFFF, counter & 0xFFFFFFFF,
        ctypes.byref(p.c_params(tallies)), deposit_plan(p, tallies),
        kbuild.stream_of(state.x)), 'scatter_lya')
    kbuild.LAUNCHES['scatter_lya'] += 1
