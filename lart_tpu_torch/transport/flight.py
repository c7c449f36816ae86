"""What the flights share: the escape tally of the plain versions, and the
constants of the two 3-D Cartesian flights (kernels K5 fly_cartesian and
K6 fly_uniform_sphere) with their C layout, the line's constants
(physics/line.py) among them: a cell's opacity is rhokap times the line's
profile.

`FlightConsts` carries every constant of lart_tpu's make_fly (engine.py:
1067-1140) and make_fly_uniform_sphere (:887-908) that the ported paths
need, plus the grid tensors the walk gathers from: rhokap, the dust's
rhokapD where DGR > 0, and the velocities of a moving medium.  With H2
pumping a cell's opacity adds rhokap times the H2 multiplier
(physics/h2.py), and for line type 8 a lane of the H-alpha band sees
only the dust, rhokapD R_Ha (engine.py:1106-1128 total_opacity).
Numbers stay Python floats, so every operation of a plain version rounds
them to f32 where JAX's weak types do; the kernels receive the same values
as f32 through `FlightParams`, whose layout csrc/lart.cuh struct
FlightParams repeats.

XLA fuses a multiply that feeds an add into one fused multiply-add on the
CPU.  Where that rounding reaches a lane's fate (a cell face, a position
advanced along the ray: a one-ulp shift next to a face becomes a relative
error of the distance to it, and of the optical depth in thick media) the
flights compute with `fma` in their plain versions and fmaf in the kernels,
so both match lart_tpu lane by lane; everywhere else they round each
operation, and the kernels are built with --fmad=false to do the same.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..physics import h2 as ph2
from ..physics import line as pline
from ..physics.line import f32

BIG = 3.0e38
TINY = 1e-30
FFS_TAU_CAP = 25.0    # 1 - exp(-25) == 1 in f32
BC_CODES = {'escape': 0, 'periodic': 1, 'reflect': 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class AmrC(ctypes.Structure):
    """csrc/amr.cuh struct AmrGrid, field for field."""
    _fields_ = [('children', _P), ('node_cx', _P), ('node_cy', _P),
                ('node_cz', _P), ('node_ch', _P), ('ileaf', _P),
                ('neighbor', _P), ('fine_map', _P), ('Dfreq', _P),
                ('voigt_a', _P), ('ncells', _I), ('levelmax', _I),
                ('nf', _I), ('xmin', _F), ('ymin', _F), ('zmin', _F),
                ('dxf', _F)]


class ClumpC(ctypes.Structure):
    """csrc/clump.cuh struct ClumpGrid, field for field."""
    _fields_ = [('x', _P), ('y', _P), ('z', _P), ('r2', _P), ('rhokap', _P),
                ('rhokapD', _P), ('vx', _P), ('vy', _P), ('vz', _P),
                ('table', _P), ('n', _I), ('dense', _I), ('overlap', _I),
                ('shift', _I), ('cg_n', _I), ('K', _I), ('R', _F), ('cg_dx', _F),
                ('inv_cg_dx', _F), ('eps_dense', _F), ('eps_csr', _F),
                ('eps_peel', _F), ('r_loc', _F), ('inv_r_loc', _F),
                ('vr', _F), ('vscale', _F), ('a_cl', _F), ('D_cl', _F)]


class JpaC(ctypes.Structure):
    """csrc/lart.cuh struct JpaBins, field for field (transport/jpa.py)."""
    _fields_ = [('J1', _P), ('Pa', _P), ('Pnew', _P), ('geom', _I),
                ('nbin', _I), ('n', _I * 3), ('amin', _F * 3), ('d', _F * 3),
                ('dr', _F), ('roff', _F), ('cross0', _F)]


class AllPhC(ctypes.Structure):
    """csrc/allph.cuh struct AllPh, field for field (transport/allph.py
    builds it)."""
    _fields_ = [('rp0', _P), ('rp', _P), ('xfreq1', _P), ('xfreq2', _P),
                ('nsg', _P), ('nsd', _P), ('I', _P), ('Q', _P), ('U', _P),
                ('V', _P), ('n', _I), ('advance', _I), ('rmax2', _F)]


class FlightParams(ctypes.Structure):
    """csrc/lart.cuh struct FlightParams, field for field."""
    _fields_ = [('rhokap', _P), ('rhokapD', _P), ('vfx', _P), ('vfy', _P),
                ('vfz', _P), ('cell_a', _P), ('cell_D', _P),
                ('Jout', _P), ('Jmu', _P), ('W_oor', _P),
                ('Jout_Ha', _P), ('W_esc1', _P), ('W_esc2', _P),
                ('Jabs2', _P), ('mask', _P),
                ('n', _I * 3), ('bc', _I * 3), ('cell0', _I * 3),
                ('walk', _I * 3), ('moving', _I), ('nxfreq', _I),
                ('save_jmu', _I), ('nmu', _I), ('mu_abs', _I),
                ('atmosphere', _I),
                ('amin', _F * 3), ('amax', _F * 3), ('neg_amin', _F * 3),
                ('d', _F * 3), ('a_ref', _F), ('Dfreq', _F),
                ('xfreq_min', _F), ('dxfreq', _F), ('mu_min', _F),
                ('dmu', _F), ('sphere_R2', _F), ('sphere_rho', _F),
                ('sphere_rhoD', _F), ('R_Ha', _F), ('line', pline.LineC),
                ('h2', ph2.H2C), ('amr', AmrC), ('clump', ClumpC),
                ('jpa', JpaC), ('omega_shear', _F), ('allph', AllPhC)]


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once, as the kernels' fmaf computes it and as
    XLA contracts a multiply feeding an add on the CPU (lart_tpu's flights
    compute cell faces and positions so).  The product of two f32 is exact
    in f64; Python-float operands are rounded to f32 first, like JAX's weak
    types."""
    def d(v):
        return v.double() if isinstance(v, torch.Tensor) \
            else float(np.float32(v))
    return (a.double() * d(b) + d(c)).float()


def div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b with b rounded to f32, correctly rounded as the kernels divide.
    On CUDA, torch multiplies by the f32 reciprocal of a Python-scalar
    divisor, which moves a bin edge or a cell index by one ulp now and then;
    a 0-d tensor on a's device is divided by exactly (torch.full runs on the
    device: no copy, no wait).  A per-lane tensor b divides lane by lane."""
    if isinstance(b, torch.Tensor):
        return a / b
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def capped_step(dmin, cap, trav):
    """(step, whether it reaches the cap) of a walk from path length trav
    with the next face dmin away: the step stops at the cap, and the walk
    with it where dmin >= cap - trav (lart_tpu's peel.py:260-265 and
    sightline.py:89-95, an interior observer's sightline); without a cap
    (None) the step is dmin."""
    if cap is None:
        return dmin, torch.zeros_like(dmin, dtype=torch.bool)
    dleft = torch.clamp_min(cap - trav, 0.0)
    return torch.minimum(dmin, dleft), dmin >= dleft


def comoving(xf, u1, D1, D2, u2):
    """(xf + u1) D1 / D2 - u2 in lart_tpu's order of f32 operations (the
    comoving frequency on a cell change, engine.py:1286-1295): two
    roundings, never one ratio D1 / D2."""
    return div((xf + u1) * D1, D2) - u2


def doppler_ratio(D, D_ref: float):
    """D / D_ref, a cell's Doppler width over the reference one, as
    lart_tpu's f32 division: per lane where D is a tensor (a Cartesian or
    AMR grid at non-uniform temperature), else exactly 1.0 (D is D_ref)."""
    return div(D, D_ref) if isinstance(D, torch.Tensor) else 1.0


def floor_bin(v: torch.Tensor, n: int) -> torch.Tensor:
    """clip(floor(v), 0, n - 1) as int64 (clamped in float first)."""
    return torch.clamp(torch.floor(v), 0, n - 1).long()


def freq_floor(p, xfreq_lab: torch.Tensor):
    """(floor of the frequency bin, whether it is on the grid) of lab
    frequencies; `p` has the bin fields xfreq_min, dxfreq and nxfreq."""
    fx = torch.floor(div(xfreq_lab - p.xfreq_min, p.dxfreq))
    return fx, (fx >= 0.0) & (fx < p.nxfreq)


def tally_plain(tallies, p, mask, xfreq_lab, wgt, kz, J=None
                ) -> torch.Tensor:
    """Add wgt to the spectrum J (Jout by default; Jout_Ha for the
    H-alpha band, Jabs2 for an atmosphere's destruction, kz None: no Jmu)
    and Jmu at lab frequency xfreq_lab for the masked lanes
    whose bin is on the frequency grid; return the masked weight that
    falls outside it (W_oor).  `p` has the bin fields xfreq_min, dxfreq,
    nxfreq, save_Jmu, nmu, mu_min, dmu and mu_abs."""
    fx, in_rng = freq_floor(p, xfreq_lab)
    zero = torch.zeros_like(wgt)
    w = torch.where(mask & in_rng, wgt, zero)
    ix = floor_bin(fx, p.nxfreq)
    (tallies.Jout if J is None else J).index_add_(0, ix, w)
    if p.save_Jmu and kz is not None:
        mu = torch.abs(kz) if p.mu_abs else kz
        tallies.Jmu.index_add_(
            0, ix * p.nmu + floor_bin(div(mu - p.mu_min, p.dmu), p.nmu), w)
    return torch.where(mask & ~in_rng, wgt, zero)


@dataclasses.dataclass(frozen=True, eq=False)
class FlightConsts:
    n: tuple                 # (nx, ny, nz)
    bc: tuple                # per axis: 'escape' | 'periodic' | 'reflect'
    cell0: tuple             # (i0, j0, k0)
    walk: tuple              # the axis' faces are walked (engine.py:1179)
    amin: tuple
    amax: tuple
    d: tuple
    a_ref: float
    Dfreq: float
    xfreq_min: float
    dxfreq: float
    nxfreq: int
    save_Jmu: bool
    nmu: int
    mu_min: float
    dmu: float
    mu_abs: bool             # xyz_symmetry bins |kz|
    sphere_R2: float
    sphere_rho: float
    sphere_rhoD: float
    rhokap: torch.Tensor     # flat (nx*ny*nz,) f32, C order
    vel: Optional[tuple]     # flat (vfx, vfy, vfz); None in a static medium
    rhokapD: Optional[torch.Tensor] = None   # flat dust opacity, or None
    line: Optional[pline.LineConsts] = None  # the line's opacity profile
    h2: Optional[ph2.H2Consts] = None        # H2 pumping, or None
    R_Ha: float = 0.0        # cext_dust_Ha / cext_dust (line type 8)
    amr: Optional['AmrGrid'] = None   # the octree, on an AMR grid
    clump: Optional['ClumpGrid'] = None   # the clumps, on a clump medium
    # a Cartesian grid at non-uniform temperature: each cell's damping and
    # Doppler width, flat (nx*ny*nz,) f32; None at uniform temperature
    cell_a: Optional[torch.Tensor] = None
    cell_D: Optional[torch.Tensor] = None
    # an exoplanet atmosphere (engine.py:1259-1272): 1 a plane one, whose
    # bottom z face destroys, 2 a spherical one, whose masked core cells
    # (flat bool, the layout of rhokap; None without rmin) destroy
    atmosphere: int = 0
    mask: Optional[torch.Tensor] = None
    # the shearing box: the jump of a lane's vfy_shear at a periodic x wrap
    # (engine.py:1250-1257), 0 without one
    omega_shear: float = 0.0
    # the flight's maps, J1 and Pnew (transport/jpa.py JpaBins), or None
    jpa: Optional[object] = None

    @classmethod
    def from_config(cls, cfg, meta, grid) -> 'FlightConsts':
        from .jpa import JpaBins
        par = cfg.par
        jpa = JpaBins.from_config(cfg, meta)
        if jpa is not None and not (jpa.J1 or jpa.Pnew):
            jpa = None
        n = (meta.nx, meta.ny, meta.nz)
        bc = (meta.bc_x, meta.bc_y, meta.bc_z)
        amin = (meta.xmin, meta.ymin, meta.zmin)
        d = (meta.dx, meta.dy, meta.dz)
        mu_min = 0.0 if par.xyz_symmetry else -1.0
        vel = None
        if not meta.static_medium:
            vel = tuple(v.reshape(-1).contiguous()
                        for v in (grid.vfx, grid.vfy, grid.vfz))
        return cls(
            n=n, bc=bc, cell0=(meta.i0, meta.j0, meta.k0),
            walk=(meta.nx > 1 or meta.bc_x == 'escape',
                  meta.ny > 1 or meta.bc_y == 'escape', True),
            amin=amin, amax=tuple(a + m * s for a, m, s in zip(amin, n, d)),
            d=d, a_ref=meta.voigt_a_ref, Dfreq=meta.Dfreq_ref,
            xfreq_min=meta.xfreq_min, dxfreq=meta.dxfreq,
            nxfreq=meta.nxfreq, save_Jmu=bool(par.save_Jmu), nmu=par.nmu,
            mu_min=mu_min, dmu=(1.0 - mu_min) / par.nmu,
            mu_abs=bool(par.xyz_symmetry),
            sphere_R2=meta.sphere_R * meta.sphere_R,
            sphere_rho=meta.sphere_rho, sphere_rhoD=meta.sphere_rhoD,
            rhokap=grid.rhokap.reshape(-1).contiguous(), vel=vel,
            rhokapD=None if grid.rhokapD is None
            else grid.rhokapD.reshape(-1).contiguous(),
            cell_a=None if grid.voigt_a is None
            else grid.voigt_a.reshape(-1).contiguous(),
            cell_D=None if grid.Dfreq is None
            else grid.Dfreq.reshape(-1).contiguous(),
            line=pline.LineConsts.from_config(cfg),
            h2=ph2.H2Consts.from_config(cfg),
            R_Ha=(par.cext_dust_Ha / par.cext_dust if par.cext_dust > 0
                  else 0.0),
            atmosphere=int(meta.atmosphere),
            mask=None if meta.atmosphere != 2 or grid.mask is None
            else grid.mask.reshape(-1).contiguous(),
            omega_shear=float(meta.omega_shear), jpa=jpa)

    @property
    def moving(self) -> bool:
        return self.vel is not None

    @property
    def comoving(self) -> bool:
        """A cell change updates the comoving frequency: in a moving
        medium, at non-uniform temperature or in a shearing box
        (engine.py:1282-1283)."""
        return self.moving or self.cell_D is not None \
            or self.omega_shear != 0.0

    @property
    def lyb(self) -> bool:
        """Line type 8: lanes of the H-alpha band fly too."""
        return self.line.line_type == 8

    @property
    def uniform_temperature(self) -> bool:
        return self.cell_D is None

    def cell_a_D(self, flat):
        """(voigt_a, Dfreq) of the flat cells `flat` (cell_voigt_a /
        cell_Dfreq, engine.py:297-317): the reference values as Python
        floats at uniform temperature, else per-lane gathers."""
        if self.cell_D is None:
            return self.a_ref, self.Dfreq
        return self.cell_a[flat], self.cell_D[flat]

    def flat(self, i, j, k) -> torch.Tensor:
        """engine._gather's flat index, clamped like jnp.take mode='clip'."""
        nx, ny, nz = self.n
        f = (i.long() * ny + j) * nz + k
        return torch.clamp(f, 0, nx * ny * nz - 1)

    def profile(self, xfreq) -> torch.Tensor:
        """The line's opacity profile H_eff(x) at a_ref and Dfreq."""
        return pline.line_profile_plain(self.line, xfreq, self.a_ref,
                                        self.Dfreq)

    def opacity(self, flat, xfreq, band2=None) -> torch.Tensor:
        """rhokap H_eff(x) (+ rhokap H2(x)) + rhokapD of the flat cells
        `flat` at the comoving frequencies xfreq, at each cell's damping and
        Doppler width (engine.py:1111-1128 total_opacity); where the mask
        band2 is set, rhokapD R_Ha, or 0 without dust."""
        return self.opacity_parts(flat, xfreq, band2)[0]

    def opacity_parts(self, flat, xfreq, band2=None):
        """(the opacity of `opacity`, its line part rhoH = rhokap H_eff(x),
        0 where band2 is set) as total_opacity returns them."""
        rk = self.rhokap[flat]
        a, D = self.cell_a_D(flat)
        rho = rhoH = rk * pline.line_profile_plain(self.line, xfreq, a, D)
        if self.h2 is not None:
            rho = rho + rk * ph2.h2_kappa_plain(self.h2, xfreq, D)
        if self.rhokapD is not None:
            rho = rho + self.rhokapD[flat]
        if band2 is not None:
            rho2 = torch.zeros_like(rho) if self.rhokapD is None \
                else self.rhokapD[flat] * self.R_Ha
            rho = torch.where(band2, rho2, rho)
            rhoH = torch.where(band2, torch.zeros_like(rhoH), rhoH)
        return rho, rhoH

    def vel_dot(self, cell, kx, ky, kz) -> torch.Tensor:
        """u . k of the cells `cell` = (i, j, k) (engine.cell_velocity_dot),
        as XLA contracts its sum of products (dot3): where a metal line's
        thermal speed is small, u reaches hundreds of Doppler units and
        the comoving update cancels them to a few ulps of u."""
        f = self.flat(*cell)
        vx, vy, vz = self.vel
        return dot3(vx[f], kx, vy[f], ky, vz[f], kz)

    @functools.cached_property
    def _c_params(self) -> FlightParams:
        c = FlightParams()
        c.rhokap = self.rhokap.data_ptr()
        if self.rhokapD is not None:
            c.rhokapD = self.rhokapD.data_ptr()
        if self.moving:
            c.vfx, c.vfy, c.vfz = (v.data_ptr() for v in self.vel)
        if self.cell_D is not None:
            c.cell_a, c.cell_D = self.cell_a.data_ptr(), self.cell_D.data_ptr()
        if self.mask is not None:
            c.mask = self.mask.data_ptr()
        c.atmosphere = self.atmosphere
        c.n[:] = self.n
        c.bc[:] = [BC_CODES[b] for b in self.bc]
        c.cell0[:] = self.cell0
        c.walk[:] = [int(w) for w in self.walk]
        c.moving = int(self.moving)
        c.nxfreq, c.save_jmu, c.nmu = self.nxfreq, int(self.save_Jmu), self.nmu
        c.mu_abs = int(self.mu_abs)
        c.amin[:] = self.amin
        c.amax[:] = self.amax
        c.neg_amin[:] = [-a for a in self.amin]
        c.d[:] = self.d
        for f in ('a_ref', 'Dfreq', 'xfreq_min', 'dxfreq', 'mu_min', 'dmu',
                  'sphere_R2', 'sphere_rho', 'sphere_rhoD', 'R_Ha'):
            setattr(c, f, getattr(self, f))
        c.line = self.line.c_struct
        if self.h2 is not None:
            c.h2 = self.h2.c_struct
        if self.amr is not None:
            c.amr = self.amr.c_struct
        if self.clump is not None:
            c.clump = self.clump.c_struct
        c.omega_shear = self.omega_shear
        return c

    @property
    def c_grid_params(self) -> FlightParams:
        """The C struct for a kernel that reads the grid and writes no
        flight tallies (K7's sightline walk)."""
        return self._c_params

    def c_params(self, tallies) -> FlightParams:
        """The C struct with this call's tally pointers (the launch copies
        it, so the next call may overwrite them)."""
        c = self._c_params
        c.Jout = tallies.Jout.data_ptr()
        c.Jmu = tallies.Jmu.data_ptr()
        c.W_oor = tallies.W_oor.data_ptr()
        if self.lyb:
            c.Jout_Ha, c.W_esc1, c.W_esc2 = (
                getattr(tallies, f).data_ptr()
                for f in ('Jout_Ha', 'W_esc1', 'W_esc2'))
        if self.atmosphere:
            c.Jabs2 = tallies.Jabs2.data_ptr()
        if self.jpa is not None:
            c.jpa = self.jpa.c_struct(tallies)
        c.allph = AllPhC() if tallies.allph is None \
            else tallies.allph.c_struct
        return c

    def masked(self, flat) -> torch.Tensor:
        """Whether the flat cells lie in a spherical atmosphere's masked
        core (False without one)."""
        if self.mask is None:
            return torch.zeros_like(flat, dtype=torch.bool)
        return self.mask[flat]

    def device_tensors(self):
        return ((self.rhokap,) + (self.vel or ())
                + (() if self.mask is None else (self.mask,))
                + (() if self.rhokapD is None else (self.rhokapD,))
                + (() if self.cell_D is None else (self.cell_a, self.cell_D))
                + (() if self.amr is None else self.amr.dev.tensors())
                + (() if self.clump is None else self.clump.dev.tensors()))


# --------------------------------------------------------------------------
# the octree AMR grid (csrc/amr.cuh), plain versions
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class AmrGrid:
    """The AMR grid as the walks read it: the device arrays (AmrDevice) and
    the box's corner, its fine voxel width and levelmax.  A lane's cell
    index ic is an octree node; its leaf is ileaf[ic], -1 in a gap cell,
    which has no gas, no dust, no velocity, and the reference Doppler width
    and damping (engine.py:279-356)."""
    dev: object              # grid.octree.AmrDevice
    levelmax: int
    amin: tuple              # (xmin, ymin, zmin) of the box
    dxf: float               # the fine voxel's width, rounded to f32

    @classmethod
    def from_meta(cls, meta, dev) -> 'AmrGrid':
        nf = max(dev.nf, 1)
        return cls(dev=dev, levelmax=int(meta.levelmax),
                   amin=(float(meta.xmin), float(meta.ymin),
                         float(meta.zmin)),
                   dxf=float(np.float32((meta.xmax - meta.xmin) / nf)))

    @property
    def nf(self) -> int:
        return self.dev.nf

    @property
    def uniform_temperature(self) -> bool:
        return self.dev.Dfreq is None

    @functools.cached_property
    def c_struct(self) -> AmrC:
        d, c = self.dev, AmrC()
        for f in ('children', 'node_cx', 'node_cy', 'node_cz', 'node_ch',
                  'ileaf', 'neighbor', 'fine_map', 'Dfreq', 'voigt_a'):
            t = getattr(d, f)
            setattr(c, f, None if t is None else t.data_ptr())
        c.ncells, c.levelmax, c.nf = d.ncells, self.levelmax, d.nf
        c.xmin, c.ymin, c.zmin = self.amin
        c.dxf = self.dxf
        return c

    def leaf(self, ic: torch.Tensor) -> torch.Tensor:
        """_leaf_of: the leaf id of node ic (clamped), -1 for a gap."""
        return self.dev.ileaf[torch.clamp(ic.long(), 0, self.dev.ncells - 1)]

    @staticmethod
    def gather(arr: Optional[torch.Tensor], il: torch.Tensor,
               default: float) -> torch.Tensor:
        """_leaf_gather: arr[il], `default` in a gap (or without arr)."""
        d = torch.full(il.shape, default, dtype=torch.float32,
                       device=il.device)
        if arr is None:
            return d
        return torch.where(il >= 0, arr[torch.clamp_min(il, 0).long()], d)

    def a_D(self, il: torch.Tensor, a_ref: float, D_ref: float):
        """(voigt_a, Dfreq) of the leaves il: the reference values as
        Python floats at uniform temperature, else per-lane tensors."""
        if self.uniform_temperature:
            return a_ref, D_ref
        return (self.gather(self.dev.voigt_a, il, a_ref),
                self.gather(self.dev.Dfreq, il, D_ref))

    def _fine(self, x, y, z) -> torch.Tensor:
        nf = self.nf
        idx = [floor_bin(div(v - lo, self.dxf), nf)
               for v, lo in zip((x, y, z), self.amin)]
        return self.dev.fine_map.reshape(-1)[(idx[0] * nf + idx[1]) * nf
                                             + idx[2]]

    def _descend(self, cur, x, y, z, axis=None, fbit=None) -> torch.Tensor:
        """levelmax + 1 octant steps from the nodes cur; where `axis` (per
        lane, 0-2) is given, that axis' octant bit is fbit."""
        d = self.dev
        pos = (x, y, z)
        centres = (d.node_cx, d.node_cy, d.node_cz)
        cur = cur.long()
        for _ in range(self.levelmax + 1):
            c = torch.clamp(cur, 0, d.ncells - 1)
            io = torch.zeros_like(cur)
            for a in range(3):
                b = (pos[a] >= centres[a][c]).long()
                if axis is not None:
                    b = torch.where(axis == a, fbit, b)
                io = io + (b << a)
            child = d.children.reshape(-1)[c * 8 + io].long()
            stop = (d.ileaf[c] >= 0) | (child < 0)
            cur = torch.where(stop, cur, child)
        return cur.to(torch.int32)

    def find_cell(self, x, y, z) -> torch.Tensor:
        """amr_find_cell (engine.py:548-578): the deepest node holding each
        point, one fine-map gather or the descent from the root."""
        if self.dev.fine_map is not None:
            return self._fine(x, y, z)
        return self._descend(torch.zeros_like(x, dtype=torch.long), x, y, z)

    def descend_from_face(self, nb, face, x, y, z) -> torch.Tensor:
        """amr_descend_from_face (engine.py:359-418): the cell entered
        across `face` (0 +x, 1 -x, ... 5 -z) from neighbor node nb at the
        face point (x, y, z)."""
        axis = torch.div(face, 2, rounding_mode='floor')
        d = self.dev
        if d.fine_map is not None:
            half = float(np.float32(0.5) * np.float32(self.dxf))
            sgn = torch.where(face % 2 == 0, 1.0, -1.0)
            nudge = half * sgn
            zero = torch.zeros_like(x)
            c = torch.clamp(nb.long(), 0, d.ncells - 1)
            nch = d.node_ch[c]
            pad = float(np.float32(0.25) * np.float32(self.dxf))
            q = []
            for a, (v, cen) in enumerate(zip((x, y, z), (d.node_cx, d.node_cy,
                                                         d.node_cz))):
                v = v + torch.where(axis == a, nudge, zero)
                nc = cen[c]
                q.append(torch.minimum(torch.maximum(v, nc - nch + pad),
                                       nc + nch - pad))
            return self._fine(*q)
        return self._descend(nb, x, y, z, axis.long(), (face % 2).long())


# --------------------------------------------------------------------------
# the clump medium (csrc/clump.cuh), plain versions
# --------------------------------------------------------------------------

def recip32(c: float) -> float:
    """The f32 reciprocal of the f32 c: XLA divides by a constant as a
    multiply by it (x / c == x * recip32(c) in lart_tpu's CPU closures)."""
    return float(np.float32(1.0) / np.float32(c))


def dot3(a1, b1, a2, b2, a3, b3):
    """a1 b1 + a2 b2 + a3 b3 as XLA contracts it on the CPU:
    fma(a3, b3, fma(a1, b1, a2 b2)); the kernels compute the same fmaf
    chain."""
    return fma(a3, b3, fma(a1, b1, a2 * b2))


def chord_det(px, py, pz, kx, ky, kz, r2):
    """(b, det) of the ray p + t k against a sphere of radius^2 r2 about
    the origin of p: b = p.k, det = b^2 - (|p|^2 - r2); the chord is
    [-b - sqrt(det), -b + sqrt(det)] where det > 0 (engine.py:3130-3135)."""
    b = dot3(px, kx, py, ky, pz, kz)
    c = dot3(px, px, py, py, pz, pz) - r2
    return b, fma(b, b, -c)


@dataclasses.dataclass(frozen=True, eq=False)
class ClumpGrid:
    """The clump medium as the walks read it (lart_tpu's ClumpDevice with
    ClumpMeta and the clump branches of engine.py:290-545): the device
    arrays, the CSR grid (cg_n^3 cells of width cg_dx over [-R, R]^3, K
    candidates a row; lart_tpu divides by cg_dx as XLA divides by a
    constant, a multiply by the f32 reciprocal inv_cg_dx), whether
    populations up to clump_dense_max take the
    dense forms (flight K9, clump_find's argmax, the owner draw over all
    clumps), overlap mode, the nudges of the three walks (dense flight
    1e-6 R + 1e-7, CSR walker 1e-4 cg_dx / cg_n + 1e-6 R, peel 1e-6 R,
    each rounded to f32), and the clumps' own Doppler units: r_loc =
    Dfreq_ref / Dfreq_cl scales a global frequency into a clump's, vr =
    1 / r_loc and vscale = Dfreq_cl / Dfreq_ref scale a clump velocity
    into reference units (the flights use vr, cell_velocity_dot vscale, the
    peel and the owner draw divide by r_loc, that is multiply by inv_r_loc,
    as the scatter's shift back does), a_cl and D_cl the clumps'
    damping and Doppler width.  A lane's cell index ic is its clump, -1 in
    the vacuum between clumps, which has no gas, dust or velocity."""
    dev: object              # grid.clump.ClumpDevice
    n: int
    cg_n: int
    cg_dx: float
    K: int
    R: float
    dense: bool
    overlap: bool
    moving: bool
    eps_dense: float
    eps_csr: float
    eps_peel: float
    r_loc: float
    vr: float
    vscale: float
    a_cl: float
    D_cl: float
    D_ref: float             # the reference Doppler width

    @classmethod
    def from_meta(cls, cfg, meta, cmeta, dev) -> 'ClumpGrid':
        par = cfg.par
        R = meta.xmax
        has_cl = meta.Dfreq_cl > 0
        r_loc = meta.Dfreq_ref / meta.Dfreq_cl if has_cl else 1.0
        return cls(
            dev=dev, n=int(cmeta.n_clumps), cg_n=int(cmeta.cg_n),
            cg_dx=float(cmeta.cg_dx), K=int(cmeta.K), R=float(R),
            dense=cmeta.n_clumps <= par.clump_dense_max,
            overlap=bool(par.clump_allow_overlap),
            moving=not meta.static_medium,
            eps_dense=f32(1e-6 * R + 1e-7),
            eps_csr=f32(1e-4 * float(cmeta.cg_dx) / max(cmeta.cg_n, 1)
                        + 1e-6 * R),
            eps_peel=f32(1e-6 * R), r_loc=r_loc, vr=1.0 / r_loc,
            vscale=meta.Dfreq_cl / meta.Dfreq_ref if has_cl else 1.0,
            a_cl=meta.voigt_a_cl if has_cl else meta.voigt_a_ref,
            D_cl=meta.Dfreq_cl if has_cl else meta.Dfreq_ref,
            D_ref=meta.Dfreq_ref)

    @property
    def shift(self) -> bool:
        """The scatter moves a lane into its clump's frame and Doppler units
        and back (engine.py:2102, :2538): in a moving medium or where the
        clumps' temperature is not the reference one."""
        return self.moving or self.r_loc != 1.0

    @property
    def d_ratio(self) -> float:
        """D_cl / Dfreq_ref as lart_tpu's f32 division of cell_Dfreq by the
        reference width: a clump's lab frequency is (x + u) d_ratio."""
        return float(np.float32(self.D_cl) / np.float32(self.D_ref))

    @property
    def has_dust(self) -> bool:
        return self.dev.rhokapD is not None

    @functools.cached_property
    def c_struct(self) -> ClumpC:
        d, c = self.dev, ClumpC()
        for f in ('x', 'y', 'z', 'r2', 'rhokap', 'rhokapD', 'vx', 'vy', 'vz',
                  'table'):
            t = getattr(d, f)
            if f in ('vx', 'vy', 'vz') and not self.moving:
                t = None
            setattr(c, f, None if t is None else t.data_ptr())
        c.n, c.dense, c.overlap = self.n, int(self.dense), int(self.overlap)
        c.shift = int(self.shift)
        c.cg_n, c.K = self.cg_n, self.K
        for f in ('R', 'cg_dx', 'eps_dense', 'eps_csr', 'eps_peel', 'r_loc',
                  'vr', 'vscale', 'a_cl', 'D_cl'):
            setattr(c, f, getattr(self, f))
        c.inv_cg_dx, c.inv_r_loc = recip32(self.cg_dx), recip32(self.r_loc)
        return c

    @staticmethod
    def gather(arr: Optional[torch.Tensor], ic: torch.Tensor,
               default: float = 0.0) -> torch.Tensor:
        """_leaf_gather of a per-clump array: arr[ic], `default` where ic <
        0 (the vacuum) or without arr."""
        d = torch.full(ic.shape, default, dtype=torch.float32,
                       device=ic.device)
        if arr is None:
            return d
        return torch.where(ic >= 0, arr[torch.clamp_min(ic, 0).long()], d)

    def csr_cell(self, x, y, z):
        """(ci, cj, ck) of the CSR cells holding the points, clamped, and
        the flat cell (ci cg_n + cj) cg_n + ck, int64."""
        idx = [floor_bin((v + self.R) * recip32(self.cg_dx), self.cg_n)
               for v in (x, y, z)]
        return idx, (idx[0] * self.cg_n + idx[1]) * self.cg_n + idx[2]

    def face_dist(self, pos, k, idx):
        """fd of engine.py:3398-3405: the distance along k to the exit face
        of CSR cell index idx on one axis (BIG where k is flat)."""
        flat = torch.abs(k) < 1e-12
        face = fma(torch.where(k > 0.0, idx + 1, idx).to(torch.float32),
                   self.cg_dx, -self.R)
        t = (face - pos) / torch.where(flat, torch.ones_like(k), k)
        return torch.where(flat, torch.full_like(k, BIG),
                           torch.clamp_min(t, 0.0))

    def cell_exit(self, pos, k):
        """(flat CSR cell, distance to its exit face) of the points pos
        along k."""
        idx, cell = self.csr_cell(*pos)
        t = [self.face_dist(pos[a], k[a], idx[a]) for a in range(3)]
        return cell, torch.minimum(torch.minimum(t[0], t[1]), t[2])

    def candidate(self, cell: torch.Tensor, q: int) -> torch.Tensor:
        """The q-th candidate clump of the cells (-1 pads), int64."""
        flat = self.dev.table.reshape(-1)
        return flat[torch.clamp(cell * self.K + q, 0, flat.numel() - 1)].long()

    def centre(self, ic):
        """(x, y, z, r2) of clumps ic (0 in the vacuum)."""
        d = self.dev
        return tuple(self.gather(a, ic) for a in (d.x, d.y, d.z, d.r2))

    def find(self, x, y, z) -> torch.Tensor:
        """clump_find (engine.py:421-450): the first clump containing each
        point, -1 in the vacuum; over all clumps (the dense argmax) or the
        CSR cell's candidates in table order."""
        d = self.dev
        if self.dense:
            px = x[:, None] - d.x[None, :]
            py = y[:, None] - d.y[None, :]
            pz = z[:, None] - d.z[None, :]
            hit = dot3(px, px, py, py, pz, pz) < d.r2[None, :]
            first = torch.argmax(hit.to(torch.int8), dim=1)
            return torch.where(hit.any(dim=1), first,
                               torch.full_like(first, -1)).to(torch.int32)
        _, cell = self.csr_cell(x, y, z)
        out = torch.full(x.shape, -1, dtype=torch.int64, device=x.device)
        for q in range(self.K):
            cand = self.candidate(cell, q)
            qx, qy, qz, qr2 = self.centre(cand)
            ex, ey, ez = x - qx, y - qy, z - qz
            hit = (cand >= 0) & (dot3(ex, ex, ey, ey, ez, ez) < qr2)
            out = torch.where((out < 0) & hit, cand, out)
        return out.to(torch.int32)

    def vel_dot(self, ic, kx, ky, kz, form: str = 'scale') -> torch.Tensor:
        """A clump's bulk velocity along k, in reference Doppler units: u.k
        times vscale (form 'scale', cell_velocity_dot), times vr ('vr', the
        flights) or over r_loc ('div', the peel and the owner draw); 0 in
        the vacuum and in a static medium."""
        if not self.moving:
            return torch.zeros_like(kx)
        d = self.dev
        u = dot3(self.gather(d.vx, ic), kx, self.gather(d.vy, ic), ky,
                 self.gather(d.vz, ic), kz)
        if form == 'div':
            return u * recip32(self.r_loc)
        return u * f32(self.vscale if form == 'scale' else self.vr)

    def local_x(self, xfreq, u=None) -> torch.Tensor:
        """A clump's local frequency of the global xfreq: (x - u) r_loc."""
        return (xfreq if u is None else xfreq - u) * f32(self.r_loc)

    def kappa(self, lc, ic, x_loc) -> torch.Tensor:
        """rhokap H_eff(x_loc; a_cl, D_cl) (+ rhokapD) of clumps ic at
        their local frequencies x_loc (0 in the vacuum)."""
        from ..physics import line as pline
        d = self.dev
        k = self.gather(d.rhokap, ic) * pline.line_profile_plain(
            lc, x_loc, f32(self.a_cl), f32(self.D_cl))
        if self.has_dust:
            k = k + self.gather(d.rhokapD, ic)
        return k
