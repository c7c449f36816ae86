"""Refill: dead lanes are reborn from the photon budget (kernel K2).

Counterpart of make_refill / refill (lart_tpu/transport/engine.py:2557,
:2689) for a point source (source_geometry 'point' or '') or an
exponential cylinder (see below) with a Voigt,
monochromatic, Gaussian or flat continuum input spectrum in a medium
static or moving, on a Cartesian grid of uniform temperature or on the
octree AMR grid.  A line of type 2, 4, 5 or 6
starts from xfreq0 shifted to a branch (branch_init_shift, engine.py:
2919-2970; physics/line.py) by the two uniforms of block 3; the continuum
(engine.py:2804-2807) replaces the frequency, that shift included, by
xfreq_min + u (xfreq_max - xfreq_min), u the first uniform of block 2.
The Gaussian (engine.py:2799-2803) is xfreq0 + N(0, 1) sigma / vtherm,
sigma = gaussian_FWHM_vel / 2.35482 where that is set, else
gaussian_sigma_vel; the normal comes by Box-Muller from block 2 of the
lane's uniforms, which only the continuum also reads.  lart_tpu
divides it by D_loc / Dfreq_ref, the source cell's Doppler width over the
reference one, which is exactly 1 at uniform temperature.  A launched lane gets the source position, an isotropic direction,
its birth frequency, the forced-first-scattering phase FFS with its xi
stashed in tau_target, the birth snapshot, the resonance line's band
(iband 1; engine.py:2888), and the unpolarized Stokes
vector (Q = U = V = 0) with the reference triad m = (cos theta cos phi,
cos theta sin phi, -sin theta), n = (-sin phi, cos phi, 0) of its
direction (engine.py:2863-2873).  In a moving medium the
drawn frequency is a lab-frame one: unless comoving_source, the lane's
comoving frequency is xfreq - u1 with u1 = v(source cell) . k
(engine.py:2836-2841); Jin is tallied at the lab frequency xfreq + u1.

On the octree AMR grid (engine.py:2755-2775, :2839) the source cell is
the node amr_find_cell gives the source position, found per lane (K2 does
it on the card); its leaf's velocity gives u1 and, at non-uniform
temperature, its damping the Voigt spectrum's a and its Doppler width
D_loc the Gaussian's and the continuum's divisor D_loc / Dfreq_ref and
Jin's lab frequency (x + u1) D_loc / Dfreq_ref.

On a clump medium (engine.py:2750-2772) the birth cell is the clump
clump_find gives the source position (-1 in the vacuum between clumps),
found per lane (K2 does it on the card, csrc/clump.cuh); photons carry
global frequencies, so the spectrum is drawn at the reference damping and
Doppler width, and u1 is the birth clump's bulk velocity along k in
reference units (cell_velocity_dot: u.k times Dfreq_cl / Dfreq_ref).

`refill_plain` ranks dead lanes by a cumsum, as the JAX version does;
kernel K2 (csrc/refill.cu) hands out tickets by warp instead, so when the
budget runs out the two may launch different dead lanes, always the same
number.  A launched lane draws its uniforms from Philox at counter
(lane, counter, block), so both launch it with the same values.

With peel-off on, the refill also writes the flag of a PeelRecord: 1 on
the lanes it launched, 0 elsewhere, so that the direct peel of the
newborn photons (kernel K7, engine.py:2909-2913) runs on exactly those.

The exponential_cylinder source (gen_position, engine.py:2629-2637) draws
each birth's position from the uniforms of block 4, after every earlier
block, so a point source draws as before: the cylindrical radius from
the log-log table of physics/sources.py (u0), the azimuth 2 pi u1, and
z from the truncated exponential in |z| up to zmax (_zexp, :2569-2575;
magnitude u2, sign u3) or, with source_zscale <= 0, uniform over the box
(zmin + zrange u2); with xyz_symmetry the position's absolute values
(:2722-2723).  The birth cell is then the lane's own: on a Cartesian grid
clip(floor((x - xmin) / dx)) per axis (:2759-2765), its velocity gathered
per lane in a moving medium; on the AMR grid and the clump medium the
lookups above run at the lane's position.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..kernels import build as kbuild
from ..physics import line as pline
from ..physics.rng import STREAM_REFILL, uniforms
from ..physics.samplers import TWOPI, box_muller, rand_voigt_x
from ..physics.sources import (RadialTable, build_sources, sample_radius_loglog,
                               zexp, zexp_consts)
from .flight import AmrGrid, ClumpGrid, div, doppler_ratio, fma
from .state import DEAD, FFS, BatchState, Tallies

SPECTRUM_MONO, SPECTRUM_VOIGT, SPECTRUM_GAUSS, SPECTRUM_CONT = 0, 1, 2, 3
SPECTRA = {'monochromatic': SPECTRUM_MONO, 'voigt': SPECTRUM_VOIGT,
           'gaussian': SPECTRUM_GAUSS, 'continuum': SPECTRUM_CONT}
BLOCK_SOURCE = 4     # the Philox block of an extended source's position

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class SourceC(ctypes.Structure):
    """csrc/refill.cu struct SourceC, field for field."""
    _fields_ = [('log_p', _P), ('log_r', _P), ('n', _I), ('zexp', _I),
                ('neg_zs', _F), ('zexp_c', _F), ('zmin', _F), ('zrange', _F),
                ('abs_xyz', _I), ('cells', _I * 3), ('amin', _F * 3),
                ('d', _F * 3)]


@dataclasses.dataclass(frozen=True, eq=False)
class ExpCylinder:
    """The exponential_cylinder source: the radius table, the z law
    (zexp (-zs, c) of the truncated exponential, or None for uniform z in
    [zmin, zmin + zrange)), xyz_symmetry, and the Cartesian grid's cells
    (n, amin, d) a birth's cell is found in."""
    table: RadialTable
    zexp: Optional[tuple]
    zmin: float
    zrange: float
    abs_xyz: bool
    n: tuple
    amin: tuple
    d: tuple

    @classmethod
    def from_config(cls, cfg, meta, device) -> Optional['ExpCylinder']:
        table = build_sources(cfg, device)
        if table is None:
            return None
        par = cfg.par
        return cls(table=table,
                   zexp=zexp_consts(par) if par.source_zscale > 0 else None,
                   zmin=meta.zmin, zrange=meta.zmax - meta.zmin,
                   abs_xyz=bool(par.xyz_symmetry),
                   n=(meta.nx, meta.ny, meta.nz),
                   amin=(meta.xmin, meta.ymin, meta.zmin),
                   d=(meta.dx, meta.dy, meta.dz))

    def position(self, w):
        """The birth positions (x, y, z) of block-4 uniforms w (4, B)."""
        rp = sample_radius_loglog(w[0], self.table)
        phi = TWOPI * w[1]
        x, y = rp * torch.cos(phi), rp * torch.sin(phi)
        z = zexp(w[2], w[3], *self.zexp) if self.zexp is not None \
            else fma(w[2], self.zrange, self.zmin)
        if self.abs_xyz:
            x, y, z = torch.abs(x), torch.abs(y), torch.abs(z)
        return x, y, z

    def cells(self, pos):
        """The Cartesian cells (ic, jc, kc) holding the positions, clipped
        to the grid (engine.py:2759-2765)."""
        return tuple(torch.clamp(torch.floor(div(v - np.float32(a), d)), 0,
                                 n - 1).to(torch.int32)
                     for v, a, d, n in zip(pos, self.amin, self.d, self.n))

    @functools.cached_property
    def c_struct(self) -> SourceC:
        c = SourceC()
        c.log_p, c.log_r = (t.data_ptr() for t in self.table.tensors())
        c.n = self.table.n
        c.zexp = int(self.zexp is not None)
        if self.zexp is not None:
            c.neg_zs, c.zexp_c = self.zexp
        c.zmin, c.zrange = self.zmin, self.zrange
        c.abs_xyz = int(self.abs_xyz)
        c.cells[:] = self.n
        c.amin[:] = self.amin
        c.d[:] = self.d
        return c


@dataclasses.dataclass(frozen=True)
class RefillParams:
    xs: float
    ys: float
    zs: float
    ic: int
    jc: int
    kc: int
    xfreq0: float
    spectrum: int        # SPECTRUM_MONO, _VOIGT, _GAUSS or _CONT
    a: float             # Voigt damping parameter of the source cell
    xfreq_min: float
    dxfreq: float
    nxfreq: int
    v_src: tuple = (0.0, 0.0, 0.0)   # the source cell's velocity (f32)
    comoving_source: bool = True
    sigma_x: float = 0.0     # the Gaussian's sigma in Doppler units
    xfreq_span: float = 0.0  # the continuum's xfreq_max - xfreq_min
    Dfreq: float = 1.0       # Doppler width of the source cell (Hz)
    line: pline.LineConsts = None
    amr: Optional[AmrGrid] = None    # the octree, on an AMR grid
    vel: Optional[tuple] = None      # per-leaf velocities (AMR), or per
    #   cell for an extended source on a moving Cartesian grid
    clump: Optional[ClumpGrid] = None   # the clumps, on a clump medium
    source: Optional[ExpCylinder] = None    # an exponential_cylinder source

    @classmethod
    def from_config(cls, cfg, meta, grid=None, cmeta=None) -> 'RefillParams':
        """Constants of a config that engine.check_supported accepted; the
        source cell's velocity comes from `grid` in a moving medium (on a
        clump medium grid is the ClumpDevice and cmeta its ClumpMeta)."""
        par = cfg.par
        f32 = np.float32
        pos = [f32(par.xs_point), f32(par.ys_point), f32(par.zs_point)]
        cells, v_src, amr, vel = [0, 0, 0], (0.0, 0.0, 0.0), None, None
        clump = None
        source = ExpCylinder.from_config(
            cfg, meta, 'cpu' if grid is None else grid.rhokap.device)
        if meta.grid_type == 'clump':
            # the births find their clump themselves (clump_find)
            clump = ClumpGrid.from_meta(cfg, meta, cmeta, grid)
        elif meta.grid_type == 'amr':
            # the births find their node themselves (amr_find_cell)
            amr = AmrGrid.from_meta(meta, grid)
            if not meta.static_medium:
                vel = (grid.vfx, grid.vfy, grid.vfz)
        else:
            for a, (p, amin, d, n) in enumerate(zip(
                    pos, (meta.xmin, meta.ymin, meta.zmin),
                    (meta.dx, meta.dy, meta.dz),
                    (meta.nx, meta.ny, meta.nz))):
                # f32 cell index with the edge clamp, as the JAX refill
                # computes it
                c = np.floor((p - f32(amin)) / f32(d))
                cells[a] = int(min(max(c, 0), n - 1))
            if not meta.static_medium and source is None:
                v_src = tuple(float(v[tuple(cells)])
                              for v in (grid.vfx, grid.vfy, grid.vfz))
            elif not meta.static_medium:
                # each birth gathers its own cell's velocity
                vel = tuple(v.reshape(-1).contiguous()
                            for v in (grid.vfx, grid.vfy, grid.vfz))
        gsig = (par.gaussian_FWHM_vel / 2.3548200450309493
                if par.gaussian_FWHM_vel > 0 else par.gaussian_sigma_vel)
        return cls(xs=float(pos[0]), ys=float(pos[1]), zs=float(pos[2]),
                   ic=cells[0], jc=cells[1], kc=cells[2],
                   xfreq0=float(par.xfreq0),
                   spectrum=SPECTRA[par.spectral_type.strip().lower()],
                   sigma_x=gsig / cfg.vtherm,
                   a=float(meta.voigt_a_ref), xfreq_min=meta.xfreq_min,
                   dxfreq=meta.dxfreq, nxfreq=meta.nxfreq, v_src=v_src,
                   comoving_source=bool(par.comoving_source),
                   xfreq_span=pline.f32(meta.xfreq_max - meta.xfreq_min),
                   Dfreq=meta.Dfreq_ref,
                   line=pline.LineConsts.from_config(cfg), amr=amr, vel=vel,
                   clump=clump, source=source)


def refill_plain(state: BatchState, tallies: Tallies, p: RefillParams,
                 seed: int, counter: int, budget: int, record=None) -> None:
    """Plain PyTorch refill, in place; `record.flag` marks the launched
    lanes when a PeelRecord is given."""
    B, dev = state.batch, state.device
    dead = state.phase == DEAD
    rank = torch.cumsum(dead.to(torch.int32), 0) - 1
    launch = dead & (rank < budget - state.n_launched[0])
    n_new = launch.sum(dtype=torch.int32)

    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    # the source cell (on the AMR grid its node, amr_find_cell; on a clump
    # medium its clump, clump_find), its damping, Doppler width and
    # velocity (engine.py:2750-2775)
    a_loc, D_loc, v_src = p.a, p.Dfreq, p.v_src
    cell = (p.ic, p.jc, p.kc)
    src = [torch.full((B,), v, dtype=torch.float32, device=dev)
           for v in (p.xs, p.ys, p.zs)]
    if p.source is not None:
        # an extended source: each birth's own position (block 4)
        src = list(p.source.position(uniforms(seed, STREAM_REFILL, lanes,
                                              counter, BLOCK_SOURCE)))
        if p.clump is None and p.amr is None:
            cell = p.source.cells(src)
            if p.vel is not None:
                f = (cell[0].long() * p.source.n[1] + cell[1]) \
                    * p.source.n[2] + cell[2]
                v_src = tuple(v[f] for v in p.vel)
    if p.clump is not None:
        cell = (p.clump.find(*src), 0, 0)
    elif p.amr is not None:
        ic = p.amr.find_cell(*src)
        il = p.amr.leaf(ic)
        cell = (ic, 0, 0)
        a_loc, D_loc = p.amr.a_D(il, p.a, p.Dfreq)
        if p.vel is not None:
            v_src = tuple(p.amr.gather(v, il, 0.0) for v in p.vel)
    # D_loc / Dfreq_ref, exactly 1 at uniform temperature
    ratio = doppler_ratio(D_loc, p.Dfreq)
    u, v = uniforms(seed, STREAM_REFILL, lanes, counter, range(2))
    cost = 2.0 * u[0] - 1.0
    sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
    phi = TWOPI * u[1]
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    kx, ky, kz = sint * cosp, sint * sinp, cost

    xfreq = torch.full((B,), p.xfreq0, dtype=torch.float32, device=dev)
    if p.line.branch_init:
        w = uniforms(seed, STREAM_REFILL, lanes, counter, 3)
        xfreq = xfreq + pline.branch_init_shift_plain(p.line, w[0], w[1],
                                                      D_loc)
    if p.spectrum == SPECTRUM_VOIGT:
        a = a_loc if isinstance(a_loc, torch.Tensor) else torch.full(
            (B,), a_loc, dtype=torch.float32, device=dev)
        xfreq = xfreq + rand_voigt_x(a, u[2], u[3], v[0])
    elif p.spectrum == SPECTRUM_GAUSS:
        w = uniforms(seed, STREAM_REFILL, lanes, counter, 2)
        xfreq = (xfreq + box_muller(w[0], w[1]) * p.sigma_x) / ratio
    elif p.spectrum == SPECTRUM_CONT:
        # replaces xfreq, the branch shift too (engine.py:2804-2807)
        w = uniforms(seed, STREAM_REFILL, lanes, counter, 2)
        xfreq = (p.xfreq_min + w[0] * p.xfreq_span) / ratio

    # lab-frame source -> comoving frequency; Jin at the lab frequency
    if p.clump is not None:
        u1 = p.clump.vel_dot(cell[0].long(), kx, ky, kz, 'scale')
    else:
        u1 = v_src[0] * kx + v_src[1] * ky + v_src[2] * kz
    if not p.comoving_source:
        xfreq = xfreq - u1
    fx = torch.floor(div((xfreq + u1) * ratio - p.xfreq_min, p.dxfreq))
    inj = launch & (fx >= 0.0) & (fx < p.nxfreq)
    tallies.Jin.index_add_(0, torch.clamp(fx, 0, p.nxfreq - 1).long(),
                           inj.to(torch.float32))

    def put(name, value):
        cur = getattr(state, name)
        cur.copy_(torch.where(launch, torch.as_tensor(value, dtype=cur.dtype,
                                                      device=dev), cur))

    put('phase', FFS)
    for nm, val in zip(('x', 'y', 'z'), src):
        put(nm, val)
        put('b' + nm, val)
    for nm, val in zip(('ic', 'jc', 'kc'), cell):
        put(nm, val)
        put('b' + nm, val)
    for nm, val in (('kx', kx), ('ky', ky), ('kz', kz), ('xfreq', xfreq)):
        put(nm, val)
        put('b' + nm, val)
    put('wgt', 1.0)
    put('tau_target', v[1])
    put('tau_run', 0.0)
    for nm, val in (('Q', 0.0), ('U', 0.0), ('V', 0.0), ('mx', cost * cosp),
                    ('my', cost * sinp), ('mz', -sint), ('nnx', -sinp),
                    ('nny', cosp), ('nnz', 0.0), ('iband', 1)):
        put(nm, val)
    state.n_launched += n_new
    if record is not None:
        record.flag.copy_(launch.to(torch.int32))


def refill(state: BatchState, tallies: Tallies, p: RefillParams, seed: int,
           counter: int, budget: int, record=None) -> None:
    """Launch min(#dead, budget - n_launched) lanes, in place: kernel K2
    for a CUDA state, the plain version for a CPU state.  `record`, a
    PeelRecord of the batch's size, receives the launch flags."""
    if state.device.type == 'cpu':
        refill_plain(state, tallies, p, seed, counter, budget, record)
        return
    if budget + state.batch >= 2 ** 31:
        raise ValueError('photon budget + batch must stay below 2^31')
    kbuild.require_cuda('refill_point', tallies.Jin, state.n_launched,
                        *(getattr(state, f) for f in ('phase', 'x')),
                        *(() if record is None else (record.flag,)),
                        *(() if p.amr is None else p.amr.dev.tensors()),
                        *(() if p.clump is None else p.clump.dev.tensors()),
                        *(() if p.source is None
                          else p.source.table.tensors()),
                        *(p.vel or ()))
    kbuild.check(kbuild.library().lart_refill_point(
        state.lane_pointers, None if record is None else record.pointers,
        state.batch, state.n_launched.data_ptr(),
        int(budget), seed & 0xFFFFFFFF, counter & 0xFFFFFFFF,
        p.xs, p.ys, p.zs, p.ic, p.jc, p.kc, p.xfreq0, p.spectrum, p.sigma_x,
        p.a, *p.v_src, int(p.comoving_source), p.xfreq_min, p.dxfreq, p.nxfreq,
        tallies.Jin.data_ptr(), p.xfreq_span, p.Dfreq,
        ctypes.byref(p.line.c_struct),
        None if p.amr is None else ctypes.byref(p.amr.c_struct),
        None if p.clump is None else ctypes.byref(p.clump.c_struct),
        *(v.data_ptr() if v is not None else None
          for v in (p.vel or (None,) * 3)),
        None if p.source is None else ctypes.byref(p.source.c_struct),
        kbuild.stream_of(state.x)),
        'refill_point')
    kbuild.LAUNCHES['refill_point'] += 1
