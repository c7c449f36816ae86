"""Refill: dead lanes are reborn from the photon budget (kernel K2).

Counterpart of make_refill / refill (lart_tpu/transport/engine.py:2557,
:2689) for a point source (source_geometry 'point' or '') with a Voigt,
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
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import build as kbuild
from ..physics import line as pline
from ..physics.rng import STREAM_REFILL, uniforms
from ..physics.samplers import TWOPI, box_muller, rand_voigt_x
from .flight import AmrGrid, ClumpGrid, div, doppler_ratio
from .state import DEAD, FFS, BatchState, Tallies

SPECTRUM_MONO, SPECTRUM_VOIGT, SPECTRUM_GAUSS, SPECTRUM_CONT = 0, 1, 2, 3
SPECTRA = {'monochromatic': SPECTRUM_MONO, 'voigt': SPECTRUM_VOIGT,
           'gaussian': SPECTRUM_GAUSS, 'continuum': SPECTRUM_CONT}


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
    vel: Optional[tuple] = None      # its per-leaf velocities (moving)
    clump: Optional[ClumpGrid] = None   # the clumps, on a clump medium

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
            if not meta.static_medium:
                v_src = tuple(float(v[tuple(cells)])
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
                   clump=clump)


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
    for nm, val in (('x', p.xs), ('y', p.ys), ('z', p.zs)):
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
                        *(() if p.clump is None else p.clump.dev.tensors()))
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
        kbuild.stream_of(state.x)),
        'refill_point')
    kbuild.LAUNCHES['refill_point'] += 1
