"""Resonant Ly-alpha scattering (kernel K4).

Counterpart of make_scatter / scatter (lart_tpu/transport/engine.py:1838,
:2087) for line_type 1 without dust, H2 or recoil: the redistribute branch
of :1947-1953, rand_resonance_cost, phi = 2 pi xi, the perpendicular atom
velocity with the core-skip boost (:2197-2205), xfreq_new,
rotate_direction (:1854) and the next optical depth.

With use_stokes (:2165-2190, :2231-2265, :2486-2496) the azimuth is drawn
by rejection from 1 + (S12/S11)(Q cos 2phi + U sin 2phi) over
scatter_rounds rounds (a lane that fails them stays AT_SCATTER, as one that
fails the u_par rounds does), and the direction, the reference triad
(m, n) and the Stokes vector turn together; the triad is re-orthonormalized
against f32 drift in lart_tpu's order.

With peel-off on, the scatter writes a PeelRecord: the flag of the lanes
that scattered, and their pre-scatter direction (with use_stokes also the
triad and Stokes vector) with this event's xfreq_atom and atom velocity
(:2207-2218), which the resonance peel (kernel K7) reads right after.

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
and with use_stokes block rounds + 2 + r the azimuth round r (after the
blocks a lane without Stokes draws, so those draw as before).  Core-skip
draws nothing new.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import build as kbuild
from ..physics import samplers
from ..physics.rng import STREAM_SCATTER, uniforms
from .flight import div
from .state import AT_SCATTER, FLYING, BatchState, Tallies

TINY = 1e-30
CORE_SKIP_OFF, CORE_SKIP_LOCAL, CORE_SKIP_GLOBAL = 0, 1, 2


@dataclasses.dataclass(frozen=True, eq=False)
class ScatterParams:
    a: float          # Voigt damping parameter (uniform temperature)
    E1: float         # dipole weight of the line's phase function
    rounds: int       # rejection rounds per call
    stokes: bool = False       # use_stokes: azimuth, triad and Stokes
    E2: float = 0.0            # isotropic and circular phase weights
    E3: float = 1.0
    core_skip: int = CORE_SKIP_OFF
    xcrit: float = 0.0         # core_skip_global's threshold and its square
    xcrit2: float = 0.0
    rk_const: float = -1.0     # local: sphere_rho on the sphere fast path
    rhokap: Optional[torch.Tensor] = None   # local: flat grid, else
    n: tuple = (1, 1, 1)
    amin: tuple = (0.0, 0.0, 0.0)
    d: tuple = (1.0, 1.0, 1.0)

    @classmethod
    def from_config(cls, cfg, meta, grid=None,
                    uniform_sphere=False) -> 'ScatterParams':
        """Constants of a config that engine.check_supported accepted;
        `uniform_sphere` is engine.uniform_sphere_fastpath(cfg, meta)."""
        par = cfg.par
        mode = CORE_SKIP_OFF
        if par.core_skip:
            mode = CORE_SKIP_GLOBAL if par.core_skip_global \
                else CORE_SKIP_LOCAL
        local = mode == CORE_SKIP_LOCAL
        line = cfg.line
        return cls(a=float(meta.voigt_a_ref), E1=float(line.E1),
                   rounds=int(par.scatter_rounds),
                   stokes=bool(par.use_stokes), E2=float(line.E2),
                   E3=float(line.E3), core_skip=mode,
                   xcrit=float(meta.xcrit), xcrit2=float(meta.xcrit2),
                   rk_const=float(meta.sphere_rho) if uniform_sphere
                   else -1.0,
                   rhokap=grid.rhokap.reshape(-1).contiguous()
                   if local and not uniform_sphere else None,
                   n=(meta.nx, meta.ny, meta.nz),
                   amin=(meta.xmin, meta.ymin, meta.zmin),
                   d=(meta.dx, meta.dy, meta.dz))


def local_xcrit(s: BatchState, p: ScatterParams):
    """(xcrit, xcrit^2) of every lane (engine.py:1872-1905)."""
    if p.core_skip == CORE_SKIP_GLOBAL:
        return (torch.full_like(s.x, p.xcrit),
                torch.full_like(s.x, p.xcrit2))
    dl = None
    for pos, c, amin, d in zip((s.x, s.y, s.z), (s.ic, s.jc, s.kc), p.amin,
                               p.d):
        f = amin + c.to(torch.float32) * d
        dla = torch.minimum(pos - f, f + d - pos)
        dl = dla if dl is None else torch.minimum(dl, dla)
    if p.rk_const > 0.0:
        rk = torch.full_like(s.x, p.rk_const)
    else:
        nx, ny, nz = p.n
        flat = (s.ic.long() * ny + s.jc) * nz + s.kc
        rk = p.rhokap[torch.clamp(flat, 0, nx * ny * nz - 1)]
    atau = p.a * rk * torch.clamp_min(dl, 0.0)
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


def scatter_plain(state: BatchState, tallies: Tallies, p: ScatterParams,
                  seed: int, counter: int, record=None) -> None:
    """Plain PyTorch scatter of every AT_SCATTER lane, in place; fills
    `record` (a PeelRecord) when it is given."""
    s = state
    lanes = torch.arange(s.batch, dtype=torch.int64, device=s.device)
    at_sc = s.phase == AT_SCATTER
    env = samplers.vz_envelope(s.xfreq, p.a)
    u = uniforms(seed, STREAM_SCATTER, lanes, counter, range(p.rounds + 2))
    acc = torch.zeros_like(at_sc)
    uz = torch.zeros_like(s.xfreq)
    for r in range(p.rounds):
        acc, uz = samplers.vz_round_xi(u[r], env, acc, uz, at_sc)
    xfreq_atom = s.xfreq - uz

    xi = u[p.rounds]
    cost = samplers.rand_resonance_cost(xi[0], p.E1)
    cost2 = cost * cost
    sint = torch.sqrt(torch.clamp_min(1.0 - cost2, 0.0))
    if p.stokes:
        # the line's scattering matrix; the azimuth by rejection
        S22 = 0.75 * p.E1 * (cost2 + 1.0)
        S11 = S22 + p.E2
        S12 = 0.75 * p.E1 * (cost2 - 1.0)
        S33 = 1.5 * p.E1 * cost
        S44 = 1.5 * p.E3 * cost
        S12o = S12 / torch.clamp_min(S11, TINY)
        pmag = torch.sqrt(s.Q * s.Q + s.U * s.U)
        uph = uniforms(seed, STREAM_SCATTER, lanes, counter,
                       range(p.rounds + 2, 2 * p.rounds + 2))
        acc_phi = torch.zeros_like(acc)
        phi = torch.zeros_like(s.x)
        for r in range(p.rounds):
            phi_p = samplers.TWOPI * uph[r, 0]
            prand = (1.0 + torch.abs(S12o) * pmag) * uph[r, 1]
            pcomp = 1.0 + S12o * (s.Q * torch.cos(2.0 * phi_p)
                                  + s.U * torch.sin(2.0 * phi_p))
            take = ~acc_phi & (prand <= pcomp)
            phi = torch.where(take, phi_p, phi)
            acc_phi = acc_phi | take
        acc = acc & acc_phi
    else:
        phi = samplers.TWOPI * xi[1]
    do_res = at_sc & acc
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    phi2 = samplers.TWOPI * xi[2]
    boost = torch.zeros_like(s.xfreq)
    if p.core_skip != CORE_SKIP_OFF:
        xcrit, xcrit2 = local_xcrit(s, p)
        boost = torch.where(torch.abs(s.xfreq) < xcrit, xcrit2, boost)
    uxy = torch.sqrt(boost - torch.log(xi[3]))
    ux, uy = uxy * torch.cos(phi2), uxy * torch.sin(phi2)
    xfreq_new = xfreq_atom + uz * cost + (ux * cosp + uy * sinp) * sint
    tau_next = -torch.log(torch.clamp_min(u[p.rounds + 1, 0], 1e-12))

    if record is not None:
        # the event as the resonance peel sees it: before the turn
        record.flag.copy_(do_res.to(torch.int32))
        for f in ('kx', 'ky', 'kz') + (('mx', 'my', 'mz', 'nnx', 'nny',
                                        'nnz', 'Q', 'U', 'V')
                                       if p.stokes else ()):
            getattr(record, f).copy_(getattr(s, f))
        for f, v in (('xatom', xfreq_atom), ('ux', ux), ('uy', uy),
                     ('uz', uz)):
            getattr(record, f).copy_(v)

    def put(name, new):
        cur = getattr(s, name)
        cur.copy_(torch.where(do_res, new, cur))

    if p.stokes:
        for name, new in zip(('kx', 'ky', 'kz', 'mx', 'my', 'mz', 'nnx',
                              'nny', 'nnz', 'Q', 'U', 'V'),
                             stokes_turn(s, cost, sint, cosp, sinp, S11, S12,
                                         S22, S33, S44)):
            put(name, new)
    else:
        for name, new in zip(('kx', 'ky', 'kz'),
                             rotate_direction(s.kx, s.ky, s.kz, cost, sint,
                                              cosp, sinp)):
            put(name, new)
    s.phase.copy_(torch.where(do_res, FLYING, s.phase).to(torch.int32))
    put('xfreq', xfreq_new)
    put('tau_target', tau_next)
    put('tau_run', torch.zeros_like(s.tau_run))
    tallies.nscatt_gas += torch.where(do_res, s.wgt,
                                      torch.zeros_like(s.wgt)).sum()
    tallies.nscatt_events += do_res.sum(dtype=torch.float32)


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


def scatter(state: BatchState, tallies: Tallies, p: ScatterParams,
            seed: int, counter: int, record=None) -> None:
    """Scatter every AT_SCATTER lane, in place: kernel K4 for a CUDA state,
    the plain version for a CPU state.  `record`, a PeelRecord of the
    batch's size, receives the events for the resonance peel."""
    if state.device.type == 'cpu':
        scatter_plain(state, tallies, p, seed, counter, record)
        return
    grid = () if p.rhokap is None else (p.rhokap,)
    kbuild.require_cuda('scatter_lya', tallies.nscatt_gas,
                        tallies.nscatt_events, state.x, *grid,
                        *(() if record is None else (record.flag,)))
    kbuild.check(kbuild.library().lart_scatter_lya(
        state.lane_pointers, None if record is None else record.pointers,
        state.batch, seed & 0xFFFFFFFF,
        counter & 0xFFFFFFFF, p.rounds, p.a, p.E1, int(p.stokes), p.E2,
        p.E3, p.core_skip, p.xcrit,
        p.xcrit2, p.rk_const, grid[0].data_ptr() if grid else None, *p.n,
        *p.amin, *p.d, tallies.nscatt_gas.data_ptr(),
        tallies.nscatt_events.data_ptr(), kbuild.stream_of(state.x)),
        'scatter_lya')
    kbuild.LAUNCHES['scatter_lya'] += 1
