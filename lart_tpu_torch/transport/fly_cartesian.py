"""Generic Cartesian flight: the Amanatides-Woo cell walk (kernel K5).

Counterpart of make_fly / fly (lart_tpu/transport/engine.py:1057, :1141).
Each step takes one lane across one cell: the
opacity of its cell is rhokap * H_eff(x; a, D) at the cell's damping a and
Doppler width D (the reference ones at uniform temperature, each cell's
own from a temp_file: engine.py:297-317), plus rhokap times the H2
multiplier with H2 pumping and the dust's rhokapD where DGR > 0
(engine.py:1106-1128 total_opacity); the
lane reaches its tau target (AT_SCATTER) or crosses the nearest face (axis
tie-break x, y, z), where the boundary op of that axis applies (escape,
periodic wrap, or reflect about the symmetry plane with the odd-n half
cell).  In a moving medium or at non-uniform temperature a cell change
shifts the comoving frequency, x' = (x + u1) D1/D2 - u2 (two f32
roundings, D1/D2 never folded into one ratio); an escape is binned at the
lab frequency (x + u) D / D_ref of the cell being left, a completed forced
first scattering at the birth cell's along the birth direction.

In a shearing box (omega_shear != 0, engine.py:1250-1313, :1406-1409) a
crossing of the periodic x boundary moves the lane's shear-frame
y-velocity vfy_shear by -omega_shear at the low face and +omega_shear at
the high one; a cell change then updates the comoving frequency with u1 +
vfy_shear ky and u2 + vfy_shear' ky' (the old and the new value, each an
fma on u.k, as XLA contracts them), also in a static medium, and an
escape is binned with the old one; a completed forced first scattering
restarts with vfy_shear 0 (its escaped fraction takes none).  With calcJ
or calcPnew (transport/jpa.py) each step of a lane through gas (rhoH > 0)
deposits its path length d wgt into J1 at the bin of its cell and the
cell's comoving frequency x D / D_ref, and d rhoH wgt / rhokap_phys into
Pnew, FFS lanes' birth rays included.  At
most max_steps crossings a
call (the while_loop's n < max_steps); a lane that completes its FFS
restarts from birth within the same budget.  No random numbers are drawn.

For line type 8 (engine.py:1276-1283, :1312-1340, :1466-1495) a lane of
the H-alpha band (iband 2) sees the dust only, rhokapD R_Ha (nothing
without dust), keeps its frequency, which is already a lab one, across
cells, and escapes into Jout_Ha at that frequency; each band's escaped
weight sums into W_esc1 or W_esc2, out-of-grid escapes included, and
W_esc1 also takes the escaped fraction of each completed forced first
scattering whose birth bin is on the grid.

In an exoplanet atmosphere (engine.py:1259-1272, :1302-1310, :1322-1333,
:1378-1382) a FLYING lane that leaves a plane atmosphere (1) through its
bottom z face, or that enters a masked core cell of a spherical one (2),
is destroyed: its weight goes to Jabs2 at the lab frequency of the cell
it leaves (W_oor off the frequency grid), not to Jout.  A forced first
scattering's birth ray that enters the core ends there with the optical
depth FFS_TAU_CAP (no escaped fraction) and restarts from birth; one that
leaves through the bottom face completes as any escape does.

With save_all_photons (tallies.allph, transport/allph.py) a lane that dies
writes its death row (engine.py:1434-1469): an escape and an atmosphere's
destruction at the lab frequency of the cell it leaves (the H-alpha band's
own frequency), a forced first scattering born in vacuum at its birth lab
frequency, each from the lane's state after the step that killed it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..kernels import build as kbuild
from .allph import record_deaths
from .flight import (BIG, FFS_TAU_CAP, TINY, FlightConsts, comoving,
                     doppler_ratio, fma, freq_floor, tally_plain)
from .jpa import block_plan, deposit_segments
from .state import AT_SCATTER, DEAD, FFS, FLYING, BatchState, Tallies


def _face_dist(pos, k, idx, amin, d):
    """Distance to the exit face along one axis (engine.py:1075-1079)."""
    flat = torch.abs(k) < 1e-12
    face = fma(torch.where(k > 0.0, idx + 1, idx).to(torch.float32), d, amin)
    t = (face - pos) / torch.where(flat, torch.ones_like(k), k)
    return torch.where(flat, torch.full_like(k, BIG), torch.clamp_min(t, 0.0))


def _cross_axis(p: FlightConsts, a: int, idx, pos, k):
    """Boundary op after stepping idx by sign(k) (engine.py:1081-1104):
    (idx, pos, k, escaped)."""
    n = p.n[a]
    nidx = idx + torch.where(k > 0.0, 1, -1).to(idx.dtype)
    lo, hi = nidx < 0, nidx >= n
    bc = p.bc[a]
    if bc == 'escape':
        return nidx, pos, k, lo | hi
    if bc == 'periodic':
        return (torch.where(lo, n - 1, torch.where(hi, 0, nidx)),
                torch.where(lo, p.amax[a], torch.where(hi, p.amin[a], pos)),
                k, torch.zeros_like(lo))
    if bc == 'reflect':
        return (torch.where(lo, p.cell0[a] - 1, nidx),
                torch.where(lo, -p.amin[a], pos), torch.where(lo, -k, k), hi)
    raise ValueError(bc)


def fly_plain(state: BatchState, tallies: Tallies, p: FlightConsts,
              max_steps: int, stats=None) -> None:
    """Plain PyTorch walk of every FLYING/FFS lane, in place; stats, a
    dict, gains the steps the lanes took (cell crossings and hits) under
    'steps'."""
    s = state
    oor = torch.zeros_like(s.wgt)
    zero = torch.zeros_like(s.wgt)
    # the band of each lane (constant through a flight)
    b2 = s.iband == 2 if p.lyb else None
    for _ in range(max_steps):
        is_ffs = s.phase == FFS
        moving = (s.phase == FLYING) | is_ffs
        if not bool(moving.any()):
            break       # the remaining iterations would change nothing
        if stats is not None:
            stats['steps'] = stats.get('steps', 0) + int(moving.sum())
        pos, dirs = (s.x, s.y, s.z), (s.kx, s.ky, s.kz)
        cell = (s.ic, s.jc, s.kc)
        flat = p.flat(*cell)
        D_c = p.cell_a_D(flat)[1]
        rho, rhoH = p.opacity_parts(flat, s.xfreq, b2)
        t = [_face_dist(pos[a], dirs[a], cell[a], p.amin[a], p.d[a])
             if p.walk[a] else torch.full_like(s.x, BIG) for a in range(3)]
        dmin = torch.minimum(torch.minimum(t[0], t[1]), t[2])
        axis = torch.where(dmin == t[0], 0, torch.where(dmin == t[1], 1, 2))
        tgt = torch.where(is_ffs, torch.full_like(s.tau_target, FFS_TAU_CAP),
                          s.tau_target)
        dtau = dmin * rho
        hit = s.tau_run + dtau >= tgt
        d_adv = torch.where(hit, (tgt - s.tau_run) / torch.clamp_min(rho, TINY),
                            dmin)
        npos = [fma(d_adv, dirs[a], pos[a]) for a in range(3)]
        tau_n = torch.where(hit, tgt, s.tau_run + dtau)
        if p.jpa is not None:
            # the segment's J1 and Pnew deposits (engine.py:1199-1219)
            deposit_segments(p.jpa, tallies, p, moving & (rhoH > 0.0), cell,
                             s.xfreq, doppler_ratio(D_c, p.Dfreq), d_adv,
                             rhoH, s.wgt, p.rhokap[flat], D_c)

        crossed = moving & ~hit
        escaped = torch.zeros_like(hit)
        ncell, ndir = list(cell), list(dirs)
        for a in range(3):
            c2, p2, k2, esc = _cross_axis(p, a, cell[a], npos[a], dirs[a])
            ca = crossed & (axis == a)
            ncell[a] = torch.where(ca, c2, cell[a])
            npos[a] = torch.where(ca, p2, npos[a])
            ndir[a] = torch.where(ca, k2, dirs[a])
            escaped = escaped | (ca & esc)

        # the shearing box: a periodic x wrap moves the lane's shear-frame
        # y-velocity by -+ omega_shear (engine.py:1250-1257)
        shear_new = s.vfy_shear
        if p.omega_shear != 0.0:
            cx = crossed & (axis == 0)
            nxt = s.ic + torch.where(s.kx > 0.0, 1, -1).to(s.ic.dtype)
            shear_new = (s.vfy_shear
                         - torch.where(cx & (nxt < 0), p.omega_shear, 0.0)
                         + torch.where(cx & (nxt >= p.n[0]), p.omega_shear,
                                       0.0))

        # comoving frequency update on a cell change, in a moving medium, at
        # non-uniform temperature or in a shearing box (engine.py:
        # 1276-1295); the H-alpha band's frequency is a lab one
        changed = crossed & ~escaped
        if p.lyb:
            changed = changed & ~b2
        if p.moving:
            u1 = p.vel_dot(cell, *dirs)
            u2 = p.vel_dot(ncell, *ndir)
            u_b = p.vel_dot((s.bic, s.bjc, s.bkc), s.bkx, s.bky, s.bkz)
        else:
            u1 = u2 = u_b = torch.zeros_like(s.xfreq)
        if p.omega_shear != 0.0:
            # the shear frame's velocity along k, old and new (:1288-1290);
            # the escape takes the old one too (:1312-1313), the forced
            # first scattering's birth frequency none
            u1 = fma(s.vfy_shear, s.ky, u1)
            u2 = fma(shear_new, ndir[1], u2)
        if p.comoving:
            D2 = p.cell_a_D(p.flat(*ncell))[1]
            xfreq_new = torch.where(
                changed, comoving(s.xfreq, u1, D_c, D2, u2), s.xfreq)
        else:
            xfreq_new = s.xfreq

        # escape at the lab frequency of the cell being left,
        # (x + u) D_cell / D_ref
        esc_fly = escaped & (s.phase == FLYING)
        xlab = (s.xfreq + u1) * doppler_ratio(D_c, p.Dfreq)
        ffs_done = (escaped & is_ffs) | (hit & is_ffs)
        dead_atm = None
        if p.atmosphere:
            # the bottom face of a plane atmosphere, the masked core of a
            # spherical one: the lane is destroyed into Jabs2
            bottom = escaped & (axis == 2) & (ncell[2] < 0) \
                if p.atmosphere == 1 else torch.zeros_like(escaped)
            hitmask = crossed & ~escaped & p.masked(p.flat(*ncell))
            mask_fly = hitmask & (s.phase == FLYING)
            mask_ffs = hitmask & is_ffs
            # a birth ray ending in the core escapes nothing
            tau_n = torch.where(mask_ffs, torch.full_like(tau_n, FFS_TAU_CAP),
                                tau_n)
            ffs_done = ffs_done | mask_ffs
            dead_atm = (esc_fly & bottom) | mask_fly
            esc_fly = esc_fly & ~bottom
            oor = oor + tally_plain(tallies, p, dead_atm, xlab, s.wgt, None,
                                    tallies.Jabs2)
        if p.lyb:
            oor = oor + tally_plain(tallies, p, esc_fly & ~b2, xlab,
                                    s.wgt, s.kz)
            oor = oor + tally_plain(tallies, p, esc_fly & b2, s.xfreq,
                                    s.wgt, s.kz, tallies.Jout_Ha)
            tallies.W_esc1 += torch.where(esc_fly & ~b2, s.wgt, zero).sum()
            tallies.W_esc2 += torch.where(esc_fly & b2, s.wgt, zero).sum()
        else:
            oor = oor + tally_plain(tallies, p, esc_fly, xlab, s.wgt, s.kz)
        # forced first scattering done: the escaped fraction at the birth
        # lab frequency (x_b + u_b) D_b / D_ref, restart from birth with
        # wgt *= 1 - exp(-tau0)
        tau0 = tau_n
        wgt_esc = s.wgt * torch.exp(-tau0)
        D_b = p.cell_a_D(p.flat(s.bic, s.bjc, s.bkc))[1]
        xlab_b = (s.bxfreq + u_b) * doppler_ratio(D_b, p.Dfreq)
        oor = oor + tally_plain(tallies, p, ffs_done, xlab_b, wgt_esc, s.bkz)
        if p.lyb:
            inb = freq_floor(p, xlab_b)[1]
            tallies.W_esc1 += torch.where(ffs_done & inb, wgt_esc, zero).sum()
        wgt1 = -torch.expm1(-tau0)
        ffs_vacuum = ffs_done & (tau0 <= 0.0)
        dead_now = esc_fly if dead_atm is None else esc_fly | dead_atm
        if tallies.allph is not None:
            # the death rows' lab frequencies (engine.py:1434-1441)
            xf2 = xlab if b2 is None else torch.where(b2, s.xfreq, xlab)
            xf2 = torch.where(ffs_vacuum, xlab_b, xf2)
        phase_new = torch.where(
            dead_now | ffs_vacuum, DEAD,
            torch.where(ffs_done, FLYING,
                        torch.where(hit & ~is_ffs, AT_SCATTER, s.phase))
        ).to(torch.int32)

        def put(name, new, birth):
            cur = getattr(s, name)
            cur.copy_(torch.where(ffs_done, birth,
                                  torch.where(moving, new, cur)))

        new_target = torch.where(
            ffs_done, -torch.log1p(-torch.clamp_max(s.tau_target, 0.99999)
                                   * wgt1), s.tau_target)
        s.phase.copy_(torch.where(moving, phase_new, s.phase))
        for name, new in zip(('x', 'y', 'z', 'ic', 'jc', 'kc', 'kx', 'ky',
                              'kz', 'xfreq'),
                             (*npos, *ncell, *ndir, xfreq_new)):
            put(name, new, getattr(s, 'b' + name))
        if p.omega_shear != 0.0:
            # a completed forced first scattering restarts unsheared
            # (engine.py:1406-1409)
            put('vfy_shear', shear_new, torch.zeros_like(shear_new))
        s.wgt.copy_(torch.where(ffs_done, s.wgt * wgt1, s.wgt))
        s.tau_run.copy_(torch.where(
            ffs_done, torch.zeros_like(tau_n),
            torch.where(moving, tau_n, s.tau_run)))
        s.tau_target.copy_(new_target)
        if tallies.allph is not None:
            record_deaths(tallies.allph, s, dead_now | ffs_vacuum, xf2)
    tallies.W_oor += oor.sum()


@dataclasses.dataclass(frozen=True, eq=False)
class CartesianFlight(FlightConsts):
    """The walk's constants and grid; calling it flies a batch (K5)."""

    def __call__(self, state: BatchState, tallies: Tallies,
                 max_steps: int) -> None:
        fly(state, tallies, self, max_steps)


def deposit_plan(p: FlightConsts, tallies: Tallies) -> tuple:
    """K5's block plan (jpa.block_plan): the slots of the block copies of
    Pnew (nbin) and J1 (nxfreq x nbin), both f64, Pnew first."""
    if p.jpa is None:
        return (0, 0)
    j1, _, pnew = p.jpa.sizes(p.nxfreq)
    return block_plan(pnew if tallies.Pnew is not None else 0,
                      j1 if tallies.J1 is not None else 0)


def fly(state: BatchState, tallies: Tallies, p: FlightConsts,
        max_steps: int) -> None:
    """Walk every FLYING/FFS lane, in place: kernel K5 for a CUDA state,
    the plain version for a CPU state."""
    if state.device.type == 'cpu':
        fly_plain(state, tallies, p, max_steps)
        return
    kbuild.require_cuda('fly_cartesian', tallies.Jout, tallies.Jmu,
                        tallies.W_oor, state.x, *p.device_tensors(),
                        *((tallies.Jout_Ha, tallies.W_esc1, tallies.W_esc2)
                          if p.lyb else ()),
                        *((tallies.Jabs2,) if p.atmosphere else ()),
                        *(p.jpa.tallies(tallies) if p.jpa else ()),
                        *(tallies.allph.tensors()
                          if tallies.allph is not None else ()))
    kbuild.check(kbuild.library().lart_fly_cartesian(
        state.lane_pointers, state.batch, max_steps,
        ctypes.byref(p.c_params(tallies)), *deposit_plan(p, tallies),
        kbuild.stream_of(state.x)), 'fly_cartesian')
    kbuild.LAUNCHES['fly_cartesian'] += 1
