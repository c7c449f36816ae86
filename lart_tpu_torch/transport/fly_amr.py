"""The octree AMR flight (kernel K8).

Counterpart of make_fly_amr / fly (lart_tpu/transport/engine.py:1507-1831)
without atmospheres or CALCJ/Pnew.  A lane's cell index ic is an octree
node (jc, kc unused).  Each step takes one lane
across one node: the node's opacity is its leaf's rhokap times the line's
profile at the leaf's damping and Doppler width (a gap cell, a missing
octant of an internal node, has none), plus rhokap times the H2
multiplier with H2 pumping and the leaf's rhokapD with dust; for line
type 8 a lane of the H-alpha band sees the dust only, rhokapD R_Ha.  The
exit face is the nearest of the node's six (ties x, then y, then z; faces
0 = +x, 1 = -x, ... 5 = -z); the lane reaches its tau target
(AT_SCATTER) or snaps to the face plane, hops to the neighbor across it
and descends to the node it enters (csrc/amr.cuh: one fine-map gather, or
the octant descent), or escapes where the face has no neighbor.  On a
node change, in a moving medium or at non-uniform temperature, the
comoving frequency becomes x' = (x + u1) D1/D2 - u2 (band 1 only).  An
escape is binned at the lab frequency (x + u) D / D_ref of the node being
left, a completed forced first scattering at its birth node's, along the
birth direction.  At most max_steps crossings a call; a lane that
completes its FFS restarts from birth within the same budget.  No random
numbers are drawn.

With line type 8 each band's escaped weight sums into W_esc1 or W_esc2 and
the H-alpha band escapes into Jout_Ha at its own (lab) frequency, as K5's.
With save_all_photons (tallies.allph) a lane that dies writes its death row
as K5's does (engine.py:1761-1796): an escape at the lab frequency of the
node it leaves, a forced first scattering born in vacuum at its birth
node's.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..kernels import build as kbuild
from ..physics import h2 as ph2
from ..physics import line as pline
from .allph import record_deaths
from .flight import (BIG, FFS_TAU_CAP, TINY, AmrGrid, FlightConsts, comoving,
                     doppler_ratio, fma, freq_floor, tally_plain)
from .state import AT_SCATTER, DEAD, FFS, FLYING, BatchState, Tallies


@dataclasses.dataclass(frozen=True, eq=False)
class AmrFlight(FlightConsts):
    """The walk's constants and the octree (FlightConsts.amr); calling it
    flies a batch (K8).  rhokap, rhokapD and the velocities are per leaf."""

    @classmethod
    def from_amr(cls, cfg, meta, dev) -> 'AmrFlight':
        """Constants of an AMR config that engine.check_supported accepted;
        dev is the grid's AmrDevice."""
        par = cfg.par
        mu_min = 0.0 if par.xyz_symmetry else -1.0
        vel = None if meta.static_medium else (dev.vfx, dev.vfy, dev.vfz)
        amin = (meta.xmin, meta.ymin, meta.zmin)
        return cls(
            n=(meta.nx, 1, 1), bc=('escape',) * 3, cell0=(0, 0, 0),
            walk=(True, True, True), amin=amin,
            amax=(meta.xmax, meta.ymax, meta.zmax),
            d=(meta.dx, meta.dy, meta.dz), a_ref=meta.voigt_a_ref,
            Dfreq=meta.Dfreq_ref, xfreq_min=meta.xfreq_min,
            dxfreq=meta.dxfreq, nxfreq=meta.nxfreq,
            save_Jmu=bool(par.save_Jmu), nmu=par.nmu, mu_min=mu_min,
            dmu=(1.0 - mu_min) / par.nmu, mu_abs=bool(par.xyz_symmetry),
            sphere_R2=1.0, sphere_rho=-1.0, sphere_rhoD=0.0,
            rhokap=dev.rhokap, vel=vel, rhokapD=dev.rhokapD,
            line=pline.LineConsts.from_config(cfg),
            h2=ph2.H2Consts.from_config(cfg),
            R_Ha=(par.cext_dust_Ha / par.cext_dust if par.cext_dust > 0
                  else 0.0),
            amr=AmrGrid.from_meta(meta, dev))

    def __call__(self, state: BatchState, tallies: Tallies,
                 max_steps: int) -> None:
        fly(state, tallies, self, max_steps)

    # the per-leaf physics of nodes (engine.py:297-356)
    def leaf_opacity(self, il, xfreq, a, D, band2=None) -> torch.Tensor:
        """rhokap H_eff(x; a, D) (+ rhokap H2(x)) + rhokapD of the leaves
        il (0 in a gap); where band2 is set, rhokapD R_Ha or 0."""
        g = self.amr.gather
        rk = g(self.rhokap, il, 0.0)
        rho = rk * pline.line_profile_plain(self.line, xfreq, a, D)
        if self.h2 is not None:
            rho = rho + rk * ph2.h2_kappa_plain(self.h2, xfreq, D)
        if self.rhokapD is not None:
            rho = rho + g(self.rhokapD, il, 0.0)
        if band2 is not None:
            rho2 = torch.zeros_like(rho) if self.rhokapD is None \
                else g(self.rhokapD, il, 0.0) * self.R_Ha
            rho = torch.where(band2, rho2, rho)
        return rho

    def leaf_vel_dot(self, il, kx, ky, kz) -> torch.Tensor:
        """u . k of the leaves il (0 in a gap or a static medium)."""
        if not self.moving:
            return torch.zeros_like(kx)
        g = self.amr.gather
        vx, vy, vz = self.vel
        return g(vx, il, 0.0) * kx + g(vy, il, 0.0) * ky + g(vz, il, 0.0) * kz

    def flat(self, i, j=None, k=None) -> torch.Tensor:
        """The leaves of nodes i (-1 in a gap): the index of the per-leaf
        arrays, as FlightConsts.flat is of a Cartesian grid's."""
        return self.amr.leaf(i)

    def vel_dot(self, cell, kx, ky, kz) -> torch.Tensor:
        """u . k of the nodes cell[0] (engine.cell_velocity_dot)."""
        return self.leaf_vel_dot(self.amr.leaf(cell[0]), kx, ky, kz)

    def node_box(self, ic):
        """(cx, cy, cz, h) of nodes ic (clamped)."""
        d = self.amr.dev
        c = torch.clamp(ic.long(), 0, d.ncells - 1)
        return d.node_cx[c], d.node_cy[c], d.node_cz[c], d.node_ch[c]


def _axis_t(pos, k, c, h):
    """Distance to a node's exit face along one axis (engine.py:1571-1576)."""
    flat = torch.abs(k) < 1e-12
    face = c + torch.where(k > 0, h, -h)
    t = (face - pos) / torch.where(flat, torch.ones_like(k), k)
    return torch.where(flat, torch.full_like(k, BIG), torch.clamp_min(t, 0.0))


def exit_face(pos, dirs, box):
    """(dmin, axis, face) of the nearest exit face of nodes box = (cx, cy,
    cz, h): ties x, then y, then z; faces 0 = +x, 1 = -x, ... 5 = -z."""
    t = [_axis_t(pos[a], dirs[a], box[a], box[3]) for a in range(3)]
    dmin = torch.minimum(torch.minimum(t[0], t[1]), t[2])
    axis = torch.where(dmin == t[0], 0, torch.where(dmin == t[1], 1, 2))
    kax = torch.where(axis == 0, dirs[0], torch.where(axis == 1, dirs[1],
                                                      dirs[2]))
    face = axis * 2 + torch.where(kax > 0, 0, 1)
    return dmin, axis, face


def hop(p: AmrFlight, ic, face, pos) -> tuple:
    """(neighbor across face, whether there is none, the node entered at
    the face point pos) of nodes ic (engine.py:1631-1637)."""
    d = p.amr.dev
    nb = d.neighbor.reshape(-1)[torch.clamp(
        torch.clamp_min(ic.long(), 0) * 6 + face, 0, d.neighbor.numel() - 1)]
    return nb, nb < 0, p.amr.descend_from_face(torch.clamp_min(nb, 0), face,
                                               *pos)


def fly_plain(state: BatchState, tallies: Tallies, p: AmrFlight,
              max_steps: int, stats=None) -> None:
    """Plain PyTorch walk of every FLYING/FFS lane, in place; stats, a
    dict, gains the steps the lanes took under 'steps' and marks the nodes
    they stood in under 'nodes'."""
    s = state
    amr = p.amr
    oor = torch.zeros_like(s.wgt)
    zero = torch.zeros_like(s.wgt)
    b2 = s.iband == 2 if p.lyb else None
    update = p.moving or not amr.uniform_temperature
    for _ in range(max_steps):
        is_ffs = s.phase == FFS
        moving = (s.phase == FLYING) | is_ffs
        if not bool(moving.any()):
            break       # the remaining iterations would change nothing
        if stats is not None:
            stats['steps'] = stats.get('steps', 0) + int(moving.sum())
            if 'nodes' not in stats:
                stats['nodes'] = torch.zeros(amr.dev.ncells, dtype=torch.bool,
                                             device=s.device)
            stats['nodes'][s.ic[moving].long()] = True
        pos, dirs = (s.x, s.y, s.z), (s.kx, s.ky, s.kz)
        il = amr.leaf(s.ic)
        a_c, D_c = amr.a_D(il, p.a_ref, p.Dfreq)
        rho = p.leaf_opacity(il, s.xfreq, a_c, D_c, b2)
        box = p.node_box(s.ic)
        dmin, axis, face = exit_face(pos, dirs, box)
        tgt = torch.where(is_ffs, torch.full_like(s.tau_target, FFS_TAU_CAP),
                          s.tau_target)
        dtau = dmin * rho
        hit = s.tau_run + dtau >= tgt
        d_adv = torch.where(
            hit, (tgt - s.tau_run) / torch.clamp_min(rho, TINY), dmin)
        tau_n = torch.where(hit, tgt, s.tau_run + dtau)
        crossed = moving & ~hit
        # the advanced position; the crossed coordinate snaps to the face
        npos = []
        for a in range(3):
            fa = box[a] + torch.where(dirs[a] > 0, box[3], -box[3])
            npos.append(torch.where(crossed & (axis == a), fa,
                                    fma(d_adv, dirs[a], pos[a])))
        nb, no_nb, ic_in = hop(p, s.ic, face, npos)
        escaped = crossed & no_nb
        ic_new = torch.where(crossed & ~escaped, ic_in, s.ic)

        # comoving frequency on a node change (engine.py:1639-1652)
        changed = crossed & ~escaped
        if p.lyb:
            changed = changed & ~b2
        u1 = p.leaf_vel_dot(il, *dirs)
        if update:
            il2 = amr.leaf(ic_new)
            _, D2 = amr.a_D(il2, p.a_ref, p.Dfreq)
            u2 = p.leaf_vel_dot(il2, *dirs)
            xfreq_new = torch.where(
                changed, comoving(s.xfreq, u1, D_c, D2, u2), s.xfreq)
        else:
            xfreq_new = s.xfreq

        # escape at the lab frequency of the node being left
        esc_fly = escaped & (s.phase == FLYING)
        xlab = (s.xfreq + u1) * doppler_ratio(D_c, p.Dfreq)
        if p.lyb:
            oor = oor + tally_plain(tallies, p, esc_fly & ~b2, xlab, s.wgt,
                                    s.kz)
            oor = oor + tally_plain(tallies, p, esc_fly & b2, s.xfreq, s.wgt,
                                    s.kz, tallies.Jout_Ha)
            tallies.W_esc1 += torch.where(esc_fly & ~b2, s.wgt, zero).sum()
            tallies.W_esc2 += torch.where(esc_fly & b2, s.wgt, zero).sum()
        else:
            oor = oor + tally_plain(tallies, p, esc_fly, xlab, s.wgt, s.kz)
        # forced first scattering done: the escaped fraction at the birth
        # node's lab frequency, restart from birth with wgt *= 1 - exp(-tau0)
        ffs_done = (escaped & is_ffs) | (hit & is_ffs)
        tau0 = tau_n
        ilb = amr.leaf(s.bic)
        _, D_b = amr.a_D(ilb, p.a_ref, p.Dfreq)
        xlab_b = (s.bxfreq + p.leaf_vel_dot(ilb, s.bkx, s.bky, s.bkz)) \
            * doppler_ratio(D_b, p.Dfreq)
        wgt_esc = s.wgt * torch.exp(-tau0)
        oor = oor + tally_plain(tallies, p, ffs_done, xlab_b, wgt_esc, s.bkz)
        if p.lyb:
            inb = freq_floor(p, xlab_b)[1]
            tallies.W_esc1 += torch.where(ffs_done & inb, wgt_esc, zero).sum()
        wgt1 = -torch.expm1(-tau0)
        ffs_vacuum = ffs_done & (tau0 <= 0.0)
        if tallies.allph is not None:
            # the death rows' lab frequencies (engine.py:1761-1767)
            xf2 = xlab if b2 is None else torch.where(b2, s.xfreq, xlab)
            xf2 = torch.where(ffs_vacuum, xlab_b, xf2)
        phase_new = torch.where(
            esc_fly | ffs_vacuum, DEAD,
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
        for name, new in zip(('x', 'y', 'z', 'ic', 'xfreq'),
                             (*npos, ic_new, xfreq_new)):
            put(name, new, getattr(s, 'b' + name))
        for name in ('kx', 'ky', 'kz'):
            cur = getattr(s, name)
            cur.copy_(torch.where(ffs_done, getattr(s, 'b' + name), cur))
        s.wgt.copy_(torch.where(ffs_done, s.wgt * wgt1, s.wgt))
        s.tau_run.copy_(torch.where(
            ffs_done, torch.zeros_like(tau_n),
            torch.where(moving, tau_n, s.tau_run)))
        s.tau_target.copy_(new_target)
        if tallies.allph is not None:
            record_deaths(tallies.allph, s, esc_fly | ffs_vacuum, xf2)
    tallies.W_oor += oor.sum()


def fly(state: BatchState, tallies: Tallies, p: AmrFlight,
        max_steps: int) -> None:
    """Walk every FLYING/FFS lane, in place: kernel K8 for a CUDA state,
    the plain version for a CPU state."""
    if state.device.type == 'cpu':
        fly_plain(state, tallies, p, max_steps)
        return
    kbuild.require_cuda('fly_amr', tallies.Jout, tallies.Jmu, tallies.W_oor,
                        state.x, *p.device_tensors(),
                        *((tallies.Jout_Ha, tallies.W_esc1, tallies.W_esc2)
                          if p.lyb else ()),
                        *(tallies.allph.tensors()
                          if tallies.allph is not None else ()))
    kbuild.check(kbuild.library().lart_fly_amr(
        state.lane_pointers, state.batch, max_steps,
        ctypes.byref(p.c_params(tallies)), kbuild.stream_of(state.x)),
        'fly_amr')
    kbuild.LAUNCHES['fly_amr'] += 1
