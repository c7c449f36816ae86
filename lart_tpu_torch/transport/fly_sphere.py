"""Closed-form flight through a uniform static sphere (kernel K6).

Counterpart of sphere_chord / make_fly_uniform_sphere / fly
(lart_tpu/transport/engine.py:871, :887, :910).  The opacity along a ray is
sphere_rho * H_eff(x) + sphere_rhoD (H_eff the line's profile,
physics/line.py) on the chord [t_in, t_out] through
r < R and zero in the vacuum corners of the box, so one step resolves a
whole flight: the lane scatters at t_in + (tau_target - tau_run) / rho
(AT_SCATTER) or escapes (Jout, Jmu).  The scatter point's cell is the
clamped floor of its position, which core-skip reads.  A forced first
scattering restarts from the birth snapshot as in the slab flight; a lane
iterates until it no longer flies, at most max_steps + 2 times, as the JAX
while_loop drains.  No random numbers are drawn.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..kernels import build as kbuild
from .flight import (FFS_TAU_CAP, TINY, FlightConsts, div, floor_bin, fma,
                     tally_plain)
from .state import AT_SCATTER, DEAD, FFS, FLYING, BatchState, Tallies


def sphere_chord(p: FlightConsts, x, y, z, kx, ky, kz):
    """(t_in, t_out) ray-parameter interval inside the sphere (0 <= t_in <=
    t_out; t_in == t_out when the ray misses it).  The dot products and the
    discriminant are fused multiply-adds, as XLA computes them."""
    b = fma(z, kz, fma(y, ky, x * kx))
    r2 = fma(z, z, fma(y, y, x * x))
    det = fma(b, b, -(r2 - p.sphere_R2))
    sq = torch.sqrt(torch.clamp_min(det, 0.0))
    t_out = torch.clamp_min(-b + sq, 0.0)
    t_in = torch.minimum(torch.clamp_min(-b - sq, 0.0), t_out)
    hit = det > 0.0
    zero = torch.zeros_like(t_in)
    return torch.where(hit, t_in, zero), torch.where(hit, t_out, zero)


def fly_plain(state: BatchState, tallies: Tallies, p: FlightConsts,
              max_steps: int) -> None:
    """Plain PyTorch flight of every FLYING/FFS lane, in place."""
    s = state
    oor = torch.zeros_like(s.wgt)
    for _ in range(max_steps + 2):
        is_ffs = s.phase == FFS
        moving = (s.phase == FLYING) | is_ffs
        if not bool(moving.any()):
            break       # the remaining iterations would change nothing
        rho = p.sphere_rho * p.profile(s.xfreq) + p.sphere_rhoD
        t_in, t_out = sphere_chord(p, s.x, s.y, s.z, s.kx, s.ky, s.kz)
        dtau_avail = (t_out - t_in) * rho
        tgt = torch.where(is_ffs, torch.full_like(s.tau_target, FFS_TAU_CAP),
                          s.tau_target)
        hit = s.tau_run + dtau_avail >= tgt
        d_adv = torch.where(
            hit, t_in + (tgt - s.tau_run) / torch.clamp_min(rho, TINY), t_out)
        new_pos = [fma(d_adv, s.kx, s.x), fma(d_adv, s.ky, s.y),
                   fma(d_adv, s.kz, s.z)]
        tau_n = torch.where(hit, tgt, s.tau_run + dtau_avail)
        esc_fly = moving & ~hit & (s.phase == FLYING)
        ffs_done = moving & is_ffs

        oor = oor + tally_plain(tallies, p, esc_fly, s.xfreq, s.wgt, s.kz)
        tau0 = tau_n
        wgt_esc = s.wgt * torch.exp(-tau0)
        oor = oor + tally_plain(tallies, p, ffs_done, s.bxfreq, wgt_esc,
                                s.bkz)
        wgt1 = -torch.expm1(-tau0)
        ffs_vacuum = ffs_done & (tau0 <= 0.0)
        phase_new = torch.where(
            esc_fly | ffs_vacuum, DEAD,
            torch.where(ffs_done, FLYING,
                        torch.where(hit & ~is_ffs, AT_SCATTER, s.phase))
        ).to(torch.int32)
        # the scatter point's cell (engine.py:995-1000)
        new_cell = [floor_bin(div(v - a, d), n).to(torch.int32) for v, a, d, n
                    in zip(new_pos, p.amin, p.d, p.n)]

        def rb(cur, birth):
            return torch.where(ffs_done, birth, cur)

        new_target = torch.where(
            ffs_done, -torch.log1p(-torch.clamp_max(s.tau_target, 0.99999)
                                   * wgt1), s.tau_target)
        s.phase.copy_(torch.where(moving, phase_new, s.phase))
        for name, new in zip(('x', 'y', 'z', 'ic', 'jc', 'kc'),
                             (*new_pos, *new_cell)):
            cur = getattr(s, name)
            cur.copy_(rb(torch.where(moving, new, cur), getattr(s, 'b' + name)))
        for name in ('kx', 'ky', 'kz', 'xfreq'):
            getattr(s, name).copy_(rb(getattr(s, name), getattr(s, 'b' + name)))
        s.wgt.copy_(torch.where(ffs_done, s.wgt * wgt1, s.wgt))
        s.tau_run.copy_(torch.where(
            ffs_done, torch.zeros_like(tau_n),
            torch.where(moving, tau_n, s.tau_run)))
        s.tau_target.copy_(new_target)
    tallies.W_oor += oor.sum()


@dataclasses.dataclass(frozen=True, eq=False)
class SphereFlight(FlightConsts):
    """The sphere's constants; calling it flies a batch (K6)."""

    def __call__(self, state: BatchState, tallies: Tallies,
                 max_steps: int) -> None:
        fly(state, tallies, self, max_steps)


def fly(state: BatchState, tallies: Tallies, p: FlightConsts,
        max_steps: int) -> None:
    """Fly every FLYING/FFS lane, in place: kernel K6 for a CUDA state, the
    plain version for a CPU state."""
    if state.device.type == 'cpu':
        fly_plain(state, tallies, p, max_steps)
        return
    kbuild.require_cuda('fly_uniform_sphere', tallies.Jout, tallies.Jmu,
                        tallies.W_oor, state.x)
    kbuild.check(kbuild.library().lart_fly_uniform_sphere(
        state.lane_pointers, state.batch, max_steps + 2,
        ctypes.byref(p.c_params(tallies)), kbuild.stream_of(state.x)),
        'fly_uniform_sphere')
    kbuild.LAUNCHES['fly_uniform_sphere'] += 1
