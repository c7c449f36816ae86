"""Closed-form flight through a uniform static slab (kernel K3).

Counterpart of make_fly_uniform_slab / fly (lart_tpu/transport/engine.py:
671, :699).  The medium is one constant opacity rho0 * H_eff(x), H_eff the
line's profile (physics/line.py: H(x, a) for line type 1), periodic in
x and y, escaping through the z faces, so one step resolves a whole
flight: the lane reaches its tau target (AT_SCATTER) or leaves through a z
face (escape: Jout, Jmu).  A forced first scattering (FFS) flies the birth
ray to tau 25, tallies the escaped fraction exp(-tau0) at the birth
frequency, and restarts from the birth snapshot with wgt *= -expm1(-tau0)
and tau_target = -log1p(-min(xi, 0.99999) * wgt1).  A lane iterates until
it no longer flies, at most max_steps + 2 times, as the JAX while_loop
drains.  The flight draws no random numbers.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..kernels import build as kbuild
from ..physics import line as pline
from .flight import BIG, FFS_TAU_CAP, TINY, div, floor_bin, tally_plain
from .state import AT_SCATTER, DEAD, FFS, FLYING, BatchState, Tallies


@dataclasses.dataclass(frozen=True)
class SlabParams:
    zmn: float
    zmx: float
    xmn: float
    ymn: float
    Lx: float
    Ly: float
    dz: float
    nz: int
    a_ref: float
    rho0: float
    xfreq_min: float
    dxfreq: float
    nxfreq: int
    save_Jmu: bool
    nmu: int
    mu_min: float
    dmu: float
    mu_abs: bool         # xyz_symmetry bins |kz|
    Dfreq: float         # Doppler width (Hz)
    line: pline.LineConsts

    @classmethod
    def from_config(cls, cfg, meta) -> 'SlabParams':
        par = cfg.par
        mu_min = 0.0 if par.xyz_symmetry else -1.0
        return cls(zmn=meta.zmin, zmx=meta.zmin + meta.nz * meta.dz,
                   xmn=meta.xmin, ymn=meta.ymin, Lx=meta.nx * meta.dx,
                   Ly=meta.ny * meta.dy, dz=meta.dz, nz=meta.nz,
                   a_ref=meta.voigt_a_ref, rho0=meta.rho_uniform,
                   xfreq_min=meta.xfreq_min, dxfreq=meta.dxfreq,
                   nxfreq=meta.nxfreq, save_Jmu=bool(par.save_Jmu),
                   nmu=par.nmu, mu_min=mu_min,
                   dmu=(1.0 - mu_min) / par.nmu,
                   mu_abs=bool(par.xyz_symmetry), Dfreq=meta.Dfreq_ref,
                   line=pline.LineConsts.from_config(cfg))

    def __call__(self, state: BatchState, tallies: Tallies,
                 max_steps: int) -> None:
        fly(state, tallies, self, max_steps)


def fly_plain(state: BatchState, tallies: Tallies, p: SlabParams,
              max_steps: int) -> None:
    """Plain PyTorch flight of every FLYING/FFS lane, in place."""
    s = state
    oor = torch.zeros_like(s.wgt)
    for _ in range(max_steps + 2):
        is_ffs = s.phase == FFS
        moving = (s.phase == FLYING) | is_ffs
        if not bool(moving.any()):
            break       # the remaining iterations would change nothing
        rho = p.rho0 * pline.line_profile_plain(p.line, s.xfreq, p.a_ref,
                                                p.Dfreq)

        zsel = torch.where(s.kz > 0.0, p.zmx, p.zmn).to(torch.float32)
        flat = torch.abs(s.kz) < 1e-12
        d_exit = (zsel - s.z) / torch.where(flat, torch.ones_like(s.kz), s.kz)
        d_exit = torch.where(flat, torch.full_like(s.kz, BIG),
                             torch.clamp_min(d_exit, 0.0))
        tgt = torch.where(is_ffs, torch.full_like(s.tau_target, FFS_TAU_CAP),
                          s.tau_target)
        dtau_exit = d_exit * rho
        hit = s.tau_run + dtau_exit >= tgt
        d_adv = torch.where(hit, (tgt - s.tau_run) / torch.clamp_min(rho, TINY),
                            d_exit)
        x_new = p.xmn + torch.remainder(s.x + d_adv * s.kx - p.xmn, p.Lx)
        y_new = p.ymn + torch.remainder(s.y + d_adv * s.ky - p.ymn, p.Ly)
        z_new = s.z + d_adv * s.kz
        kcn = floor_bin(div(z_new - p.zmn, p.dz), p.nz).to(torch.int32)
        tau_n = torch.where(hit, tgt, s.tau_run + dtau_exit)
        escaped = moving & ~hit
        esc_fly = escaped & (s.phase == FLYING)
        ffs_done = moving & is_ffs

        # escape at the (lab == comoving) frequency
        oor = oor + tally_plain(tallies, p, esc_fly, s.xfreq, s.wgt, s.kz)
        # forced first scattering done: escaped fraction at birth frequency
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

        def rb(cur, birth):
            return torch.where(ffs_done, birth, cur)

        new_target = torch.where(
            ffs_done, -torch.log1p(-torch.clamp_max(s.tau_target, 0.99999)
                                   * wgt1), s.tau_target)
        s.phase.copy_(torch.where(moving, phase_new, s.phase))
        s.x.copy_(rb(torch.where(moving, x_new, s.x), s.bx))
        s.y.copy_(rb(torch.where(moving, y_new, s.y), s.by))
        s.z.copy_(rb(torch.where(moving, z_new, s.z), s.bz))
        s.kc.copy_(rb(torch.where(moving, kcn, s.kc), s.bkc))
        s.kx.copy_(rb(s.kx, s.bkx))
        s.ky.copy_(rb(s.ky, s.bky))
        s.kz.copy_(rb(s.kz, s.bkz))
        s.xfreq.copy_(rb(s.xfreq, s.bxfreq))
        s.wgt.copy_(torch.where(ffs_done, s.wgt * wgt1, s.wgt))
        s.tau_run.copy_(torch.where(
            ffs_done, torch.zeros_like(tau_n),
            torch.where(moving, tau_n, s.tau_run)))
        s.tau_target.copy_(new_target)
    tallies.W_oor += oor.sum()


def fly(state: BatchState, tallies: Tallies, p: SlabParams,
        max_steps: int) -> None:
    """Fly every FLYING/FFS lane, in place: kernel K3 for a CUDA state, the
    plain version for a CPU state."""
    if state.device.type == 'cpu':
        fly_plain(state, tallies, p, max_steps)
        return
    kbuild.require_cuda('fly_uniform_slab', tallies.Jout, tallies.Jmu,
                        tallies.W_oor, state.x)
    kbuild.check(kbuild.library().lart_fly_uniform_slab(
        state.lane_pointers, state.batch, max_steps + 2, p.zmn, p.zmx, p.xmn,
        p.ymn, p.Lx, p.Ly, p.dz, p.nz, p.a_ref, p.rho0, p.xfreq_min,
        p.dxfreq, p.nxfreq, int(p.save_Jmu), p.nmu, p.mu_min, p.dmu,
        int(p.mu_abs), tallies.Jout.data_ptr(), tallies.Jmu.data_ptr(),
        tallies.W_oor.data_ptr(), p.Dfreq, ctypes.byref(p.line.c_struct),
        kbuild.stream_of(state.x)),
        'fly_uniform_slab')
    kbuild.LAUNCHES['fly_uniform_slab'] += 1
