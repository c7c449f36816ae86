"""Resonant Ly-alpha scattering (kernel K4).

Counterpart of make_scatter / scatter (lart_tpu/transport/engine.py:1838,
:2087) for line_type 1 without dust, H2, Stokes, core-skip, recoil or
peel-off (the config defaults, lart_tpu/config.py:105-106): the
redistribute branch of :1947-1953, rand_resonance_cost, phi = 2 pi xi, the
perpendicular atom velocity, xfreq_new (:2205), rotate_direction (:1854)
and the next optical depth.  scatter_rounds rejection rounds of the u_par
sampler run per call; a lane still rejected stays AT_SCATTER and retries
next cycle.  Uniforms come from Philox stream STREAM_SCATTER at counter
(lane, counter, block): block r feeds round r, block `rounds` the angles,
block rounds + 1 the next tau.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import build as kbuild
from ..physics import samplers
from ..physics.rng import STREAM_SCATTER, uniforms
from .state import AT_SCATTER, FLYING, BatchState, Tallies

TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class ScatterParams:
    a: float          # Voigt damping parameter (uniform temperature)
    E1: float         # dipole weight of the line's phase function
    rounds: int       # rejection rounds per call

    @classmethod
    def from_config(cls, cfg, meta) -> 'ScatterParams':
        """Constants of a config that engine.check_supported accepted."""
        return cls(a=float(meta.voigt_a_ref), E1=float(cfg.line.E1),
                   rounds=int(cfg.par.scatter_rounds))


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
                  seed: int, counter: int) -> None:
    """Plain PyTorch scatter of every AT_SCATTER lane, in place."""
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
    sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
    phi = samplers.TWOPI * xi[1]
    do_res = at_sc & acc
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    phi2 = samplers.TWOPI * xi[2]
    uxy = torch.sqrt(0.0 - torch.log(xi[3]))
    ux, uy = uxy * torch.cos(phi2), uxy * torch.sin(phi2)
    xfreq_new = xfreq_atom + uz * cost + (ux * cosp + uy * sinp) * sint
    kx_n, ky_n, kz_n = rotate_direction(s.kx, s.ky, s.kz, cost, sint,
                                        cosp, sinp)
    tau_next = -torch.log(torch.clamp_min(u[p.rounds + 1, 0], 1e-12))

    s.phase.copy_(torch.where(do_res, FLYING, s.phase).to(torch.int32))
    s.kx.copy_(torch.where(do_res, kx_n, s.kx))
    s.ky.copy_(torch.where(do_res, ky_n, s.ky))
    s.kz.copy_(torch.where(do_res, kz_n, s.kz))
    s.xfreq.copy_(torch.where(do_res, xfreq_new, s.xfreq))
    s.tau_target.copy_(torch.where(do_res, tau_next, s.tau_target))
    s.tau_run.copy_(torch.where(do_res, torch.zeros_like(s.tau_run),
                                s.tau_run))
    tallies.nscatt_gas += torch.where(do_res, s.wgt,
                                      torch.zeros_like(s.wgt)).sum()
    tallies.nscatt_events += do_res.sum(dtype=torch.float32)


def scatter(state: BatchState, tallies: Tallies, p: ScatterParams,
            seed: int, counter: int) -> None:
    """Scatter every AT_SCATTER lane, in place: kernel K4 for a CUDA state,
    the plain version for a CPU state."""
    if state.device.type == 'cpu':
        scatter_plain(state, tallies, p, seed, counter)
        return
    kbuild.require_cuda('scatter_lya', tallies.nscatt_gas,
                        tallies.nscatt_events, state.x)
    kbuild.check(kbuild.library().lart_scatter_lya(
        state.lane_pointers, state.batch, seed & 0xFFFFFFFF,
        counter & 0xFFFFFFFF, p.rounds, p.a, p.E1,
        tallies.nscatt_gas.data_ptr(), tallies.nscatt_events.data_ptr(),
        kbuild.stream_of(state.x)), 'scatter_lya')
    kbuild.LAUNCHES['scatter_lya'] += 1
