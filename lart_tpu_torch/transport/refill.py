"""Refill: dead lanes are reborn from the photon budget (kernel K2).

Counterpart of make_refill / refill (lart_tpu/transport/engine.py:2557,
:2689) for a point source (source_geometry 'point' or '') with a Voigt or
monochromatic input spectrum in a uniform-temperature static medium.  A
launched lane gets the source position, an isotropic direction, its birth
frequency (Jin tally), the forced-first-scattering phase FFS with its xi
stashed in tau_target, and the birth snapshot.

`refill_plain` ranks dead lanes by a cumsum, as the JAX version does;
kernel K2 (csrc/refill.cu) hands out tickets by warp instead, so when the
budget runs out the two may launch different dead lanes, always the same
number.  A launched lane draws its uniforms from Philox at counter
(lane, counter, block), so both launch it with the same values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import build as kbuild
from ..physics.rng import STREAM_REFILL, uniforms
from ..physics.samplers import TWOPI, rand_voigt_x
from .state import DEAD, FFS, BatchState, Tallies


@dataclasses.dataclass(frozen=True)
class RefillParams:
    xs: float
    ys: float
    zs: float
    ic: int
    jc: int
    kc: int
    xfreq0: float
    voigt: bool          # Voigt input spectrum (else monochromatic)
    a: float             # Voigt damping parameter of the source cell
    xfreq_min: float
    dxfreq: float
    nxfreq: int

    @classmethod
    def from_config(cls, cfg, meta) -> 'RefillParams':
        """Constants of a config that engine.check_supported accepted."""
        par = cfg.par
        f32 = np.float32
        pos = [f32(par.xs_point), f32(par.ys_point), f32(par.zs_point)]
        cells = []
        for p, amin, d, n in zip(pos, (meta.xmin, meta.ymin, meta.zmin),
                                 (meta.dx, meta.dy, meta.dz),
                                 (meta.nx, meta.ny, meta.nz)):
            # f32 cell index with the edge clamp, as the JAX refill computes it
            c = np.floor((p - f32(amin)) / f32(d))
            cells.append(int(min(max(c, 0), n - 1)))
        return cls(xs=float(pos[0]), ys=float(pos[1]), zs=float(pos[2]),
                   ic=cells[0], jc=cells[1], kc=cells[2],
                   xfreq0=float(par.xfreq0),
                   voigt=par.spectral_type.strip().lower() == 'voigt',
                   a=float(meta.voigt_a_ref), xfreq_min=meta.xfreq_min,
                   dxfreq=meta.dxfreq, nxfreq=meta.nxfreq)


def refill_plain(state: BatchState, tallies: Tallies, p: RefillParams,
                 seed: int, counter: int, budget: int) -> None:
    """Plain PyTorch refill, in place."""
    B, dev = state.batch, state.device
    dead = state.phase == DEAD
    rank = torch.cumsum(dead.to(torch.int32), 0) - 1
    launch = dead & (rank < budget - state.n_launched[0])
    n_new = launch.sum(dtype=torch.int32)

    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    u, v = uniforms(seed, STREAM_REFILL, lanes, counter, range(2))
    cost = 2.0 * u[0] - 1.0
    sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
    phi = TWOPI * u[1]
    kx, ky, kz = sint * torch.cos(phi), sint * torch.sin(phi), cost

    xfreq = torch.full((B,), p.xfreq0, dtype=torch.float32, device=dev)
    if p.voigt:
        a = torch.full((B,), p.a, dtype=torch.float32, device=dev)
        xfreq = xfreq + rand_voigt_x(a, u[2], u[3], v[0])

    fx = torch.floor((xfreq - p.xfreq_min) / p.dxfreq)
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
    for nm, val in (('ic', p.ic), ('jc', p.jc), ('kc', p.kc)):
        put(nm, val)
        put('b' + nm, val)
    for nm, val in (('kx', kx), ('ky', ky), ('kz', kz), ('xfreq', xfreq)):
        put(nm, val)
        put('b' + nm, val)
    put('wgt', 1.0)
    put('tau_target', v[1])
    put('tau_run', 0.0)
    state.n_launched += n_new


def refill(state: BatchState, tallies: Tallies, p: RefillParams, seed: int,
           counter: int, budget: int) -> None:
    """Launch min(#dead, budget - n_launched) lanes, in place: kernel K2
    for a CUDA state, the plain version for a CPU state."""
    if state.device.type == 'cpu':
        refill_plain(state, tallies, p, seed, counter, budget)
        return
    if budget + state.batch >= 2 ** 31:
        raise ValueError('photon budget + batch must stay below 2^31')
    kbuild.require_cuda('refill_point', tallies.Jin, state.n_launched,
                        *(getattr(state, f) for f in ('phase', 'x')))
    kbuild.check(kbuild.library().lart_refill_point(
        state.lane_pointers, state.batch, state.n_launched.data_ptr(),
        int(budget), seed & 0xFFFFFFFF, counter & 0xFFFFFFFF,
        p.xs, p.ys, p.zs, p.ic, p.jc, p.kc, p.xfreq0, int(p.voigt), p.a,
        p.xfreq_min, p.dxfreq, p.nxfreq, tallies.Jin.data_ptr(),
        kbuild.stream_of(state.x)), 'refill_point')
    kbuild.LAUNCHES['refill_point'] += 1
