"""The all-photons table of save_all_photons: one row per photon id.

Counterpart of AllPhotons, zero_allph, impact_parameter and
allph_record_death (lart_tpu/transport/engine.py:149-214; the reference's
all_photons_type, define.f90:602-613).  Each photon id is written twice:
its birth row (rp0, xfreq1) by the refill that launches it (K2; engine.py:
2885-2899), its death row (rp, xfreq2, nscatt_gas, nscatt_dust and with
Stokes I, Q, U, V) where it dies: an escape or a forced first scattering
born in vacuum in the flights (K5, K8, K9, K10), a dust absorption or an H2
destruction in the scatter (K4).  A dead lane no longer moves, so a row
written where the lane dies equals lart_tpu's, written after the flight's
loop from the final state.

Unlike lart_tpu, which hands every chunk a fresh nphotons-long table and
adds the tables on the host in f64 (each id is written once, so the sum is
the value written), the port keeps one f32 table on the device for the
whole run, its columns the rows of one tensor (`table`): zeroed once,
written in place by plain stores, and copied to the host once at the end
(in a run of several ranks summed onto rank 0 first, parallel/reduce.py).

The impact parameter is the distance of the ray from the origin, after the
ray is advanced to the rmax sphere where it starts outside it
(make_all_photons, run_simulation_mod.f90:294-331); the Stokes vector of a
death row is rotated into the frame of the impact-parameter vector
(engine.py:204-214).  Both follow XLA's contraction of lart_tpu's sums of
products on the CPU (fma chains, flight.dot3), which csrc/allph.cuh
repeats with fmaf.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .flight import AllPhC, dot3, fma

# the table's columns in lart_tpu's order (AllPhotons._fields); the Stokes
# ones only with use_stokes
FIELDS = ('rp0', 'rp', 'xfreq1', 'xfreq2', 'nscatt_gas', 'nscatt_dust')
STOKES = ('I', 'Q', 'U', 'V')


@dataclasses.dataclass(eq=False)
class AllPhotons:
    """The run's table: (nphotons,) f32 columns on the device."""
    rp0: torch.Tensor
    rp: torch.Tensor
    xfreq1: torch.Tensor
    xfreq2: torch.Tensor
    nscatt_gas: torch.Tensor
    nscatt_dust: torch.Tensor
    I: Optional[torch.Tensor] = None
    Q: Optional[torch.Tensor] = None
    U: Optional[torch.Tensor] = None
    V: Optional[torch.Tensor] = None
    rmax: float = 0.0        # > 0: rays are advanced to the rmax sphere
    # the (columns, nphotons) tensor whose rows the columns are
    table: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)

    @property
    def n(self) -> int:
        return self.rp.numel()

    @property
    def fields(self) -> tuple:
        return FIELDS + (STOKES if self.I is not None else ())

    def tensors(self) -> tuple:
        return tuple(getattr(self, f) for f in self.fields)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def to_host(self) -> dict:
        """{column: (n,) f64 numpy} in one device-to-host copy, as
        lart_tpu's driver accumulates them (driver.py:306-313)."""
        flat = self.table.cpu().numpy().astype(np.float64)
        return dict(zip(self.fields, flat))

    @functools.cached_property
    def c_struct(self) -> AllPhC:
        c = AllPhC()
        c.rp0, c.rp, c.xfreq1, c.xfreq2, c.nsg, c.nsd = (
            t.data_ptr() for t in self.tensors()[:6])
        if self.I is not None:
            c.I, c.Q, c.U, c.V = (t.data_ptr() for t in self.tensors()[6:])
        c.n = self.n
        c.advance = int(self.rmax > 0.0)
        c.rmax2 = float(np.float32(self.rmax ** 2))
        return c


def zero_allph(nphotons: int, stokes: bool, rmax: float,
               device) -> AllPhotons:
    """The zero table of nphotons rows (zero_allph, engine.py:165-170)."""
    cols = FIELDS + (STOKES if stokes else ())
    data = torch.zeros((len(cols), nphotons), dtype=torch.float32,
                       device=device)
    return AllPhotons(**dict(zip(cols, data.unbind(0))), rmax=float(rmax),
                      table=data)


def impact_parameter(rmax: float, x, y, z, kx, ky, kz):
    """(|m|, (mx, my, mz)): the perpendicular vector m from the origin to
    the ray p + t k after advancing p to the rmax sphere where it lies
    outside it (engine.py:172-190), in XLA's contraction on the CPU."""
    if rmax > 0.0:
        r2 = float(np.float32(rmax ** 2))
        rr = dot3(x, x, y, y, z, z)
        rk = dot3(x, kx, y, ky, z, kz)
        det = fma(rk, rk, -(rr - r2))
        dist = torch.where((rr > r2) & (det >= 0.0),
                           -rk + torch.sqrt(torch.clamp_min(det, 0.0)),
                           torch.zeros_like(rk))
        x, y, z = fma(dist, kx, x), fma(dist, ky, y), fma(dist, kz, z)
    rk = dot3(x, kx, y, ky, z, kz)
    mx, my, mz = fma(-rk, kx, x), fma(-rk, ky, y), fma(-rk, kz, z)
    return torch.sqrt(dot3(mx, mx, my, my, mz, mz)), (mx, my, mz)


def _put(col: torch.Tensor, idx: torch.Tensor, mask, value) -> None:
    col.index_put_((idx[mask],), torch.broadcast_to(
        torch.as_tensor(value, dtype=col.dtype, device=col.device),
        mask.shape)[mask])


def _ids(table: AllPhotons, pid: torch.Tensor, mask: torch.Tensor):
    """(row index, the masked lanes that own a row) of lanes with ids."""
    return pid.long(), mask & (pid >= 0) & (pid < table.n)


def record_births(table: AllPhotons, launch, pid, x, y, z, kx, ky, kz,
                  xfreq) -> None:
    """The birth rows of the launched lanes (engine.py:2890-2899): rp0 the
    impact parameter of the birth ray, xfreq1 the comoving birth
    frequency."""
    idx, m = _ids(table, pid, launch)
    _put(table.rp0, idx, m, impact_parameter(table.rmax, x, y, z, kx, ky,
                                             kz)[0])
    _put(table.xfreq1, idx, m, xfreq)


def record_deaths(table: AllPhotons, s, mask, xfreq_lab) -> None:
    """The death rows of the masked lanes of state s (allph_record_death,
    engine.py:193-214), at their position, direction, counts, weight and
    Stokes vector in s; xfreq_lab their lab frequency (xfreq2)."""
    idx, m = _ids(table, s.pid, mask)
    mm, (mx, my, mz) = impact_parameter(table.rmax, s.x, s.y, s.z, s.kx,
                                        s.ky, s.kz)
    for col, v in ((table.rp, mm), (table.xfreq2, xfreq_lab),
                   (table.nscatt_gas, s.nsg), (table.nscatt_dust, s.nsd)):
        _put(col, idx, m, v)
    if table.I is None:
        return
    pos = mm > 0.0
    mmi = torch.ones_like(mm) / torch.clamp_min(mm, 1e-30)
    cosp = torch.where(pos, dot3(mx, s.mx, my, s.my, mz, s.mz) * mmi, 1.0)
    sinp = torch.where(pos, dot3(mx, s.nnx, my, s.nny, mz, s.nnz) * mmi, 0.0)
    cos2p = fma(2.0 * cosp, cosp, -1.0)
    sin2p = 2.0 * sinp * cosp
    for col, v in ((table.I, s.wgt),
                   (table.Q, fma(sin2p, s.U, cos2p * s.Q) * s.wgt),
                   (table.U, fma(cos2p, s.U, -(sin2p * s.Q)) * s.wgt),
                   (table.V, s.V * s.wgt)):
        _put(col, idx, m, v)


def count_events(s, mask_gas, mask_dust) -> None:
    """nsg += the gas (resonance) scattering events, nsd += the dust
    scatterings (engine.py:2478-2479): counts, not weights."""
    s.nsg.copy_(s.nsg + mask_gas.to(s.nsg.dtype))
    s.nsd.copy_(s.nsd + mask_dust.to(s.nsd.dtype))
