"""The CALCJ / CALCP / CALCPnew maps on a Cartesian grid: the deposit bin of
a cell and the plain versions of the three deposits.

Counterparts of jpa_bin and rhokap_phys (lart_tpu/transport/engine.py:
581-610) and of the deposits of make_fly (:1199-1219) and make_scatter
(:2541-2547).  A bin is the cell's z index (geometry -1, a slab), the
radial bin of the cell's centre (1, a sphere or a box with rmax) or the
flat cell index (3, any other box); build_cartesian sets the geometry, its
nbin, dr and roff.  The maps:

- J1 (nxfreq x nbin, frequency-major): each flight segment's path length
  times the weight, at the comoving frequency x D_cell / D_ref of the
  segment's cell (dropped off the frequency grid), by the flight (K5);
- Pnew (nbin): each segment's d rhoH wgt / rhokap_phys, the path-length
  estimate of the scatterings per atom, by the flight (K5);
- Pa (nbin): each resonance scattering's wgt / rhokap_phys at the cell it
  happened in, by the scatter (K4), after every flight.

Segments count while a lane moves (FLYING or FFS) through gas, rhoH =
rhokap H > 0; rhokap_phys = rhokap D / cross0 (add_to_Pa,
scattering_car.f90:842-847).  lart_tpu's AMR and clump grids bin nothing
(their metas leave nbin_JPa 0): `JpaBins.from_config` gives None there.
Each deposit is computed in f32 in lart_tpu's order and added into an
f64 map, as the reference keeps them (define.f90:203-205; lart_tpu adds
in f32, where the many equal deposits of a chunk into one hot bin round
alike: 1.05e-3 of the sum of 2^17 of them, tests/test_torch_precision.py).
The plain versions add with index_add_ and divide by a 0-d tensor
(flight.div), as the kernels' f64 sums and f32 divisions do, to the order
of the sums.

The kernels add their deposits through csrc/lart.cuh deposit_aggregated:
the lanes of a warp that deposit into one bin sum first, and a block sums
into its private copy of a map in shared memory where the copy fits
BLOCK_COPY_BYTES (block_plan), which the wrapper gives the launch as
dynamic shared memory; a map that does not fit (J1's nxfreq x nbin, the
flat-cell geometry on a large grid) takes the warp level alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..physics.line import f32
from .flight import TINY, JpaC, div, dot3, fma


# The most dynamic shared memory a launch gives its block copies of the
# maps: 4096 f64 bins (32 KB), under the 48 KB a launch takes without an
# attribute and small enough for K4's and K5's 3-4 blocks an SM
BLOCK_COPY_BYTES = 32768


def block_plan(*maps) -> tuple:
    """The slots of each map's block copy: `maps` are the maps' f64 slots
    in order of priority, and each gets a copy of all its slots where they
    fit in what the maps before it left of BLOCK_COPY_BYTES, else 0 (its
    deposits take the warp level alone)."""
    left, plan = BLOCK_COPY_BYTES, []
    for n in maps:
        take = n if 0 < 8 * n <= left else 0
        left -= 8 * take
        plan.append(take)
    return tuple(plan)


@dataclasses.dataclass(frozen=True, eq=False)
class JpaBins:
    geom: int                # -1 the z cell, 1 radial by centre, 3 flat
    nbin: int
    n: tuple                 # (nx, ny, nz)
    amin: tuple              # (xmin, ymin, zmin)
    d: tuple                 # (dx, dy, dz)
    dr: float
    roff: float
    cross0: float            # the line's cross section at line centre
    J1: bool                 # calcJ
    Pa: bool                 # calcP
    Pnew: bool               # calcPnew

    @classmethod
    def from_config(cls, cfg, meta) -> Optional['JpaBins']:
        """The maps a config asks for on a grid that bins them, or None."""
        par = cfg.par
        if not meta.nbin_JPa or not (par.calcJ or par.calcP
                                     or par.calcPnew):
            return None
        return cls(geom=int(meta.geometry_JPa), nbin=int(meta.nbin_JPa),
                   n=(meta.nx, meta.ny, meta.nz),
                   amin=(meta.xmin, meta.ymin, meta.zmin),
                   d=(meta.dx, meta.dy, meta.dz), dr=float(meta.dr_JPa),
                   roff=float(meta.roff_JPa), cross0=float(cfg.line.cross0),
                   J1=bool(par.calcJ), Pa=bool(par.calcP),
                   Pnew=bool(par.calcPnew))

    def sizes(self, nxfreq: int) -> tuple:
        """The sizes of J1, Pa and Pnew (0: the map is off)."""
        return (nxfreq * self.nbin if self.J1 else 0,
                self.nbin if self.Pa else 0, self.nbin if self.Pnew else 0)

    def bin(self, ic, jc, kc) -> torch.Tensor:
        """jpa_bin (engine.py:581-603) of the cells (ic, jc, kc), int64: the
        centre's coordinates as fma(i + 0.5, dx, xmin) and its radius
        through the fma chain of the squares, as XLA contracts them."""
        top = self.nbin - 1
        if self.geom == -1:
            return torch.clamp(kc.long(), 0, top)
        if self.geom == 1:
            c = [fma(i.to(torch.float32) + 0.5, d, a)
                 for i, d, a in zip((ic, jc, kc), self.d, self.amin)]
            rr = torch.sqrt(dot3(c[0], c[0], c[1], c[1], c[2], c[2]))
            return torch.clamp(torch.floor(div(rr - self.roff, self.dr)),
                               0, top).long()
        nx, ny, nz = self.n
        return torch.clamp((ic.long() * ny + jc) * nz + kc, 0, top)

    def rhokap_phys(self, rk, D) -> torch.Tensor:
        """rhokap D / cross0 (engine.py:606-610), D a cell's Doppler width
        (per lane, or the reference one as a Python float)."""
        return div(rk * (D if isinstance(D, torch.Tensor) else f32(D)),
                   self.cross0)

    def c_struct(self, tallies) -> JpaC:
        """The C struct with this call's map pointers."""
        c = JpaC()
        for f in ('J1', 'Pa', 'Pnew'):
            t = getattr(tallies, f)
            setattr(c, f, None if t is None else t.data_ptr())
        c.geom, c.nbin = self.geom, self.nbin
        c.n[:], c.amin[:], c.d[:] = self.n, self.amin, self.d
        c.dr, c.roff, c.cross0 = self.dr, self.roff, self.cross0
        return c

    def tallies(self, tallies) -> tuple:
        """The map tensors of a kernel's launch (for require_cuda)."""
        return tuple(t for t in (tallies.J1, tallies.Pa, tallies.Pnew)
                     if t is not None)


def deposit_segments(q: JpaBins, tallies, p, seg_ok, cell, xfreq, ratio,
                     d_adv, rhoH, wgt, rk, D) -> None:
    """The J1 and Pnew deposits of one step of the flight (engine.py:
    1199-1219): the lanes seg_ok (moving through gas) add d_adv wgt to J1
    at their cell's bin and the comoving frequency xfreq ratio (ratio = D /
    D_ref), and d_adv rhoH wgt / max(rhokap_phys, TINY) to Pnew; `p` has
    the frequency bins xfreq_min, dxfreq, nxfreq."""
    binp = q.bin(*cell)
    zero = torch.zeros_like(wgt)
    if tallies.J1 is not None:
        ixr = torch.floor(div(xfreq * ratio - p.xfreq_min, p.dxfreq))
        okf = seg_ok & (ixr >= 0.0) & (ixr < p.nxfreq)
        ix = torch.clamp(ixr, 0, p.nxfreq - 1).long()
        tallies.J1.index_add_(0, ix * q.nbin + binp,
                              torch.where(okf, d_adv * wgt, zero).double())
    if tallies.Pnew is not None:
        rkp = q.rhokap_phys(rk, D)
        tallies.Pnew.index_add_(0, binp, torch.where(
            seg_ok, d_adv * rhoH * wgt / torch.clamp_min(rkp, TINY),
            zero).double())


def deposit_scatterings(q: JpaBins, tallies, do_res, cell, wgt, rk,
                        D) -> None:
    """The Pa deposit of one scatter call (engine.py:2541-2547): each
    resonance scattering do_res in a cell with rhokap_phys > 0 adds wgt /
    rhokap_phys at the bin of that cell."""
    rkp = q.rhokap_phys(rk, D)
    tallies.Pa.index_add_(0, q.bin(*cell), torch.where(
        do_res & (rkp > 0.0), wgt / torch.clamp_min(rkp, TINY),
        torch.zeros_like(wgt)).double())
