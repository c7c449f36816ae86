"""Sight-line optical-depth and column-density maps (kernel K11).

Counterpart of lart_tpu/instruments/sightline.py (make_sightline_tau,
reference src/sightline_tau_rect.f90:11-340, sightline_tau_heal.f90:
12-146, sightline_tau_clump.f90): for each observer pixel a ray through
the grid gives the column density N_gas, the dust optical depth tau_dust
and the gas optical depth tau_gas at the centre of every frequency bin.
A map column is one of those nxfreq + 2 quantities: column 0 N_gas
(rhokap D / cross0 a cell), column 1 tau_dust (rhokapD), column 2 + i
tau_gas at the lab frequency xfreq_min + (i + 0.5) dxfreq (rhokap times
the line's profile at the comoving frequency).

The rays (:137-192) are built as lart_tpu's numpy builds them, in f64: an
external observer's pixel-centre ray by the inverse TAN projection,
rotated into the grid by R^T and clipped to the box, starting 1e-6 of the
box width inside it (rays that miss the box map to 0); an interior
observer's ray along -v for each HEALPix pixel centre v (pix2vec_ring in
f32, healpix.py), starting that far inside the boundary where v leaves
the box and walking back toward the observer, capped at that distance
('from the distant universe toward Earth').  The start and the direction
then go to f32.  In a moving medium or at non-uniform temperature (where
each cell's opacity and N_gas take its own damping and Doppler width,
:65-67) a tau_gas ray starts at the comoving frequency of its entry
cell, xf0 D_ref / D1 - u1 (:226-238), and its frequency follows the
comoving update (xf + u1) D1 / D2 - u2 at every crossing.

The walks: on a Cartesian grid the DDA of :48-134, with no boundary ops
(a ray ends where it leaves the box), the cap of an interior observer (a
partial last step), no tau cutoff and at most 2 (nx + ny + nz) + 8
crossings; on the AMR grid the node walk of :414-560 (exit face, neighbor
hop, descent; no snap of the crossed coordinate, unlike the peel's; at
most 8 2^levelmax + 16 nodes); on a clump medium the CSR walk of
:268-411 (each CSR cell's candidates' chord overlaps clipped to the cell
segment plus 1e-6 R, summed in table order as one fused multiply-add
each, at most 3 cg_n + 8 cells).  lart_tpu walks every ray of a column in
one lockstep while_loop until the last leaves; each ray's sum runs in the
same order whether it walks alone or not, so K11 gives each (observer,
pixel, column) its own thread.  The AMR walker of lart_tpu has no
interior branch (every ray would be a TAN ray of width 0);
engine.check_supported refuses AMR with an interior observer and
save_sightline_tau, and lart_tpu's clump medium vetoes interior
observers.

`sightline_plain` walks all of a map's rays in one batch, compacted after
every crossing, with each ray's column selecting its opacity: the same
f32 operations in the same order as K11, whose wrapper `sightline` takes
it for a CPU grid.  `write_sightline_tau` writes the `_tau` file
(sightline_tau_rect.f90:340-420 schema) through io/iofile.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import build as kbuild
from ..physics import line as pline
from ..transport.flight import (FlightConsts, capped_step, chord_det,
                                comoving, div, f32, fma)
from ..transport.fly_amr import AmrFlight, exit_face, hop
from ..transport.fly_cartesian import _face_dist
from ..transport.fly_clump import ClumpFlight
from .healpix import pix2vec_ring
from .observer import build_observers

RAD2DEG = 180.0 / math.pi
# the columns of a map: N_gas, tau_dust, then tau_gas bin by bin
COL_NGAS, COL_DUST, COL_GAS0 = 0, 1, 2
MODE_GAS, MODE_NGAS, MODE_DUST = 0, 1, 2
GRID_CART, GRID_AMR, GRID_CLUMP = 0, 1, 2

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_double


class SightParams(ctypes.Structure):
    """csrc/sightline.cu struct SightParams, field for field."""
    _fields_ = [('obs_pos', _P), ('obs_rmat', _P), ('xf_axis', _P),
                ('out', _P), ('nobs', _I), ('npix', _I), ('nxim', _I),
                ('nyim', _I), ('nside', _I), ('nxfreq', _I),
                ('max_steps', _I), ('healpix', _I), ('comoving', _I),
                ('grid', _I), ('cross0', _F), ('ngas_fac', _F),
                ('dxim', _D), ('dyim', _D), ('lo', _D * 3), ('hi', _D * 3),
                ('eps', _D)]


@dataclasses.dataclass(frozen=True, eq=False)
class Sightline:
    """K11's constants for one config: the grid it walks (the flights'
    FlightConsts, AmrFlight or ClumpFlight), the observers, the box the
    rays are clipped to and the columns' frequencies."""
    grid: FlightConsts
    obs_meta: object                 # observer.ObserverSetMeta
    pos: torch.Tensor                # (nobs, 3) f32
    rmat: torch.Tensor               # (nobs, 3, 3) f32
    kind: int                        # GRID_CART, GRID_AMR or GRID_CLUMP
    lo: tuple                        # the box, f64
    hi: tuple
    eps: float                       # the start's nudge into the box
    max_steps: int
    comoving: bool                   # tau_gas: entry shift and updates
    cross0: float                    # N_gas = rhokap D / cross0 a cell
    ngas_fac: float                  # clumps: f32(D_cl / cross0)
    xf_axis: torch.Tensor            # (nxfreq,) f32 lab frequencies

    @classmethod
    def from_config(cls, cfg, meta, grid, cmeta=None) -> Optional['Sightline']:
        """None without save_peeloff (no observers, lart_tpu's driver.py:
        372); on a clump medium grid is the ClumpDevice and cmeta its
        ClumpMeta, on an AMR grid the AmrDevice."""
        obs = build_observers(cfg, grid.rhokap.device)
        if obs is None:
            return None
        obs_meta, odev = obs
        nx, ny, nz = meta.nx, meta.ny, meta.nz
        ngas_fac = 0.0
        if meta.grid_type == 'clump':
            fc = ClumpFlight.from_clumps(cfg, meta, cmeta, grid)
            kind, R = GRID_CLUMP, meta.xmax
            lo, hi, eps = (-R,) * 3, (R,) * 3, 1e-6 * R
            max_steps = 3 * cmeta.cg_n + 8
            ngas_fac = f32(fc.clump.D_cl / cfg.line.cross0)
            comoving = False
        elif meta.grid_type == 'amr':
            fc = AmrFlight.from_amr(cfg, meta, grid)
            kind = GRID_AMR
            lo = (meta.xmin, meta.ymin, meta.zmin)
            hi = (meta.xmax, meta.ymax, meta.zmax)
            eps = 1e-6 * (meta.xmax - meta.xmin)
            max_steps = 8 * (2 ** meta.levelmax) + 16
            comoving = fc.moving or not fc.amr.uniform_temperature
        else:
            fc = FlightConsts.from_config(cfg, meta, grid)
            kind = GRID_CART
            lo = (meta.xmin, meta.ymin, meta.zmin)
            hi = tuple(a + n * d for a, n, d in zip(
                lo, (nx, ny, nz), (meta.dx, meta.dy, meta.dz)))
            eps = 1e-6 * (hi[0] - lo[0])
            max_steps = 2 * (nx + ny + nz) + 8
            comoving = fc.moving or not meta.uniform_temperature
        xf = meta.xfreq_min + (np.arange(meta.nxfreq) + 0.5) * meta.dxfreq
        return cls(grid=fc, obs_meta=obs_meta, pos=odev.pos.contiguous(),
                   rmat=odev.rmat.reshape(-1, 3, 3).contiguous(), kind=kind,
                   lo=tuple(map(float, lo)), hi=tuple(map(float, hi)),
                   eps=float(eps), max_steps=int(max_steps),
                   comoving=bool(comoving), cross0=float(cfg.line.cross0),
                   ngas_fac=ngas_fac,
                   xf_axis=torch.as_tensor(xf, dtype=torch.float32,
                                           device=grid.rhokap.device))

    @property
    def nobs(self) -> int:
        return self.obs_meta.nobs

    @property
    def npix(self) -> int:
        return self.obs_meta.nxim * self.obs_meta.nyim

    @property
    def ncol(self) -> int:
        return COL_GAS0 + self.grid.nxfreq

    def device_tensors(self):
        return (self.pos, self.rmat, self.xf_axis) + self.grid.device_tensors()

    @functools.cached_property
    def _c_params(self) -> SightParams:
        c = SightParams()
        o = self.obs_meta
        c.obs_pos, c.obs_rmat = self.pos.data_ptr(), self.rmat.data_ptr()
        c.xf_axis = self.xf_axis.data_ptr()
        c.nobs, c.npix, c.nxim, c.nyim = o.nobs, self.npix, o.nxim, o.nyim
        c.nside, c.nxfreq = o.nside, self.grid.nxfreq
        c.max_steps, c.healpix = self.max_steps, int(o.inside)
        c.comoving, c.grid = int(self.comoving), self.kind
        c.cross0, c.ngas_fac = self.cross0, self.ngas_fac
        c.dxim, c.dyim = o.dxim, o.dyim
        c.lo[:], c.hi[:] = self.lo, self.hi
        c.eps = self.eps
        return c

    def c_params(self, out: torch.Tensor) -> SightParams:
        c = self._c_params
        c.out = out.data_ptr()
        return c


# --------------------------------------------------------------------------
# the rays
# --------------------------------------------------------------------------

def ray_origins(sl: Sightline, o: int):
    """(start (3, npix) f32, k (3, npix) f32, hit (npix,) bool, cap (npix,)
    f32 or None) of observer o's pixels, built in f64 (:137-192)."""
    dev = sl.pos.device
    f64 = torch.float64
    pos = sl.pos[o].to(f64)
    lo = torch.tensor(sl.lo, dtype=f64, device=dev)[:, None]
    hi = torch.tensor(sl.hi, dtype=f64, device=dev)[:, None]
    obs = sl.obs_meta
    inf = torch.tensor(math.inf, dtype=f64, device=dev)
    if obs.inside:
        v = pix2vec_ring(obs.nside, torch.arange(obs.npix, device=dev))
        kout = torch.stack(v).to(f64)
        t_lo = (lo - pos[:, None]) / kout
        t_hi = (hi - pos[:, None]) / kout
        t_pos = torch.where(torch.isfinite(t_lo) & (t_lo > 0), t_lo, inf)
        t_pos = torch.minimum(t_pos, torch.where(
            torch.isfinite(t_hi) & (t_hi > 0), t_hi, inf))
        dist = t_pos.amin(0)
        hit = torch.isfinite(dist)
        dist = torch.where(hit, dist, torch.zeros_like(dist))
        start = pos[:, None] + (dist - sl.eps)[None, :] * kout
        return start.float(), (-kout).float(), hit, dist.float()
    i = torch.arange(obs.nxim, dtype=f64, device=dev)
    j = torch.arange(obs.nyim, dtype=f64, device=dev)
    ang_x = div((i + 0.5 - obs.nxim / 2.0) * obs.dxim, RAD2DEG)
    ang_y = div((j + 0.5 - obs.nyim / 2.0) * obs.dyim, RAD2DEG)
    kx_o = (-torch.tan(ang_x))[:, None].expand(obs.nxim, obs.nyim)
    ky_o = (-torch.tan(ang_y))[None, :].expand(obs.nxim, obs.nyim)
    kz_o = torch.full_like(kx_o, -1.0)
    nrm = torch.sqrt(kx_o * kx_o + ky_o * ky_o + kz_o * kz_o)
    kob = [kx_o / nrm, ky_o / nrm, kz_o / nrm]
    R = sl.rmat[o].to(f64)
    k = torch.stack([R[0, a] * kob[0] + R[1, a] * kob[1] + R[2, a] * kob[2]
                     for a in range(3)]).reshape(3, -1)
    t_lo = (lo - pos[:, None]) / k
    t_hi = (hi - pos[:, None]) / k
    t_near = torch.minimum(t_lo, t_hi)
    t_far = torch.maximum(t_lo, t_hi)
    t0 = torch.where(torch.isfinite(t_near), t_near, -inf).amax(0)
    t1 = torch.where(torch.isfinite(t_far), t_far, inf).amin(0)
    hit = (t1 > t0) & (t0 > 0)
    start = pos[:, None] + (t0 + sl.eps)[None, :] * k
    return start.float(), k.float(), hit, None


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _cart_rho(g: FlightConsts, sl: Sightline, mode, flat, xf):
    """A Cartesian cell's opacity of each ray's column: rhokap H(x; a, D),
    rhokap D / cross0, or rhokapD (0 without dust), at the cell's damping a
    and Doppler width D."""
    rk = g.rhokap[flat]
    a, D = g.cell_a_D(flat)
    gas = rk * pline.line_profile_plain(g.line, xf, a, D)
    ngas = div(rk * (D if isinstance(D, torch.Tensor) else f32(D)),
               sl.cross0)
    dust = g.rhokapD[flat] if g.rhokapD is not None else torch.zeros_like(rk)
    return torch.where(mode == MODE_GAS, gas,
                       torch.where(mode == MODE_NGAS, ngas, dust))


def _count(stats, mode, cells, n_cells):
    """stats (a dict, or None) gains the crossings of this step, tau_gas
    ones under 'gas' and column ones under 'col', and marks the cells read
    (flat indices, -1 left out) in its 'visited' mask."""
    if stats is None:
        return
    gas = int((mode == MODE_GAS).sum())
    stats['gas'] = stats.get('gas', 0) + gas
    stats['col'] = stats.get('col', 0) + mode.numel() - gas
    if 'visited' not in stats:
        stats['visited'] = torch.zeros(n_cells, dtype=torch.bool,
                                       device=mode.device)
    stats['visited'][cells[cells >= 0]] = True


def _walk_cart(sl: Sightline, pos, k, xf, mode, cap, stats=None):
    g = sl.grid
    n = len(xf)
    tau = torch.zeros_like(xf)
    idx = torch.arange(n, device=xf.device)
    cell = [torch.clamp(torch.floor(div(pos[a] - f32(g.amin[a]), g.d[a])), 0,
                        g.n[a] - 1).to(torch.int64) for a in range(3)]
    if sl.comoving:
        # the entry cell's comoving frequency of a tau_gas column,
        # xf0 D_ref / D1 - u1 (:226-238)
        D1 = g.cell_a_D(g.flat(*cell))[1]
        xf0 = xf * (torch.full_like(D1, g.Dfreq) / D1) \
            if isinstance(D1, torch.Tensor) else xf
        if g.moving:
            xf0 = xf0 - g.vel_dot(cell, *k)
        xf = torch.where(mode == MODE_GAS, xf0, xf)
    acc, trav = tau.clone(), torch.zeros_like(tau)
    for _ in range(sl.max_steps):
        if idx.numel() == 0:
            break
        flat = g.flat(*cell)
        _count(stats, mode, flat, g.rhokap.numel())
        rho = _cart_rho(g, sl, mode, flat, xf)
        t = [_face_dist(pos[a], k[a], cell[a], g.amin[a], g.d[a])
             for a in range(3)]
        dmin = torch.minimum(torch.minimum(t[0], t[1]), t[2])
        axis = torch.where(dmin == t[0], 0, torch.where(dmin == t[1], 1, 2))
        dstep, hit_cap = capped_step(dmin, cap, trav)
        acc = acc + dstep * rho
        trav = trav + dstep
        ncell = []
        out = torch.zeros_like(hit_cap)
        for a in range(3):
            step = torch.where(k[a] > 0, 1, -1)
            c2 = torch.where(axis == a, cell[a] + step, cell[a])
            out = out | (c2 < 0) | (c2 >= g.n[a])
            ncell.append(c2)
        pos = [fma(dmin, k[a], pos[a]) for a in range(3)]
        if sl.comoving:
            nc = [torch.clamp(c, 0, g.n[a] - 1) for a, c in enumerate(ncell)]
            zero = torch.zeros_like(xf)
            u1 = g.vel_dot(cell, *k) if g.moving else zero
            u2 = g.vel_dot(nc, *k) if g.moving else zero
            D1 = g.cell_a_D(flat)[1]
            D2 = g.cell_a_D(g.flat(*nc))[1]
            upd = (mode == MODE_GAS) & ~out
            xf = torch.where(upd, comoving(xf, u1, D1, D2, u2), xf)
        done = out | hit_cap
        tau[idx[done]] = acc[done]
        keep = ~done
        idx, xf, acc, trav, mode = (v[keep] for v in (idx, xf, acc, trav,
                                                       mode))
        if cap is not None:
            cap = cap[keep]
        pos, k = [v[keep] for v in pos], [v[keep] for v in k]
        cell = [v[keep] for v in ncell]
    tau[idx] = acc      # the rays still live after max_steps
    return tau


def _walk_amr(sl: Sightline, pos, k, xf, mode, stats=None):
    g = sl.grid
    amr = g.amr
    tau = torch.zeros_like(xf)
    idx = torch.arange(len(xf), device=xf.device)
    ic = amr.find_cell(*pos)
    update = sl.comoving
    if update:
        # the entry node's comoving frequency of a tau_gas column
        il = amr.leaf(ic)
        D1 = amr.a_D(il, g.a_ref, g.Dfreq)[1]
        xf0 = xf * (torch.full_like(D1, g.Dfreq) / D1) \
            if isinstance(D1, torch.Tensor) else xf
        xf = torch.where(mode == MODE_GAS, xf0 - g.leaf_vel_dot(il, *k), xf)
    acc = tau.clone()
    for _ in range(sl.max_steps):
        if idx.numel() == 0:
            break
        il = amr.leaf(ic)
        _count(stats, mode, il, g.rhokap.numel())
        a_c, D_c = amr.a_D(il, g.a_ref, g.Dfreq)
        rk = amr.gather(g.rhokap, il, 0.0)
        gas = rk * pline.line_profile_plain(g.line, xf, a_c, D_c)
        ngas = (rk * D_c) / torch.full_like(rk, sl.cross0) \
            if isinstance(D_c, torch.Tensor) else div(rk * f32(D_c),
                                                      sl.cross0)
        dust = amr.gather(g.rhokapD, il, 0.0)
        rho = torch.where(mode == MODE_GAS, gas,
                          torch.where(mode == MODE_NGAS, ngas, dust))
        box = g.node_box(ic)
        dmin, axis, face = exit_face(pos, k, box)
        acc = acc + dmin * rho
        pos = [fma(dmin, k[a], pos[a]) for a in range(3)]
        _, esc, icn = hop(g, ic, face, pos)
        if update:
            il2 = amr.leaf(icn)
            D2 = amr.a_D(il2, g.a_ref, g.Dfreq)[1]
            upd = (mode == MODE_GAS) & ~esc
            xf = torch.where(upd, comoving(
                xf, g.leaf_vel_dot(il, *k), D_c, D2,
                g.leaf_vel_dot(il2, *k)), xf)
        done = esc
        tau[idx[done]] = acc[done]
        keep = ~done
        idx, xf, acc, mode, ic = (v[keep] for v in (idx, xf, acc, mode, icn))
        pos, k = [v[keep] for v in pos], [v[keep] for v in k]
    tau[idx] = acc
    return tau


def _walk_clump(sl: Sightline, pos, k, xf, mode, stats=None):
    g = sl.grid
    cl = g.clump
    tau = torch.zeros_like(xf)
    idx = torch.arange(len(xf), device=xf.device)
    acc = tau.clone()
    for _ in range(sl.max_steps):
        if idx.numel() == 0:
            break
        cell, t_cell = cl.cell_exit(pos, k)
        _count(stats, mode, cell.new_empty(0), cl.n)
        t_end = t_cell + cl.eps_peel
        add = torch.zeros_like(xf)
        for q in range(cl.K):
            cand = cl.candidate(cell, q)
            qx, qy, qz, qr2 = cl.centre(cand)
            eb, edet = chord_det(pos[0] - qx, pos[1] - qy, pos[2] - qz, *k,
                                 qr2)
            sq = torch.sqrt(torch.clamp_min(edet, 0.0))
            t0 = torch.minimum(torch.clamp_min(-eb - sq, 0.0), t_end)
            t1 = torch.minimum(torch.clamp_min(-eb + sq, 0.0), t_end)
            rk = cl.gather(cl.dev.rhokap, cand)
            u = cl.vel_dot(cand, *k, form='div') if cl.moving else None
            gas = rk * pline.line_profile_plain(
                g.line, cl.local_x(xf, u), f32(cl.a_cl), f32(cl.D_cl))
            dust = cl.gather(cl.dev.rhokapD, cand)
            kq = torch.where(mode == MODE_GAS, gas, torch.where(
                mode == MODE_NGAS, rk * sl.ngas_fac, dust))
            ok = (cand >= 0) & (edet > 0.0)
            if stats is not None:
                # the candidates read (their chord tests are the work)
                stats['visited'][cand[cand >= 0]] = True
            add = fma(torch.where(ok, kq, torch.zeros_like(kq)), t1 - t0, add)
        acc = acc + add
        pos = [fma(t_end, k[a], pos[a]) for a in range(3)]
        out = ((torch.abs(pos[0]) >= cl.R) | (torch.abs(pos[1]) >= cl.R)
               | (torch.abs(pos[2]) >= cl.R))
        tau[idx[out]] = acc[out]
        keep = ~out
        idx, xf, acc, mode = (v[keep] for v in (idx, xf, acc, mode))
        pos, k = [v[keep] for v in pos], [v[keep] for v in k]
    tau[idx] = acc
    return tau


def sightline_plain(sl: Sightline, stats=None) -> torch.Tensor:
    """Plain PyTorch maps of every observer: (nobs, ncol, npix) f32, 0 on
    the rays that miss the box.  stats, a dict, gains the work the maps
    needed: the rays that enter the box ('rays'), their crossings of
    tau_gas columns ('gas') and of N_gas and tau_dust ones ('col'), and
    the distinct cells read ('cells': Cartesian cells, AMR leaves, or the
    clumps whose chords were tested)."""
    out = []
    ncol, npix = sl.ncol, sl.npix
    dev = sl.pos.device
    col = torch.arange(ncol, device=dev).repeat_interleave(npix)
    mode = torch.where(col == COL_NGAS, MODE_NGAS, torch.where(
        col == COL_DUST, MODE_DUST, MODE_GAS))
    xf = torch.where(col >= COL_GAS0, sl.xf_axis[torch.clamp_min(
        col - COL_GAS0, 0)], torch.zeros((), device=dev))
    for o in range(sl.nobs):
        start, k, hit, cap = ray_origins(sl, o)
        pos = [start[a].repeat(ncol) for a in range(3)]
        kk = [k[a].repeat(ncol) for a in range(3)]
        hit_c = hit.repeat(ncol)
        sel = hit_c.nonzero().squeeze(1)
        pos, kk = [v[sel] for v in pos], [v[sel] for v in kk]
        capc = None if cap is None else cap.repeat(ncol)[sel]
        if stats is not None:
            stats['rays'] = stats.get('rays', 0) + sel.numel()
        if sl.kind == GRID_CART:
            t = _walk_cart(sl, pos, kk, xf[sel], mode[sel], capc, stats)
        elif sl.kind == GRID_AMR:
            t = _walk_amr(sl, pos, kk, xf[sel], mode[sel], stats)
        else:
            t = _walk_clump(sl, pos, kk, xf[sel], mode[sel], stats)
        m = torch.zeros(ncol * npix, dtype=torch.float32, device=dev)
        m[sel] = t
        out.append(m.view(ncol, npix))
    if stats is not None:
        stats['cells'] = int(stats.pop('visited').sum()) \
            if 'visited' in stats else 0
    return torch.stack(out)


def sightline(sl: Sightline) -> torch.Tensor:
    """The maps of every observer, (nobs, ncol, npix) f32: kernel K11 for
    a CUDA grid, the plain version for a CPU grid."""
    dev = sl.pos.device
    if dev.type == 'cpu':
        return sightline_plain(sl)
    out = torch.empty((sl.nobs, sl.ncol, sl.npix), dtype=torch.float32,
                      device=dev)
    kbuild.require_cuda('sightline', out, *sl.device_tensors())
    kbuild.check(kbuild.library().lart_sightline(
        ctypes.byref(sl.grid.c_grid_params), ctypes.byref(sl.c_params(out)),
        kbuild.stream_of(out)), 'sightline')
    kbuild.LAUNCHES['sightline'] += 1
    return out


def maps(sl: Sightline, cube: torch.Tensor, o: int) -> Dict[str, np.ndarray]:
    """Observer o's maps on the host as lart_tpu returns them: tau_gas
    (nxfreq, nxim, nyim), N_gas and tau_dust (nxim, nyim)."""
    obs = sl.obs_meta
    c = cube[o].cpu().numpy().reshape(sl.ncol, obs.nxim, obs.nyim)
    return {'tau_gas': c[COL_GAS0:], 'N_gas': c[COL_NGAS],
            'tau_dust': c[COL_DUST]}


def make_maps(cfg, meta, grid, cmeta=None):
    """Every observer's maps of save_sightline_tau, a list of dicts (None
    without observers), through K11 on a CUDA grid."""
    sl = Sightline.from_config(cfg, meta, grid, cmeta)
    if sl is None:
        return None
    cube = sightline(sl)
    return [maps(sl, cube, o) for o in range(sl.nobs)]


def write_sightline_tau(filename: str, m: Dict, cfg, meta) -> str:
    """Write the _tau output file (sightline_tau_rect.f90:340-420 schema;
    lart_tpu/instruments/sightline.py:253)."""
    from ..io.iofile import open_write
    with open_write(filename, cfg.par.file_format) as f:
        for name in ('tau_gas', 'N_gas', 'tau_dust'):
            g = f.create_group(name)
            g.create_dataset('data', data=np.asarray(m[name]))
            g.attrs['EXTNAME'] = name
            if name == 'tau_gas':
                g.attrs['Dxfreq'] = meta.dxfreq
                g.attrs['Xfreq1'] = meta.xfreq_min
                g.attrs['Xfreq2'] = meta.xfreq_max
    return filename
