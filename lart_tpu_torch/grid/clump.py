"""Clumpy medium: spherical-clump populations + CSR acceleration grid, as
tensors on one device.

The port's copy of lart_tpu/grid/clump.py (clump_mod.f90:646-1388:
init_clumps, generate_clumps, build_clump_csr), whose module imports
jax.numpy.  The numpy/scipy body of build_clumps is carried over unchanged,
so one seed gives the same population and the same padded candidate table
to the bit: N spherical clumps placed by batched random sequential
adsorption (cKDTree neighbour rejection) in the shell [rmin, rmax], each
with a radius, an opacity and a bulk velocity, and a uniform acceleration
grid of cg_n^3 cells that lists, per cell, the K clumps whose bounding box
overlaps it (-1 pads the rows).  Only the device arrays differ in kind:
torch tensors on `device`.  save_clumps and load_clumps read and write the
population file through io/iofile (HDF5, where h5py is installed).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import ResolvedConfig, vtherm_total
from ..constants import FOURPI, SPEEDC, UM2KM
from ..utils.device import resolve_device
from .cartesian import GridMeta, _voigt0


@dataclasses.dataclass
class ClumpDevice:
    """The population on the device (lart_tpu's ClumpDevice, field for
    field): f32 centres, radius^2, radius, line opacity per length at line
    centre, dust opacity (None without dust), bulk velocity in units of
    the clump thermal speed, and the (cg_n^3, K) int32 candidate table."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    r2: torch.Tensor
    radius: torch.Tensor
    rhokap: torch.Tensor
    rhokapD: Optional[torch.Tensor]
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    table: torch.Tensor

    def tensors(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if getattr(self, f.name) is not None)


@dataclasses.dataclass(frozen=True)
class ClumpMeta:
    n_clumps: int
    cg_n: int               # CSR cells per axis
    cg_dx: float
    K: int                  # table pad width
    f_vol: float
    f_cov: float
    rhokap_ref: float


def build_clumps(cfg: ResolvedConfig, seed: int = 1234, device=None):
    """Build (GridMeta, ClumpMeta, ClumpDevice) on `device` ('cuda' when
    None; utils.device.resolve_device) (lart_tpu/grid/clump.py:58-331, the
    same numpy body)."""
    device = resolve_device(device)
    par, line = cfg.par, cfg.line
    R = par.rmax if par.rmax > 0 else min(par.xmax, par.ymax, par.zmax)
    rmin = max(0.0, par.rmin)
    from_file = bool(par.clump_input_file.strip())
    r_cl = par.clump_radius
    if r_cl <= 0 and not from_file:
        raise ValueError('clump_radius must be > 0')

    # --- population size (init_clumps, clump_mod.f90:723-740)
    if from_file:
        N = 1   # placeholder; set from the file below
    elif par.clump_N_clumps > 0:
        N = int(par.clump_N_clumps)
    elif par.clump_f_vol > 0:
        N = int(round(par.clump_f_vol * (R ** 3 - rmin ** 3) / r_cl ** 3))
    elif par.clump_f_cov > 0:
        N = int(round((4.0 / 3.0) * par.clump_f_cov
                      * (R ** 2 + R * rmin + rmin ** 2) / r_cl ** 2))
    else:
        raise ValueError('specify clump_N_clumps, clump_f_vol or clump_f_cov')
    N = max(N, 1)

    # --- clump opacity (clump_mod.f90:766-812)
    T_cl = par.clump_temperature if par.clump_temperature > 0 \
        else par.temperature
    vth = vtherm_total(par, line, T_cl)
    Dfreq_cl = vth / (line.wavelength0 * UM2KM)
    voigt_a_cl = (line.damping / FOURPI) / Dfreq_cl
    H0 = float(_voigt0(np.array([voigt_a_cl]))[0])
    d2cm = par.distance2cm if par.distance2cm > 0 else 1.0
    if par.clump_tau0 > 0 and r_cl > 0:
        rhokap_ref = par.clump_tau0 / (H0 * r_cl)
    elif par.clump_NHI > 0 and r_cl > 0:
        rhokap_ref = par.clump_NHI * line.cross0 / (Dfreq_cl * r_cl)
    elif par.clump_nH > 0:
        rhokap_ref = par.clump_nH * line.cross0 * d2cm / Dfreq_cl
    elif (par.taumax > 0 or par.N_HImax > 0) and not from_file:
        GF = N * r_cl ** 3 / max(R ** 2 + R * rmin + rmin ** 2, 1e-300)
        if par.taumax > 0:
            rhokap_ref = par.taumax / (GF * H0)
        else:
            rhokap_ref = par.N_HImax * line.cross0 / (GF * Dfreq_cl)
    elif from_file:
        rhokap_ref = 0.0   # taken from the file's RHOKAP column/keyword
    else:
        raise ValueError('specify clump_tau0/clump_NHI/clump_nH/taumax')

    # --- radial shape profiles of clump radius / density / number
    # (profile_factor, clump_mod.f90:200-260; profile file :554-640)
    prof_table = None
    if par.clump_profile_file.strip():
        prof_table = np.loadtxt(par.clump_profile_file, ndmin=2)

    def shape(name, rr_, alpha, r0, col):
        nm = (name or 'constant').strip().lower()
        if nm == 'constant':
            return np.ones_like(rr_)
        if nm in ('powerlaw', 'power_law'):
            r_floor = 1e-3 * R
            return (np.maximum(rr_, r_floor)
                    / max(r0 if r0 > 0 else R, r_floor)) ** (-alpha)
        if nm == 'file':
            if prof_table is None:
                raise ValueError('clump_profile_file required for '
                                 'profile "file"')
            return np.interp(rr_, prof_table[:, 0], prof_table[:, col])
        raise ValueError(f'unknown clump profile {name!r}')

    num_uniform = (par.clump_number_profile or 'constant').strip().lower() \
        == 'constant'

    if from_file:
        # population from file (read_clumps_info, clump_mod.f90:2000-2315)
        pop = load_clumps(par.clump_input_file)
        pos = pop['pos']
        N = len(pos)
        radius = pop.get('radius')
        radius = np.asarray(radius) if radius is not None \
            else np.full(N, r_cl)
        v = pop.get('vel')
        v = np.asarray(v) / vth if v is not None else np.zeros((N, 3))
        rho_i = pop.get('rhokap')
        if rho_i is None:
            rho_i = par.clump_tau0 / (H0 * radius) if par.clump_tau0 > 0 \
                else np.full(N, rhokap_ref)
    else:
        pos, rng = _place(par, N, R, rmin, r_cl, seed, shape, num_uniform)
        N = len(pos)
        # per-clump radius from the radius profile (clamped)
        rcen = np.sqrt((pos ** 2).sum(axis=1))
        radius = r_cl * shape(par.clump_radius_profile, rcen,
                              par.clump_radius_alpha, par.clump_radius_r0, 1)
        if par.clump_radius_min > 0:
            radius = np.maximum(radius, par.clump_radius_min)
        if par.clump_radius_max_in > 0:
            radius = np.minimum(radius, par.clump_radius_max_in)

        # per-clump opacity: tau0/NHI are per-clump invariants (rhokap ~
        # 1/radius); nH-based opacity is radius-independent
        dens_fac = shape(par.clump_density_profile, rcen,
                         par.clump_density_alpha, par.clump_density_r0, 2)
        if par.clump_tau0 > 0 or par.clump_NHI > 0:
            rho_i = rhokap_ref * (r_cl / radius) * dens_fac
        else:
            rho_i = rhokap_ref * dens_fac

        # bulk velocities (clump_sigma_v), normalized by clump vtherm
        if par.clump_sigma_v > 0:
            v = rng.normal(0.0, par.clump_sigma_v, (N, 3)) / vth
        else:
            v = np.zeros((N, 3))

    rho_i = np.broadcast_to(np.asarray(rho_i, np.float64), (N,)).copy()
    f_vol = np.sum(radius ** 3) / max(R ** 3 - rmin ** 3, 1e-300)
    f_cov = 0.75 * np.sum(radius ** 2) \
        / max(R ** 2 + R * rmin + rmin ** 2, 1e-300)
    cg_n, cg_dx, K, table = csr_table(pos, radius, R)

    rhokapD = None
    if par.DGR > 0:
        # matches the Cartesian rhokapD/rhokap ratio (clump_mod.f90:862-864)
        rhokapD = rho_i * par.cext_dust * par.DGR * Dfreq_cl / line.cross0

    # GridMeta reused: the bounding cube is the "grid"; nx=1 etc unused
    taumax_d = par.taumax if par.taumax > 0 else \
        f_cov * rhokap_ref * H0 * r_cl * (4.0 / 3.0)
    atau3 = (cfg.voigt_a_ref * max(taumax_d, 1e-30)) ** (1 / 3)
    xfreq_min, xfreq_max, nxfreq = par.xfreq_min, par.xfreq_max, par.nxfreq
    if not (xfreq_min == xfreq_min and xfreq_max == xfreq_max):
        xscale = 25.0 if taumax_d <= 5e1 else 14.0 if taumax_d <= 5e2 \
            else 10.0 if taumax_d <= 5e3 else 5.0
        xfreq_max = math.floor(xscale * atau3) + 1
        xfreq_min = -xfreq_max
    dxfreq = (xfreq_max - xfreq_min) / nxfreq
    dwave = cfg.vtherm / SPEEDC * (line.wavelength0 * 1e4) * dxfreq

    meta = GridMeta(
        nx=1, ny=1, nz=1, dx=2 * R, dy=2 * R, dz=2 * R,
        xmin=-R, ymin=-R, zmin=-R, xmax=R, ymax=R, zmax=R,
        i0=0, j0=0, k0=0, bc_x='escape', bc_y='escape', bc_z='escape',
        Dfreq_ref=cfg.Dfreq_ref, voigt_a_ref=cfg.voigt_a_ref,
        uniform_temperature=True, static_medium=bool(par.clump_sigma_v <= 0),
        has_dust=rhokapD is not None,
        nxfreq=nxfreq, xfreq_min=float(xfreq_min), xfreq_max=float(xfreq_max),
        dxfreq=float(dxfreq), dwave=float(dwave),
        xcrit=0.0, xcrit2=0.0,
        taumax=float(taumax_d), tauhomo=float(taumax_d),
        taupole_dust=0.0, tauhomo_dust=0.0,
        N_gasmax=float(max(par.N_HImax, 0.0)), N_gashomo=0.0,
        atau3=float(atau3), grid_type='clump',
        Dfreq_cl=float(Dfreq_cl), voigt_a_cl=float(voigt_a_cl))

    cmeta = ClumpMeta(n_clumps=N, cg_n=cg_n, cg_dx=float(cg_dx), K=K,
                      f_vol=float(f_vol), f_cov=float(f_cov),
                      rhokap_ref=float(rhokap_ref))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    dev = ClumpDevice(
        x=f32(pos[:, 0]), y=f32(pos[:, 1]), z=f32(pos[:, 2]),
        r2=f32(radius * radius), radius=f32(radius),
        rhokap=f32(rho_i),
        rhokapD=f32(rhokapD) if rhokapD is not None else None,
        vx=f32(v[:, 0]), vy=f32(v[:, 1]), vz=f32(v[:, 2]),
        table=torch.as_tensor(table, device=device))
    return meta, cmeta, dev


def _place(par, N, R, rmin, r_cl, seed, shape, num_uniform):
    """((N', 3) positions, the generator) of the batched RSA
    (generate_clumps; lart_tpu/grid/clump.py:148-216): N' <= N when the
    rounds run out."""
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(seed)
    r_hi = R - r_cl if par.clump_fully_inside else R
    r_lo = rmin + r_cl if (rmin > 0 and par.clump_fully_inside) else rmin
    pos = np.zeros((N, 3))
    placed = 0
    max_tries = 200
    # number-profile rejection envelope over [r_lo, r_hi]
    if not num_uniform:
        rgrid = np.linspace(max(r_lo, 1e-6 * R), r_hi, 512)
        fnum = shape(par.clump_number_profile, rgrid,
                     par.clump_number_alpha, par.clump_number_r0, 4)
        fnum_max = fnum.max()

    def draw(n):
        """n candidate positions with the radial number profile."""
        u = rng.random((n, 3))
        rr = (r_lo ** 3 + u[:, 0] * (r_hi ** 3 - r_lo ** 3)) ** (1 / 3)
        if not num_uniform:
            fn = shape(par.clump_number_profile, rr,
                       par.clump_number_alpha, par.clump_number_r0, 4)
            keep = rng.random(n) * fnum_max < fn
            rr, u = rr[keep], u[keep]
        ct = 2 * u[:, 1] - 1
        st = np.sqrt(np.maximum(1 - ct * ct, 0))
        ph = 2 * np.pi * u[:, 2]
        return np.stack([rr * st * np.cos(ph), rr * st * np.sin(ph),
                         rr * ct], axis=1)

    # batched RSA: reject candidates overlapping accepted clumps, resolve
    # intra-batch pairs by killing the later-drawn member, repeat
    for _ in range(max_tries):
        if placed >= N:
            break
        cand = draw(max(N - placed + (N >> 6), 1024))
        if cand.size == 0:
            continue
        if not par.clump_allow_overlap:
            if placed:
                d, _ = cKDTree(pos[:placed]).query(
                    cand, k=1, distance_upper_bound=2 * r_cl)
                cand = cand[d >= 2 * r_cl]   # inf when no neighbor
                if cand.size == 0:
                    continue
            pairs = cKDTree(cand).query_pairs(2 * r_cl, output_type='ndarray')
            if len(pairs):
                kill = np.zeros(len(cand), bool)
                kill[pairs[:, 1]] = True
                cand = cand[~kill]
        take = cand[:N - placed]
        pos[placed:placed + len(take)] = take
        placed += len(take)
    return pos[:placed], rng


def csr_table(pos, radius, R):
    """(cg_n, cg_dx, K, table) of the CSR acceleration grid over the
    bounding cube [-R, R]^3 (build_clump_csr, clump_mod.f90:1267-1388):
    cell size ~ the largest clump's diameter, cg_n clipped to [4, 192];
    each cell's row lists the clumps whose bounding box overlaps it, in the
    order of a stable sort by cell of the (cell, clump) pairs enumerated
    offset by offset, padded with -1 to the longest row, K."""
    N = len(pos)
    r_max_cl = float(radius.max())
    cg_n = int(np.clip(math.floor(2 * R / (2 * r_max_cl)), 4, 192))
    cg_dx = 2 * R / cg_n
    lo = np.clip(np.floor((pos - radius[:, None] + R) / cg_dx), 0,
                 cg_n - 1).astype(np.int64)
    hi = np.clip(np.floor((pos + radius[:, None] + R) / cg_dx), 0,
                 cg_n - 1).astype(np.int64)
    span = hi - lo
    smax = span.max(axis=0) if N else np.zeros(3, np.int64)
    cells_l, clumps_l = [], []
    ids = np.arange(N, dtype=np.int64)
    for di in range(int(smax[0]) + 1):
        for dj in range(int(smax[1]) + 1):
            for dk in range(int(smax[2]) + 1):
                ok = (di <= span[:, 0]) & (dj <= span[:, 1]) \
                    & (dk <= span[:, 2])
                cell = ((lo[ok, 0] + di) * cg_n + (lo[ok, 1] + dj)) \
                    * cg_n + (lo[ok, 2] + dk)
                cells_l.append(cell)
                clumps_l.append(ids[ok])
    cells = np.concatenate(cells_l) if cells_l else np.zeros(0, np.int64)
    clumps = np.concatenate(clumps_l) if clumps_l else np.zeros(0, np.int64)
    order = np.argsort(cells, kind='stable')
    cells, clumps = cells[order], clumps[order]
    counts = np.bincount(cells, minlength=cg_n ** 3)
    K = max(1, int(counts.max())) if counts.size else 1
    table = np.full((cg_n ** 3, K), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(cells.size) - starts[cells]
    table[cells, slot] = clumps
    return cg_n, cg_dx, K, table


def save_clumps(path: str, pos, radius, rhokap=None, vel=None, T=None,
                sphere_R: float = 0.0, rmin: float = 0.0,
                attrs: dict = None) -> str:
    """Save a clump population (write_clumps_info, reference
    src/clump_mod.f90:1779-1990: X/Y/Z/VX/VY/VZ table + optional
    RADIUS/RHOKAP columns and population keywords) as an HDF5 file with
    one group CLUMPS, as lart_tpu's save_clumps writes it."""
    from ..io.iofile import open_write
    pos = np.asarray(pos, np.float64)
    with open_write(path, 'hdf5') as f:
        g = f.create_group('CLUMPS')
        for i, k in enumerate('XYZ'):
            g.create_dataset(k, data=pos[:, i].astype(np.float32))
        if vel is not None:
            vel = np.asarray(vel, np.float64)
            for i, k in enumerate(('VX', 'VY', 'VZ')):
                g.create_dataset(k, data=vel[:, i].astype(np.float32))
        radius = np.asarray(radius, np.float64)
        if np.ptp(radius) > 1e-3 * radius.mean():
            g.create_dataset('RADIUS', data=radius.astype(np.float32))
        g.attrs['RCL'] = float(radius.mean())
        if rhokap is not None:
            rhokap = np.asarray(rhokap, np.float64)
            if np.ptp(rhokap) > 1e-3 * abs(rhokap.mean()):
                g.create_dataset('RHOKAP', data=rhokap.astype(np.float32))
            g.attrs['RHOKAP'] = float(rhokap.mean())
        if T is not None:
            g.attrs['TEMP_CL'] = float(np.mean(T))
        g.attrs['N_CLUMPS'] = len(pos)
        g.attrs['SPHERE_R'] = float(sphere_R)
        g.attrs['R_MIN'] = float(rmin)
        for k, val in (attrs or {}).items():
            g.attrs[k] = val
    return path


def load_clumps(path: str) -> dict:
    """Load a clump population file written by save_clumps (its columns in
    a group CLUMPS, or at the file's root): pos, and vel, radius, rhokap
    where the file has them, with its keywords under 'attrs'."""
    from ..io.iofile import read_hdf5_columns
    cols, attrs = read_hdf5_columns(
        path, ('X', 'Y', 'Z', 'VX', 'VY', 'VZ', 'RADIUS', 'RHOKAP'), 'X')
    c = {k: np.asarray(v, np.float64) for k, v in cols.items()}
    out = {'pos': np.stack([c['X'], c['Y'], c['Z']], axis=1)}
    if 'VX' in c:
        out['vel'] = np.stack([c['VX'], c['VY'], c['VZ']], axis=1)
    n = len(c['X'])
    if 'RADIUS' in c:
        out['radius'] = c['RADIUS']
    elif 'RCL' in attrs:
        out['radius'] = np.full(n, float(attrs['RCL']))
    if 'RHOKAP' in c:
        out['rhokap'] = c['RHOKAP']
    elif 'RHOKAP' in attrs:
        out['rhokap'] = np.full(n, float(attrs['RHOKAP']))
    out['attrs'] = attrs
    return out
