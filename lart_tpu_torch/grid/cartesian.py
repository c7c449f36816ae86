"""Cartesian grid construction: host numpy f64 build, f32 torch tensors.

Port of lart_tpu/grid/cartesian.py, which cannot be imported here because
it imports jax.numpy (:19).  The numpy body of build_cartesian (:134-571)
is carried over unchanged; 3-D FITS/HDF5 density, temperature and
velocity cubes are read by io/reader.py.  GridMeta has the same
fields as the JAX one; GridDevice holds torch tensors on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from scipy.special import wofz

from ..config import ResolvedConfig
from ..constants import FOURPI, SPEEDC, UM2KM
from ..io.reader import read_3d_any, read_velocity_any


def _voigt0(a: np.ndarray) -> np.ndarray:
    """H(a, 0) exactly (host-side, f64)."""
    return wofz(1j * np.asarray(a, np.float64)).real


@dataclasses.dataclass
class GridDevice:
    """Grid tensors on the device.  Optional entries are None where a fast
    path applies (uniform T: no Dfreq/voigt_a; static medium: no
    velocities)."""
    rhokap: torch.Tensor                  # gas line opacity / length
    rhokapD: Optional[torch.Tensor]       # dust opacity / length
    vfx: Optional[torch.Tensor]
    vfy: Optional[torch.Tensor]
    vfz: Optional[torch.Tensor]
    Dfreq: Optional[torch.Tensor]         # local Doppler width [Hz]
    voigt_a: Optional[torch.Tensor]
    mask: Optional[torch.Tensor] = None   # spherical-atmosphere core


@dataclasses.dataclass(frozen=True)
class GridMeta:
    """Static grid description (fields as lart_tpu.grid.cartesian.GridMeta)."""
    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: float
    xmin: float
    ymin: float
    zmin: float
    xmax: float
    ymax: float
    zmax: float
    i0: int
    j0: int
    k0: int
    bc_x: str
    bc_y: str
    bc_z: str
    Dfreq_ref: float
    voigt_a_ref: float
    uniform_temperature: bool
    static_medium: bool
    has_dust: bool
    nxfreq: int
    xfreq_min: float
    xfreq_max: float
    dxfreq: float
    dwave: float
    xcrit: float
    xcrit2: float
    taumax: float
    tauhomo: float
    taupole_dust: float
    tauhomo_dust: float
    N_gasmax: float
    N_gashomo: float
    atau3: float
    grid_type: str = 'cartesian'
    levelmax: int = 0
    geometry_JPa: int = 0
    nbin_JPa: int = 0
    dr_JPa: float = 0.0
    roff_JPa: float = 0.0
    atmosphere: int = 0
    omega_shear: float = 0.0
    Dfreq_cl: float = 0.0
    voigt_a_cl: float = 0.0
    # gas opacity when one constant fills the grid (uniform static slab);
    # -1 when it varies
    rho_uniform: float = -1.0
    sphere_R: float = -1.0
    sphere_rho: float = -1.0
    sphere_rhoD: float = 0.0


def _cell_centers(n, amin, d):
    return amin + (np.arange(n) + 0.5) * d


def build_cartesian(cfg: ResolvedConfig, device='cpu',
                    host_out: Optional[dict] = None):
    """Build (GridMeta, GridDevice) on `device`.  Mirrors grid_create
    ordering (lart_tpu/grid/cartesian.py:134-571, the same numpy f64 body).
    host_out, if given, receives the host f64 copy of the gas opacity
    ('rhokap'), which a diffuse_emissivity source of emiss_file 'density1'
    or 'density2' draws from (lart_tpu/grid/cartesian.py:562-563)."""
    par, line = cfg.par, cfg.line
    nx, ny, nz = par.nx, par.ny, par.nz
    dx, dy, dz = cfg.dx, cfg.dy, cfg.dz
    xmin, ymin, zmin = cfg.xmin, cfg.ymin, cfg.zmin
    xmax, ymax, zmax = par.xmax, par.ymax, par.zmax
    zmin_sym = (abs(zmax + zmin) < 1e-12)

    xx = _cell_centers(nx, xmin, dx)
    yy = _cell_centers(ny, ymin, dy)
    zz = _cell_centers(nz, zmin, dz)
    X, Y, Z = np.meshgrid(xx, yy, zz, indexing='ij')

    geom0 = par.geometry.strip().lower()
    atm = {'plane_atmosphere': 1, 'spherical_atmosphere': 2}.get(geom0, 0)
    dens_file = (par.dens_file or par.density_file).strip()
    temp_file = (par.temp_file or par.temperature_file).strip()
    velo_file = (par.velo_file or par.velocity_file).strip()
    rr3_flat = np.sqrt(X * X + Y * Y + Z * Z)

    def profile_1d(path):
        """1-D text profile (axis, value) interpolated onto the grid:
        vs z for plane atmospheres, vs r otherwise (read_plane_data /
        read_spherical_data, read_text_data.f90:7-141)."""
        dat = np.loadtxt(path, ndmin=2)
        ax, val = dat[:, 0], dat[:, 1]
        coord = Z if atm == 1 else rr3_flat
        return np.interp(coord, ax, val, left=val[0], right=0.0)

    def _is_text(path):
        return path.rsplit('.', 1)[-1].lower() in ('txt', 'dat')

    def grid_3d(path, what):
        """3-D FITS/HDF5 grid array (read_3D, read_grid_data.f90:21-140);
        must match the declared (nx, ny, nz)."""
        arr = read_3d_any(path)
        if arr.shape != (nx, ny, nz):
            raise ValueError(
                f'{what} file {path}: shape {arr.shape} != grid '
                f'({nx}, {ny}, {nz})')
        return arr

    # --- (1) temperature and Doppler widths
    T = np.full((nx, ny, nz), par.temperature, np.float64)
    uniform_T = True
    if temp_file:
        T = profile_1d(temp_file) if _is_text(temp_file) \
            else grid_3d(temp_file, 'temperature')
        T[T <= 0.0] = par.temperature
        uniform_T = False
    if not uniform_T:
        bt = par.bturb if par.bturb > 0 else 0.0
        vtherm = np.sqrt((line.vtherm1 ** 2) * T + bt * bt)
    else:
        vtherm = np.full_like(T, cfg.vtherm)
    Dfreq = vtherm / (line.wavelength0 * UM2KM)
    voigt_a = (line.damping / FOURPI) / Dfreq
    Dfreq_ref = cfg.Dfreq_ref

    # --- (2) density (relative units) + geometry masks
    rho = np.ones((nx, ny, nz), np.float64)
    geom = par.geometry.strip().lower()
    mask_arr = None
    if dens_file:
        rho = profile_1d(dens_file) if _is_text(dens_file) \
            else grid_3d(dens_file, 'density')
    if atm == 2 and par.rmin > 0.0:
        mask_arr = (rr3_flat <= par.rmin)
    rr3 = np.sqrt(X * X + Y * Y + Z * Z)
    rr2 = np.sqrt(X * X + Y * Y)
    if par.rmax > 0.0:
        rr = rr2 if geom == 'cylinder' else rr3
        mask = (rr > par.rmax)
        if par.rmin > 0.0:
            mask |= (rr < par.rmin)
        rho[mask] = 0.0
    if par.cone_opening > 0.0:
        cos_cone = math.cos(math.radians(par.cone_opening))
        with np.errstate(invalid='ignore', divide='ignore'):
            mu = np.abs(Z) / np.where(rr3 > 0, rr3, 1.0)
        rho[mu < cos_cone] = 0.0
    if par.density_rscale > 0.0:
        rr = rr2 if geom == 'cylinder' else rr3
        rho *= np.exp(-rr / par.density_rscale)
    if par.density_zscale > 0.0:
        rho *= np.exp(-np.abs(Z) / par.density_zscale)
    if par.density_alpha != 0.0:
        rpeak = par.rmax if par.rmax > 0.0 else max(xmax, ymax, zmax)
        rr = rr2 if geom == 'cylinder' else rr3
        with np.errstate(divide='ignore'):
            fac = np.where(rr > 0.0, (rpeak / np.maximum(rr, 1e-300))
                           ** par.density_alpha, 1.0)
        rho *= fac

    distance2cm = par.distance2cm if par.distance2cm > 0.0 else 1.0
    rhokap = rho * distance2cm
    rhokapD = rhokap * par.cext_dust * par.DGR if par.DGR > 0.0 else None

    # CIE neutral fraction (grid_mod_car.f90:472-486)
    if par.use_cie_condition:
        T4 = T / 1e4
        k_ion = 5.84862e-9 * np.sqrt(T4) * np.exp(-15.78215 / T4)
        k_rec = 4.13e-13 * T4 ** (-0.7131 - 0.0115 * np.log(T4))
        rhokap = rhokap * (k_rec / (k_ion + k_rec))

    # --- (3) opacity per unit length at line center x=0
    rhokap = rhokap / Dfreq * line.cross0

    # opac_length (grid_mod_car.f90:495-504)
    if par.rmax > 0.0 and par.rmin > 0.0:
        opac_length = par.rmax - par.rmin
    elif par.rmax > 0.0:
        opac_length = par.rmax
    elif zmin_sym:
        opac_length = (zmax - zmin) / 2.0
    else:
        opac_length = zmax - zmin

    nxcen = 0 if (par.xyz_symmetry or par.xy_symmetry) else (nx - 1) // 2
    nycen = 0 if (par.xyz_symmetry or par.xy_symmetry) else (ny - 1) // 2
    H0 = _voigt0(voigt_a)

    # symmetry half-weights for "homo" averages
    nadd = np.ones((nx, ny, nz))
    if par.xyz_symmetry or par.xy_symmetry:
        if nx % 2 == 1:
            nadd[0, :, :] *= 0.5
        if ny % 2 == 1:
            nadd[:, 0, :] *= 0.5
        if par.xyz_symmetry and nz % 2 == 1:
            nadd[:, :, 0] *= 0.5

    def pole_sum(arr):
        s = np.sum(arr[nxcen, nycen, :])
        if par.xyz_symmetry:
            out = s * dz
            if nz % 2 == 1:
                out -= arr[nxcen, nycen, 0] * dz / 2.0
            return out
        if zmin_sym:
            return s * dz / 2.0
        return s * dz

    # --- (4) normalization (grid_mod_car.f90:519-618)
    N_gasmax_in = max(par.N_gasmax, par.N_HImax, par.N_HI)
    N_gashomo_in = max(par.N_gashomo, par.N_HIhomo)
    taumax_in = max(par.taumax, par.tau0)
    if taumax_in > 0.0:
        s = np.sum(rhokap[nxcen, nycen, :] * H0[nxcen, nycen, :])
        if par.xyz_symmetry:
            if nz % 2 == 0:
                norm = taumax_in / (s * dz)
            else:
                s1 = rhokap[nxcen, nycen, 0] * H0[nxcen, nycen, 0]
                norm = taumax_in / ((s - s1 / 2.0) * dz)
        elif zmin_sym:
            norm = 2.0 * taumax_in / (s * dz)
        else:
            norm = taumax_in / (s * dz)
    elif par.tauhomo > 0.0:
        sel = rhokap > 0.0
        s = np.sum(rhokap * H0 * nadd * sel)
        n = np.sum(nadd * sel)
        norm = par.tauhomo / (s / n * opac_length)
    elif N_gasmax_in > 0.0:
        s = np.sum(rhokap[nxcen, nycen, :] * Dfreq[nxcen, nycen, :])
        if par.xyz_symmetry:
            if nz % 2 == 0:
                norm = N_gasmax_in / (s * dz / line.cross0)
            else:
                s1 = rhokap[nxcen, nycen, 0] * Dfreq[nxcen, nycen, 0]
                norm = N_gasmax_in / ((s - s1 / 2.0) * dz / line.cross0)
        elif zmin_sym:
            norm = 2.0 * N_gasmax_in / (s * dz / line.cross0)
        else:
            norm = N_gasmax_in / (s * dz / line.cross0)
    elif N_gashomo_in > 0.0:
        sel = rhokap > 0.0
        s = np.sum(rhokap * Dfreq * nadd * sel)
        n = np.sum(nadd * sel)
        dens = s / n / line.cross0
        norm = N_gashomo_in / (dens * opac_length)
    else:
        norm = 1.0
    rhokap = rhokap * norm
    if rhokapD is not None:
        rhokapD = rhokapD * norm

    # --- diagnostics (taupole/tauhomo/N_gaspole/N_gashomo)
    sel = rhokap > 0.0
    nsel = max(np.sum(nadd * sel), 1.0)
    tauhomo = np.sum(rhokap * H0 * nadd * sel) / nsel * opac_length
    taupole = pole_sum(rhokap * H0)
    N_gashomo = np.sum(rhokap * Dfreq * nadd * sel) / nsel / line.cross0 * opac_length
    N_gaspole = pole_sum(rhokap * Dfreq) / line.cross0
    if rhokapD is not None:
        tauhomo_dust = np.sum(rhokapD * nadd * sel) / nsel * opac_length
        taupole_dust = pole_sum(rhokapD)
    else:
        tauhomo_dust = taupole_dust = 0.0


    taumax_d = taumax_in if taumax_in > 0.0 else taupole
    tauhomo_d = par.tauhomo if par.tauhomo > 0.0 else tauhomo

    # --- (5) velocity field (grid_mod_car.f90:786-946); in local vtherm units
    vt = vtherm
    vfx = vfy = vfz = None
    vtype = par.velocity_type.strip().lower()
    if velo_file and _is_text(velo_file):
        prof = profile_1d(velo_file)
        if atm == 1:
            vfx = np.zeros_like(rho)
            vfy = np.zeros_like(rho)
            vfz = prof / vt
        else:
            with np.errstate(invalid='ignore', divide='ignore'):
                fac = prof / vt / np.maximum(rr3_flat, 1e-300)
            vfx = fac * X
            vfy = fac * Y
            vfz = fac * Z
    elif velo_file:
        # 3-component (x,y,z,3) velocity cube in km/s (read_velocity,
        # read_grid_data.f90:142-244; stored (nz,ny,nx,3) on disk)
        v3 = read_velocity_any(velo_file)
        if v3.shape != (nx, ny, nz, 3):
            raise ValueError(
                f'velocity file {velo_file}: shape {v3.shape} != '
                f'({nx}, {ny}, {nz}, 3)')
        vfx = v3[..., 0] / vt
        vfy = v3[..., 1] / vt
        vfz = v3[..., 2] / vt
    elif vtype:
        vfx = np.zeros_like(rho)
        vfy = np.zeros_like(rho)
        vfz = np.zeros_like(rho)
        nonzero = rho > 0.0
        rpeak = par.rmax if par.rmax > 0.0 else max(xmax, ymax, zmax)
        if vtype == 'hubble':
            vfx = np.where(nonzero, (par.Vexp / vt) * X / rpeak, 0.0)
            vfy = np.where(nonzero, (par.Vexp / vt) * Y / rpeak, 0.0)
            vfz = np.where(nonzero, (par.Vexp / vt) * Z / rpeak, 0.0)
        elif vtype == 'parallel_velocity':
            vfx = np.where(nonzero, par.Vx / vt, 0.0)
            vfy = np.where(nonzero, par.Vy / vt, 0.0)
            vfz = np.where(nonzero, par.Vz / vt, 0.0)
        elif vtype == 'ssh':
            rr = rr3
            inner = rr < par.rpeak
            Vs_in = par.Vpeak / max(par.rpeak, 1e-300)
            with np.errstate(invalid='ignore', divide='ignore'):
                Vs_out = (par.Vpeak + par.DeltaV * (rr - par.rpeak)
                          / max(par.rmax - par.rpeak, 1e-300)) / np.maximum(rr, 1e-300)
            fac = np.where(inner, Vs_in, Vs_out) / vt
            vfx = np.where(nonzero, fac * X, 0.0)
            vfy = np.where(nonzero, fac * Y, 0.0)
            vfz = np.where(nonzero, fac * Z, 0.0)
        elif vtype in ('constant_radial', 'power_law', 'linear_decelerate'):
            rr = rr3
            ok = nonzero & (rr > dz / 10.0)
            if vtype == 'constant_radial':
                Vs = par.Vexp
            elif vtype == 'power_law':
                Vs = par.Vexp * (rr / rpeak) ** par.velocity_alpha
            else:
                Vs = par.Vexp * np.maximum(
                    0.0, (rpeak - rr) / (rpeak - max(par.rmin, 0.0)))
            with np.errstate(invalid='ignore', divide='ignore'):
                fac = Vs / vt / np.maximum(rr, 1e-300)
            vfx = np.where(ok, fac * X, 0.0)
            vfy = np.where(ok, fac * Y, 0.0)
            vfz = np.where(ok, fac * Z, 0.0)
        elif vtype == 'rotating_solid_body':
            vfx = np.where(nonzero, -par.Vrot / vt * Y / par.rmax, 0.0)
            vfy = np.where(nonzero, par.Vrot / vt * X / par.rmax, 0.0)
        elif vtype == 'rotating_galaxy_halo':
            rr = np.maximum(rr2, 1e-300)
            rin = np.maximum(par.rinner, 1e-300)
            denom = np.where(rr2 < par.rinner, rin, rr)
            vfx = np.where(nonzero, -par.Vrot / vt * Y / denom, 0.0)
            vfy = np.where(nonzero, par.Vrot / vt * X / denom, 0.0)
        else:
            raise ValueError(f'unknown velocity_type: {par.velocity_type!r}')
    static_medium = vfx is None or (np.all(vfx == 0.0) and np.all(vfy == 0.0)
                                    and np.all(vfz == 0.0))
    if static_medium:
        vfx = vfy = vfz = None

    # --- uniform-sphere medium detection: constant opacity exactly on the
    # r < rmax ball, vacuum outside -> flights and peel sightlines become
    # closed-form chords (engine.make_fly_uniform_sphere).  Any density
    # modifier (profiles, cones, files) breaks the constancy test.
    sphere_R, sphere_rho, sphere_rhoD = -1.0, -1.0, 0.0
    if (geom == 'sphere' and par.rmax > 0.0 and par.rmin <= 0.0
            and static_medium and uniform_T and mask_arr is None
            and not (par.xyz_symmetry or par.xy_symmetry)
            and np.any(sel)):
        v0 = rhokap[sel].flat[0]
        ball = rr3 <= par.rmax
        if (v0 > 0.0 and np.all(rhokap[sel] == v0)
                and np.array_equal(sel, ball)
                and (rhokapD is None
                     or np.all(rhokapD[sel] == rhokapD[sel].flat[0]))
                and (rhokapD is None or np.all(rhokapD[~sel] == 0.0))):
            sphere_R = float(par.rmax)
            sphere_rho = float(v0)
            sphere_rhoD = float(rhokapD[sel].flat[0]) \
                if rhokapD is not None else 0.0

    # --- (6) frequency grid (car_setup_freq_grid, grid_mod_car.f90:1442-1548)
    voigt_amean = (line.damping / FOURPI) / Dfreq_ref
    atau3 = (voigt_amean * tauhomo_d) ** (1.0 / 3.0) if tauhomo_d > 0 else 0.0

    xfreq_min, xfreq_max, nxfreq = par.xfreq_min, par.xfreq_max, par.nxfreq
    vth = cfg.vtherm
    if _finite(par.wavelength_min) and _finite(par.wavelength_max):
        if par.nwavelength > 0:
            nxfreq = par.nwavelength
        lam0A = line.wavelength0 * 1e4
        xfreq_min = -(par.wavelength_max - lam0A) / lam0A * (SPEEDC / vth)
        xfreq_max = -(par.wavelength_min - lam0A) / lam0A * (SPEEDC / vth)
    elif _finite(par.velocity_min) and _finite(par.velocity_max):
        if par.nvelocity > 0:
            nxfreq = par.nvelocity
        xfreq_min = -par.velocity_max / vth
        xfreq_max = -par.velocity_min / vth
    if not (_finite(xfreq_min) and _finite(xfreq_max)):
        tm = taumax_d
        if tm <= 5e1:
            xscale = 25.0
        elif tm <= 5e2:
            xscale = 14.0
        elif tm <= 5e3:
            xscale = 10.0
        else:
            xscale = 5.0
        if par.spectral_type.strip() == 'continuum':
            xscale *= 4.0
        dnuHK = line.DnuHK_Hz / Dfreq_ref
        if par.Vexp == 0.0:
            xfreq_max = math.floor(xscale * atau3) + 1
            xfreq_min = -(math.floor(xscale * atau3 + dnuHK) + 1)
        elif par.Vexp > 0.0:
            xfreq_max = math.floor(xscale * atau3) + 1
            xfreq_min = -(math.floor(xscale * atau3 + abs(par.Vexp) / vth + dnuHK) + 1)
        else:
            xfreq_max = math.floor(xscale * atau3 + abs(par.Vexp) / vth) + 1
            xfreq_min = -(math.floor(xscale * atau3 + dnuHK) + 1)
        if par.spectral_type.strip() == 'continuum':
            xfreq_max = math.floor(xscale * atau3 + abs(par.Vexp) / vth) + 1
            xfreq_min = -(math.floor(xscale * atau3 + abs(par.Vexp) / vth + dnuHK) + 1)
    dxfreq = (xfreq_max - xfreq_min) / nxfreq
    dwave = vth / SPEEDC * (line.wavelength0 * 1e4) * dxfreq

    # --- (7) core-skip xcrit constants (grid_mod_car.f90:1186-1220)
    atau0 = voigt_amean * tauhomo_d
    if not par.core_skip_global:
        atau0 = atau0 / (xmax / dx)
    if atau0 <= 1.0:
        xcrit = 0.0
    else:
        xi_, chi = (0.6, 1.2) if atau0 <= 60.0 else (1.4, 0.6)
        xcrit = 0.02 * math.exp(xi_ * (math.log(atau0)) ** chi)

    # shearing box (TIGRESS): background vy0 = -q*Omega*x; a photon
    # wrapping across the periodic x boundary shifts its shear-frame
    # y-velocity by q*Omega*Lx (converted to thermal units)
    omega_shear = 0.0
    if par.Omega != 0.0 and par.xy_periodic:
        KPC2CM = 3.0856775814913673e21
        om = par.Omega
        # key the conversion on distance2cm alone (resolve() has already
        # folded distance_unit into it; kpc gives an identity factor) --
        # the reference converts for ANY unit other than 'kpc', including
        # the empty unit (distance2cm=1, setup.f90:479) and an explicit
        # distance2cm (renamed 'user', setup.f90:484; grid_mod_car.f90:349)
        if par.distance2cm > 0:
            om = om * (par.distance2cm / KPC2CM)
        omega_shear = par.q * om * (2.0 * xmax) / cfg.vtherm

    # CALCJ/P binning geometry
    geometry_JPa, nbin_JPa, dr_JPa, roff_JPa = 0, 0, 0.0, 0.0
    if par.calcJ or par.calcP or par.calcPnew:
        if par.xy_periodic or (nx == 1 and ny == 1):
            geometry_JPa, nbin_JPa = -1, nz
        elif geom == 'sphere' or par.rmax > 0:
            nr = max(nx, ny, nz)
            nr = nr // 2 if nr % 2 == 0 else (nr - 1) // 2 + 1
            if max(nx, ny, nz) % 2 == 0:
                dr_JPa, roff_JPa = par.rmax / nr, 0.0
            else:
                dr_JPa, roff_JPa = par.rmax / (nr - 0.5), -par.rmax / (nr - 0.5) / 2.0
            geometry_JPa, nbin_JPa = 1, nr
        else:
            geometry_JPa, nbin_JPa = 3, nx * ny * nz

    meta = GridMeta(
        nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, dz=dz,
        xmin=xmin, ymin=ymin, zmin=zmin, xmax=xmax, ymax=ymax, zmax=zmax,
        i0=cfg.i0, j0=cfg.j0, k0=cfg.k0,
        bc_x=cfg.bc_x, bc_y=cfg.bc_y, bc_z=cfg.bc_z,
        Dfreq_ref=Dfreq_ref, voigt_a_ref=cfg.voigt_a_ref,
        uniform_temperature=uniform_T, static_medium=static_medium,
        has_dust=rhokapD is not None,
        rho_uniform=(float(rhokap.flat[0])
                     if rhokap.size > 0 and rhokap.flat[0] > 0.0
                     and np.all(rhokap == rhokap.flat[0]) else -1.0),
        sphere_R=sphere_R, sphere_rho=sphere_rho, sphere_rhoD=sphere_rhoD,
        nxfreq=nxfreq, xfreq_min=float(xfreq_min), xfreq_max=float(xfreq_max),
        dxfreq=float(dxfreq), dwave=float(dwave),
        xcrit=float(xcrit), xcrit2=float(xcrit * xcrit),
        taumax=float(taumax_d), tauhomo=float(tauhomo_d),
        taupole_dust=float(taupole_dust), tauhomo_dust=float(tauhomo_dust),
        N_gasmax=float(N_gasmax_in if N_gasmax_in > 0 else N_gaspole),
        N_gashomo=float(N_gashomo_in if N_gashomo_in > 0 else N_gashomo),
        atau3=float(atau3),
        geometry_JPa=geometry_JPa, nbin_JPa=nbin_JPa,
        dr_JPa=float(dr_JPa), roff_JPa=float(roff_JPa),
        atmosphere=atm, omega_shear=float(omega_shear))

    if host_out is not None:
        host_out['rhokap'] = np.asarray(rhokap, np.float64)

    def f32(x):
        return None if x is None else \
            torch.as_tensor(np.asarray(x, np.float32), device=device)

    dev = GridDevice(
        rhokap=f32(rhokap), rhokapD=f32(rhokapD),
        vfx=f32(vfx), vfy=f32(vfy), vfz=f32(vfz),
        Dfreq=None if uniform_T else f32(Dfreq),
        voigt_a=None if uniform_T else f32(voigt_a),
        mask=None if mask_arr is None
        else torch.as_tensor(mask_arr, device=device))
    return meta, dev


def _finite(v: float) -> bool:
    return v == v and abs(v) != math.inf
