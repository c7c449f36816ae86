"""AMR grid construction: generic-AMR leaf list -> linear octree + per-leaf
physics, as tensors on one device.

The port's copy of lart_tpu/grid/amr.py (grid_create_amr, reference
src/grid_mod_amr.f90:34-720), whose module imports jax through its octree.
The leaf list (x, y, z, level, nH, T, vx, vy, vz + optional columns) comes
from a generic-AMR HDF5 file, read with h5py inside read_generic_amr, or in
memory through build_amr's `data` (where h5py is missing, as on a machine
without it, the caller builds the leaves in-process and passes them there).
The octree and its neighbor table come from grid/octree.py; the per-leaf
neutral fraction, scatterer and dust densities follow the reference's
ionization, ion and dust models (physics_amr_mod.f90:34-173), the opacity is
normalized by the +z pole traversal from the box centre, and
velocity_type replaces the file's velocities by an analytic field; the
solar-CIE ion model takes its ion densities from grid/ion_data.py.  The
RAMSES reader (amr_type 'ramses') is not ported (engine.check_supported
names it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..config import ResolvedConfig, vtherm_total
from ..constants import FOURPI, SPEEDC, UM2KM
from .cartesian import GridMeta, _voigt0
from ..io.iofile import read_hdf5_columns
from .octree import AmrDevice, HostOctree, build_octree, to_device

AMR_COLUMNS = ('x', 'y', 'z', 'level', 'nH', 'T', 'vx', 'vy', 'vz',
               'metallicity', 'xHI', 'n_e', 'n_ion', 'emissivity', 'ndust')


def read_generic_amr(path: str):
    """Read a generic AMR file (HDF5). Returns dict of columns + box info.
    Needs h5py; without it, build the leaves in-process and pass them to
    build_amr (driver.run's amr_data)."""
    try:
        out, attrs = read_hdf5_columns(path, AMR_COLUMNS, 'x')
    except ImportError as e:
        raise ImportError(f'reading the generic-AMR file {path!r} needs '
                          f'h5py, which is not installed: pass the leaves '
                          f'in memory (driver.run(..., amr_data=...))') from e
    out['boxlen'] = float(attrs.get('BOXLEN', attrs.get('boxlen', 0.0)))
    out['origin'] = (float(attrs.get('ORIGINX', -0.5 * out['boxlen'])),
                     float(attrs.get('ORIGINY', -0.5 * out['boxlen'])),
                     float(attrs.get('ORIGINZ', -0.5 * out['boxlen'])))
    if out['boxlen'] <= 0:
        ext = max(out['x'].max() - out['x'].min(),
                  out['y'].max() - out['y'].min(),
                  out['z'].max() - out['z'].min())
        out['boxlen'] = float(ext) * (1 + 1e-9)
    return out


def cie_neutral_fraction_formula(T):
    """CIE xHI (physics_amr_mod.f90:34-44)."""
    T4 = np.maximum(T, 10.0) / 1e4
    k_ion = 5.84862e-9 * np.sqrt(T4) * np.exp(-15.78215 / T4)
    k_rec = 4.13e-13 * T4 ** (-0.7131 - 0.0115 * np.log(T4))
    return k_rec / (k_ion + k_rec)


def cie_neutral_fraction_table(T):
    """Voronov+Verner CIE xHI (physics_amr_mod.f90:120-173)."""
    T = np.maximum(np.asarray(T, np.float64), 1.0)
    Gamma = 5.85e-11 * np.sqrt(T) * np.exp(-157809.1 / T) \
        / (1.0 + np.sqrt(T / 1e5))
    alpha_A = 4.309e-13 * (T / 1e4) ** (-0.6166) \
        / (1.0 + 0.6703 * (T / 1e4) ** 0.5300)
    xHI = alpha_A / (Gamma + alpha_A)
    xHI = np.where(T <= 1e3, 1.0, xHI)
    return np.clip(xHI, 0.0, 1.0)


def laursen09_ndust(nH, xHI, Z, Z_ref, f_ion):
    nHI = nH * xHI
    nHII = nH * (1.0 - xHI)
    return (Z / max(Z_ref, 1e-30)) * (nHI + f_ion * nHII)


def caseB_lya_emissivity(nH, T, xHI, ne):
    """Case B recombination + collisional Lya emissivity
    (physics_amr_mod.f90:76-116)."""
    T = np.maximum(T, 10.0)
    lam = 315614.0 / T
    alpha_B = 2.753e-14 * lam ** 1.5 / (1.0 + (lam / 2.74) ** 0.407) ** 2.242
    Ta = np.maximum(T, 100.0)
    P_B = 0.686 - 0.106 * np.log10(Ta / 1e4) - 0.009 * (Ta / 1e4) ** (-0.44)
    nHI = nH * xHI
    nHII = nH * (1.0 - xHI)
    q_coll = (6.58e-18 / T ** 0.185) * np.exp(-4.86e4 / T ** 0.895)
    return P_B * alpha_B * ne * nHII + nHI * ne * q_coll


@dataclasses.dataclass
class AmrBuildResult:
    meta: GridMeta
    tree: HostOctree
    dev: AmrDevice
    emissivity: Optional[np.ndarray] = None


def _part1by2(v):
    """Spread the low 21 bits of v so there are two zero bits between
    each (int64 bit-interleave helper)."""
    v = v.astype(np.int64) & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def morton_order(x, y, z, boxlen, origin, bits=20):
    """Permutation sorting leaves along a Morton (Z-order) curve.

    The transport kernel reads leaf physics with gathers
    (engine.make_fly_amr); Z-ordering makes spatially adjacent leaves
    index-adjacent so a ray's successive gathers hit nearby memory
    (SURVEY.md hard-part 4: 'layout leaves for locality, Morton order')."""
    ox, oy, oz = origin
    n = 1 << bits
    ix = np.clip(((x - ox) / boxlen * n).astype(np.int64), 0, n - 1)
    iy = np.clip(((y - oy) / boxlen * n).astype(np.int64), 0, n - 1)
    iz = np.clip(((z - oz) / boxlen * n).astype(np.int64), 0, n - 1)
    code = (_part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2))
    return np.argsort(code, kind='stable')


def build_amr(cfg: ResolvedConfig, data: Optional[dict] = None,
              device='cpu') -> AmrBuildResult:
    """Build the AMR grid on `device`; `data`, a leaf dict as
    read_generic_amr returns it, replaces reading par.amr_file."""
    par, line = cfg.par, cfg.line
    if data is None:
        if par.amr_type.strip().lower() == 'ramses':
            raise NotImplementedError("amr_type 'ramses' (the RAMSES "
                                      "snapshot reader) is not ported")
        data = read_generic_amr(par.amr_file)

    xl = np.asarray(data['x'], np.float64)
    yl = np.asarray(data['y'], np.float64)
    zl = np.asarray(data['z'], np.float64)
    lev = np.asarray(data['level'], np.int32)
    nH = np.asarray(data['nH'], np.float64)
    T = np.maximum(np.asarray(data['T'], np.float64), 10.0)
    vx = np.asarray(data.get('vx', np.zeros_like(nH)), np.float64)
    vy = np.asarray(data.get('vy', np.zeros_like(nH)), np.float64)
    vz = np.asarray(data.get('vz', np.zeros_like(nH)), np.float64)
    boxlen = float(data['boxlen'])
    ox, oy, oz = data.get('origin', (-boxlen / 2,) * 3)

    # Morton-order the leaves (file order is arbitrary; Z-order gives the
    # neighbor-gather walk spatial locality).  Every per-leaf array below
    # is permuted consistently, so leaf ids are simply renamed.
    if getattr(par, 'amr_morton_order', True):
        perm = morton_order(xl, yl, zl, boxlen, (ox, oy, oz))
        xl, yl, zl, lev = xl[perm], yl[perm], zl[perm], lev[perm]
        nH, T = nH[perm], T[perm]
        vx, vy, vz = vx[perm], vy[perm], vz[perm]
        data = dict(data)
        for k in ('xHI', 'n_ion', 'metallicity', 'ndust', 'emissivity',
                  'sfr'):
            if k in data and data[k] is not None \
                    and np.ndim(data[k]) == 1 and len(data[k]) == len(perm):
                data[k] = np.asarray(data[k])[perm]
    nleaf = len(xl)

    tree = build_octree(xl, yl, zl, lev,
                        [ox, ox + boxlen, oy, oy + boxlen, oz, oz + boxlen])

    distance2cm = par.distance2cm if par.distance2cm > 0 else 1.0

    vtherm = np.array([vtherm_total(par, line, t) for t in T]) \
        if par.bturb > 0 else line.vtherm1 * np.sqrt(T)
    Dfreq = vtherm / (line.wavelength0 * UM2KM)
    voigt_a = (line.damping / FOURPI) / Dfreq

    # --- neutral fraction (grid_mod_amr.f90:226-252)
    if 'xHI' in data:
        xHI = np.asarray(data['xHI'], np.float64)
    elif par.ionization_model == 'from_file':
        raise ValueError("ionization_model='from_file' requires an xHI "
                         "column in the AMR file")
    elif par.ionization_model == 'cie_table':
        xHI = cie_neutral_fraction_table(T)
    elif par.ionization_model == 'full_neutral':
        xHI = np.ones_like(T)
    else:  # 'cie_formula' path is gated by use_cie_condition
        xHI = cie_neutral_fraction_formula(T) if par.use_cie_condition \
            else np.ones_like(T)

    # --- scatterer density (ion model; grid_mod_amr.f90:255-276)
    if 'n_ion' in data:
        n_scat = np.asarray(data['n_ion'], np.float64)
    elif par.ion_model == 'solar_cie':
        from .ion_data import solar_ion_density
        Z = data.get('metallicity')
        Zv = np.asarray(Z, np.float64) if Z is not None else \
            np.full_like(T, max(par.metallicity_global, 0.0))
        n_scat = solar_ion_density(nH, Zv, T, line.ion_id)
    else:
        n_scat = nH * xHI
    rhokap = n_scat * line.cross0 / Dfreq * distance2cm

    # --- dust (grid_mod_amr.f90:278-300)
    rhokapD = None
    if 'ndust' in data:
        rhokapD = np.asarray(data['ndust'], np.float64) \
            * par.cext_dust * distance2cm
    elif par.dust_model == 'laursen09' and (
            'metallicity' in data or par.metallicity_global >= 0.0):
        Z = np.asarray(data['metallicity'], np.float64) \
            if 'metallicity' in data else \
            np.full_like(T, par.metallicity_global)
        rhokapD = laursen09_ndust(nH, xHI, Z, par.Z_ref, par.f_ion_dust) \
            * par.cext_dust * distance2cm
    elif par.DGR > 0.0:
        rhokapD = nH * par.cext_dust * par.DGR * distance2cm

    # --- emissivity (for diffuse_emissivity sources)
    emissivity = None
    if 'emissivity' in data:
        emissivity = np.asarray(data['emissivity'], np.float64)
    elif par.emissivity_model == 'from_file':
        raise ValueError("emissivity_model='from_file' requires an "
                         "emissivity column in the AMR file")
    elif par.emissivity_model == 'caseB':
        ne = np.asarray(data['n_e'], np.float64) if 'n_e' in data \
            else nH * (1.0 - xHI)
        emissivity = caseB_lya_emissivity(nH, T, xHI, ne)

    # --- biconical mask
    if 0.0 < par.cone_opening < 90.0:
        cosc = math.cos(math.radians(par.cone_opening))
        lc = tree.icell_of_leaf
        rr = np.sqrt(tree.cx[lc] ** 2 + tree.cy[lc] ** 2 + tree.cz[lc] ** 2)
        mask = (rr > 0) & (np.abs(tree.cz[lc]) / np.maximum(rr, 1e-300) < cosc)
        rhokap[mask] = 0.0
        if rhokapD is not None:
            rhokapD[mask] = 0.0

    # --- normalization via +z pole traversal from box center
    # (grid_mod_amr.f90:358-420); host-side serial walk on the octree
    H0 = _voigt0(voigt_a)
    sel = rhokap > 0
    nsel = max(sel.sum(), 1)
    opac_length = boxlen / 2.0
    tauhomo = (rhokap * H0)[sel].sum() / nsel * opac_length
    taupole, NHI_pole = _pole_traverse(tree, rhokap, H0, Dfreq, line.cross0)
    if taupole <= 0.0:
        taupole = tauhomo

    taumax_in = max(par.taumax, par.tau0)
    N_gasmax_in = max(par.N_gasmax, par.N_HImax, par.N_HI)
    N_gashomo_in = max(par.N_gashomo, par.N_HIhomo)
    if taumax_in > 0.0 and taupole > 0.0:
        norm = taumax_in / taupole
    elif par.tauhomo > 0.0 and tauhomo > 0.0:
        norm = par.tauhomo / tauhomo
    elif N_gasmax_in > 0.0 and NHI_pole > 0.0:
        norm = N_gasmax_in / NHI_pole
    elif N_gashomo_in > 0.0:
        NHI_homo = (rhokap * Dfreq)[sel].sum() / nsel / line.cross0 \
            * opac_length
        norm = N_gashomo_in / max(NHI_homo, 1e-300)
    else:
        norm = 1.0
    rhokap = rhokap * norm
    if rhokapD is not None:
        rhokapD = rhokapD * norm
    taupole *= norm
    tauhomo *= norm

    # --- box dims (grid_mod_amr.f90:186-200)
    geom = par.geometry.strip().lower()
    half = boxlen / 2.0
    if geom == 'sphere':
        par.rmax = half
    par.xmax, par.ymax, par.zmax = (tree.box[1], tree.box[3], tree.box[5])

    # --- analytic velocity-model override (assign_amr_velocities_from_type,
    # grid_mod_amr.f90:1134-1230): replaces file velocities per leaf
    vtype = par.velocity_type.strip().lower()
    if vtype:
        lc = tree.icell_of_leaf
        cxl = tree.cx[lc]
        cyl = tree.cy[lc]
        czl = tree.cz[lc]
        chl = tree.ch[lc]
        rr = np.sqrt(cxl ** 2 + cyl ** 2 + czl ** 2)
        rmax_eff = par.rmax if par.rmax > 0 else boxlen / 2.0
        # velocities here are in km/s; the device build divides by the
        # local vtherm below
        if vtype == 'hubble':
            vx = par.Vexp * cxl / rmax_eff
            vy = par.Vexp * cyl / rmax_eff
            vz = par.Vexp * czl / rmax_eff
        elif vtype == 'constant_radial':
            ok = rr > chl * 0.1
            with np.errstate(invalid='ignore', divide='ignore'):
                fac = np.where(ok, par.Vexp / np.maximum(rr, 1e-300), 0.0)
            vx, vy, vz = fac * cxl, fac * cyl, fac * czl
        elif vtype == 'parallel_velocity':
            vx = np.full(nleaf, par.Vx)
            vy = np.full(nleaf, par.Vy)
            vz = np.full(nleaf, par.Vz)
        elif vtype == 'ssh':
            inner = rr < par.rpeak
            with np.errstate(invalid='ignore', divide='ignore'):
                Vs = np.where(
                    inner, par.Vpeak / max(par.rpeak, 1e-300),
                    (par.Vpeak + par.DeltaV * (rr - par.rpeak)
                     / max(rmax_eff - par.rpeak, 1e-300))
                    / np.maximum(rr, 1e-300))
            vx, vy, vz = Vs * cxl, Vs * cyl, Vs * czl
        elif vtype in ('rotating_solid_body', 'rotating_galaxy_halo'):
            rr2 = np.sqrt(cxl ** 2 + cyl ** 2)
            if vtype == 'rotating_solid_body':
                denom = np.full(nleaf, rmax_eff)
            else:
                rin = max(par.rinner, 1e-300)
                denom = np.where(rr2 < par.rinner, rin,
                                 np.maximum(rr2, 1e-300))
            vx = -par.Vrot * cyl / denom
            vy = par.Vrot * cxl / denom
            vz = np.zeros(nleaf)
        else:
            raise ValueError(f'unknown velocity_type: {par.velocity_type!r}')

    uniform_T = bool(np.all(T == T[0])) and not par.bturb > 0
    static = bool(np.all(vx == 0) and np.all(vy == 0) and np.all(vz == 0))

    # the frequency grid of the Cartesian logic
    voigt_amean = cfg.voigt_a_ref
    atau3 = (voigt_amean * max(tauhomo, 1e-30)) ** (1.0 / 3.0)
    xfreq_min, xfreq_max, nxfreq = par.xfreq_min, par.xfreq_max, par.nxfreq
    if not (_fin(xfreq_min) and _fin(xfreq_max)):
        tm = taumax_in if taumax_in > 0 else taupole
        xscale = 25.0 if tm <= 5e1 else 14.0 if tm <= 5e2 else \
            10.0 if tm <= 5e3 else 5.0
        dnuHK = line.DnuHK_Hz / cfg.Dfreq_ref
        xfreq_max = math.floor(xscale * atau3) + 1
        xfreq_min = -(math.floor(xscale * atau3 + dnuHK) + 1)
    dxfreq = (xfreq_max - xfreq_min) / nxfreq
    dwave = cfg.vtherm / SPEEDC * (line.wavelength0 * 1e4) * dxfreq

    atau0 = voigt_amean * tauhomo
    if not par.core_skip_global:
        mean_h = float(np.mean(tree.ch[tree.icell_of_leaf]))
        atau0 = atau0 / max(half / max(mean_h, 1e-30), 1.0)
    if atau0 <= 1.0:
        xcrit = 0.0
    else:
        xi_, chi = (0.6, 1.2) if atau0 <= 60.0 else (1.4, 0.6)
        xcrit = 0.02 * math.exp(xi_ * (math.log(atau0)) ** chi)

    meta = GridMeta(
        nx=tree.ncells, ny=1, nz=1,
        dx=boxlen, dy=boxlen, dz=boxlen,
        xmin=tree.box[0], ymin=tree.box[2], zmin=tree.box[4],
        xmax=tree.box[1], ymax=tree.box[3], zmax=tree.box[5],
        i0=0, j0=0, k0=0, bc_x='escape', bc_y='escape', bc_z='escape',
        Dfreq_ref=cfg.Dfreq_ref, voigt_a_ref=cfg.voigt_a_ref,
        uniform_temperature=uniform_T, static_medium=static,
        has_dust=rhokapD is not None,
        nxfreq=nxfreq, xfreq_min=float(xfreq_min), xfreq_max=float(xfreq_max),
        dxfreq=float(dxfreq), dwave=float(dwave),
        xcrit=float(xcrit), xcrit2=float(xcrit * xcrit),
        taumax=float(taumax_in if taumax_in > 0 else taupole),
        tauhomo=float(tauhomo), taupole_dust=0.0, tauhomo_dust=0.0,
        N_gasmax=float(N_gasmax_in if N_gasmax_in > 0 else NHI_pole * norm),
        N_gashomo=float(N_gashomo_in if N_gashomo_in > 0 else 0.0),
        atau3=float(atau3),
        grid_type='amr', levelmax=tree.levelmax)

    dev = to_device(tree, rhokap, rhokapD,
                    None if uniform_T else Dfreq,
                    None if uniform_T else voigt_a,
                    None if static else vx / vtherm,
                    None if static else vy / vtherm,
                    None if static else vz / vtherm,
                    fine_limit=par.amr_fine_lookup_max, device=device)
    return AmrBuildResult(meta=meta, tree=tree, dev=dev,
                          emissivity=emissivity)


def _pole_traverse(tree: HostOctree, rhokap, H0, Dfreq, cross0):
    """Serial +z walk from the box center (grid_mod_amr.f90:381-420)."""
    x = 0.5 * (tree.box[0] + tree.box[1])
    y = 0.5 * (tree.box[2] + tree.box[3])
    z = 0.5 * (tree.box[4] + tree.box[5])
    zmax = tree.box[5]
    tau = 0.0
    NHI = 0.0
    for _ in range(10_000_000):
        if z >= zmax:
            break
        # descend to deepest enclosing cell
        ic = 0
        while True:
            if tree.ileaf[ic] >= 0:
                break
            io = (1 if x >= tree.cx[ic] else 0) \
                + (2 if y >= tree.cy[ic] else 0) \
                + (4 if z >= tree.cz[ic] else 0)
            c = tree.children[ic, io]
            if c < 0:
                break
            ic = c
        t_exit = tree.cz[ic] + tree.ch[ic] - z
        t_exit = max(t_exit, 1e-12 * (tree.box[5] - tree.box[4]))
        il = tree.ileaf[ic]
        if il >= 0:
            tau += rhokap[il] * H0[il] * t_exit
            NHI += rhokap[il] * Dfreq[il] / cross0 * t_exit
        z += t_exit
    return tau, NHI


def _fin(v):
    return v == v and abs(v) != math.inf


def make_amr_sphere(n_base=16, levels_extra=1, rmax=1.0, T=1e4, nH0=1.0,
                    refine_r=0.5):
    """Analytic AMR sphere generator for tests (the standalone
    make_amr_sphere_radial.x tool, reference src/make_amr_sphere_radial.f90):
    uniform base grid with one extra refinement level inside refine_r."""
    lev0 = int(round(math.log2(n_base)))
    boxlen = 2.0 * rmax
    xs = (np.arange(n_base) + 0.5) / n_base * boxlen - rmax
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing='ij')
    R = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    coarse = R.ravel() >= refine_r * rmax
    out_x = [X.ravel()[coarse]]
    out_y = [Y.ravel()[coarse]]
    out_z = [Z.ravel()[coarse]]
    out_l = [np.full(coarse.sum(), lev0, np.int32)]
    if levels_extra > 0:
        h = boxlen / n_base / 4.0
        for cx, cy, cz in zip(X.ravel()[~coarse], Y.ravel()[~coarse],
                              Z.ravel()[~coarse]):
            for io in range(8):
                out_x.append(np.array([cx + (h if io & 1 else -h)]))
                out_y.append(np.array([cy + (h if io & 2 else -h)]))
                out_z.append(np.array([cz + (h if io & 4 else -h)]))
                out_l.append(np.array([lev0 + 1], np.int32))
    xl = np.concatenate(out_x)
    yl = np.concatenate(out_y)
    zl = np.concatenate(out_z)
    ll = np.concatenate(out_l)
    rr = np.sqrt(xl ** 2 + yl ** 2 + zl ** 2)
    nH = np.where(rr <= rmax, nH0, 0.0)
    return {
        'x': xl, 'y': yl, 'z': zl, 'level': ll, 'nH': nH,
        'T': np.full_like(nH, T),
        'vx': np.zeros_like(nH), 'vy': np.zeros_like(nH),
        'vz': np.zeros_like(nH),
        'boxlen': boxlen, 'origin': (-rmax, -rmax, -rmax),
    }
