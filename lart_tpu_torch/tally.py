"""Tally normalization and result container for the ported path.

Port of RunResult / spectral_axes / normalize (lart_tpu/tally.py:22-259),
which cannot be imported here: lart_tpu/tally.py imports the grid module,
which imports jax.  Only the outputs of the ported path are carried: the
spectra Jin/Jout/Jabs, Jmu, the scattering counts, the weight budget, the
peel-off cubes (scattered, direct, Stokes I/Q/U/V, H-alpha), line type 8's
H-alpha spectra, band budgets and two-photon spectrum, and H2 pumping's
per-photon weights, an exoplanet atmosphere's Jabs2, an
illumination's flux factor, and the CALCJ/CALCP/CALCPnew maps J1, Pa and
Pnew over each bin's cells with their bin centres r_JPa (lart_tpu/tally.py:
99-122, :211-230), and the all-photons table of save_all_photons, its
columns as the driver copied them (lart_tpu/tally.py:68, :244).  The
arithmetic is lart_tpu's, on host float64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .config import ResolvedConfig
from .constants import FOURPI, SPEEDC, TWOPI
from .grid.cartesian import GridMeta


@dataclasses.dataclass
class RunResult:
    cfg: ResolvedConfig
    meta: GridMeta
    nphotons: int
    xfreq: np.ndarray
    velocity: np.ndarray
    wavelength: np.ndarray
    Jin: Optional[np.ndarray]
    Jout: np.ndarray
    Jabs: Optional[np.ndarray]
    nscatt_gas: float          # mean scattered weight per photon
    nscatt_dust: float
    nscatt_tot: float
    exetime_s: float = 0.0
    nscatt_events: float = 0.0  # unweighted resonance scatterings per photon
    W_oor: float = 0.0          # escaped weight outside the xfreq grid
    Jmu: Optional[np.ndarray] = None       # (nxfreq, nmu)
    # raw escaped / absorbed weight per launched photon (conservation)
    W_escape: float = 0.0
    W_absorb: float = 0.0
    # peel cubes: name -> (nobs, nxfreq, nxim, nyim), normalized
    peel: Optional[dict] = None
    obs_meta: object = None      # instruments.observer.ObserverSetMeta
    # per observer {'tau_gas', 'N_gas', 'tau_dust'} (save_sightline_tau)
    sightline: Optional[list] = None
    # H2 pumping, per photon (0 and None without it)
    W_H2abs: float = 0.0
    W_H2scat: float = 0.0
    W_H2pump: Optional[np.ndarray] = None
    # line type 8: the H-alpha band's spectra, the analytic two-photon
    # spectrum of the 2s decays, and the band budgets per photon
    Jout_Ha: Optional[np.ndarray] = None
    Jabs_Ha: Optional[np.ndarray] = None
    J2gam: Optional[np.ndarray] = None
    y_2gam: Optional[np.ndarray] = None
    W_conv: float = 0.0
    W_esc1: float = 0.0
    W_abs1: float = 0.0
    W_esc2: float = 0.0
    W_abs2: float = 0.0
    # an exoplanet atmosphere's destroyed weight (normalized like Jout),
    # an illumination's flux factor sum / (nphotons + nrejected) and its
    # rejected draws
    Jabs2: Optional[np.ndarray] = None
    flux_factor: float = 0.0
    nrejected: float = 0.0
    # CALCJ/CALCP/CALCPnew: the mean intensity (nxfreq, nbin), the
    # scatterings per atom and their path-length estimate (nbin), and the
    # bins' centres (z, radius or flat cell index)
    J1: Optional[np.ndarray] = None
    Pa: Optional[np.ndarray] = None
    Pnew: Optional[np.ndarray] = None
    r_JPa: Optional[np.ndarray] = None
    # save_all_photons: {column: (nphotons,) f64} (transport/allph.py FIELDS)
    allph: Optional[dict] = None
    nprocs: int = 1              # the ranks of the run (the file's Nprocs)

    @property
    def line(self):
        return self.cfg.line


def twophoton_dAdy(y):
    """Nussbaumer & Schmutz (1984) two-photon decay spectrum fit
    (twophoton_dAdy, line_mod.f90:1274-1294)."""
    y = np.asarray(y, np.float64)
    w = y * (1.0 - y)
    out = np.zeros_like(w)
    pos = w > 0
    w4 = (4.0 * w[pos]) ** 0.8
    out[pos] = 202.0 * (w[pos] * (1.0 - w4)
                        + 0.88 * w[pos] ** 1.53 * w4)
    return out


def _jpa_counts(meta: GridMeta):
    """Cells per CALCJ/P bin + bin-center coordinates (ncount_sph/
    ncount_plane, grid_mod_car.f90:1300-1440) of a grid that bins them."""
    g = meta.geometry_JPa
    if g == -1:
        z = meta.zmin + (np.arange(meta.nz) + 0.5) * meta.dz
        return np.full(meta.nz, meta.nx * meta.ny, np.float64), z
    if g == 1:
        xs = meta.xmin + (np.arange(meta.nx) + 0.5) * meta.dx
        ys = meta.ymin + (np.arange(meta.ny) + 0.5) * meta.dy
        zs = meta.zmin + (np.arange(meta.nz) + 0.5) * meta.dz
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing='ij')
        rr = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
        ib = np.floor((rr - meta.roff_JPa) / meta.dr_JPa).astype(int)
        sel = (ib >= 0) & (ib < meta.nbin_JPa)
        ncount = np.bincount(ib[sel], minlength=meta.nbin_JPa
                             ).astype(np.float64)[:meta.nbin_JPa]
        r = meta.roff_JPa + (np.arange(meta.nbin_JPa) + 0.5) * meta.dr_JPa
        return ncount, r
    return np.ones(meta.nbin_JPa, np.float64), \
        np.arange(meta.nbin_JPa, dtype=np.float64)


def jpa_maps(cfg: ResolvedConfig, meta: GridMeta, raw: dict,
             nphotons: int):
    """(J1, Pa, Pnew, r_JPa) normalized (output_sum_rect.f90:300-345):
    over the cell volume, the cells of each bin and the photons; a slab
    (xy_periodic) per its xy area; None where a map is not in raw."""
    par = cfg.par
    if not meta.nbin_JPa or not any(k in raw for k in ('J1', 'Pa', 'Pnew')):
        return None, None, None, None
    bin_unit = meta.dwave if par.intensity_unit == 1 else meta.dxfreq
    distance2cm = par.distance2cm if par.distance2cm > 0.0 else 1.0
    dVol = meta.dx * meta.dy * meta.dz * distance2cm ** 2
    ncount, r_JPa = _jpa_counts(meta)
    if par.xy_periodic:
        areaJ = (meta.xmax - meta.xmin) * (meta.ymax - meta.ymin) \
            * distance2cm ** 2
        facJ = areaJ / (FOURPI * dVol * nphotons * bin_unit)
        facP = areaJ / (dVol * nphotons)
    else:
        facJ = 1.0 / (FOURPI * dVol * nphotons * bin_unit)
        facP = 1.0 / (dVol * nphotons)
    nc = np.maximum(ncount, 1)
    J1 = raw['J1'].reshape(meta.nxfreq, meta.nbin_JPa) / nc * facJ \
        if 'J1' in raw else None
    Pa = raw['Pa'] / nc * facP if 'Pa' in raw else None
    Pnew = raw['Pnew'] / nc * facP if 'Pnew' in raw else None
    return J1, Pa, Pnew, r_JPa


# numpy 2 renamed trapz
_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def spectral_axes(cfg: ResolvedConfig, meta: GridMeta):
    """Bin-center axes (car_setup_freq_grid, grid_mod_car.f90:1505-1512)."""
    i = np.arange(meta.nxfreq)
    xfreq = (i + 0.5) * meta.dxfreq + meta.xfreq_min
    velocity = -cfg.vtherm * xfreq
    wavelength = (velocity / SPEEDC + 1.0) * (cfg.line.wavelength0 * 1e4)
    return xfreq, velocity, wavelength


def spectrum_denom(cfg, meta, nphotons) -> float:
    """What normalize divides the spectra Jin, Jout and Jabs by: the
    photons times the bin width times the emitting area and 2 pi sr."""
    par = cfg.par
    bin_unit = meta.dwave if par.intensity_unit == 1 else meta.dxfreq
    distance2cm = par.distance2cm if par.distance2cm > 0.0 else 1.0
    if par.xy_periodic:
        # slab: unit luminosity spread over 2 faces x 2pi sr
        return nphotons * bin_unit * TWOPI * 2.0
    if par.geometry.strip().lower() == 'sphere':
        area = FOURPI * par.rmax ** 2 * distance2cm ** 2
    else:
        area = (meta.xmax * meta.ymax + meta.ymax * meta.zmax
                + meta.zmax * meta.xmax) * 8.0 * distance2cm ** 2
    return nphotons * bin_unit * TWOPI * area


def normalize(cfg: ResolvedConfig, meta: GridMeta, raw: dict,
              nphotons: int, exetime_s: float = 0.0,
              obs_meta=None) -> RunResult:
    """raw: dict with f64 arrays Jin/Jout/Jabs (and Jmu, the flat peel
    cubes peel_scatt, peel_direc, peel_I, ..., line type 8's Jout_Ha and
    Jabs_Ha, H2's W_H2pump) and scalars nscatt_gas/nscatt_dust/
    nscatt_events/W_oor (and W_conv, W_esc1, ..., W_H2abs, W_H2scat)."""
    par = cfg.par
    xfreq, velocity, wavelength = spectral_axes(cfg, meta)

    bin_unit = meta.dwave if par.intensity_unit == 1 else meta.dxfreq
    distance2cm = par.distance2cm if par.distance2cm > 0.0 else 1.0
    denom = spectrum_denom(cfg, meta, nphotons)
    Jout = raw['Jout'] / denom
    Jin = raw.get('Jin')
    Jin = Jin / denom if Jin is not None else None
    Jabs = raw.get('Jabs')
    Jabs = Jabs / denom if (Jabs is not None and par.DGR > 0.0
                            and par.save_Jabs) else None
    Jabs2 = raw['Jabs2'] / denom if 'Jabs2' in raw else None
    flux_factor = 0.0
    if 'flux_factor' in raw:
        # the transit flux factor, sum(flux_factor) / (nphotons +
        # nrejected) (output_sum_rect.f90:17-18)
        flux_factor = raw['flux_factor'] / (nphotons
                                            + raw.get('nrejected', 0.0))

    if (par.spectral_type.strip() in ('continuum', 'continuum+gaussian')
            and par.continuum_normalize and Jin is not None):
        scale = Jin.mean() * (1.0 - par.f_line) if 0.0 < par.f_line < 1.0 \
            else Jin.mean()
        if scale > 0:
            Jout = Jout / scale
            Jin = Jin / scale
            if Jabs is not None:
                Jabs = Jabs / scale

    # peel-off cube normalization (output_sum_rect.f90:427-450):
    # scale = nphotons * steradian_pix * bin_unit * distance2cm^2
    peel = None
    if obs_meta is not None and 'peel_scatt' in raw:
        shape = (obs_meta.nobs, meta.nxfreq, obs_meta.nxim, obs_meta.nyim)
        scale = (nphotons * obs_meta.steradian_pix * bin_unit
                 * distance2cm ** 2)
        peel = {k[5:]: raw[k].reshape(shape) / scale
                for k in raw if k.startswith('peel_')}

    # Jmu: each mu bin normalized to equal Jout for a homogeneous isotropic
    # field (output_sum_rect.f90:188-190)
    Jmu = None
    if 'Jmu' in raw:
        Jmu = raw['Jmu'].reshape(meta.nxfreq, par.nmu) * par.nmu / denom

    # ly_beta's analytic two-photon spectrum (write_output_rect.f90:84-111):
    # J2gam(y) = 2 * W_conv_per_photon * P(y), the Nussbaumer & Schmutz fit
    J2gam = y_2gam = None
    if 'W_conv' in raw and par.ny_2gam > 0:
        y_2gam = (np.arange(par.ny_2gam) + 0.5) / par.ny_2gam
        yy = np.linspace(0.0, 1.0, 10001)
        A = _trapezoid(twophoton_dAdy(yy), yy)
        J2gam = 2.0 * (raw['W_conv'] / nphotons) \
            * twophoton_dAdy(y_2gam) / A

    J1, Pa, Pnew, r_JPa = jpa_maps(cfg, meta, raw, nphotons)
    return RunResult(
        cfg=cfg, meta=meta, nphotons=nphotons,
        xfreq=xfreq, velocity=velocity, wavelength=wavelength,
        Jin=Jin, Jout=Jout, Jabs=Jabs,
        nscatt_gas=raw['nscatt_gas'] / nphotons,
        nscatt_dust=raw['nscatt_dust'] / nphotons,
        nscatt_tot=(raw['nscatt_gas'] + raw['nscatt_dust']) / nphotons,
        nscatt_events=raw.get('nscatt_events', 0.0) / nphotons,
        W_oor=raw.get('W_oor', 0.0) / nphotons,
        exetime_s=exetime_s, Jmu=Jmu, peel=peel, obs_meta=obs_meta,
        Jout_Ha=raw['Jout_Ha'] / denom if 'Jout_Ha' in raw else None,
        Jabs_Ha=raw['Jabs_Ha'] / denom if 'Jabs_Ha' in raw else None,
        J2gam=J2gam, y_2gam=y_2gam,
        Jabs2=Jabs2, flux_factor=flux_factor,
        nrejected=raw.get('nrejected', 0.0),
        J1=J1, Pa=Pa, Pnew=Pnew, r_JPa=r_JPa, allph=raw.get('allph'),
        W_H2pump=raw['W_H2pump'] / nphotons if 'W_H2pump' in raw else None,
        **{k: raw.get(k, 0.0) / nphotons for k in (
            'W_conv', 'W_esc1', 'W_abs1', 'W_esc2', 'W_abs2', 'W_H2abs',
            'W_H2scat')},
        W_escape=float(np.sum(raw['Jout'])) / nphotons,
        W_absorb=float(np.sum(raw.get('Jabs', 0.0))) / nphotons)
