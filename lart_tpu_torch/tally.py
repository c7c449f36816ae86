"""Tally normalization and result container for the ported path.

Port of RunResult / spectral_axes / normalize (lart_tpu/tally.py:22-259),
which cannot be imported here: lart_tpu/tally.py imports the grid module,
which imports jax.  Only the outputs of the ported path are carried: the
spectra Jin/Jout/Jabs, Jmu, the scattering counts and the weight budget.
Peel cubes, CALCJ/P maps, the ly_beta and H2 sections come with their
features.  The arithmetic is lart_tpu's, on host float64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lart_tpu.config import ResolvedConfig
from lart_tpu.constants import FOURPI, SPEEDC, TWOPI

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

    @property
    def line(self):
        return self.cfg.line


def spectral_axes(cfg: ResolvedConfig, meta: GridMeta):
    """Bin-center axes (car_setup_freq_grid, grid_mod_car.f90:1505-1512)."""
    i = np.arange(meta.nxfreq)
    xfreq = (i + 0.5) * meta.dxfreq + meta.xfreq_min
    velocity = -cfg.vtherm * xfreq
    wavelength = (velocity / SPEEDC + 1.0) * (cfg.line.wavelength0 * 1e4)
    return xfreq, velocity, wavelength


def normalize(cfg: ResolvedConfig, meta: GridMeta, raw: dict,
              nphotons: int, exetime_s: float = 0.0) -> RunResult:
    """raw: dict with f64 arrays Jin/Jout/Jabs (and Jmu) and scalars
    nscatt_gas/nscatt_dust/nscatt_events/W_oor."""
    par = cfg.par
    xfreq, velocity, wavelength = spectral_axes(cfg, meta)

    bin_unit = meta.dwave if par.intensity_unit == 1 else meta.dxfreq
    distance2cm = par.distance2cm if par.distance2cm > 0.0 else 1.0

    if par.xy_periodic:
        # slab: unit luminosity spread over 2 faces x 2pi sr
        denom = nphotons * bin_unit * TWOPI * 2.0
    else:
        if par.geometry.strip().lower() == 'sphere':
            area = FOURPI * par.rmax ** 2 * distance2cm ** 2
        else:
            area = (meta.xmax * meta.ymax + meta.ymax * meta.zmax
                    + meta.zmax * meta.xmax) * 8.0 * distance2cm ** 2
        denom = nphotons * bin_unit * TWOPI * area

    Jout = raw['Jout'] / denom
    Jin = raw.get('Jin')
    Jin = Jin / denom if Jin is not None else None
    Jabs = raw.get('Jabs')
    Jabs = Jabs / denom if (Jabs is not None and par.DGR > 0.0
                            and par.save_Jabs) else None

    if (par.spectral_type.strip() in ('continuum', 'continuum+gaussian')
            and par.continuum_normalize and Jin is not None):
        scale = Jin.mean() * (1.0 - par.f_line) if 0.0 < par.f_line < 1.0 \
            else Jin.mean()
        if scale > 0:
            Jout = Jout / scale
            Jin = Jin / scale
            if Jabs is not None:
                Jabs = Jabs / scale

    # Jmu: each mu bin normalized to equal Jout for a homogeneous isotropic
    # field (output_sum_rect.f90:188-190)
    Jmu = None
    if 'Jmu' in raw:
        Jmu = raw['Jmu'].reshape(meta.nxfreq, par.nmu) * par.nmu / denom

    return RunResult(
        cfg=cfg, meta=meta, nphotons=nphotons,
        xfreq=xfreq, velocity=velocity, wavelength=wavelength,
        Jin=Jin, Jout=Jout, Jabs=Jabs,
        nscatt_gas=raw['nscatt_gas'] / nphotons,
        nscatt_dust=raw['nscatt_dust'] / nphotons,
        nscatt_tot=(raw['nscatt_gas'] + raw['nscatt_dust']) / nphotons,
        nscatt_events=raw.get('nscatt_events', 0.0) / nphotons,
        W_oor=raw.get('W_oor', 0.0) / nphotons,
        exetime_s=exetime_s, Jmu=Jmu,
        W_escape=float(np.sum(raw['Jout'])) / nphotons,
        W_absorb=float(np.sum(raw.get('Jabs', 0.0))) / nphotons)
