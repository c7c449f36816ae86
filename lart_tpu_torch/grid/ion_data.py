"""Solar abundances + CIE ion fractions for metal-ion AMR grids.

Provides the ``ion_model='solar_cie'`` scatterer-density model
(reference: src/ion_data_mod.f90:64-200): per-leaf ion number density

    n_ion = nH * (Z / Z_sun) * (n_X/n_H)_sun * f_ion(T)

with Asplund et al. (2009, ARA&A 47, 481) solar number abundances and
collisional-ionization-equilibrium ion fractions approximated as Gaussian
fits in log10(T) to the Gnat & Sternberg (2007, ApJS 168, 213) tables.
Hydrogen and helium skip the metallicity scaling; hydrogen uses the full
CIE rate equation (same one as physics_amr_mod / cie_neutral_fraction_formula).

All functions are vectorized over NumPy arrays of (nH, Z, T).

The port's copy of lart_tpu/grid/ion_data.py (numpy only, the same
body), so that lart_tpu_torch imports nothing of lart_tpu.
"""

from __future__ import annotations

import numpy as np

# Solar metallicity (Asplund+09)
Z_SUN = 0.0134

# Solar number abundances n_X/n_H, linear: 10**(A(X) - 12)
# (Asplund+09 Table 1 photospheric values)
_ABUNDANCE = {
    'H': 1.0,          # by definition
    'He': 8.511e-2,    # A = 10.93
    'C': 2.692e-4,     # A = 8.43
    'N': 6.761e-5,     # A = 7.83
    'O': 4.898e-4,     # A = 8.69
    'Na': 1.738e-6,    # A = 6.24
    'Mg': 3.981e-5,    # A = 7.60
    'Al': 2.818e-6,    # A = 6.45
    'Si': 3.236e-5,    # A = 7.51
    'Ca': 2.188e-6,    # A = 6.34
    'Fe': 3.162e-5,    # A = 7.50
}

# CIE ion-fraction Gaussian fits: ion_id -> (log10 T_peak, f_peak, sigma).
# Approximations to the Gnat & Sternberg (2007) CIE tables, accurate to
# ~10% near the peak (reference: src/ion_data_mod.f90:113-157).
_CIE_FIT = {
    'He I':  (4.25, 0.95, 0.25),
    'C II':  (4.35, 0.70, 0.22),
    'C IV':  (5.05, 0.29, 0.20),
    'N V':   (5.25, 0.23, 0.18),
    'O VI':  (5.45, 0.20, 0.18),
    'Na I':  (3.60, 0.90, 0.20),
    'Ca II': (4.10, 0.65, 0.25),
    'Mg II': (4.35, 0.70, 0.22),
    'Si IV': (4.85, 0.35, 0.22),
    'Si II': (4.30, 0.70, 0.20),
    'Al II': (4.20, 0.75, 0.22),
    'Fe II': (4.35, 0.70, 0.22),
}

# ion_id -> element symbol for the abundance lookup
_ELEMENT_OF_ION = {
    'H I': 'H', 'H  I': 'H', 'H+D': 'H',
    'He I': 'He',
    'C II': 'C', 'C IV': 'C',
    'N V': 'N',
    'O VI': 'O',
    'Na I': 'Na',
    'Mg II': 'Mg',
    'Al II': 'Al',
    'Si II': 'Si', 'Si IV': 'Si',
    'Ca II': 'Ca',
    'Fe II': 'Fe',
}


def _norm(ion_id: str) -> str:
    return ' '.join(ion_id.split())


def solar_abundance(ion_id: str) -> float:
    """Solar number abundance n_X/n_H for the element of `ion_id`."""
    elem = _ELEMENT_OF_ION.get(_norm(ion_id))
    if elem is None:
        return 0.0
    return _ABUNDANCE[elem]


def cie_xHI(T):
    """CIE hydrogen neutral fraction from the rate equation
    (reference: src/ion_data_mod.f90:200-209)."""
    T4 = np.maximum(np.asarray(T, np.float64), 10.0) / 1e4
    k_ion = 5.84862e-9 * np.sqrt(T4) * np.exp(-15.78215 / T4)
    k_rec = 4.13e-13 * T4 ** (-0.7131 - 0.0115 * np.log(T4))
    return k_rec / (k_ion + k_rec)


def cie_ion_fraction(ion_id: str, T):
    """CIE ion fraction f_ion(T); vectorized over T [K]."""
    key = _norm(ion_id)
    if key in ('H I', 'H+D'):
        return cie_xHI(T)
    fit = _CIE_FIT.get(key)
    if fit is None:
        return np.zeros_like(np.asarray(T, np.float64))
    logT_peak, f_peak, sigma = fit
    logT = np.log10(np.maximum(np.asarray(T, np.float64), 10.0))
    f = f_peak * np.exp(-0.5 * ((logT - logT_peak) / sigma) ** 2)
    return np.clip(f, 0.0, 1.0)


def solar_ion_density(nH, Z, T, ion_id: str):
    """Per-cell ion number density for ion_model='solar_cie'.

    Hydrogen: nH * xHI(T) (no metallicity scaling).
    Helium:   nH * A_He * f_HeI(T) (no metallicity scaling).
    Metals:   nH * (Z/Z_sun) * A_X * f_ion(T).
    Reference: src/ion_data_mod.f90:171-193.
    """
    nH = np.asarray(nH, np.float64)
    key = _norm(ion_id)
    if key in ('H I', 'H+D'):
        return nH * cie_xHI(T)
    if key == 'He I':
        return nH * _ABUNDANCE['He'] * cie_ion_fraction(key, T)
    A_X = solar_abundance(key)
    f = cie_ion_fraction(key, T)
    return nH * (np.asarray(Z, np.float64) / Z_SUN) * A_X * f
