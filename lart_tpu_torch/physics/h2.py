"""Molecular-hydrogen (H2) pumping of Lyman-alpha: the Neufeld (1990)
two-line B-X treatment, R(6) at +14.1 km/s and P(5) at +99.2 km/s from
line centre.

Port of lart_tpu/physics/h2.py (H2Setup, read_energy_X, h2_init, :40-107;
h2_kappa and h2_line_weights, :109-133) and of engine.h2_setup
(lart_tpu/transport/engine.py:613-618), which this package cannot import.
The line table is built on the host in f64 from the CLOUDY X-state
energies (lart_tpu/data/h2/energy_X.dat, read as data where lart_tpu
bundles it, as physics/mueller.py reads the Mueller tables): LTE level
populations, each line's oscillator strength relative to Ly-alpha's, its
Voigt damping in H2 Doppler units, and its chance p_scat = A_ul / A_tot
of scattering back to Ly-alpha (else the photon is destroyed).

`H2Consts` holds the table as lart_tpu's weak types round it: each f64
value rounded once to f32.  The opacity is a multiplier of the local H I
rhokap: with ratio = D / Dfreq_H2 (1 with h2_hi_width), line i adds
strength_i ratio H((x - dnu_i / D) ratio, a_i); D, Dfreq_H2, dnu_i / D and
the ratio are f32 divisions, as lart_tpu takes them with the cell's
Doppler width a 0-d f32 array.  csrc/h2.cuh is the same data (struct H2C)
and the same device functions, inlined where the kernels take the opacity
(K4, K5, K7).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os
from typing import Optional, Tuple

import torch

from ..constants import PI, SPEEDC, UM2M
from .line import div32, f32, mul32
from .voigt import voigt_plain

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                        '..', 'lart_tpu', 'data', 'h2')

F_OSC_LYA = 0.4162
HC_OVER_K = 1.4387769          # [cm K]
F_OSC_CONST = 1.4992e-16       # f = const * (gu/gl) * lambda_A^2 * A_ul
N_LINES = 2

# the Neufeld two-line table (h2_mod.f90:144-155): CLOUDY energies,
# Abgrall+00 A-values
_LINES = (
    dict(dv_kms=14.140, vl=2, Jl=6, Ju=7, lambda_A=1215.72534,
         A_ul=1.36e8, A_tot_up=1.6825e9),
    dict(dv_kms=99.229, vl=2, Jl=5, Ju=4, lambda_A=1216.07038,
         A_ul=1.59e8, A_tot_up=1.7199e9),
)


@dataclasses.dataclass(frozen=True)
class H2Setup:
    """The line table in f64 (lart_tpu's H2Setup)."""
    n_lines: int
    Dfreq_Hz: float                    # H2 Doppler width
    dnu_Hz: Tuple[float, ...]          # nu_line - nu_Lya
    strength: Tuple[float, ...]        # s_i relative to H I line centre
    a_damp: Tuple[float, ...]          # Voigt a in H2 Doppler units
    p_scat: Tuple[float, ...]          # return-to-Lya probability
    hi_width: bool                     # benchmark flag: use the H I width


def read_energy_X(path: Optional[str] = None):
    """(v, J, E [cm^-1]) rows of the X-state energy table."""
    path = path or os.path.join(DATA_DIR, 'energy_X.dat')
    rows = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith('#') or '//' in ln:
                continue
            parts = ln.split()
            if len(parts) < 3:
                continue
            try:
                rows.append((int(float(parts[0])), int(float(parts[1])),
                             float(parts[2])))
            except ValueError:
                continue
    return rows


def h2_init(par, line, data_dir: Optional[str] = None) -> H2Setup:
    """The static H2 line table (h2_init, h2_mod.f90:118-210)."""
    nu_Lya = (SPEEDC * 1e5) / (line.wavelength0 * UM2M * 1e2)   # [Hz]
    vth1_H2 = line.vtherm1 * math.sqrt(line.mass_amu / (2.0 * line.mass_amu))
    T = par.h2_temperature
    b2 = par.bturb ** 2 if par.bturb > 0 else 0.0
    vth_H2 = math.sqrt((vth1_H2 * math.sqrt(T)) ** 2 + b2)
    Dfreq_Hz = nu_Lya * vth_H2 / SPEEDC

    levels = read_energy_X(os.path.join(data_dir, 'energy_X.dat')
                           if data_dir else None)
    Z = sum((3.0 if J % 2 else 1.0) * (2 * J + 1)
            * math.exp(-HC_OVER_K * E / T) for v, J, E in levels)

    def level_E(v, J):
        for vv, JJ, E in levels:
            if vv == v and JJ == J:
                return E
        raise KeyError((v, J))

    dnu, strength, a_damp, p_scat = [], [], [], []
    for ln in _LINES:
        dnu.append(-(ln['dv_kms'] / SPEEDC) * nu_Lya)
        f_osc = (F_OSC_CONST * (2 * ln['Ju'] + 1) / (2 * ln['Jl'] + 1)
                 * ln['lambda_A'] ** 2 * ln['A_ul'])
        E = level_E(ln['vl'], ln['Jl'])
        gns = 3.0 if ln['Jl'] % 2 else 1.0
        pop = gns * (2 * ln['Jl'] + 1) * math.exp(-HC_OVER_K * E / T) / Z
        strength.append(par.f_H2 * pop * f_osc / F_OSC_LYA)
        a_damp.append(ln['A_tot_up'] / (4.0 * PI * Dfreq_Hz))
        p_scat.append(0.0 if par.h2_pure_absorption
                      else ln['A_ul'] / ln['A_tot_up'])

    return H2Setup(n_lines=len(_LINES), Dfreq_Hz=Dfreq_Hz,
                   dnu_Hz=tuple(dnu), strength=tuple(strength),
                   a_damp=tuple(a_damp), p_scat=tuple(p_scat),
                   hi_width=par.h2_hi_width)


def h2_on(par) -> bool:
    """H2 pumping is on: any h2_model but '' and 'none'."""
    return par.h2_model.strip().lower() not in ('', 'none')


def h2_setup(cfg) -> Optional[H2Setup]:
    """engine.h2_setup: the table of a config with H2 on, else None."""
    if not h2_on(cfg.par):
        return None
    return h2_init(cfg.par, cfg.line, cfg.par.h2_data_dir.strip() or None)


_I, _F = ctypes.c_int, ctypes.c_float


class H2C(ctypes.Structure):
    """csrc/h2.cuh struct H2C, field for field."""
    _fields_ = [('n_lines', _I), ('hi_width', _I), ('Dfreq', _F),
                ('dnu', _F * N_LINES),
                ('strength', _F * N_LINES), ('a_damp', _F * N_LINES),
                ('p_scat', _F * N_LINES)]


@dataclasses.dataclass(frozen=True)
class H2Consts:
    """The table rounded to f32, as lart_tpu's weak types round it."""
    hi_width: bool
    Dfreq: float
    dnu: Tuple[float, ...]
    strength: Tuple[float, ...]
    a_damp: Tuple[float, ...]
    p_scat: Tuple[float, ...]

    @classmethod
    def from_setup(cls, h: H2Setup) -> 'H2Consts':
        assert h.n_lines == N_LINES, h.n_lines
        return cls(hi_width=bool(h.hi_width), Dfreq=f32(h.Dfreq_Hz),
                   dnu=tuple(map(f32, h.dnu_Hz)),
                   strength=tuple(map(f32, h.strength)),
                   a_damp=tuple(map(f32, h.a_damp)),
                   p_scat=tuple(map(f32, h.p_scat)))

    @classmethod
    def from_config(cls, cfg) -> Optional['H2Consts']:
        h = h2_setup(cfg)
        return None if h is None else cls.from_setup(h)

    @functools.cached_property
    def c_struct(self) -> H2C:
        c = H2C()
        c.n_lines, c.hi_width = N_LINES, int(self.hi_width)
        c.Dfreq = self.Dfreq
        for f in ('dnu', 'strength', 'a_damp', 'p_scat'):
            getattr(c, f)[:] = getattr(self, f)
        return c


def h2_ratio(h: H2Consts, D: float) -> float:
    """D / Dfreq_H2 in f32, or 1 with h2_hi_width."""
    return 1.0 if h.hi_width else div32(D, h.Dfreq)


def h2_line_weights_plain(h: H2Consts, x: torch.Tensor, D: float):
    """Each line's opacity as a multiplier of rhokap at the comoving
    frequencies x and Doppler width D (h2_line_weights, :123): a list of
    N_LINES tensors."""
    ratio = h2_ratio(h, D)
    out = []
    for i in range(N_LINES):
        x_h2 = (x - div32(h.dnu[i], D)) * ratio
        out.append(mul32(h.strength[i], ratio)
                   * voigt_plain(x_h2, h.a_damp[i]))
    return out


def h2_kappa_plain(h: H2Consts, x: torch.Tensor, D: float) -> torch.Tensor:
    """The H2 opacity as a multiplier of rhokap (h2_kappa, :109)."""
    w = h2_line_weights_plain(h, x, D)
    return w[0] + w[1]
