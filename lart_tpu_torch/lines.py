"""Resonance-line atomic data catalog.

Atomic data (NIST vacuum wavelengths, oscillator strengths, Einstein A
coefficients, fine-structure splittings, and the Rayleigh/isotropic phase
weights E1/E2/E3 per branch) for every line supported by the reference
implementation (reference: src/line_mod.f90:551-1270).  Values are physical
facts from physics.nist.gov; they must match the reference so spectra agree.

Line types
----------
1 : singlet (one resonance)
2 : doublet (two upward transitions; H/K fine structure)
4 : one upward transition + >=1 downward branches (resonance + fluorescence)
5 : two upward transitions, each with multiple downward branches (FeII UV1/2)
6 : three upward transitions + one downward each (HeI 10833 triplet)
7 : H + D Lyman-alpha (two coexisting two-level scatterers)
8 : H I Lyman-beta with 3p->2s fluorescent conversion (H-alpha band 2)

The port's own copy of lart_tpu/lines.py, which has no jax in it:
lart_tpu_torch imports nothing of lart_tpu.  Keep the two in step;
tests/test_torch_config.py compares the resolved lines field for field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from .constants import (AMU, H_PLANCK, SIGMA_0, SPEEDC_CM, SQRTPI, UM2M,
                        VTHERM1_AMU)


@dataclasses.dataclass(frozen=True)
class Branch:
    """Downward branches of one upward level.

    A21      : Einstein A per downward channel [1/s]
    Elow_cm  : lower-level energy above ground [cm^-1] (0 = resonance channel)
    E1,E2,E3 : per-channel phase weights (Rayleigh fraction etc.)
    """
    A21: Tuple[float, ...]
    Elow_cm: Tuple[float, ...]
    E1: Tuple[float, ...]
    E2: Tuple[float, ...]
    E3: Tuple[float, ...]

    @property
    def ndown(self) -> int:
        return len(self.A21)

    @property
    def damping(self) -> float:
        return sum(self.A21)

    @property
    def Elow_Hz(self) -> Tuple[float, ...]:
        return tuple(e * SPEEDC_CM for e in self.Elow_cm)

    @property
    def P_down(self) -> Tuple[float, ...]:
        d = self.damping
        return tuple(a / d for a in self.A21)


@dataclasses.dataclass(frozen=True)
class Line:
    """Static data for one resonance line (or line system)."""
    line_id: str
    ion_id: str
    line_type: int
    wavelength0: float            # um (shortest / reference component)
    f12: Tuple[float, ...]        # oscillator strengths of upward transitions
    damping: float                # total damping constant of reference level [1/s]
    mass_amu: float
    DnuHK_Hz: float = 0.0         # fine-structure split (type 2)
    # upward-level energies relative to level 1, as delE_Hz = E1 - Ei (<=0)
    delE_Hz: Tuple[float, ...] = (0.0,)
    branches: Tuple[Branch, ...] = ()
    # dipole weights for simple lines (types 1, 7, 8 and non-FS Lya)
    E1: float = 1.0
    E2: float = 0.0
    E3: float = 1.0
    # cross0 override: sum of f12 instead of f12[0] (Lya convention)
    cross0_use_sum: bool = False
    # --- type 7 (H+D) secondary-species data ---
    wavelength0_D: Optional[float] = None
    mass_amu_D: Optional[float] = None
    damping_D: Optional[float] = None
    # --- type 8 (ly_beta) band-2 wavelength ---
    wavelength0_Ha: Optional[float] = None

    # Derived quantities ---------------------------------------------------
    @property
    def nup(self) -> int:
        return max(len(self.branches), 1) if self.line_type in (4, 5, 6) \
            else (2 if self.line_type in (2, 3) else 1)

    @property
    def cross0(self) -> float:
        f = sum(self.f12) if self.cross0_use_sum else self.f12[0]
        return SIGMA_0 / SQRTPI * f

    @property
    def vtherm1(self) -> float:
        """Thermal speed of a 1 K atom of this mass [km/s]."""
        return VTHERM1_AMU / math.sqrt(self.mass_amu)

    @property
    def g_recoil0(self) -> float:
        """Recoil constant, reference convention (line_mod.f90:604).

        NOTE: the reference evaluates h[SI] / (amu[g] * mass) / lambda[m]^2,
        mixing gram and SI masses.  We reproduce the same expression verbatim
        for output parity (recoil defaults to off in both codes).
        """
        return (H_PLANCK / AMU / self.mass_amu) / (self.wavelength0 * UM2M) ** 2

    # type-7 derived constants (reference line_mod.f90:1166-1176)
    @property
    def f12_D(self) -> float:
        return sum(self.f12)

    @property
    def cross0_D(self) -> float:
        return SIGMA_0 / SQRTPI * self.f12_D

    @property
    def vtherm1_D(self) -> float:
        return VTHERM1_AMU / math.sqrt(self.mass_amu_D)

    @property
    def g_recoil0_D(self) -> float:
        return (H_PLANCK / AMU / self.mass_amu_D) / (self.wavelength0_D * UM2M) ** 2

    @property
    def delta_nu_HD_Hz(self) -> float:
        lam_D_cm = self.wavelength0_D * UM2M * 1e2
        lam_H_cm = self.wavelength0 * UM2M * 1e2
        return SPEEDC_CM * (1.0 / lam_D_cm - 1.0 / lam_H_cm)

    @property
    def ratio_Dfreq_HD(self) -> float:
        return (self.wavelength0_D / self.wavelength0) * math.sqrt(self.mass_amu_D / self.mass_amu)

    @property
    def ratio_voigta_HD(self) -> float:
        return (self.damping_D / self.damping) * self.ratio_Dfreq_HD


def _dnu(cm_short: float, cm_long: float) -> float:
    """Fine-structure split in Hz from level energies in cm^-1."""
    return SPEEDC_CM * (cm_short - cm_long)


def _delE(levels_cm: Tuple[float, ...]) -> Tuple[float, ...]:
    """delE_Hz(i) = (E1 - Ei) * c, reference convention (<= 0 for i > 1)."""
    e0 = levels_cm[0]
    return tuple((e0 - e) * SPEEDC_CM for e in levels_cm)


# E-weight shorthand tuples used by many SiII/FeII/CII branches
_E_RES_HALF = ((1.0 / 2.0,), (1.0 / 2.0,), (5.0 / 6.0,))  # 1/2->3/2->1/2

_CATALOG = {}


def _register(line: Line) -> None:
    _CATALOG[line.line_id] = line


# ----------------------------------------------------------------------------
# Doublets (type 2)   [line_mod.f90:592-700]
# ----------------------------------------------------------------------------
_register(Line('CIV_1548', 'C IV', 2, 0.1548187, (0.190, 0.0952), 2.647e8,
               12.011, DnuHK_Hz=_dnu(64591.7, 64484.0)))
_register(Line('NV_1239', 'N V', 2, 0.1238821, (0.156, 0.078), 3.390e8,
               14.0067, DnuHK_Hz=_dnu(80721.9, 80463.2)))
_register(Line('OVI_1032', 'O VI', 2, 0.1031912, (0.133, 0.066), 4.137e8,
               15.9994, DnuHK_Hz=_dnu(96907.5, 96375.0)))
_register(Line('NaI_D', 'Na I', 2, 0.5891583253, (0.641, 0.320), 6.153e7,
               22.98977, DnuHK_Hz=_dnu(16973.36619, 16956.17025)))
_register(Line('CaII_HK', 'Ca II', 2, 0.3934777, (0.682, 0.330), 1.446667e8,
               40.078, DnuHK_Hz=_dnu(25414.40, 25191.51)))
_register(Line('MgII_2796', 'Mg II', 2, 0.2796352, (0.608, 0.303), 2.590e8,
               24.305, DnuHK_Hz=_dnu(35760.88, 35669.31)))
_register(Line('SiIV_1394', 'Si IV', 2, 0.1393755, (0.513, 0.255), 8.743e8,
               28.0855, DnuHK_Hz=_dnu(71748.64, 71287.54)))

# ----------------------------------------------------------------------------
# Singlet (type 1)
# ----------------------------------------------------------------------------
_register(Line('AlII_1671', 'Al II', 1, 0.16707874, (1.77,), 1.41e9,
               26.98154, E1=1.0, E2=0.0, E3=1.0))

# ----------------------------------------------------------------------------
# Resonance + fluorescence (type 4)
# ----------------------------------------------------------------------------
_register(Line('CII_1334', 'C II', 4, 0.13345326, (0.129,), 2.41e8 + 3.356e8,
               12.011, branches=(Branch(
                   A21=(2.41e8, 3.356e8), Elow_cm=(0.0, 63.42),
                   E1=(1 / 2, -2 / 5), E2=(1 / 2, 7 / 5), E3=(5 / 6, 1 / 3)),)))
_register(Line('SiII_1527', 'Si II', 4, 0.1526707, (0.133,), 3.81e8 + 7.52e8,
               28.0855, branches=(Branch(
                   A21=(3.81e8, 7.52e8), Elow_cm=(0.0, 287.24),
                   E1=(0.0, 0.0), E2=(1.0, 1.0), E3=(2 / 3, -1 / 3)),)))
_register(Line('SiII_1260', 'Si II', 4, 0.1260422, (1.22,), 2.57e9 + 4.73e8,
               28.0855, branches=(Branch(
                   A21=(2.57e9, 4.73e8), Elow_cm=(0.0, 287.24),
                   E1=(1 / 2, -2 / 5), E2=(1 / 2, 7 / 5), E3=(5 / 6, 1 / 3)),)))
_register(Line('SiII_1304', 'Si II', 4, 0.1304370, (0.0928,), 3.64e8 + 6.23e8,
               28.0855, branches=(Branch(
                   A21=(3.64e8, 6.23e8), Elow_cm=(0.0, 287.24),
                   E1=(0.0, 0.0), E2=(1.0, 1.0), E3=(2 / 3, -1 / 3)),)))
_register(Line('FeII_2250', 'Fe II', 4, 0.224988, (0.00182,), 3.00e6 + 4.00e5,
               55.845, branches=(Branch(
                   A21=(3.00e6, 4.00e5), Elow_cm=(0.0, 384.7872),
                   E1=(7 / 150, -2 / 15), E2=(143 / 150, 17 / 15),
                   E3=(7 / 18, -1 / 9)),)))
_register(Line('FeII_2261', 'Fe II', 4, 0.226078, (0.00244,), 3.18e6 + 4.49e6,
               55.847, branches=(Branch(
                   A21=(3.18e6, 4.49e6), Elow_cm=(0.0, 384.7872),
                   E1=(64 / 165, -4 / 15), E2=(101 / 165, 19 / 15),
                   E3=(2 / 99, 1 / 9)),)))
_register(Line('FeII_2344', 'Fe II', 4, 0.234421274, (0.114,),
               1.73e8 + 5.90e7 + 3.10e7, 55.847, branches=(Branch(
                   A21=(1.73e8, 5.90e7, 3.10e7),
                   Elow_cm=(0.0, 384.7872, 667.6829),
                   E1=(7 / 150, -2 / 15, 1 / 10),
                   E2=(143 / 150, 17 / 15, 9 / 10),
                   E3=(7 / 18, -1 / 9, -1 / 2)),)))
_CATALOG['FeII_UV3'] = _CATALOG['FeII_2344']

# ----------------------------------------------------------------------------
# Two upward + multiple downward (type 5)
# ----------------------------------------------------------------------------
_register(Line('SiII_1193', 'Si II', 5, 0.1193290, (0.575, 0.277),
               2.69e9 + 1.40e9, 28.0855,
               delE_Hz=_delE((83801.95, 84004.26)),
               branches=(
                   Branch(A21=(2.69e9, 1.40e9), Elow_cm=(0.0, 287.24),
                          E1=(0.0, 0.0), E2=(1.0, 1.0), E3=(2 / 3, -1 / 3)),
                   Branch(A21=(6.53e8, 3.45e9), Elow_cm=(0.0, 287.24),
                          E1=(1 / 2, -2 / 5), E2=(1 / 2, 7 / 5),
                          E3=(5 / 6, 1 / 3)))))
_CATALOG['SiII_1190'] = _CATALOG['SiII_1193']

_register(Line('FeII_2600', 'Fe II', 5, 0.260017206, (0.239, 0.0717),
               2.35e8 + 3.52e7, 55.847,
               delE_Hz=_delE((38458.9934, 38660.0537)),
               branches=(
                   Branch(A21=(2.35e8, 3.52e7), Elow_cm=(0.0, 384.7872),
                          E1=(64 / 165, -4 / 15), E2=(101 / 165, 19 / 15),
                          E3=(2 / 99, 1 / 9)),
                   Branch(A21=(8.94e7, 1.20e8, 6.29e7),
                          Elow_cm=(0.0, 384.7872, 667.6829),
                          E1=(7 / 150, -2 / 15, 1 / 10),
                          E2=(143 / 150, 17 / 15, 9 / 10),
                          E3=(7 / 18, -1 / 9, -1 / 2)))))
_CATALOG['FeII_UV1'] = _CATALOG['FeII_2600']

_register(Line('FeII_2383', 'Fe II', 5, 0.238276386, (0.320, 0.0359),
               3.13e8, 55.847,
               delE_Hz=_delE((41968.0698, 42114.8380)),
               branches=(
                   Branch(A21=(3.13e8,), Elow_cm=(0.0,),
                          E1=(91 / 550,), E2=(459 / 550,), E3=(13 / 22,)),
                   Branch(A21=(4.25e7, 2.59e8), Elow_cm=(0.0, 384.7872),
                          E1=(64 / 165, -4 / 15), E2=(101 / 165, 19 / 15),
                          E3=(2 / 99, 1 / 9)))))
_CATALOG['FeII_UV2'] = _CATALOG['FeII_2383']

# ----------------------------------------------------------------------------
# HeI 10833 triplet (type 6)
# ----------------------------------------------------------------------------
_register(Line('HeI_10833', 'He I', 6, 1.0833306444,
               (2.9958e-1, 1.797e-1, 5.9902e-2), 1.0216e7, 4.0026032545,
               delE_Hz=_delE((169086.7664725, 169086.8428979, 169087.8308131)),
               branches=(
                   Branch(A21=(1.0216e7,), Elow_cm=(0.0,),
                          E1=(7 / 20,), E2=(13 / 20,), E3=(3 / 4,)),
                   Branch(A21=(1.0216e7,), Elow_cm=(0.0,),
                          E1=(1 / 4,), E2=(3 / 4,), E3=(1 / 4,)),
                   Branch(A21=(1.0216e7,), Elow_cm=(0.0,),
                          E1=(0.0,), E2=(1.0,), E3=(0.0,)))))

# ----------------------------------------------------------------------------
# Lyman-alpha (default; type 1 without fine structure, type 2 with)
# ----------------------------------------------------------------------------
_LYA_DELE = _delE((82259.2850014, 82258.9191133))
_register(Line('ly_alpha', 'H  I', 1, 0.1215668237310, (0.27760, 0.13881),
               6.2649e8, 1.00797, delE_Hz=_LYA_DELE, DnuHK_Hz=0.0,
               E1=1.0, E2=0.0, E3=1.0, cross0_use_sum=True))
_register(Line('ly_alpha_fs', 'H  I', 2, 0.1215668237310, (0.27760, 0.13881),
               6.2649e8, 1.00797, delE_Hz=_LYA_DELE,
               DnuHK_Hz=_LYA_DELE[1] * -1.0 if _LYA_DELE[1] < 0 else _LYA_DELE[1],
               cross0_use_sum=True))

# ----------------------------------------------------------------------------
# H + D Lyman-alpha (type 7)
# ----------------------------------------------------------------------------
_register(Line('ly_alpha_HD', 'H+D', 7, 0.1215668237310, (0.27760, 0.13881),
               6.2649e8, 1.00797, E1=1.0, E2=0.0, E3=1.0, cross0_use_sum=True,
               wavelength0_D=0.1215337431, mass_amu_D=2.01410177812,
               damping_D=6.2649e8))

# ----------------------------------------------------------------------------
# Lyman-beta with 3p->2s conversion (type 8)
# ----------------------------------------------------------------------------
_register(Line('ly_beta', 'H  I', 8, 0.10257222, (0.07910,), 1.8970e8,
               1.00797, E1=1.0, E2=0.0, E3=1.0,
               branches=(Branch(
                   A21=(1.6725e8, 2.2448e7), Elow_cm=(0.0, 0.0),
                   E1=(1.0, 1.0), E2=(0.0, 0.0), E3=(1.0, 1.0)),),
               wavelength0_Ha=0.6564553))


def get_line(line_id: str, fine_structure: bool = False,
             include_deuterium: bool = False) -> Line:
    """Resolve a line_id (reference namelist convention) to its catalog entry.

    Mirrors the promotion rules of setup_resonance_line
    (line_mod.f90:582-590): include_deuterium promotes ly_alpha to
    ly_alpha_HD; fine_structure selects the H/K doublet treatment of Lya.
    """
    lid = line_id.strip()
    if lid in ('', 'ly_alpha', 'lya', 'Lya'):
        if include_deuterium:
            return _CATALOG['ly_alpha_HD']
        return _CATALOG['ly_alpha_fs' if fine_structure else 'ly_alpha']
    if lid == 'ly_alpha_HD':
        return _CATALOG['ly_alpha_HD']
    if lid not in _CATALOG:
        raise KeyError(f'unknown line_id: {line_id!r}; known: {sorted(_CATALOG)}')
    return _CATALOG[lid]


def line_ids() -> Tuple[str, ...]:
    return tuple(sorted(_CATALOG))
