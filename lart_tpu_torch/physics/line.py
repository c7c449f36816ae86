"""The constants of a resonance line, and the plain PyTorch versions of the
line's device functions (csrc/line.cuh): its opacity profile, its
frequency redistribution at a scattering, and the birth shift of a
multi-level line.

Counterparts of lart_tpu/transport/engine.py line_profile (:621, with the
profile wrappers of lart_tpu/physics/voigt.py:121-142), make_scatter's
redistribute with _vz and _branch_select (:1907-2086), and
branch_init_shift (:2919-2970), for line types 1, 2, 4, 5, 6 (with and
without HeI_coherent), 7 and 8:

- 1 (a singlet): H(x, a);
- 2 (a doublet): H(x + dHK, a) / 3 + 2 H(x, a) / 3, dHK = DnuHK_Hz / D; at
  a scattering the upper level is H with probability pH / (pH + pK), the
  u_par sampler runs at x + dHK there, and E1 = (2 qK qH + qH^2) / (qK^2 +
  2 qH^2) at qK = xfreq_atom, qH = qK + dHK;
- 4 (one upper level, downward branches): H(x, a); a scattering picks its
  downward branch by P_down, shifts xfreq_atom by -Elow_Hz / D and takes
  that branch's E1, E2, E3;
- 5 and 6 (several upper levels): the sum over upper levels i of
  f_i / f_1 H(x + delE_i / D, a a_i / a_1); a scattering picks its upper
  level by those terms, runs the sampler at x + delE_i / D with damping
  a a_i / a_1, then its downward branch; with HeI_coherent (type 6) the E
  weights follow from xfreq_atom and the level offsets;
- 7 (H + D): H(x, a) + (D/H) r H(x_D, a a_D / a_H), x_D = (x - dHD) r with
  r the ratio of the Doppler widths; a deuterium event samples in D
  Doppler units and scales back, its perpendicular velocity by 1 / r, its
  recoil constant g_recoil0_D;
- 8 (Ly-beta): H(x, a), redistributed as type 1 (do_resonance8,
  engine.py:2053-2065); a scattering also draws its downward channel, the
  3p -> 2s one (H-alpha) with probability P_down[1] (`P_conv`), and takes
  that channel's phase weights.

`LineConsts` holds the constants as lart_tpu's weak types round them: each
f64 quantity of lines.Line (sums and ratios taken in f64 first, as Python
evaluates them there) rounded once to f32, so a Python float here is an
exact f32 and every torch operation with it rounds as the f32 operation of
the JAX function and of the kernel does.  `c_struct` is the same data as
csrc/line.cuh struct LineC, which every kernel that evaluates the opacity
or redistributes carries.  The per-cell quantities delE_Hz / D, Elow_Hz / D
and the damping a a_i / a_1 are f32 operations on those constants
(`line_prof`), the kernels' too; only the sphere chord of the peel-off
takes them in f64 (instruments/peel.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import samplers
from .voigt import voigt_plain

MAX_LEVELS = 3         # upper levels, and downward branches of each
LINE_TYPES = (1, 2, 4, 5, 6, 7, 8)
TINY = 1e-30
THIRD, TWO_THIRDS = 1.0 / 3.0, 2.0 / 3.0

_I, _F = ctypes.c_int, ctypes.c_float
_N = MAX_LEVELS * MAX_LEVELS


def f32(v: float) -> float:
    """v rounded once to f32, as a Python float."""
    return float(np.float32(v))


class LineC(ctypes.Structure):
    """csrc/line.cuh struct LineC, field for field."""
    _fields_ = [('line_type', _I), ('nup', _I), ('ndown', _I * MAX_LEVELS),
                ('branch_init', _I), ('per_lane_E', _I), ('he_coherent', _I),
                ('P_cum', _F * _N), ('f_cum', _F * MAX_LEVELS),
                ('Elow_Hz', _F * _N), ('E1', _F * _N), ('E2', _F * _N),
                ('E3', _F * _N), ('delE_Hz', _F * MAX_LEVELS),
                ('f12', _F * MAX_LEVELS), ('f_ratio', _F * MAX_LEVELS),
                ('a_ratio', _F * MAX_LEVELS), ('DnuHK_Hz', _F),
                ('dnu_HD_Hz', _F), ('ratio_Dfreq_HD', _F),
                ('ratio_voigta_HD', _F), ('nD_HD', _F), ('perp_D', _F),
                ('E1s', _F), ('E2s', _F), ('E3s', _F), ('g_recoil0', _F),
                ('g_recoil0_D', _F), ('P_conv', _F)]


class LineProfC(ctypes.Structure):
    """csrc/line.cuh struct LineProf, field for field."""
    _fields_ = [('dx', _F * MAX_LEVELS), ('a', _F * MAX_LEVELS)]


@dataclasses.dataclass(frozen=True)
class LineProf:
    """The profile's components at one (a, D): offsets dx (Doppler units)
    and damping parameters a, component 0 at line centre."""
    dx: Tuple[float, ...]
    a: Tuple[float, ...]

    @property
    def c_struct(self) -> LineProfC:
        c = LineProfC()
        c.dx[:] = self.dx
        c.a[:] = self.a
        return c


def _pad(vals, n=MAX_LEVELS, fill=0.0):
    vals = tuple(vals)
    assert len(vals) <= n, vals
    return vals + (fill,) * (n - len(vals))


@dataclasses.dataclass(frozen=True)
class LineConsts:
    line_type: int
    nup: int                 # upper levels (2 for the doublet's H and K)
    ndown: tuple             # downward branches of each upper level
    he_coherent: bool        # type 6 with HeI_coherent
    branch_init: bool        # births shifted to a branch: types 2, 4, 5, 6
    P_cum: tuple             # per upper level, the cumulative P_down
    f_cum: tuple             # cumulative f12 / sum f12 (types 5, 6 births)
    Elow_Hz: tuple           # per upper level and branch
    E1: tuple
    E2: tuple
    E3: tuple
    delE_Hz: tuple
    f12: tuple
    f_ratio: tuple           # f12_i / f12_1
    a_ratio: tuple           # damping_i / damping_1
    DnuHK_Hz: float = 0.0
    dnu_HD_Hz: float = 0.0
    ratio_Dfreq_HD: float = 1.0
    ratio_voigta_HD: float = 1.0
    nD_HD: float = 0.0       # D_to_H_ratio * ratio_Dfreq_HD
    perp_D: float = 1.0      # 1 / ratio_Dfreq_HD
    E1s: float = 1.0         # the line's own weights (types 1 and 7)
    E2s: float = 0.0
    E3s: float = 1.0
    g_recoil0: float = 0.0
    g_recoil0_D: float = 0.0
    P_conv: float = 0.0      # type 8: P_down of the 3p -> 2s channel

    @classmethod
    def from_config(cls, cfg) -> 'LineConsts':
        """The constants of cfg.line (a lines.Line), for a line type the
        port runs."""
        line, par = cfg.line, cfg.par
        lt = line.line_type
        if lt not in LINE_TYPES:
            raise NotImplementedError(f'line_type {lt}')
        brs = line.branches if lt in (4, 5, 6, 8) else ()
        nup = line.nup
        P_cum, Elow, E1, E2, E3 = [], [], [], [], []
        for br in brs:
            cum, cums = 0.0, []
            for pd in br.P_down:       # summed in f64, as lart_tpu's loops
                cum += pd
                cums.append(f32(cum))
            P_cum.append(_pad(cums, fill=2.0))
            Elow.append(_pad(f32(e) for e in br.Elow_Hz))
            for out, vals in ((E1, br.E1), (E2, br.E2), (E3, br.E3)):
                out.append(_pad(f32(e) for e in vals))
        ndown = tuple(br.ndown for br in brs)
        f_cum = []
        if lt in (5, 6):
            ftot, cumf = sum(line.f12[:nup]), 0.0
            for i in range(nup):
                cumf += line.f12[i] / ftot
                f_cum.append(f32(cumf))
        a1 = brs[0].damping if brs else 1.0
        hd = lt == 7
        return cls(
            line_type=lt, nup=nup, ndown=_pad(ndown, fill=0),
            he_coherent=bool(lt == 6 and par.HeI_coherent),
            branch_init=lt in (2, 4, 5, 6),
            P_cum=_pad(P_cum, fill=(2.0,) * MAX_LEVELS),
            f_cum=_pad(f_cum, fill=2.0),
            Elow_Hz=_pad(Elow, fill=(0.0,) * MAX_LEVELS),
            E1=_pad(E1, fill=(0.0,) * MAX_LEVELS),
            E2=_pad(E2, fill=(0.0,) * MAX_LEVELS),
            E3=_pad(E3, fill=(0.0,) * MAX_LEVELS),
            delE_Hz=_pad(f32(v) for v in line.delE_Hz[:nup]
                         if lt in (5, 6)),
            f12=_pad(f32(v) for v in line.f12[:nup] if lt in (5, 6)),
            f_ratio=_pad(f32(line.f12[i] / line.f12[0]) for i in range(nup)
                         if lt in (5, 6)),
            a_ratio=_pad(f32(brs[i].damping / a1) for i in range(nup)
                         if lt in (5, 6)),
            DnuHK_Hz=f32(line.DnuHK_Hz),
            dnu_HD_Hz=f32(line.delta_nu_HD_Hz) if hd else 0.0,
            ratio_Dfreq_HD=f32(line.ratio_Dfreq_HD) if hd else 1.0,
            ratio_voigta_HD=f32(line.ratio_voigta_HD) if hd else 1.0,
            nD_HD=f32(par.D_to_H_ratio * line.ratio_Dfreq_HD) if hd else 0.0,
            perp_D=f32(1.0 / line.ratio_Dfreq_HD) if hd else 1.0,
            E1s=f32(line.E1), E2s=f32(line.E2), E3s=f32(line.E3),
            g_recoil0=f32(line.g_recoil0),
            g_recoil0_D=f32(line.g_recoil0_D) if hd else 0.0,
            P_conv=f32(brs[0].P_down[1]) if lt == 8 else 0.0)

    @property
    def per_lane_E(self) -> bool:
        """E1, E2, E3 differ from scattering to scattering."""
        return self.line_type in (2, 4, 5, 6)

    @functools.cached_property
    def c_struct(self) -> LineC:
        c = LineC()
        c.line_type, c.nup = self.line_type, self.nup
        c.ndown[:] = self.ndown
        c.branch_init, c.per_lane_E = int(self.branch_init), \
            int(self.per_lane_E)
        c.he_coherent = int(self.he_coherent)
        for f in ('P_cum', 'Elow_Hz', 'E1', 'E2', 'E3'):
            getattr(c, f)[:] = [v for row in getattr(self, f) for v in row]
        for f in ('f_cum', 'delE_Hz', 'f12', 'f_ratio', 'a_ratio'):
            getattr(c, f)[:] = getattr(self, f)
        for f in ('DnuHK_Hz', 'dnu_HD_Hz', 'ratio_Dfreq_HD',
                  'ratio_voigta_HD', 'nD_HD', 'perp_D', 'E1s', 'E2s', 'E3s',
                  'g_recoil0', 'g_recoil0_D', 'P_conv'):
            setattr(c, f, getattr(self, f))
        return c


def _div(t: torch.Tensor, b: float) -> torch.Tensor:
    """t / b, b rounded to f32, correctly rounded: on CUDA torch divides by
    a Python scalar as a multiply by its f32 reciprocal, the kernels divide
    (transport/flight.py div, which this module cannot import)."""
    return t / torch.full((), b, dtype=t.dtype, device=t.device)


def div32(a, b):
    """a / b of two f32 values, in f32, correctly rounded (the kernels'
    division and XLA's); a tensor where either is a per-lane tensor (a
    cell's Doppler width at non-uniform temperature)."""
    if isinstance(b, torch.Tensor):
        return (a if isinstance(a, torch.Tensor)
                else torch.full_like(b, f32(a))) / b
    if isinstance(a, torch.Tensor):
        return _div(a, f32(b))
    return float(np.float32(a) / np.float32(b))


def mul32(a, b):
    """a * b of two f32 values, in f32 (per lane where either is a
    tensor)."""
    if isinstance(a, torch.Tensor):
        return a * (b if isinstance(b, torch.Tensor) else f32(b))
    if isinstance(b, torch.Tensor):
        return f32(a) * b
    return float(np.float32(a) * np.float32(b))


def lanes_like(v, like: torch.Tensor) -> torch.Tensor:
    """v, an f32 constant or a per-lane tensor, as a tensor of like's
    shape."""
    if isinstance(v, torch.Tensor):
        return v.expand_as(like)
    return torch.full_like(like, v)


def line_prof(lc: LineConsts, a: float, D: float) -> LineProf:
    """The profile's components at a cell of damping a and Doppler width D
    (Hz): f32 operations on the f32 constants, as the flights, the scatter
    and the walk take them (line.cuh line_prof).  a and D may be per-lane
    tensors (a Cartesian or AMR grid at non-uniform temperature): the
    offsets and dampings are then per lane."""
    a0 = a if isinstance(a, torch.Tensor) else f32(a)
    dx, aa = [0.0] * MAX_LEVELS, [a0] * MAX_LEVELS
    lt = lc.line_type
    if lt == 2:
        dx[1] = div32(lc.DnuHK_Hz, D)
    elif lt in (5, 6):
        for i in range(1, lc.nup):
            dx[i] = div32(lc.delE_Hz[i], D)
            aa[i] = mul32(a, lc.a_ratio[i])
    elif lt == 7:
        dx[1] = div32(lc.dnu_HD_Hz, D)
        aa[1] = mul32(a, lc.ratio_voigta_HD)
    return LineProf(tuple(dx), tuple(aa))


def line_prof_f64(line, a: float, D: float) -> LineProf:
    """line_prof with Python floats throughout (a lines.Line, f64 a and D),
    each component's offset and damping rounded once: lart_tpu's peel
    chord calls line_profile with meta.voigt_a_ref and meta.Dfreq_ref
    (instruments/peel.py:374)."""
    lt = line.line_type
    dx, aa = [0.0] * MAX_LEVELS, [f32(a)] * MAX_LEVELS
    if lt == 2:
        dx[1] = f32(line.DnuHK_Hz / D)
    elif lt in (5, 6):
        for i in range(1, line.nup):
            dx[i] = f32(line.delE_Hz[i] / D)
            aa[i] = f32(a * (line.branches[i].damping
                             / line.branches[0].damping))
    elif lt == 7:
        dx[1] = f32(line.delta_nu_HD_Hz / D)
        aa[1] = f32(a * line.ratio_voigta_HD)
    return LineProf(tuple(dx), tuple(aa))


def line_profile_q(lc: LineConsts, q: LineProf, x: torch.Tensor):
    """The opacity profile H_eff at x with the components q (engine.py:621
    line_profile)."""
    lt = lc.line_type
    if lt == 2:
        return (voigt_plain(x + q.dx[1], q.a[0]) * THIRD
                + voigt_plain(x, q.a[0]) * TWO_THIRDS)
    if lt in (5, 6):
        out = voigt_plain(x, q.a[0])
        for i in range(1, lc.nup):
            out = out + voigt_plain(x + q.dx[i], q.a[i]) * lc.f_ratio[i]
        return out
    if lt == 7:
        x_D = (x - q.dx[1]) * lc.ratio_Dfreq_HD
        return voigt_plain(x, q.a[0]) + lc.nD_HD * voigt_plain(x_D, q.a[1])
    return voigt_plain(x, q.a[0])


def line_profile_plain(lc: LineConsts, x: torch.Tensor, a: float,
                       D: float) -> torch.Tensor:
    """H_eff(x) at a cell of damping a and Doppler width D (Hz)."""
    return line_profile_q(lc, line_prof(lc, a, D), x)


def branch_select(xi: torch.Tensor, P_cum, ndown: int) -> torch.Tensor:
    """_branch_select (engine.py:1916): the first branch whose cumulative
    P_down exceeds xi, else the last; int64."""
    idown = torch.full_like(xi, ndown - 1, dtype=torch.int64)
    for i in reversed(range(ndown)):
        idown = torch.where(xi < P_cum[i], i, idown)
    return idown


def _pick(idx: torch.Tensor, vals) -> torch.Tensor:
    """vals[idx] of a short tuple of f32 constants or per-lane tensors
    (_branch_consts)."""
    out = vals[0] if isinstance(vals[0], torch.Tensor) else torch.full(
        idx.shape, vals[0], dtype=torch.float32, device=idx.device)
    for i in range(1, len(vals)):
        out = torch.where(idx == i, vals[i], out)
    return out


def branch_init_shift_plain(lc: LineConsts, u0: torch.Tensor,
                            u1: torch.Tensor, D: float) -> torch.Tensor:
    """The birth frequency's shift of a multi-level line (engine.py:2923):
    type 2 the K line with probability 1/3 (-dHK), type 4 a downward branch
    by P_down (-Elow / D), types 5 and 6 an upper level by f12 and then its
    downward branch (-delE_i / D - Elow / D); 0 where no draw hits."""
    lt = lc.line_type
    zero = torch.zeros_like(u0)
    if lt == 2:
        return torch.where(u0 <= THIRD, -div32(lc.DnuHK_Hz, D), zero)
    if lt == 4:
        shift = zero
        for i in reversed(range(lc.ndown[0])):
            shift = torch.where(u0 < lc.P_cum[0][i],
                                -div32(lc.Elow_Hz[0][i], D), shift)
        return shift
    if lt in (5, 6):
        shift = zero
        for iup in reversed(range(lc.nup)):
            sh_up = -div32(lc.delE_Hz[iup], D) if iup else 0.0
            sh_dn = zero
            if lc.ndown[iup] > 1:
                for i in reversed(range(lc.ndown[iup])):
                    sh_dn = torch.where(u1 < lc.P_cum[iup][i],
                                        -div32(lc.Elow_Hz[iup][i], D), sh_dn)
            shift = torch.where(u0 < lc.f_cum[iup], sh_up + sh_dn, shift)
        return shift
    return zero


def he_coherent_E(xatom: torch.Tensor, Dx2: float, Dx3: float):
    """(E1, E2, E3) of a coherent He I 10833 scattering at xfreq_atom, from
    the level offsets Dx2 = delE_2 / D, Dx3 = delE_3 / D
    (compute_HeI_E_coherent, engine.py:2032-2050)."""
    D2v = xatom
    D1v = xatom + Dx2
    D0v = xatom + Dx3
    D2D0 = D2v * D0v
    D2D1 = D2v * D1v
    D0D1 = D0v * D1v
    pqq = D2v * D0v * D1v
    den = 4.0 * (D2D1 * D2D1 + 3.0 * D2D0 * D2D0 + 5.0 * D0D1 * D0D1)
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    E1 = (3.0 * D2D0 * D2D0 + 7.0 * D0D1 * D0D1 + 8.0 * pqq * D1v
          + 18.0 * pqq * D0v) / den
    E3 = (3.0 * D2D0 * D2D0 + 15.0 * D0D1 * D0D1 + 8.0 * D2v * pqq
          + 10.0 * pqq * D0v) / den
    return E1, 1.0 - E1, E3


@dataclasses.dataclass
class Redistribution:
    """What redistribute returns per lane: whether the u_par rounds
    accepted, u_par, xfreq_atom (with the fluorescent shift), the phase
    weights E1, E2, E3 (floats for types 1 and 7, else tensors), the
    perpendicular velocity's scale and the recoil constant (floats, or
    tensors for type 7), and for type 8 whether each lane converts to
    H-alpha."""
    acc: torch.Tensor
    uz: torch.Tensor
    xatom: torch.Tensor
    E1: object
    E2: object
    E3: object
    perp: object = 1.0
    g0: object = 0.0
    conv: Optional[torch.Tensor] = None


def redistribute_plain(lc: LineConsts, x: torch.Tensor, a: float, D: float,
                       u_rounds, sel: Optional[torch.Tensor],
                       active: torch.Tensor) -> Redistribution:
    """make_scatter's redistribute (engine.py:1931-2086) on the uniforms
    u_rounds (rounds, 4, B), one block a u_par round, and sel (4, B): sel[0]
    picks the upper level (types 2, 5, 6; H or D in type 7) or, in type 4,
    the downward branch, sel[1] the downward branch of types 5 and 6; in
    type 8 sel[0] < P_conv converts the photon."""
    lt = lc.line_type
    q = line_prof(lc, a, D)
    x0, va = x, q.a[0]
    if lt == 2:
        pH = voigt_plain(x + q.dx[1], q.a[0]) * THIRD
        pK = voigt_plain(x, q.a[0]) * TWO_THIRDS
        isH = sel[0] < pH / (pH + pK)
        x0 = torch.where(isH, x + q.dx[1], x)
    elif lt in (5, 6):
        ps = [voigt_plain(x + q.dx[i], q.a[i]) * lc.f12[i]
              for i in range(lc.nup)]
        ptot = ps[0]
        for p_ in ps[1:]:
            ptot = ptot + p_
        xi_up = sel[0] * ptot
        iup = torch.zeros_like(x, dtype=torch.int64)
        cum, chosen = torch.zeros_like(x), torch.zeros_like(active)
        for i in range(lc.nup):
            cum = cum + ps[i]
            hit = ~chosen & (xi_up < cum)
            iup = torch.where(hit, i, iup)
            chosen = chosen | hit
        x0 = x
        va = lanes_like(q.a[0], x)
        for i in range(1, lc.nup):
            x0 = torch.where(iup == i, x + q.dx[i], x0)
            va = torch.where(iup == i, q.a[i], va)
    elif lt == 7:
        x_D = (x - q.dx[1]) * lc.ratio_Dfreq_HD
        pH = voigt_plain(x, q.a[0])
        pD = lc.nD_HD * voigt_plain(x_D, q.a[1])
        is_H = sel[0] < pH / (pH + pD)
        x0 = torch.where(is_H, x, x_D)
        va = torch.where(is_H, q.a[0], lanes_like(q.a[1], x))
    env = samplers.vz_envelope(x0, va)
    acc = torch.zeros_like(active)
    uz = torch.zeros_like(x)
    for u in u_rounds:
        acc, uz = samplers.vz_round_xi(u, env, acc, uz, active)
    if lt == 7:
        uz = torch.where(is_H, uz, _div(uz, lc.ratio_Dfreq_HD))
        return Redistribution(acc, uz, x - uz, lc.E1s, lc.E2s, lc.E3s,
                              perp=torch.where(is_H, 1.0, lc.perp_D),
                              g0=torch.where(is_H, lc.g_recoil0,
                                             lc.g_recoil0_D))
    xatom = x - uz
    if lt == 1:
        return Redistribution(acc, uz, xatom, lc.E1s, lc.E2s, lc.E3s,
                              g0=lc.g_recoil0)
    if lt == 8:
        conv = sel[0] < lc.P_conv
        idown = conv.to(torch.int64)
        return Redistribution(acc, uz, xatom,
                              *(_pick(idown, v[0][:2]) for v in (lc.E1, lc.E2,
                                                                 lc.E3)),
                              g0=lc.g_recoil0, conv=conv)
    if lt == 2:
        qH, qK = xatom + q.dx[1], xatom
        E1 = (2.0 * qK * qH + qH * qH) / torch.clamp_min(
            qK * qK + 2.0 * qH * qH, TINY)
        return Redistribution(acc, uz, xatom, E1, 1.0 - E1,
                              _div(E1 + 2.0, 3.0), g0=lc.g_recoil0)
    if lt == 4:
        idown = branch_select(sel[0], lc.P_cum[0], lc.ndown[0])
        shift = _pick(idown, tuple(div32(e, D) for e in lc.Elow_Hz[0]))
        return Redistribution(acc, uz, xatom - shift,
                              *(_pick(idown, v[0]) for v in (lc.E1, lc.E2,
                                                             lc.E3)),
                              g0=lc.g_recoil0)
    # types 5 and 6: the downward branch of the chosen upper level
    E = [torch.zeros_like(x) for _ in range(3)]
    shift = torch.zeros_like(x)
    for i in range(lc.nup):
        sel_i = iup == i
        idown = branch_select(sel[1], lc.P_cum[i], lc.ndown[i]) \
            if lc.ndown[i] > 1 else torch.zeros_like(iup)
        for k, v in enumerate((lc.E1, lc.E2, lc.E3)):
            E[k] = torch.where(sel_i, _pick(idown, v[i]), E[k])
        if lc.ndown[i] > 1:
            shift = torch.where(sel_i, _pick(idown, tuple(
                div32(e, D) for e in lc.Elow_Hz[i])), shift)
    if lc.he_coherent:
        E = he_coherent_E(xatom, q.dx[1], q.dx[2])
    return Redistribution(acc, uz, xatom - shift, *E, g0=lc.g_recoil0)
