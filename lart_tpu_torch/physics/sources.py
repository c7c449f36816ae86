"""Table-driven source samplers: radial laws, star particles, emissivity
fields and 1-D emissivity profiles.

Port of the host builders of lart_tpu/physics/sources.py with the same
numpy f64 bodies: _monotone_pr (:69), inv_cdf_rexp (:77; the inverse CDF
of p(r) dr = r^k exp(-r) dr, the table equivalent of the reference's
rand_r1exp/rand_r2exp, src/random_mt.f90:1227-1260),
sersic_deprojected_cumulative (:92; its trapezoid sums written out as
np.trapezoid computes them, so an older numpy gives the same table),
_composite_bias (:132), read_stars (:146), read_line_prof (:159; the
alias table over a line-profile file's bins and their edges),
build_emiss_profile_1d (:190) and build_sources (:226-297), with the
log-log radius draw sample_radius_loglog (:478) and the 1-D profile draw
sample_alias_linear (:486) as plain PyTorch.

The illumination sources (:300-474) draw by masked rejection rounds: the
limb-darkened cos theta of a point of the stellar surface
(sample_limb_cost), a finite star at distance D lighting the atmosphere
sphere (sample_stellar_illumination) and a point source on the z axis
lighting the box's near face (sample_point_illumination).  Their plain
versions here take their uniforms as tensors, (n_rounds, k, B), round r's
k uniforms in row r as lart_tpu's fold_in(key, r) draws them: every round
is computed for every lane, a lane keeps the first round it accepts, a
lane that accepts none takes the fallback (the sub-planet point aiming at
the centre, or straight down the axis), and nrejected counts the rounds a
lane rejected before its first acceptance.  Each operation rounds to f32
on its own, as kernel K2 (csrc/refill.cu, built with --fmad=false)
computes it; lart_tpu's closures fuse some products into their sums, so
the two agree to an ulp but for the lanes within an ulp of a test's
edge.

The tables live on the device in f32 (integers in int32), as lart_tpu's
SourceTables' jnp.asarray puts them there.  The radius draw is
jnp.interp of log(max(u, 1e-12)) over the f32 logs of the f32 knots
(jax's _interp: the knot i = clip(searchsorted(xp, x, 'right'), 1, n - 1),
fp[i-1] + (x - xp[i-1]) / dx df contracted into one fused multiply-add,
the end values outside the table), then exp.  The logs of the knots are
taken once here, by torch.log on the table's device: the kernel (K2,
csrc/refill.cu) and the plain version read the same ones.

The categorical draws (stars, emitting cells or leaves, profile bins) take
their bin from 32 random bits, (bits * n) >> 32, where lart_tpu takes
min(int(u n), n - 1) of an f32 uniform: with 2^24 distinct uniforms a
table of millions of cells would leave bins unequally likely, and beyond
2^24 bins unreachable (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..constants import SPEEDC
from ..transport.flight import div, fma
from .samplers import TWOPI, build_alias_table

P_FLOOR = float(np.float32(1e-12))     # jnp.maximum(u, 1e-12), weak f32
TINY_DP = float(np.float32(1e-30))     # sample_alias_linear's flat-bin test

# the geometries whose births a table drives
RADIAL = ('exponential_sphere', 'exponential_cylinder', 'sersic', 'ssh')


def _monotone_pr(cdf: np.ndarray, r: np.ndarray):
    """Strictly-increasing (p, r) knots for log-log inverse-CDF interp."""
    cdf = np.maximum.accumulate(cdf)
    keep = np.concatenate([[True], np.diff(cdf) > 0])
    keep &= (cdf > 0) & (r > 0)
    return cdf[keep], r[keep]


def inv_cdf_rexp(k: int, rmax: float, n: int = 2048):
    """Inverse CDF of p(r) dr = r^k exp(-r) dr on (0, rmax], radii in
    units of the scale length: (p, r) knots, with a power-law tail p ~
    r^(k+1) below the first."""
    from scipy.special import gammainc
    r = np.geomspace(rmax * 1e-7, rmax, n)
    cdf = gammainc(k + 1, r) / gammainc(k + 1, rmax)
    p, rr = _monotone_pr(cdf, r)
    p0 = p[0] * 1e-12
    r0 = rr[0] * (p0 / p[0]) ** (1.0 / (k + 1))
    return np.concatenate([[p0], p]), np.concatenate([[r0], rr])


def _trapezoid(f: np.ndarray, t: np.ndarray) -> float:
    """np.trapezoid(f, t) in its own operations (numpy >= 2.0 has it)."""
    return (np.diff(t) * (f[1:] + f[:-1]) / 2.0).sum()


def sersic_deprojected_cumulative(m: float, rmax: float,
                                  n_r: int = 200, n_t: int = 1024):
    """(p, r) knots of the normalized cumulative 3-D luminosity of a
    Sersic-m surface brightness exp(-b (R/Re)^(1/m)), r in units of Re: the
    inverse Abel integral nu(s) = (b / (pi m)) int_0^inf (s cosh t)^(1/m -
    1) exp(-b (s cosh t)^(1/m)) dt, then L(<r) = int_0^r 4 pi s^2 nu ds
    (reference src/random_sersic.f90:20-126)."""
    # Ciotti & Bertin (1999) asymptotic b(m)
    b = 2.0 * m - 1.0 / 3.0 + 4.0 / (405.0 * m) + 46.0 / (25515.0 * m * m)
    x_cut = (700.0 / b) ** m                      # exp(-700) underflow bound
    s = np.geomspace(min(1e-4, rmax * 1e-4), rmax, n_r)
    nu = np.empty(n_r)
    for i, si in enumerate(s):
        tmax = np.arccosh(max(x_cut / si, 1.0 + 1e-12))
        t = np.linspace(0.0, tmax, n_t)
        x = si * np.cosh(t)
        f = x ** (1.0 / m - 1.0) * np.exp(-b * x ** (1.0 / m))
        nu[i] = (b / (math.pi * m)) * _trapezoid(f, t)
    integrand = 4.0 * math.pi * s * s * nu
    L = np.concatenate([[0.0], np.cumsum(
        0.5 * (integrand[1:] + integrand[:-1]) * np.diff(s))])
    # the innermost shell: the cumulative goes as s^(1/m + 2) there
    L = L + integrand[0] * s[0] / (1.0 / m + 3.0)
    cdf = L / L[-1]
    p, rr = _monotone_pr(cdf, s)
    p0 = p[0] * 1e-12
    r0 = rr[0] * (p0 / p[0]) ** (1.0 / (1.0 / m + 2.0))
    return np.concatenate([[p0], p]), np.concatenate([[r0], rr])


def _composite_bias(prob: np.ndarray, f_comp: float):
    """The natural pdf mixed with a uniform over its support: (biased
    prob, weight) (read_text_data.f90:403-414)."""
    prob = prob / prob.sum()
    mask = prob > 0
    ncount = int(mask.sum())
    wgt = np.ones_like(prob)
    biased = prob.copy()
    biased[mask] = prob[mask] * (1.0 - f_comp) + f_comp / ncount
    wgt[mask] = prob[mask] / biased[mask]
    return biased, wgt


def read_stars(path: str, sampling_method: int, f_composite: float):
    """A star-particle file, text columns x y z luminosity: (x, y, z,
    alias prob, alias, composite weight or None) (read_stars,
    read_text_data.f90:346-415)."""
    dat = np.loadtxt(path, ndmin=2)
    x, y, z, lum = dat[:, 0], dat[:, 1], dat[:, 2], np.maximum(dat[:, 3], 0.0)
    prob = lum / lum.sum()
    wgt = None
    if sampling_method > 0:
        prob, wgt = _composite_bias(prob, f_composite)
    pr, al = build_alias_table(prob)
    return x, y, z, pr, al, wgt


def read_line_prof(path: str, cfg):
    """A line-profile file: (alias prob, alias, bin edges in xfreq units)
    (setup_line_profile, setup.f90:651-746).  Two columns: frequency [Hz]
    (line_prof_file_type 0) or wavelength [Angstrom] (1), and the profile
    density (negatives clipped)."""
    par, line = cfg.par, cfg.line
    dat = np.loadtxt(path, ndmin=2)
    xf, pdf = dat[:, 0].astype(np.float64), np.maximum(dat[:, 1], 0.0)
    lam_A = line.wavelength0 * 1e4          # um -> Angstrom
    lam_km = line.wavelength0 * 1e-9        # um -> km
    if par.line_prof_file_type == 0:
        xf = (xf - SPEEDC / lam_km) / cfg.Dfreq_ref
    elif par.line_prof_file_type == 1:
        xf = -(xf - lam_A) / lam_A * (SPEEDC / cfg.vtherm)
    else:
        raise ValueError(f'line_prof_file_type {par.line_prof_file_type}')
    if xf[-1] < xf[0]:
        xf, pdf = xf[::-1].copy(), pdf[::-1].copy()
    n = len(xf)
    edges = np.empty(n + 1)
    edges[1:-1] = 0.5 * (xf[:-1] + xf[1:])
    edges[0] = xf[0] - 0.5 * (xf[1] - xf[0])
    edges[-1] = xf[-1] + 0.5 * (xf[-1] - xf[-2])
    pbin = pdf * np.diff(edges)
    pbin = pbin / pbin.sum()
    pr, al = build_alias_table(pbin)
    return pr, al, edges


@dataclasses.dataclass(frozen=True, eq=False)
class LineProfTable:
    """The line_prof_file spectrum's device tables (lart_tpu's lp_prob,
    lp_alias, lp_edges): f32 alias probabilities, int32 aliases and the
    f32 bin edges in xfreq units."""
    prob: torch.Tensor
    alias: torch.Tensor
    edges: torch.Tensor

    @classmethod
    def from_config(cls, cfg, device) -> 'LineProfTable':
        pr, al, edges = read_line_prof(cfg.par.line_prof_file, cfg)
        return cls(prob=torch.as_tensor(pr, dtype=torch.float32,
                                        device=device),
                   alias=torch.as_tensor(np.asarray(al, np.int32),
                                         device=device),
                   edges=torch.as_tensor(edges, dtype=torch.float32,
                                         device=device))

    @property
    def n(self) -> int:
        return self.prob.numel()

    def tensors(self):
        return self.prob, self.alias, self.edges

    def sample(self, bits: torch.Tensor, u_alias: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
        """The bin by alias_bin, then uniform within it: lo + u (hi - lo)
        (engine.py:2826-2834, before the division by D_loc / D_ref)."""
        idx = alias_bin(self.prob, self.alias, bits, u_alias)
        lo, hi = self.edges[idx], self.edges[idx + 1]
        return lo + u * (hi - lo)


def build_emiss_profile_1d(path: str, xmax: float, spherical: bool,
                           sampling_method: int, f_composite: float):
    """A 1-D emissivity profile (axis, density knots) truncated at xmax:
    (axis, density of the draw, alias prob, alias over the bins, weight at
    each knot or None); spherical profiles are weighted by r^2, a bin's
    probability is its trapezoid (read_text_data.f90:143-344)."""
    dat = np.loadtxt(path, ndmin=2)
    ax, pr = dat[:, 0].astype(np.float64), np.maximum(dat[:, 1], 0.0)
    if spherical:
        pr = pr * ax * ax
    keep = np.searchsorted(ax, xmax, side='left')
    if keep < len(ax):
        # truncate at the box edge, interpolating the last knot
        pr_edge = np.interp(xmax, ax, pr, left=0.0, right=0.0)
        ax = np.concatenate([ax[:keep], [xmax]])
        pr = np.concatenate([pr[:keep], [pr_edge]])
    pbin = 0.5 * (pr[:-1] + pr[1:]) * np.diff(ax)
    psum = pbin.sum()
    pbin = pbin / psum
    pr = pr / psum
    wgt = None
    if sampling_method > 0:
        f1 = 1.0 - f_composite
        support = (pbin > 0)
        width = np.diff(ax)
        wsum = width[support].sum()
        pcomp = np.where(support, width / wsum, 0.0)
        pbin = np.where(support, pbin * f1 + f_composite * pcomp, pbin)
        dens_mix = pr * f1 + f_composite / wsum
        wgt = np.where(dens_mix > 0, pr / np.where(dens_mix > 0, dens_mix, 1),
                       1.0)
        pr = dens_mix
    pal, al = build_alias_table(pbin)
    return ax, pr, pal, al, wgt


def emiss_kind(par) -> str:
    """What a diffuse_emissivity source draws from: 'profile' (a 1-D
    .txt/.dat file), 'grid' (a 3-D FITS/HDF5 file), 'density1'/'density2'
    (the gas opacity or its square) or 'column' (the grid's own emissivity,
    an AMR file's column)."""
    src = par.emiss_file.strip()
    ext = src.rsplit('.', 1)[-1].lower() if '.' in src else ''
    if ext in ('txt', 'dat'):
        return 'profile'
    if ext in ('fits', 'h5', 'hdf5'):
        return 'grid'
    return src if src in ('density1', 'density2') else 'column'


@dataclasses.dataclass(frozen=True, eq=False)
class RadialTable:
    """The radius draw's knots on the device: the f32 cumulative
    probabilities p and radii r (lart_tpu's r_p, r_r), and their f32 logs."""
    p: torch.Tensor
    r: torch.Tensor
    log_p: torch.Tensor
    log_r: torch.Tensor

    @classmethod
    def from_knots(cls, p, r, device) -> 'RadialTable':
        pt = torch.as_tensor(np.asarray(p, np.float64), dtype=torch.float32,
                             device=device)
        rt = torch.as_tensor(np.asarray(r, np.float64), dtype=torch.float32,
                             device=device)
        return cls(p=pt, r=rt, log_p=torch.log(pt), log_r=torch.log(rt))

    @property
    def n(self) -> int:
        return self.p.numel()

    def tensors(self):
        return self.log_p, self.log_r


@dataclasses.dataclass(frozen=True, eq=False)
class SourceTables:
    """A source's device tables (lart_tpu's SourceTables, one kind at a
    time): the radial knots (kind 'radial'); the stars' positions (x, y, z)
    and their alias table (kind 'stars'); the alias table over the flat
    C-order cells or the leaf ids (kind 'cells' or 'leaves'); the profile's
    knots, axis and density, with the alias table over its bins (kind
    'profile').  wgt is the composite weight of each star, cell or leaf, or
    of each profile knot; None without composite bias."""
    kind: str
    table: Optional[RadialTable] = None
    x: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None
    z: Optional[torch.Tensor] = None
    prob: Optional[torch.Tensor] = None
    alias: Optional[torch.Tensor] = None
    wgt: Optional[torch.Tensor] = None
    axis: Optional[torch.Tensor] = None
    dens: Optional[torch.Tensor] = None

    @property
    def nbin(self) -> int:
        return 0 if self.prob is None else self.prob.numel()

    def tensors(self):
        return tuple(v for v in (
            *(self.table.tensors() if self.table is not None else ()),
            self.x, self.y, self.z, self.prob, self.alias, self.wgt,
            self.axis, self.dens) if v is not None)


def build_sources(cfg, meta, host_data=None, device='cpu'
                  ) -> Optional[SourceTables]:
    """The device tables of the config's source, or None where its
    position has a closed form.  host_data may carry 'rhokap', the host
    (nx, ny, nz) gas opacity of a Cartesian grid (emiss_file 'density1'
    or 'density2'), and 'emissivity', the AMR grid's column per leaf."""
    par = cfg.par
    sg = par.source_geometry.strip().lower()
    host_data = host_data or {}

    def f32(v):
        return None if v is None else torch.as_tensor(
            np.asarray(v, np.float64), dtype=torch.float32, device=device)

    def i32(v):
        return torch.as_tensor(np.asarray(v, np.int32), device=device)

    if sg in RADIAL:
        if sg in ('sersic', 'ssh'):
            p, r = sersic_deprojected_cumulative(
                par.sersic_m, par.source_rmax / par.Reff)
            scale = par.Reff
        else:
            k = 1 if sg == 'exponential_cylinder' else 2
            p, r = inv_cdf_rexp(k, par.source_rmax / par.source_rscale)
            scale = par.source_rscale
        return SourceTables(kind='radial', table=RadialTable.from_knots(
            p, r * scale, device))
    if sg == 'star_file':
        x, y, z, pr, al, wgt = read_stars(par.star_file, par.sampling_method,
                                          par.f_composite)
        return SourceTables(kind='stars', x=f32(x), y=f32(y), z=f32(z),
                            prob=f32(pr), alias=i32(al), wgt=f32(wgt))
    if sg != 'diffuse_emissivity':
        return None
    kind = emiss_kind(par)
    if kind == 'profile':
        xmax = min(meta.xmax, meta.ymax, meta.zmax)
        spherical = par.geometry.strip() != 'plane_atmosphere'
        ax, prd, pal, al, wgt = build_emiss_profile_1d(
            par.emiss_file.strip(), xmax, spherical, par.sampling_method,
            par.f_composite)
        return SourceTables(kind='profile', axis=f32(ax), dens=f32(prd),
                            prob=f32(pal), alias=i32(al), wgt=f32(wgt))
    em = host_data.get('emissivity')
    if em is None and kind in ('density1', 'density2'):
        rk = np.asarray(host_data['rhokap'], np.float64)
        em = rk if kind == 'density1' else rk * rk
    if em is None and kind == 'grid':
        # a 3-D FITS/HDF5 emissivity cube (sources.py:268-270)
        from ..io.reader import read_3d_any
        em = read_3d_any(par.emiss_file.strip())
    if em is None:
        raise ValueError(
            'diffuse_emissivity needs emiss_file or grid emissivity')
    prob = np.asarray(em, np.float64).reshape(-1)
    wgt = None
    if par.sampling_method > 0:
        prob, wgt = _composite_bias(prob, par.f_composite)
    else:
        prob = prob / prob.sum()
    pr, al = build_alias_table(prob)
    return SourceTables(kind='leaves' if meta.grid_type == 'amr' else 'cells',
                        prob=f32(pr), alias=i32(al), wgt=f32(wgt))


def sample_radius_loglog(u: torch.Tensor, tab: RadialTable) -> torch.Tensor:
    """The radius of uniforms u by log-log interpolation of the knots
    (sample_radius_loglog, sources.py:478)."""
    x = torch.log(torch.clamp_min(u, P_FLOOR))
    xp, fp = tab.log_p, tab.log_r
    n = xp.numel()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fma(delta / dx, df, fp[i - 1])
    f = torch.where(x < xp[0], fp[0], f)
    f = torch.where(x > xp[-1], fp[-1], f)
    return torch.exp(f)


def alias_bin(prob: torch.Tensor, alias: torch.Tensor, bits: torch.Tensor,
              u_alias: torch.Tensor) -> torch.Tensor:
    """The alias draw of a bin from 32 random bits (int64 tensor < 2^32)
    and a uniform: the bin (bits * n) >> 32, or its alias where u_alias >=
    its probability (samplers.py:287-293 with the integer bin); int64."""
    n = prob.numel()
    idx = (bits * n) >> 32
    return torch.where(u_alias >= prob[idx], alias[idx].long(), idx)


def sample_alias_linear(tabs: SourceTables, idx: torch.Tensor,
                        xi: torch.Tensor):
    """The profile's coordinate in bin idx, the linear density's inverse
    CDF of xi (uniform where the bin is flat), and its interpolated
    composite weight (or 1) (sample_alias_linear, sources.py:486): (x,
    wgt)."""
    x0, x1 = tabs.axis[idx], tabs.axis[idx + 1]
    p0, p1 = tabs.dens[idx], tabs.dens[idx + 1]
    dp = p1 - p0
    root = torch.sqrt(torch.clamp_min(p0 * p0 + (p1 * p1 - p0 * p0) * xi,
                                      0.0))
    x = torch.where(torch.abs(dp) > TINY_DP,
                    (root - p0) * (x1 - x0) / torch.where(dp == 0, 1.0, dp)
                    + x0, x0 + xi * (x1 - x0))
    if tabs.wgt is None:
        return x, torch.ones_like(x)
    w0, w1 = tabs.wgt[idx], tabs.wgt[idx + 1]
    return x, (w1 - w0) / torch.clamp_min(x1 - x0, TINY_DP) * (x - x0) + w0


def zexp_consts(par):
    """(-zs, c) of the truncated exponential in |z| up to zmax (rand_zexp,
    random_mt.f90:1208-1221; engine.py:2569-2575): |z| = -zs log1p(-u c),
    c = 1 - exp(-zmax / zs) in f64 rounded once, as lart_tpu's weak
    constants round them."""
    zs = par.source_zscale
    return float(np.float32(-zs)), float(np.float32(
        1.0 - math.exp(-par.zmax / zs)))


def zexp(u_a: torch.Tensor, u_b: torch.Tensor, neg_zs: float, c: float
         ) -> torch.Tensor:
    """The truncated exponential's z: its magnitude from u_a, its sign from
    u_b (negative below 0.5)."""
    zmag = neg_zs * torch.log1p(-(u_a * c))
    return torch.where(u_b < 0.5, -zmag, zmag)


# --------------------------------------------------------------------------
# the illumination sources (sources.py:300-474), plain versions
# --------------------------------------------------------------------------

# limb darkening polynomial I(mu)/I(0) = c0 + c1 mu + c2 mu^2 (the Sun at
# 200 nm; stellar_illumination.f90:48-55)
LIMB_COEFF = (0.55, 0.12, 0.33)
N_ROUNDS = 8          # the rejection rounds of every illumination sampler
LIMB_NORM = LIMB_COEFF[0] / 2.0 + LIMB_COEFF[1] / 3.0 + LIMB_COEFF[2] / 4.0


def _limb_poly(mu):
    """(c0 + c1 mu + c2 mu^2) mu / norm / 2 in lart_tpu's order of f32
    operations, on a tensor."""
    c0, c1, c2 = LIMB_COEFF
    t = (c0 + c1 * mu + c2 * mu * mu) * mu
    return div(div(t, LIMB_NORM), 2.0)


def limb_pmax(limb_model: int) -> float:
    """The rejection envelope of sample_limb_cost: 2.5 (Eddington), the
    polynomial at mu = 1 in f32 operations (models >= 3)."""
    if limb_model == 2:
        return 2.5
    f = np.float32
    c0, c1, c2 = (f(c) for c in LIMB_COEFF)
    one = f(1.0)
    return float((c0 + c1 * one + c2 * one * one) * one / f(LIMB_NORM)
                 / f(2.0))


def limb_wgt(limb_model: int, cos_ang: torch.Tensor) -> torch.Tensor:
    """The photon weight of the limb-darkening law at cos_ang
    (_limb_wgt, sources.py:304-320)."""
    if limb_model <= 0:
        return torch.ones_like(cos_ang)
    if limb_model == 1:          # Lambertian
        return 2.0 * cos_ang
    if limb_model == 2:          # Eddington
        return cos_ang * (1.5 * cos_ang + 1.0)
    return _limb_poly(cos_ang)


def sample_limb_cost(limb_model: int, xi: torch.Tensor) -> torch.Tensor:
    """cos theta of emission from the stellar surface under the limb law
    (sample_limb_cost, sources.py:322-351), weight 1: xi (n_rounds, 2, B);
    models 0 and 1 read xi[0, 0] alone (u and sqrt(u)), the others reject
    xi[r, 0] where xi[r, 1] pmax >= pdf(xi[r, 0]), 1 where every round
    rejects."""
    if limb_model <= 0:
        return xi[0, 0].clone()
    if limb_model == 1:
        return torch.sqrt(xi[0, 0])
    pmax = limb_pmax(limb_model)
    acc = torch.zeros_like(xi[0, 0], dtype=torch.bool)
    out = torch.ones_like(xi[0, 0])
    for rnd in range(xi.shape[0]):
        mu = xi[rnd, 0]
        pdf = mu * (1.5 * mu + 1.0) if limb_model == 2 else _limb_poly(mu)
        take = ~acc & (xi[rnd, 1] * pmax < pdf)
        out = torch.where(take, mu, out)
        acc = acc | take
    return out


@dataclasses.dataclass(frozen=True)
class Illumination:
    """The constants of an illumination source: 'stellar' (a star of
    radius Rs at distance D on the -z axis lighting the atmosphere sphere
    of radius rmax: the cone bounds cosvt_max and cost_max and the flux
    factor of a birth, flux_fac1; the limb model), 'point' (a point on
    the z axis at zs lighting the box's near face: dist_wall, costm,
    flux_fac1, the face zface and the box's x, y bounds) or 'plane'
    (plane_illumination: the top face of a plane atmosphere beaming -z,
    else the disk of radius rmax at zmin beaming +z over the azimuth
    dphi).  Values are f64 Python floats that the samplers round to f32
    where they use them, as lart_tpu's weak types do."""
    kind: str
    flux_fac1: float = 0.0
    Rs: float = 0.0
    D: float = 0.0
    rmax: float = 0.0
    cosvt_max: float = 0.0
    cost_max: float = 0.0
    limb: int = 0
    dist_wall: float = 0.0
    costm: float = 0.0
    below: bool = False
    zface: float = 0.0
    box: tuple = (0.0, 0.0, 0.0, 0.0)    # xmin, xmax, ymin, ymax
    top: bool = False        # plane: the top face of a plane atmosphere
    dphi: float = 0.0

    @classmethod
    def from_config(cls, cfg, meta) -> Optional['Illumination']:
        par = cfg.par
        sg = par.source_geometry.strip().lower()
        if sg == 'stellar_illumination':
            Rs, D = par.stellar_radius, par.distance_star_to_planet
            rmax = par.rmax if par.rmax > 0 else meta.xmax
            cosvt_max = (Rs - rmax) / D
            cost_max = math.sqrt(max(1.0 - (rmax / (D - Rs)) ** 2, 0.0))
            return cls(kind='stellar', Rs=Rs, D=D, rmax=rmax,
                       cosvt_max=cosvt_max, cost_max=cost_max,
                       flux_fac1=(1.0 - cosvt_max) * (1.0 - cost_max) / 2.0,
                       limb=int(par.stellar_limb_darkening))
        if sg == 'point_illumination':
            dist_wall = abs(par.zs_point) - meta.zmax
            alpha = meta.xmax / dist_wall
            beta = meta.ymax / dist_wall
            below = par.zs_point < 0.0
            return cls(kind='point', dist_wall=dist_wall,
                       flux_fac1=math.atan(alpha * beta / math.sqrt(
                           1.0 + alpha ** 2 + beta ** 2)) / math.pi,
                       costm=dist_wall / math.sqrt(
                           dist_wall ** 2 + meta.xmax ** 2 + meta.ymax ** 2),
                       below=below, zface=meta.zmin if below else meta.zmax,
                       box=(meta.xmin, meta.xmax, meta.ymin, meta.ymax))
        if sg == 'plane_illumination':
            top = par.geometry.strip().lower() == 'plane_atmosphere'
            return cls(kind='plane', top=top,
                       zface=par.zmax if top else meta.zmin,
                       rmax=meta.xmax if par.rmax <= 0 else par.rmax,
                       dphi=0.5 * math.pi if par.xy_symmetry
                       else 2.0 * math.pi)
        return None

    @property
    def n_uniforms(self) -> int:
        """Uniforms a rejection round reads."""
        return 4 if self.kind == 'stellar' else 2


def sample_stellar_illumination(il: Illumination, xi: torch.Tensor):
    """Births on the atmosphere sphere lit by a finite star
    (sample_stellar_illumination, sources.py:354-418; the reference's
    random_stellar_illumination1, stellar_illumination.f90:313-470) from
    xi (n_rounds, 4, B): (x, y, z, kx, ky, kz, wgt, flux_factor,
    nrejected)."""
    c1 = 1.0 - il.cosvt_max
    t1 = 1.0 - il.cost_max
    rmax2 = il.rmax * il.rmax
    shape = xi[0, 0]
    acc = torch.zeros_like(shape, dtype=torch.bool)
    nrej = torch.zeros_like(shape)
    x_, y_, z_, kx_, ky_, kz_, ca_ = (torch.zeros_like(shape)
                                      for _ in range(7))
    for rnd in range(xi.shape[0]):
        u = xi[rnd]
        cosvt = c1 * u[0] + il.cosvt_max
        sinvt = torch.sqrt(torch.clamp_min(1.0 - cosvt * cosvt, 0.0))
        vphi = TWOPI * u[1]
        x0 = sinvt * torch.cos(vphi)
        y0 = sinvt * torch.sin(vphi)
        z0 = cosvt
        x = il.Rs * x0
        y = il.Rs * y0
        z = il.Rs * z0 - il.D
        rr = torch.sqrt(x * x + y * y + z * z)
        kx0, ky0, kz0 = -x / rr, -y / rr, -z / rr
        cost = t1 * u[2] + il.cost_max
        sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
        phi = TWOPI * u[3]
        cosp, sinp = torch.cos(phi), torch.sin(phi)
        kr = torch.sqrt(torch.clamp_min(kx0 * kx0 + ky0 * ky0, 1e-24))
        kx = cost * kx0 + sint * (kz0 * kx0 * cosp - ky0 * sinp) / kr
        ky = cost * ky0 + sint * (kz0 * ky0 * cosp + kx0 * sinp) / kr
        kz = cost * kz0 - sint * cosp * kr
        r_dot_k = x * kx + y * ky + z * kz
        det = r_dot_k * r_dot_k - (rr * rr - rmax2)
        cos_ang = x0 * kx + y0 * ky + z0 * kz
        ok = (cos_ang >= 0.0) & (det >= 0.0)
        dist = -r_dot_k - torch.sqrt(torch.clamp_min(det, 0.0))
        take = ~acc & ok
        x_ = torch.where(take, x + kx * dist, x_)
        y_ = torch.where(take, y + ky * dist, y_)
        z_ = torch.where(take, z + kz * dist, z_)
        kx_ = torch.where(take, kx, kx_)
        ky_ = torch.where(take, ky, ky_)
        kz_ = torch.where(take, kz, kz_)
        ca_ = torch.where(take, cos_ang, ca_)
        nrej = nrej + (~acc & ~ok).to(nrej.dtype)
        acc = acc | ok
    # stragglers: aim at the planet centre from the sub-planet point
    strag = ~acc
    zero, one = torch.zeros_like(shape), torch.ones_like(shape)
    x_ = torch.where(strag, zero, x_)
    y_ = torch.where(strag, zero, y_)
    z_ = torch.where(strag, torch.full_like(shape, -il.rmax), z_)
    kx_ = torch.where(strag, zero, kx_)
    ky_ = torch.where(strag, zero, ky_)
    kz_ = torch.where(strag, one, kz_)
    ca_ = torch.where(strag, one, ca_)
    wgt = limb_wgt(il.limb, ca_)
    return x_, y_, z_, kx_, ky_, kz_, wgt, il.flux_fac1 * wgt, nrej


def sample_point_illumination(il: Illumination, xi: torch.Tensor):
    """Births on the box's near z face lit by a point source on the z axis
    (sample_point_illumination, sources.py:421-474; the reference's
    random_point_illumination, point_illumination.f90:15-120) from xi
    (n_rounds, 2, B): (x, y, z, kx, ky, kz, wgt, flux_factor,
    nrejected)."""
    xmin, xmax, ymin, ymax = (float(np.float32(v)) for v in il.box)
    c1 = 1.0 - il.costm
    dw = torch.full((), il.dist_wall, dtype=xi.dtype, device=xi.device)
    shape = xi[0, 0]
    acc = torch.zeros_like(shape, dtype=torch.bool)
    nrej = torch.zeros_like(shape)
    x_, y_, kx_, ky_ = (torch.zeros_like(shape) for _ in range(4))
    cz_ = torch.ones_like(shape)
    for rnd in range(xi.shape[0]):
        u = xi[rnd]
        cost = u[0] * c1 + il.costm
        sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
        phi = TWOPI * u[1]
        kx = sint * torch.cos(phi)
        ky = sint * torch.sin(phi)
        dist = dw / cost
        x = dist * kx
        y = dist * ky
        ok = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
        take = ~acc & ok
        x_ = torch.where(take, x, x_)
        y_ = torch.where(take, y, y_)
        kx_ = torch.where(take, kx, kx_)
        ky_ = torch.where(take, ky, ky_)
        cz_ = torch.where(take, cost, cz_)
        nrej = nrej + (~acc & ~ok).to(nrej.dtype)
        acc = acc | ok
    # stragglers: straight down the axis
    strag = ~acc
    zero = torch.zeros_like(shape)
    x_ = torch.where(strag, zero, x_)
    y_ = torch.where(strag, zero, y_)
    kx_ = torch.where(strag, zero, kx_)
    ky_ = torch.where(strag, zero, ky_)
    cz_ = torch.where(strag, torch.ones_like(shape), cz_)
    z = torch.full_like(shape, il.zface)
    kz = cz_ if il.below else -cz_
    wgt = torch.ones_like(shape)
    return x_, y_, z, kx_, ky_, kz, wgt, il.flux_fac1 * wgt, nrej


def sample_plane_illumination(il: Illumination, u0: torch.Tensor,
                              u1: torch.Tensor):
    """plane_illumination's births (gen_position, engine.py:2645-2660;
    random_plane_illumination, generate_photon.f90:729-813): (x, y, z,
    kz); the top face's centre of a plane atmosphere beaming -z, else a
    uniform point of the disk of radius rmax at zmin (azimuth dphi u1)
    beaming +z."""
    if il.top:
        zero = torch.zeros_like(u0)
        return zero, zero.clone(), torch.full_like(u0, il.zface), -1.0
    rp = torch.sqrt(u0) * il.rmax
    phi = il.dphi * u1
    return (rp * torch.cos(phi), rp * torch.sin(phi),
            torch.full_like(u0, il.zface), 1.0)
