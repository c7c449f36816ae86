"""Table-driven source samplers: the exponential cylinder's radius.

Port of the part of lart_tpu/physics/sources.py that the
exponential_cylinder source needs: _monotone_pr (:69), inv_cdf_rexp (:77;
the inverse CDF of p(r) dr = r exp(-r) dr, the table equivalent of the
reference's rand_r1exp, src/random_mt.f90:1227-1260), the table of
build_sources (:241-243) and the log-log radius draw sample_radius_loglog
(:478).  The table is built on the host in f64 with scipy's gammainc, as
lart_tpu builds it, and lives on the device in f32 (SourceTables'
jnp.asarray).  The draw is jnp.interp of log(max(u, 1e-12)) over the f32
logs of the f32 knots (jax's _interp: the knot i = clip(searchsorted(xp, x,
'right'), 1, n - 1), fp[i-1] + (x - xp[i-1]) / dx df contracted into one
fused multiply-add, the end values outside the table), then exp.  The logs
of the knots are taken once here, by torch.log on the table's device: the
kernel (K2, csrc/refill.cu) and the plain version read the same ones.
The other source geometries (spheres, Sersic, star files, emissivity
fields, illumination) are not ported (engine.check_supported names them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..transport.flight import fma

P_FLOOR = float(np.float32(1e-12))     # jnp.maximum(u, 1e-12), weak f32


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


def build_sources(cfg, device) -> Optional[RadialTable]:
    """The radial table of an exponential_cylinder source (the radius in
    units of source_rscale up to source_rmax, times source_rscale), or
    None for a point source."""
    par = cfg.par
    sg = par.source_geometry.strip().lower()
    if sg != 'exponential_cylinder':
        return None
    p, r = inv_cdf_rexp(1, par.source_rmax / par.source_rscale)
    return RadialTable.from_knots(p, r * par.source_rscale, device)


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
