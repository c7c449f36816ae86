"""Refill: dead lanes are reborn from the photon budget (kernel K2).

Counterpart of make_refill / refill (lart_tpu/transport/engine.py:2557,
:2689) for a point source (source_geometry 'point' or ''), any extended
source of gen_position or an illumination (see below) with a Voigt,
voigt0, monochromatic, Gaussian, flat continuum, continuum+gaussian or
line_prof_file input spectrum in a medium static or moving, on a Cartesian
grid, on the octree AMR grid or in a clump medium.  A line
of type 2, 4, 5 or 6
starts from xfreq0 shifted to a branch (branch_init_shift, engine.py:
2919-2970; physics/line.py) by the two uniforms of block 3; the continuum
(engine.py:2804-2807) replaces the frequency, that shift included, by
xfreq_min + u (xfreq_max - xfreq_min), u the first uniform of block 2.
The Gaussian (engine.py:2799-2803) is xfreq0 + N(0, 1) sigma / vtherm,
sigma = gaussian_FWHM_vel / 2.35482 where that is set, else
gaussian_sigma_vel; the normal comes by Box-Muller from block 2 of the
lane's uniforms, which only the continuum also reads.  lart_tpu
divides it by D_loc / Dfreq_ref, the source cell's Doppler width over the
reference one, which is exactly 1 at uniform temperature.  A launched lane gets the source position, an isotropic direction,
its birth frequency, the forced-first-scattering phase FFS with its xi
stashed in tau_target, the birth snapshot, the resonance line's band
(iband 1; engine.py:2888), no shear-frame velocity (vfy_shear 0;
engine.py:2883), and the unpolarized Stokes
vector (Q = U = V = 0) with the reference triad m = (cos theta cos phi,
cos theta sin phi, -sin theta), n = (-sin phi, cos phi, 0) of its
direction (engine.py:2863-2873).  In a moving medium the
drawn frequency is a lab-frame one: unless comoving_source, the lane's
comoving frequency is xfreq - u1 with u1 = v(source cell) . k
(engine.py:2836-2841); Jin is tallied at the lab frequency xfreq + u1.

On the octree AMR grid (engine.py:2755-2775, :2839) the source cell is
the node amr_find_cell gives the source position, found per lane (K2 does
it on the card); its leaf's velocity gives u1 and, at non-uniform
temperature, its damping the Voigt spectrum's a and its Doppler width
D_loc the Gaussian's and the continuum's divisor D_loc / Dfreq_ref and
Jin's lab frequency (x + u1) D_loc / Dfreq_ref.  A Cartesian grid at
non-uniform temperature (a temp_file) does the same with the birth cell's
a and D (engine.py:2771-2775): the point source's fixed cell's, an
extended source's per birth from the grid's per-cell arrays; D_loc also
sets the branch shift's offsets.

On a clump medium (engine.py:2750-2772) the birth cell is the clump
clump_find gives the source position (-1 in the vacuum between clumps),
found per lane (K2 does it on the card, csrc/clump.cuh); photons carry
global frequencies, so the spectrum is drawn at the reference damping and
Doppler width, and u1 is the birth clump's bulk velocity along k in
reference units (cell_velocity_dot: u.k times Dfreq_cl / Dfreq_ref).

`refill_plain` ranks dead lanes by a cumsum, as the JAX version does;
kernel K2 (csrc/refill.cu) hands out tickets by warp instead, so when the
budget runs out the two may launch different dead lanes, always the same
number.  A launched lane draws its uniforms from Philox at counter
(lane, counter, block), so both launch it with the same values.

With peel-off on, the refill also writes the flag of a PeelRecord: 1 on
the lanes it launched, 0 elsewhere, so that the direct peel of the
newborn photons (kernel K7, engine.py:2909-2913) runs on exactly those.

The extended sources (gen_position, engine.py:2577-2687) draw each
birth's position from the uniforms of block 4 and, where they need more,
the words of block 5, after every earlier block, so a point source draws
as before.  K2 has one instance per family of sources:
- radial table (`exponential_cylinder`, `exponential_sphere`, `sersic`,
  `ssh`): the radius from the log-log table of physics/sources.py (u0),
  then for the cylinder the azimuth 2 pi u1 and z from the truncated
  exponential in |z| up to zmax (_zexp, :2569-2575; magnitude u2, sign
  u3) or, with source_zscale <= 0, uniform over the box (zmin + zrange
  u2); for the others a point on the sphere of that radius (_iso_sphere,
  :2563: cos theta 2 u1 - 1, azimuth 2 pi u2);
- analytic volume: `uniform_sphere`/`sphere` (radius u0^(1/3) rmax,
  powf as samplers.cbrt, on the sphere of u1, u2), `uniform_cylinder`/
  `cylinder` (radius sqrt(u0) rmax, azimuth 2 pi u1, z uniform over the
  box from u2), `uniform` (the box from u0, u1, u2), `uniform_xy` (the
  disk of radius source_rmax, or the box, from u0, u1 at z = 0),
  `gaussian` (x, y over the box, z = source_zscale / sqrt(2) times a
  normal drawn by Box-Muller from words 0 and 1 of block 5), `exponential`
  (x, y over the box, z from _zexp); this instance also runs a point
  source whose spectrum is `voigt0` or `continuum+gaussian`;
- alias table (`star_file`, `diffuse_emissivity`): the bin from word 0 of
  block 5 as (bits n) >> 32 and its alias where the uniform of word 1
  reaches its probability (physics/sources.py alias_bin); a star's
  position, a uniform point in a Cartesian cell (the flat C-order index
  idx: ic = idx // (ny nz), jc = (idx // nz) % ny, kc = idx % nz, then
  xmin + (ic + u1) dx, ...) or an AMR leaf (its centre + (2 u - 1) its
  half-size, u1, u2, u3), or the radius of a 1-D profile
  (sample_alias_linear: the linear density's inverse CDF within the bin
  of the uniform of word 2) on the sphere of u1, u2.
With xyz_symmetry every non-point position is taken in absolute value
(:2722-2723).  The birth cell is then the lane's own: on a Cartesian grid
clip(floor((x - xmin) / dx)) per axis (:2759-2765), its velocity gathered
per lane in a moving medium; on the AMR grid and the clump medium the
lookups above run at the lane's position.

The birth weight (engine.py:2876, :2843-2850) is the star's, cell's or
leaf's composite weight, or the profile's weight interpolated at the drawn
radius, where sampling_method > 0 biased the table, else 1; it is written
into the lane's wgt and added into Jin.  A plane atmosphere's 1-D profile
(GEOM_PROFILE_PLANE, engine.py:2661-2667) draws the height and puts it at
a uniform point of the box's x-y extent (u0, u1).

The illuminations are K2's fifth instance, `refill_illum` (engine.py:
2707-2719, physics/sources.py's samplers): stellar_illumination and
point_illumination draw position and direction by their rejection rounds,
round r from the four uniforms of block BLOCK_ILLUM + r, the birth weight
being the limb weight; their flux factors and rejected rounds over the
launched lanes go into the tallies flux_factor and nrejected
(engine.py:2900-2908).  plane_illumination (engine.py:2645-2660) births at
the top face of a plane atmosphere beaming -z, else on the disk of radius
rmax at zmin (u0, u1 of block 4) beaming +z.  A beamed birth's triad is
its direction's (cos theta = kz, cos phi = kx / sin theta; engine.py:
2740-2749).  With peel-off, a stellar source's birth also draws its one
limb-darkened surface sample for the stellar direct peel (cos theta by
sample_limb_cost's rounds, two a block from BLOCK_LIMB, vphi from the
block after them) into the record's limb_cost and limb_vphi.  The
line_prof_file spectrum (engine.py:2826-2834), in every instance, is the
profile's alias bin from the 32 bits of word 0 of block 2 (its alias by
word 1), uniform within the bin by word 2, divided by D_loc / Dfreq_ref;
it replaces the frequency, a branch shift too.  The voigt0 spectrum (:2783)
draws a Voigt x at the source temperature's damping va0 and scales it by
Dfreq0 / D_loc; continuum+gaussian (:2808) takes the line with probability
f_line = EW_vel / (EW_vel + dv_range) (the uniform of word 2 of block 2)
as xfreq0 + a Box-Muller normal (words 0, 1) times sigma_x, else the flat
continuum (word 3), all divided by D_loc / Dfreq_ref.

With save_all_photons (tallies.allph, transport/allph.py) a launched lane
takes the photon id pid_base + n_launched + its rank among the dead lanes
(engine.py:2884-2885; K2 gives it its warp ticket, the same set of ids in
another lane order), starts with no scattering events and writes its birth
row: the impact parameter of its birth ray and its comoving birth
frequency (engine.py:2890-2899).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..config import vtherm_total
from ..constants import FOURPI, SPEEDC, UM2KM
from ..kernels import build as kbuild
from ..physics import line as pline
from ..physics.rng import STREAM_REFILL, to_uniform, uniforms, words
from ..physics.samplers import TWOPI, box_muller, cbrt, rand_voigt_x
from ..physics.sources import (N_ROUNDS, Illumination, LineProfTable,
                               SourceTables, alias_bin, build_sources,
                               emiss_kind, limb_pmax, sample_alias_linear,
                               sample_limb_cost, sample_plane_illumination,
                               sample_point_illumination,
                               sample_radius_loglog,
                               sample_stellar_illumination, zexp,
                               zexp_consts)
from .allph import record_births
from .flight import AmrGrid, ClumpGrid, div, doppler_ratio, fma
from .state import DEAD, FFS, BatchState, Tallies

SPECTRUM_MONO, SPECTRUM_VOIGT, SPECTRUM_GAUSS, SPECTRUM_CONT = 0, 1, 2, 3
SPECTRUM_VOIGT0, SPECTRUM_CONT_GAUSS, SPECTRUM_LINE_PROF = 4, 5, 6
SPECTRA = {'monochromatic': SPECTRUM_MONO, 'voigt': SPECTRUM_VOIGT,
           'gaussian': SPECTRUM_GAUSS, 'continuum': SPECTRUM_CONT,
           'voigt0': SPECTRUM_VOIGT0,
           'continuum+gaussian': SPECTRUM_CONT_GAUSS,
           'line_prof_file': SPECTRUM_LINE_PROF}
BLOCK_SPECTRUM = 2   # the spectrum's uniforms (and the profile's alias bits)
BLOCK_SOURCE = 4     # the Philox block of an extended source's position
BLOCK_SOURCE2 = 5    # its normal (gaussian) or its alias draw
BLOCK_ILLUM = 6      # round r of an illumination sampler: block 6 + r
BLOCK_LIMB = 14      # the stellar peel's limb rounds (two a block) and vphi

# K2's instances (csrc/refill.cu kSrc), each counted under its own name
FAMILY_POINT, FAMILY_RADIAL, FAMILY_VOLUME, FAMILY_ALIAS, FAMILY_ILLUM = \
    range(5)
REFILL_KERNELS = ('refill_point', 'refill_radial', 'refill_volume',
                  'refill_alias', 'refill_illum')
(GEOM_POINT, GEOM_EXP_CYLINDER, GEOM_RADIAL_SPHERE, GEOM_UNIFORM_SPHERE,
 GEOM_CYLINDER, GEOM_BOX, GEOM_XY_DISK, GEOM_XY_BOX, GEOM_GAUSSIAN,
 GEOM_EXPONENTIAL, GEOM_STARS, GEOM_CELLS, GEOM_LEAVES,
 GEOM_PROFILE, GEOM_PROFILE_PLANE, GEOM_STELLAR, GEOM_POINT_ILLUM,
 GEOM_PLANE_ILLUM) = range(18)
GEOMETRIES = {
    'point': GEOM_POINT, '': GEOM_POINT,
    'exponential_cylinder': GEOM_EXP_CYLINDER,
    'exponential_sphere': GEOM_RADIAL_SPHERE, 'sersic': GEOM_RADIAL_SPHERE,
    'ssh': GEOM_RADIAL_SPHERE,
    'uniform_sphere': GEOM_UNIFORM_SPHERE, 'sphere': GEOM_UNIFORM_SPHERE,
    'uniform_cylinder': GEOM_CYLINDER, 'cylinder': GEOM_CYLINDER,
    'uniform': GEOM_BOX, 'uniform_xy': GEOM_XY_BOX,
    'gaussian': GEOM_GAUSSIAN, 'exponential': GEOM_EXPONENTIAL,
    'star_file': GEOM_STARS, 'diffuse_emissivity': GEOM_CELLS,
    'stellar_illumination': GEOM_STELLAR,
    'point_illumination': GEOM_POINT_ILLUM,
    'plane_illumination': GEOM_PLANE_ILLUM}


def family_of(geom: int) -> int:
    if geom in (GEOM_EXP_CYLINDER, GEOM_RADIAL_SPHERE):
        return FAMILY_RADIAL
    if geom >= GEOM_STELLAR:
        return FAMILY_ILLUM
    if geom >= GEOM_STARS:
        return FAMILY_ALIAS
    return FAMILY_VOLUME


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class SourceC(ctypes.Structure):
    """csrc/refill.cu struct SourceC, field for field."""
    _fields_ = [('geom', _I), ('log_p', _P), ('log_r', _P), ('n', _I),
                ('zexp', _I), ('neg_zs', _F), ('zexp_c', _F), ('rmax', _F),
                ('zgauss', _F), ('abs_xyz', _I), ('cells', _I * 3),
                ('amin', _F * 3), ('d', _F * 3), ('span', _F * 3),
                ('prob', _P), ('alias', _P), ('nbin', _I), ('wgt', _P),
                ('px', _P), ('py', _P), ('pz', _P), ('ph', _P),
                ('va0', _F), ('dfreq0', _F), ('f_line', _F),
                ('Rs', _F), ('Dsp', _F), ('atm_r', _F), ('atm_r2', _F),
                ('cosvt_c1', _F), ('cosvt_max', _F), ('cost_c1', _F),
                ('cost_max', _F), ('flux_fac1', _F), ('limb', _I),
                ('limb_pmax', _F), ('dist_wall', _F), ('costm_c1', _F),
                ('costm', _F), ('zface', _F), ('ibox', _F * 4),
                ('below', _I), ('dphi', _F)]


class ProfC(ctypes.Structure):
    """csrc/refill.cu struct ProfC: the line_prof_file spectrum's table."""
    _fields_ = [('prob', _P), ('alias', _P), ('edges', _P), ('n', _I)]


def iso_sphere(rp, xi1, xi2):
    """A point on the sphere of radius rp from two uniforms (_iso_sphere,
    engine.py:2563)."""
    cost = 2.0 * xi1 - 1.0
    sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
    phi = TWOPI * xi2
    return rp * sint * torch.cos(phi), rp * sint * torch.sin(phi), rp * cost


@dataclasses.dataclass(frozen=True, eq=False)
class Source:
    """An extended source (or a point source in the volume instance): its
    geometry, its tables (physics/sources.py SourceTables), the radius of
    the uniform sphere, cylinder and disk, the z laws (zexp (-zs, c) of
    the truncated exponential, or None for uniform z over the box; the
    Gaussian's zscale / sqrt(2)), xyz_symmetry, the box (amin, span) and the
    Cartesian grid's cells (n, amin, d) a birth's cell is found in, and
    on the AMR grid the leaves' centres and half-sizes; the constants of
    the voigt0 and continuum+gaussian spectra ride here too."""
    geom: int
    tabs: Optional[SourceTables]
    rmax: float
    zexp: Optional[tuple]
    zgauss: float
    abs_xyz: bool
    n: tuple
    amin: tuple
    d: tuple
    span: tuple
    leaves: Optional[tuple] = None
    va0: float = 0.0
    dfreq0: float = 1.0
    f_line: float = 0.0
    illum: Optional[Illumination] = None   # an illumination's constants

    @property
    def family(self) -> int:
        return family_of(self.geom)

    @property
    def table(self):
        """The radial table, or None."""
        return None if self.tabs is None else self.tabs.table

    @classmethod
    def from_config(cls, cfg, meta, grid=None, host_data=None,
                    device='cpu') -> Optional['Source']:
        """The config's source, or None for a point source with one of the
        spectra the point instance draws (monochromatic, voigt, gaussian,
        continuum, line_prof_file)."""
        par, line = cfg.par, cfg.line
        sg = par.source_geometry.strip().lower()
        st = par.spectral_type.strip().lower()
        geom = GEOMETRIES[sg]
        if geom == GEOM_POINT and SPECTRA[st] not in (SPECTRUM_VOIGT0,
                                                      SPECTRUM_CONT_GAUSS):
            return None
        if sg == 'uniform_xy' and par.source_rmax > 0:
            geom = GEOM_XY_DISK
        leaves = None
        if geom == GEOM_CELLS:
            if emiss_kind(par) == 'profile':
                # a 1-D profile: the radius of a sphere, or the height of
                # a plane atmosphere (engine.py:2661-2667)
                geom = GEOM_PROFILE_PLANE if par.geometry.strip().lower() \
                    == 'plane_atmosphere' else GEOM_PROFILE
            elif meta.grid_type == 'amr':
                geom = GEOM_LEAVES
                leaves = (grid.leaf_cx, grid.leaf_cy, grid.leaf_cz,
                          grid.leaf_ch)
        tabs = build_sources(cfg, meta, host_data, device)
        zexp_c = zexp_consts(par) if geom in (
            GEOM_EXP_CYLINDER, GEOM_EXPONENTIAL) and par.source_zscale > 0 \
            else None
        rmax = par.source_rmax if geom == GEOM_XY_DISK else (
            par.source_rmax if par.source_rmax > 0 else par.rmax)
        va0, dfreq0, f_line = 0.0, 1.0, 0.0
        if st == 'voigt0':
            # the source temperature's Doppler width and damping
            # (generate_photon.f90:249-252, setup.f90:140-142)
            T0 = par.temperature0 if par.temperature0 > 0 \
                else par.temperature
            vth0 = vtherm_total(par, line, T0)
            dfreq0 = par.Dfreq0 if par.Dfreq0 > 0 \
                else vth0 / (line.wavelength0 * UM2KM)
            va0 = par.voigt_a0 if par.voigt_a0 > 0 \
                else (line.damping / FOURPI) / dfreq0
        elif st == 'continuum+gaussian':
            # the line's share of the flat continuum + Gaussian line by its
            # equivalent width (generate_photon.f90:275-305)
            ew_vel = par.EW_line / (line.wavelength0 * 1e4) * SPEEDC
            dv_range = (meta.xfreq_max - meta.xfreq_min) * cfg.vtherm
            f_line = ew_vel / (ew_vel + dv_range)
        f32 = np.float32
        return cls(geom=geom, tabs=tabs, rmax=float(f32(rmax)),
                   zexp=zexp_c,
                   zgauss=float(f32(par.source_zscale / math.sqrt(2.0))),
                   abs_xyz=bool(par.xyz_symmetry) and geom != GEOM_POINT,
                   n=(meta.nx, meta.ny, meta.nz),
                   amin=(meta.xmin, meta.ymin, meta.zmin),
                   d=(meta.dx, meta.dy, meta.dz),
                   span=(meta.xmax - meta.xmin, meta.ymax - meta.ymin,
                         meta.zmax - meta.zmin),
                   leaves=leaves, va0=float(f32(va0)),
                   dfreq0=float(f32(dfreq0)), f_line=float(f32(f_line)),
                   illum=Illumination.from_config(cfg, meta))

    def _box(self, u, axis):
        return fma(u, self.span[axis], self.amin[axis])

    def position(self, seed, lanes, counter, point):
        """The birth positions (x, y, z) and weights (None: all 1) of
        lanes, from the uniforms of block 4 (and words of block 5); point
        is the point source's (x, y, z)."""
        g = self.geom
        if g == GEOM_POINT:
            return (*point, None)
        w = uniforms(seed, STREAM_REFILL, lanes, counter, BLOCK_SOURCE)
        wgt = None
        if g in (GEOM_EXP_CYLINDER, GEOM_RADIAL_SPHERE):
            rp = sample_radius_loglog(w[0], self.table)
            if g == GEOM_RADIAL_SPHERE:
                x, y, z = iso_sphere(rp, w[1], w[2])
            else:
                phi = TWOPI * w[1]
                x, y = rp * torch.cos(phi), rp * torch.sin(phi)
                z = zexp(w[2], w[3], *self.zexp) if self.zexp is not None \
                    else self._box(w[2], 2)
        elif g == GEOM_UNIFORM_SPHERE:
            x, y, z = iso_sphere(cbrt(w[0]) * self.rmax, w[1], w[2])
        elif g in (GEOM_CYLINDER, GEOM_XY_DISK):
            rp = torch.sqrt(w[0]) * self.rmax
            phi = TWOPI * w[1]
            x, y = rp * torch.cos(phi), rp * torch.sin(phi)
            z = self._box(w[2], 2) if g == GEOM_CYLINDER \
                else torch.zeros_like(rp)
        elif g in (GEOM_BOX, GEOM_XY_BOX, GEOM_GAUSSIAN, GEOM_EXPONENTIAL):
            x, y = self._box(w[0], 0), self._box(w[1], 1)
            if g == GEOM_BOX:
                z = self._box(w[2], 2)
            elif g == GEOM_XY_BOX:
                z = torch.zeros_like(x)
            elif g == GEOM_GAUSSIAN:
                v = uniforms(seed, STREAM_REFILL, lanes, counter,
                             BLOCK_SOURCE2)
                z = self.zgauss * box_muller(v[0], v[1])
            else:
                z = zexp(w[2], w[3], *self.zexp)
        else:
            t = self.tabs
            bits = words(seed, STREAM_REFILL, lanes, counter, BLOCK_SOURCE2)
            idx = alias_bin(t.prob, t.alias, bits[0], to_uniform(bits[1]))
            if g == GEOM_PROFILE:
                rp, wgt = sample_alias_linear(t, idx, to_uniform(bits[2]))
                x, y, z = iso_sphere(rp, w[1], w[2])
            elif g == GEOM_PROFILE_PLANE:
                z, wgt = sample_alias_linear(t, idx, to_uniform(bits[2]))
                x, y = self._box(w[0], 0), self._box(w[1], 1)
            else:
                if t.wgt is not None:
                    wgt = t.wgt[idx]
                if g == GEOM_STARS:
                    x, y, z = t.x[idx], t.y[idx], t.z[idx]
                elif g == GEOM_LEAVES:
                    cx, cy, cz, ch = (v[idx] for v in self.leaves)
                    x, y, z = (fma(2.0 * u - 1.0, ch, c)
                               for u, c in zip(w[1:], (cx, cy, cz)))
                else:
                    nx, ny, nz = self.n
                    c = (idx // (ny * nz), (idx // nz) % ny, idx % nz)
                    x, y, z = (fma(ci.float() + u, d, a) for ci, u, d, a in
                               zip(c, w[1:], self.d, self.amin))
        if self.abs_xyz:
            x, y, z = torch.abs(x), torch.abs(y), torch.abs(z)
        return x, y, z, wgt

    def illuminate(self, seed, lanes, counter):
        """An illumination's births (sources.py:354-474, engine.py:
        2645-2660, :2707-2719): (x, y, z, (kx, ky, kz), wgt, flux factor,
        nrejected), the last two None for plane_illumination; the rounds
        of the stellar and point samplers read blocks BLOCK_ILLUM + r, the
        plane's disk words 0 and 1 of block 4."""
        il = self.illum
        if il.kind == 'plane':
            w = uniforms(seed, STREAM_REFILL, lanes, counter, BLOCK_SOURCE)
            x, y, z, kz = sample_plane_illumination(il, w[0], w[1])
            zero = torch.zeros_like(x)
            k = (zero, zero.clone(), torch.full_like(x, kz))
            wgt = ff = nrej = None
        else:
            xi = uniforms(seed, STREAM_REFILL, lanes, counter,
                          range(BLOCK_ILLUM, BLOCK_ILLUM + N_ROUNDS))
            sampler = sample_stellar_illumination if il.kind == 'stellar' \
                else sample_point_illumination
            x, y, z, kx, ky, kz, wgt, ff, nrej = sampler(
                il, xi[:, :il.n_uniforms])
            k = (kx, ky, kz)
        if self.abs_xyz:
            x, y, z = torch.abs(x), torch.abs(y), torch.abs(z)
        return x, y, z, k, wgt, ff, nrej

    def limb_sample(self, seed, lanes, counter):
        """The stellar direct peel's one limb-darkened surface sample of
        each lane, (cos theta, vphi) (peel.py:732-737): the rounds of
        sample_limb_cost from blocks BLOCK_LIMB.. (two a block), vphi = 2
        pi u from word 0 of block BLOCK_LIMB + 4."""
        w = uniforms(seed, STREAM_REFILL, lanes, counter,
                     range(BLOCK_LIMB, BLOCK_LIMB + N_ROUNDS // 2 + 1))
        xi = torch.stack([w[r // 2, 2 * (r % 2):2 * (r % 2) + 2]
                          for r in range(N_ROUNDS)])
        return (sample_limb_cost(self.illum.limb, xi),
                TWOPI * w[N_ROUNDS // 2, 0])

    def cells(self, pos):
        """The Cartesian cells (ic, jc, kc) holding the positions, clipped
        to the grid (engine.py:2759-2765)."""
        return tuple(torch.clamp(torch.floor(div(v - np.float32(a), d)), 0,
                                 n - 1).to(torch.int32)
                     for v, a, d, n in zip(pos, self.amin, self.d, self.n))

    @functools.cached_property
    def c_struct(self) -> SourceC:
        c = SourceC()
        c.geom = self.geom
        if self.table is not None:
            c.log_p, c.log_r = (t.data_ptr() for t in self.table.tensors())
            c.n = self.table.n
        c.zexp = int(self.zexp is not None)
        if self.zexp is not None:
            c.neg_zs, c.zexp_c = self.zexp
        c.rmax, c.zgauss = self.rmax, self.zgauss
        c.abs_xyz = int(self.abs_xyz)
        c.cells[:] = self.n
        c.amin[:] = self.amin
        c.d[:] = self.d
        c.span[:] = self.span
        t = self.tabs
        if t is not None and t.prob is not None:
            c.prob, c.alias = t.prob.data_ptr(), t.alias.data_ptr()
            c.nbin = t.nbin
            c.wgt = None if t.wgt is None else t.wgt.data_ptr()
            # the stars' positions, the leaves' centres and half-sizes, or
            # the profile's axis and density
            pts = {'stars': (t.x, t.y, t.z, None),
                   'leaves': self.leaves or (None,) * 4,
                   'profile': (t.axis, t.dens, None, None)}.get(
                       t.kind, (None,) * 4)
            c.px, c.py, c.pz, c.ph = (None if v is None else v.data_ptr()
                                      for v in pts)
        c.va0, c.dfreq0, c.f_line = self.va0, self.dfreq0, self.f_line
        il = self.illum
        if il is not None:
            c.Rs, c.Dsp, c.atm_r, c.atm_r2 = il.Rs, il.D, il.rmax, \
                il.rmax * il.rmax
            c.cosvt_c1, c.cosvt_max = 1.0 - il.cosvt_max, il.cosvt_max
            c.cost_c1, c.cost_max = 1.0 - il.cost_max, il.cost_max
            c.flux_fac1, c.limb = il.flux_fac1, il.limb
            c.limb_pmax = limb_pmax(il.limb) if il.limb >= 2 else 1.0
            c.dist_wall, c.costm_c1, c.costm = il.dist_wall, \
                1.0 - il.costm, il.costm
            c.zface, c.ibox[:], c.below = il.zface, il.box, int(il.below)
            c.dphi = il.dphi if not il.top else -1.0
        return c

    def tensors(self):
        return (() if self.tabs is None else self.tabs.tensors()) \
            + (self.leaves or ())


@dataclasses.dataclass(frozen=True)
class RefillParams:
    xs: float
    ys: float
    zs: float
    ic: int
    jc: int
    kc: int
    xfreq0: float
    spectrum: int        # SPECTRUM_MONO, _VOIGT, ... or _CONT_GAUSS
    a: float             # Voigt damping parameter of the source cell
    xfreq_min: float
    dxfreq: float
    nxfreq: int
    v_src: tuple = (0.0, 0.0, 0.0)   # the source cell's velocity (f32)
    comoving_source: bool = True
    sigma_x: float = 0.0     # the Gaussian's (or the continuum+gaussian
    #   line's) sigma in Doppler units
    xfreq_span: float = 0.0  # the continuum's xfreq_max - xfreq_min
    Dfreq: float = 1.0       # the reference Doppler width (Hz)
    line: pline.LineConsts = None
    amr: Optional[AmrGrid] = None    # the octree, on an AMR grid
    vel: Optional[tuple] = None      # per-leaf velocities (AMR), or per
    #   cell for an extended source on a moving Cartesian grid
    clump: Optional[ClumpGrid] = None   # the clumps, on a clump medium
    source: Optional[Source] = None    # an extended source, or None for
    #   the point instance
    D_src: float = 1.0       # the point source's cell's Doppler width (Hz)
    grid_n: tuple = (1, 1, 1)   # (nx, ny, nz) of a Cartesian grid
    # a Cartesian grid at non-uniform temperature: each cell's damping and
    # Doppler width, flat; None at uniform temperature
    cell_a: Optional[torch.Tensor] = None
    cell_D: Optional[torch.Tensor] = None
    lp: Optional[LineProfTable] = None   # the line_prof_file spectrum
    # save_all_photons: the id of this device's first photon (lart_tpu's
    # n_shard offset, driver.py:108-118; 0 on one device)
    pid_base: int = 0

    @property
    def kernel(self) -> str:
        """The name of K2's instance that launches these births."""
        return REFILL_KERNELS[FAMILY_POINT if self.source is None
                              else self.source.family]

    @classmethod
    def from_config(cls, cfg, meta, grid=None, cmeta=None,
                    host_data=None) -> 'RefillParams':
        """Constants of a config that engine.check_supported accepted; the
        source cell's velocity comes from `grid` in a moving medium (on a
        clump medium grid is the ClumpDevice and cmeta its ClumpMeta);
        host_data is build_sources' (physics/sources.py)."""
        par = cfg.par
        f32 = np.float32
        pos = [f32(par.xs_point), f32(par.ys_point), f32(par.zs_point)]
        cells, v_src, amr, vel = [0, 0, 0], (0.0, 0.0, 0.0), None, None
        clump = cell_a = cell_D = None
        a_src, D_src = float(meta.voigt_a_ref), float(meta.Dfreq_ref)
        device = 'cpu' if grid is None else grid.rhokap.device
        source = Source.from_config(cfg, meta, grid, host_data, device)
        extended = source is not None and source.geom != GEOM_POINT
        if meta.grid_type == 'clump':
            # the births find their clump themselves (clump_find)
            clump = ClumpGrid.from_meta(cfg, meta, cmeta, grid)
        elif meta.grid_type == 'amr':
            # the births find their node themselves (amr_find_cell)
            amr = AmrGrid.from_meta(meta, grid)
            if not meta.static_medium:
                vel = (grid.vfx, grid.vfy, grid.vfz)
        else:
            for a, (p, amin, d, n) in enumerate(zip(
                    pos, (meta.xmin, meta.ymin, meta.zmin),
                    (meta.dx, meta.dy, meta.dz),
                    (meta.nx, meta.ny, meta.nz))):
                # f32 cell index with the edge clamp, as the JAX refill
                # computes it
                c = np.floor((p - f32(amin)) / f32(d))
                cells[a] = int(min(max(c, 0), n - 1))
            if not meta.static_medium and not extended:
                v_src = tuple(float(v[tuple(cells)])
                              for v in (grid.vfx, grid.vfy, grid.vfz))
            elif not meta.static_medium:
                # each birth gathers its own cell's velocity
                vel = tuple(v.reshape(-1).contiguous()
                            for v in (grid.vfx, grid.vfy, grid.vfz))
            if grid is not None and grid.Dfreq is not None:
                # non-uniform temperature: the source cell's a and D
                # (engine.py:2771-2775), each birth's own for an extended
                # source
                cell_a = grid.voigt_a.reshape(-1).contiguous()
                cell_D = grid.Dfreq.reshape(-1).contiguous()
                a_src = float(grid.voigt_a[tuple(cells)])
                D_src = float(grid.Dfreq[tuple(cells)])
        gsig = (par.gaussian_FWHM_vel / 2.3548200450309493
                if par.gaussian_FWHM_vel > 0 else par.gaussian_sigma_vel)
        if par.spectral_type.strip().lower() == 'continuum+gaussian':
            gsig = (par.gaussian_FWHM_vel if par.gaussian_FWHM_vel > 0
                    else 150.0) / 2.3548200450309493
        return cls(xs=float(pos[0]), ys=float(pos[1]), zs=float(pos[2]),
                   ic=cells[0], jc=cells[1], kc=cells[2],
                   xfreq0=float(par.xfreq0),
                   spectrum=SPECTRA[par.spectral_type.strip().lower()],
                   sigma_x=gsig / cfg.vtherm,
                   a=a_src, xfreq_min=meta.xfreq_min,
                   dxfreq=meta.dxfreq, nxfreq=meta.nxfreq, v_src=v_src,
                   comoving_source=bool(par.comoving_source),
                   xfreq_span=pline.f32(meta.xfreq_max - meta.xfreq_min),
                   Dfreq=meta.Dfreq_ref,
                   line=pline.LineConsts.from_config(cfg), amr=amr, vel=vel,
                   clump=clump, source=source, D_src=D_src,
                   grid_n=(meta.nx, meta.ny, meta.nz), cell_a=cell_a,
                   cell_D=cell_D,
                   lp=LineProfTable.from_config(cfg, device)
                   if par.spectral_type.strip().lower() == 'line_prof_file'
                   else None)

    @functools.cached_property
    def prof_struct(self) -> Optional[ProfC]:
        if self.lp is None:
            return None
        c = ProfC()
        c.prob, c.alias, c.edges = (t.data_ptr() for t in self.lp.tensors())
        c.n = self.lp.n
        return c

    @property
    def illumination(self) -> bool:
        """A stellar or point illumination: the births sum their flux
        factors and rejected draws."""
        return self.source is not None and self.source.geom in (
            GEOM_STELLAR, GEOM_POINT_ILLUM)


def refill_plain(state: BatchState, tallies: Tallies, p: RefillParams,
                 seed: int, counter: int, budget: int, record=None) -> None:
    """Plain PyTorch refill, in place; `record.flag` marks the launched
    lanes when a PeelRecord is given."""
    if int(state.n_launched[0]) >= budget:
        # the budget is launched: no lane is reborn (the drain tail)
        if record is not None:
            record.flag.zero_()
        return
    B, dev = state.batch, state.device
    dead = state.phase == DEAD
    rank = torch.cumsum(dead.to(torch.int32), 0) - 1
    launch = dead & (rank < budget - state.n_launched[0])
    n_new = launch.sum(dtype=torch.int32)

    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    # the source cell (on the AMR grid its node, amr_find_cell; on a clump
    # medium its clump, clump_find), its damping, Doppler width and
    # velocity (engine.py:2750-2775)
    a_loc, D_loc, v_src = p.a, p.Dfreq, p.v_src
    cell = (p.ic, p.jc, p.kc)
    src = [torch.full((B,), v, dtype=torch.float32, device=dev)
           for v in (p.xs, p.ys, p.zs)]
    wgt = None     # the birth weight: 1 but for a composite-biased table
    kdir = ff = nrej = None     # an illumination's direction, flux, draws
    if p.source is not None and p.source.family == FAMILY_ILLUM:
        # an illumination: position, direction and limb weight by the
        # rejection rounds of blocks 6.. (engine.py:2707-2719)
        *src, kdir, wgt, ff, nrej = p.source.illuminate(seed, lanes,
                                                        counter)
    elif p.source is not None:
        # an extended source: each birth's own position (blocks 4, 5)
        *src, wgt = p.source.position(seed, lanes, counter, src)
    if p.source is not None:
        if p.clump is None and p.amr is None \
                and p.source.geom != GEOM_POINT:
            cell = p.source.cells(src)
            if p.vel is not None:
                f = (cell[0].long() * p.source.n[1] + cell[1]) \
                    * p.source.n[2] + cell[2]
                v_src = tuple(v[f] for v in p.vel)
    if p.clump is not None:
        cell = (p.clump.find(*src), 0, 0)
    elif p.cell_D is not None:
        # the birth cell's a and D at non-uniform temperature
        # (engine.py:2771-2775)
        f = (torch.as_tensor(cell[0], device=dev).long() * p.grid_n[1]
             + cell[1]) * p.grid_n[2] + cell[2]
        a_loc, D_loc = p.cell_a[f], p.cell_D[f]
    elif p.amr is not None:
        ic = p.amr.find_cell(*src)
        il = p.amr.leaf(ic)
        cell = (ic, 0, 0)
        a_loc, D_loc = p.amr.a_D(il, p.a, p.Dfreq)
        if p.vel is not None:
            v_src = tuple(p.amr.gather(v, il, 0.0) for v in p.vel)
    # D_loc / Dfreq_ref, exactly 1 at uniform temperature
    ratio = doppler_ratio(D_loc, p.Dfreq)
    u, v = uniforms(seed, STREAM_REFILL, lanes, counter, range(2))
    if kdir is None:
        # isotropic
        cost = 2.0 * u[0] - 1.0
        sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
        phi = TWOPI * u[1]
        cosp, sinp = torch.cos(phi), torch.sin(phi)
        kx, ky, kz = sint * cosp, sint * sinp, cost
    else:
        # beamed: the sampler's direction and its triad (engine.py:
        # 2740-2749)
        kx, ky, kz = kdir
        cost = kz
        sint = torch.sqrt(torch.clamp_min(1.0 - kz * kz, 0.0))
        safe = torch.clamp_min(sint, 1e-20)
        cosp = torch.where(sint > 0, kx / safe, torch.ones_like(kx))
        sinp = torch.where(sint > 0, ky / safe, torch.zeros_like(ky))

    xfreq = torch.full((B,), p.xfreq0, dtype=torch.float32, device=dev)
    if p.line.branch_init:
        w = uniforms(seed, STREAM_REFILL, lanes, counter, 3)
        xfreq = xfreq + pline.branch_init_shift_plain(p.line, w[0], w[1],
                                                      D_loc)
    if p.spectrum == SPECTRUM_VOIGT:
        a = torch.broadcast_to(a_loc, (B,)) if isinstance(
            a_loc, torch.Tensor) else torch.full((B,), a_loc,
                                                dtype=torch.float32,
                                                device=dev)
        xfreq = xfreq + rand_voigt_x(a, u[2], u[3], v[0])
    elif p.spectrum == SPECTRUM_GAUSS:
        w = uniforms(seed, STREAM_REFILL, lanes, counter, 2)
        xfreq = (xfreq + box_muller(w[0], w[1]) * p.sigma_x) / ratio
    elif p.spectrum == SPECTRUM_CONT:
        # replaces xfreq, the branch shift too (engine.py:2804-2807)
        w = uniforms(seed, STREAM_REFILL, lanes, counter, 2)
        xfreq = (p.xfreq_min + w[0] * p.xfreq_span) / ratio
    elif p.spectrum == SPECTRUM_VOIGT0:
        # a Voigt x at the source temperature, in local Doppler units
        dl = D_loc if isinstance(D_loc, torch.Tensor) else torch.full(
            (), D_loc, dtype=torch.float32, device=dev)
        scale = torch.div(torch.full((), p.source.dfreq0,
                                     dtype=torch.float32, device=dev), dl)
        xfreq = xfreq + rand_voigt_x(p.source.va0, u[2], u[3], v[0]) * scale
    elif p.spectrum == SPECTRUM_CONT_GAUSS:
        # the line with probability f_line, else the flat continuum
        w = uniforms(seed, STREAM_REFILL, lanes, counter, 2)
        xfreq = torch.where(w[2] < p.source.f_line,
                            xfreq + box_muller(w[0], w[1]) * p.sigma_x,
                            p.xfreq_min + w[3] * p.xfreq_span) / ratio
    elif p.spectrum == SPECTRUM_LINE_PROF:
        # the profile's alias bin, uniform within it; replaces xfreq, the
        # branch shift too (engine.py:2826-2834)
        bits = words(seed, STREAM_REFILL, lanes, counter, BLOCK_SPECTRUM)
        xfreq = p.lp.sample(bits[0], to_uniform(bits[1]),
                            to_uniform(bits[2])) / ratio

    # lab-frame source -> comoving frequency; Jin at the lab frequency
    if p.clump is not None:
        u1 = p.clump.vel_dot(cell[0].long(), kx, ky, kz, 'scale')
    else:
        u1 = v_src[0] * kx + v_src[1] * ky + v_src[2] * kz
    if not p.comoving_source:
        xfreq = xfreq - u1
    fx = torch.floor(div((xfreq + u1) * ratio - p.xfreq_min, p.dxfreq))
    inj = launch & (fx >= 0.0) & (fx < p.nxfreq)
    tallies.Jin.index_add_(0, torch.clamp(fx, 0, p.nxfreq - 1).long(),
                           inj.to(torch.float32) if wgt is None
                           else torch.where(inj, wgt, 0.0))

    def put(name, value):
        cur = getattr(state, name)
        cur.copy_(torch.where(launch, torch.as_tensor(value, dtype=cur.dtype,
                                                      device=dev), cur))

    put('phase', FFS)
    for nm, val in zip(('x', 'y', 'z'), src):
        put(nm, val)
        put('b' + nm, val)
    for nm, val in zip(('ic', 'jc', 'kc'), cell):
        put(nm, val)
        put('b' + nm, val)
    for nm, val in (('kx', kx), ('ky', ky), ('kz', kz), ('xfreq', xfreq)):
        put(nm, val)
        put('b' + nm, val)
    if tallies.allph is not None:
        # the photon's id by its rank among the dead lanes, no events yet,
        # and its birth row (engine.py:2884-2899)
        pid = p.pid_base + state.n_launched[0] + rank
        for nm, val in (('pid', pid), ('nsg', 0.0), ('nsd', 0.0)):
            put(nm, val)
        record_births(tallies.allph, launch, pid, *src, kx, ky, kz, xfreq)
    put('wgt', 1.0 if wgt is None else wgt)
    put('tau_target', v[1])
    put('tau_run', 0.0)
    for nm, val in (('Q', 0.0), ('U', 0.0), ('V', 0.0), ('mx', cost * cosp),
                    ('my', cost * sinp), ('mz', -sint), ('nnx', -sinp),
                    ('nny', cosp), ('nnz', 0.0), ('iband', 1),
                    ('vfy_shear', 0.0)):
        put(nm, val)
    state.n_launched += n_new
    if ff is not None:
        # transit bookkeeping over the launched lanes (engine.py:2900-2908)
        tallies.flux_factor += torch.where(launch, ff, 0.0).sum()
        tallies.nrejected += torch.where(launch, nrej, 0.0).sum()
    if record is not None:
        record.flag.copy_(launch.to(torch.int32))
        if p.source is not None and p.source.geom == GEOM_STELLAR:
            # the stellar direct peel's surface sample, shared by every
            # observer's pair (peel.py:732-737)
            cost_s, vphi = p.source.limb_sample(seed, lanes, counter)
            record.limb_cost.copy_(torch.where(launch, cost_s,
                                               record.limb_cost))
            record.limb_vphi.copy_(torch.where(launch, vphi,
                                               record.limb_vphi))


def refill(state: BatchState, tallies: Tallies, p: RefillParams, seed: int,
           counter: int, budget: int, record=None) -> None:
    """Launch min(#dead, budget - n_launched) lanes, in place: kernel K2
    for a CUDA state, the plain version for a CPU state.  `record`, a
    PeelRecord of the batch's size, receives the launch flags."""
    if state.device.type == 'cpu':
        refill_plain(state, tallies, p, seed, counter, budget, record)
        return
    if budget + state.batch >= 2 ** 31:
        raise ValueError('photon budget + batch must stay below 2^31')
    name = p.kernel
    kbuild.require_cuda(name, tallies.Jin, state.n_launched,
                        *(getattr(state, f) for f in ('phase', 'x')),
                        *(() if record is None else (record.flag,)),
                        *(() if p.amr is None else p.amr.dev.tensors()),
                        *(() if p.clump is None else p.clump.dev.tensors()),
                        *(() if p.source is None else p.source.tensors()),
                        *(p.vel or ()),
                        *(() if p.cell_D is None else (p.cell_a, p.cell_D)),
                        *(() if p.lp is None else p.lp.tensors()),
                        *((tallies.flux_factor, tallies.nrejected)
                          if p.illumination else ()),
                        *(tallies.allph.tensors()
                          if tallies.allph is not None else ()))
    kbuild.check(kbuild.library().lart_refill_point(
        state.lane_pointers, None if record is None else record.pointers,
        state.batch, state.n_launched.data_ptr(),
        int(budget), seed & 0xFFFFFFFF, counter & 0xFFFFFFFF,
        p.xs, p.ys, p.zs, p.ic, p.jc, p.kc, p.xfreq0, p.spectrum, p.sigma_x,
        p.a, *p.v_src, int(p.comoving_source), p.xfreq_min, p.dxfreq, p.nxfreq,
        tallies.Jin.data_ptr(), p.xfreq_span, p.Dfreq, p.D_src,
        ctypes.byref(p.line.c_struct),
        None if p.amr is None else ctypes.byref(p.amr.c_struct),
        None if p.clump is None else ctypes.byref(p.clump.c_struct),
        *(v.data_ptr() if v is not None else None
          for v in (p.vel or (None,) * 3)),
        *((None, None) if p.cell_D is None
          else (p.cell_a.data_ptr(), p.cell_D.data_ptr())),
        None if p.source is None else ctypes.byref(p.source.c_struct),
        None if p.lp is None else ctypes.byref(p.prof_struct),
        *((tallies.flux_factor.data_ptr(), tallies.nrejected.data_ptr())
          if p.illumination else (None, None)),
        None if tallies.allph is None
        else ctypes.byref(tallies.allph.c_struct), p.pid_base,
        kbuild.stream_of(state.x)),
        name)
    kbuild.LAUNCHES[name] += 1
