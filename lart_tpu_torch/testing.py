"""Inputs and comparisons shared by the tests and chip_smoke.py.

Everything random here is drawn with numpy from a seed, so the JAX
reference, the plain PyTorch versions and the CUDA kernels can be handed
the identical input.  The analytic sphere spectrum and its shape test are
jax-free copies of tools/acceptance.py's (which imports lart_tpu.driver,
and so jax).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .config import Params
from .transport.state import (AT_SCATTER, DEAD, FFS, FLYING, INT_FIELDS,
                              LANE_FIELDS, BatchState, init_state)


def slab_params(tau0: float = 100.0, nz: int = 101, nphotons: int = 10_000,
                batch: int = 4096, **kw) -> Params:
    """The Neufeld slab: Ly-alpha, T = 1e4 K, 1 x 1 x nz, xy-periodic, a
    point source with a Voigt input spectrum (examples/slab)."""
    base = dict(nphotons=nphotons, temperature=1e4, taumax=tau0,
                xy_periodic=True, nx=1, ny=1, nz=nz, spectral_type='voigt',
                source_geometry='point', save_Jmu=True, nmu=8,
                batch_size=batch, fly_substeps=8, scatter_rounds=4,
                chunk_cycles=16, refill_every=4)
    base.update(kw)
    return Params(**base)


def sphere_params(tau0: float = 100.0, n: int = 33, nphotons: int = 10_000,
                  batch: int = 4096, **kw) -> Params:
    """A uniform static sphere (examples/sphere, the Dijkstra et al. 2006
    family): Ly-alpha, T = 1e4 K, R = 1 in an n^3 box, a central point
    source with a Voigt input spectrum."""
    base = dict(nphotons=nphotons, temperature=1e4, taumax=tau0,
                geometry='sphere', rmax=1.0, nx=n, ny=n, nz=n, xmax=1.0,
                ymax=1.0, zmax=1.0, spectral_type='voigt',
                source_geometry='point', save_Jmu=True, nmu=8,
                batch_size=batch, fly_substeps=8, scatter_rounds=4,
                chunk_cycles=16, refill_every=4)
    base.update(kw)
    return Params(**base)


def shear_params(Omega: float = 60.0, tau0: float = 100.0,
                 nphotons: int = 4000, batch: int = 2048, **kw) -> Params:
    """examples/tigress_shear/shear.in cut as lart_tpu's tests/test_shear.py
    cuts it: a 16 x 16 x 33 xy-periodic box (xmax = ymax = 0.5 kpc, zmax =
    1), a Hubble flow of Vexp 1 km/s, tau0 100, Omega in km/s/kpc with q =
    1 (Omega 60: omega_shear > 1, a jump of several Doppler widths a wrap;
    shear.in as written sets 28), xfreq +-40."""
    base = dict(nphotons=nphotons, xy_periodic=True, velocity_type='hubble',
                Vexp=1.0, nx=16, ny=16, nz=33, xmax=0.5, ymax=0.5, zmax=1.0,
                taumax=tau0, temperature=1e4, distance_unit='kpc',
                xfreq_min=-40.0, xfreq_max=40.0, Omega=Omega, q=1.0,
                batch_size=batch, chunk_cycles=32, fly_substeps=16)
    base.update(kw)
    return Params(**base)


# the three binning geometries of the CALCJ/CALCP/CALCPnew maps (lart_tpu/
# grid/cartesian.py:522-536): -1 the z cell of a slab, 1 the radial bin of
# a sphere's cell centre, 3 the flat cell of a box without rmax
JPA_GEOMETRIES = {'slab': -1, 'sphere': 1, 'box': 3}


def jpa_params(case: str, tau0: float = 10.0, nphotons: int = 2000,
               batch: int = 2048, **kw) -> Params:
    """calcJ, calcP and calcPnew on in one of JPA_GEOMETRIES: the slab
    (1 x 1 x 33), the 17^3 uniform sphere, or a 9^3 uniform box with escape
    on every face and no rmax; Ly-alpha at T = 1e4 K, xfreq +-20."""
    maps = dict(calcJ=True, calcP=True, calcPnew=True, xfreq_min=-20.0,
                xfreq_max=20.0, nxfreq=80)
    maps.update(kw)
    if case == 'slab':
        return slab_params(tau0=tau0, nz=33, nphotons=nphotons, batch=batch,
                           **maps)
    if case == 'sphere':
        return sphere_params(tau0=tau0, n=17, nphotons=nphotons,
                             batch=batch, **maps)
    base = dict(nphotons=nphotons, temperature=1e4, taumax=tau0,
                geometry='box', nx=9, ny=9, nz=9, xmax=1.0, ymax=1.0,
                zmax=1.0, spectral_type='voigt', source_geometry='point',
                batch_size=batch, fly_substeps=8, scatter_rounds=4,
                chunk_cycles=16, refill_every=4)
    base.update(maps)
    return Params(**base)


def shear_state(meta, batch: int, seed: int, device='cpu') -> BatchState:
    """mixed_state's lanes with a shear-frame velocity of up to +-3
    omega_shear each, a quarter of the FLYING lanes moved next to an x face
    and headed through it (within 1e-3 dx; the periodic wrap moves their
    vfy_shear)."""
    s = mixed_state(meta, batch, seed, device)
    rng = np.random.default_rng([seed, 7])
    om = max(abs(meta.omega_shear), 1.0)
    dev = s.device
    s.vfy_shear.copy_(torch.as_tensor(rng.uniform(-3.0, 3.0, batch) * om,
                                      dtype=torch.float32, device=dev))
    sel = torch.as_tensor(rng.random(batch) < 0.25, device=dev) \
        & (s.phase == FLYING)
    hi = s.kx > 0.0
    off = torch.as_tensor(rng.uniform(0.0, 1e-3, batch) * meta.dx,
                          dtype=torch.float32, device=dev)
    x = torch.where(hi, meta.xmax - off, meta.xmin + off).to(s.x.dtype)
    s.x.copy_(torch.where(sel, x, s.x))
    s.ic.copy_(torch.where(sel, torch.where(hi, meta.nx - 1, 0),
                           s.ic).to(s.ic.dtype))
    s.tau_run.copy_(torch.where(sel, torch.zeros_like(s.tau_run), s.tau_run))
    return s


def write_namelist(path, par: Params, keys) -> Path:
    """A namelist at path (a pathlib.Path) with the Params par's values of
    keys, one par%key = value a line."""
    lines = ['&parameters']
    for k in keys:
        v = getattr(par, k)
        if isinstance(v, bool):
            v = '.true.' if v else '.false.'
        elif isinstance(v, str):
            v = f"'{v}'"
        else:
            v = f'{v:g}'
        lines.append(f' par%{k} = {v}')
    path.write_text('\n'.join(lines + ['/', '']))
    return path


def spectrum_rms(x, J) -> float:
    """The rms of the spectrum J on the bin centres x about its mean
    (lart_tpu's tests/test_shear.py)."""
    w = np.asarray(J, np.float64) / np.sum(J)
    mu = (w * x).sum()
    return float(np.sqrt((w * (x - mu) ** 2).sum()))


def pa_closure(res):
    """(sum of the raw Pa times rhokap_phys, the raw resonance scattered
    weight) of a run on a uniform grid, whose rhokap_phys = rhokap D /
    cross0 is one f32 number: the two are equal to f32 rounding, as each
    scattering adds wgt / rhokap_phys to Pa and wgt to nscatt_gas."""
    from .tally import jpa_maps
    meta, cfg = res.meta, res.cfg
    assert meta.rho_uniform > 0.0 and meta.uniform_temperature
    f = np.float32
    rkp = float(f(meta.rho_uniform) * f(meta.Dfreq_ref) / f(cfg.line.cross0))
    # the normalization's factor of a raw count of 1 in every bin
    unit = jpa_maps(cfg, meta, {'Pa': np.ones(meta.nbin_JPa)},
                    res.nphotons)[1]
    return float(np.sum(res.Pa / unit)) * rkp, res.nscatt_gas * res.nphotons


def map_chi2(runs_a, n_a: int, runs_b, n_b: int, floor: float = 1e-3):
    """chi^2/dof between two sets of runs of one map (each run's map
    normalized per photon, n_a and n_b photons a run) over the bins above
    floor times the largest mean: a bin's variance from one photon is c
    times its mean, c pooled over the bins from the runs' spread about
    their set's mean (a bin sums many photons' deposits, so its variance
    grows with its mean; the pooled c has many degrees of freedom where
    one bin's spread over a few runs has few).  At least one set holds two
    runs."""
    A, B = np.atleast_2d(runs_a), np.atleast_2d(runs_b)
    ma, mb = A.mean(axis=0), B.mean(axis=0)
    m = 0.5 * (ma + mb)
    sel = m > floor * m.max()
    num = den = 0.0
    for R, n, mu in ((A, n_a, ma), (B, n_b, mb)):
        if len(R) > 1:
            num += float((n * (R - mu) ** 2)[:, sel].sum())
            den += (len(R) - 1) * float(mu[sel].sum())
    var = (num / den) * m[sel] * (1.0 / (len(A) * n_a)
                                  + 1.0 / (len(B) * n_b))
    return float(((ma - mb)[sel] ** 2 / var).mean())


def run_maps(res) -> dict:
    """A run's normalized Pa and Pnew, and J1 summed over frequency
    (J1_bins) and over bins (J1_freq)."""
    return {'Pa': res.Pa, 'Pnew': res.Pnew, 'J1_bins': res.J1.sum(axis=0),
            'J1_freq': res.J1.sum(axis=1)}


def map_keys(meta) -> tuple:
    """The maps of run_maps that map_chi2 can compare: J1's spectrum not on
    an xy-periodic slab, where a grazing wing photon streams through the
    periodic box for a path without bound (the per-photon path length,
    ~1 / |kz|, has no finite variance), a run's J1 in a wing bin a few
    photons' flights (a single one put 5% of the peak into a bin at x =
    2.7 that the other package's runs left at 0.5%)."""
    return ('Pa', 'Pnew', 'J1_bins') + (
        () if meta.bc_x == 'periodic' else ('J1_freq',))


def chunk_vs_cycles(par, seed: int = 3, device='cpu'):
    """One chunk of par.chunk_cycles cycles from an empty batch, and the
    same cycles one at a time (Chunk.__call__'s loop body) into fresh
    tallies flushed to f64 after each: (the chunk's state, its tallies as
    f64 numpy, the cycles' state, their summed tallies).  Philox is keyed
    by (seed, cycle index), so both run the identical histories."""
    from .grid.cartesian import build_cartesian
    from .transport.engine import make_chunk
    from .transport.refill import refill
    from .transport.scatter import scatter
    from .transport.state import init_state
    keys = ('Jout', 'Jin', 'J1', 'Pa', 'Pnew')

    def host(t):
        return {k: getattr(t, k).double().cpu().numpy() for k in keys
                if getattr(t, k) is not None}
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=device)
    ch = make_chunk(cfg, meta, grid)
    n = par.chunk_cycles
    s1 = init_state(par.batch_size, device)
    prod = host(ch(s1, seed, 0, par.nphotons, n)[0])
    s2 = init_state(par.batch_size, device)
    acc = None
    for i in range(n):
        t = ch.zero_tallies(device)
        if i % ch.refill_every == 0:
            refill(s2, t, ch.refill_params, seed, i, par.nphotons)
        ch.flight(s2, t, ch.fly_substeps)
        scatter(s2, t, ch.scatter_params, seed, i)
        arrs = host(t)
        acc = arrs if acc is None else {k: acc[k] + arrs[k] for k in acc}
    return s1, prod, s2, acc


def hubble_params(tau0: float = 100.0, n: int = 17, Vexp: float = 200.0,
                  nphotons: int = 10_000, batch: int = 4096, **kw) -> Params:
    """An expanding Hubble-flow sphere like examples/vel_effect: Ly-alpha,
    T = 1e4 K, R = 1, one octant of an n^3 grid reflected on all three
    axes (xyz_symmetry), a point source at the centre whose drawn frequency
    is a lab-frame one (comoving_source false)."""
    base = dict(nphotons=nphotons, temperature=1e4, taumax=tau0,
                velocity_type='hubble', Vexp=Vexp, xyz_symmetry=True,
                comoving_source=False, rmax=1.0, nx=n, ny=n, nz=n, xmax=1.0,
                ymax=1.0, zmax=1.0, spectral_type='voigt',
                source_geometry='point', save_Jmu=True, nmu=8,
                batch_size=batch, fly_substeps=8, scatter_rounds=4,
                chunk_cycles=16, refill_every=4)
    base.update(kw)
    return Params(**base)


def dust_params(N_HI: float = 3.4e14, DGR: float = 1.8e6, n: int = 17,
                nphotons: int = 2000, batch: int = 2048, stokes: bool = True,
                **kw) -> Params:
    """A dusty expanding shell like examples/DL2008/DL20e_dust.in (the
    Dijkstra & Loeb 2008 shell: 0.9 < r < 1, a constant radial outflow of
    200 km/s, a Gaussian input line, its 231 frequency bins), cut to a CPU's
    size: an n^3 grid, the shell thickened to 0.6 < r < 1 so that its
    voxels make a sphere from every direction (at 0.9 the 17^3 shell is one
    cell thick and a peel-off observer on an axis sees 25% less flux than
    the mean), N_HI lowered from 1e20 to 3.4e14 (gas tau0 ~ 20) and DGR
    raised from 1 to 1.8e6, so that the dust's optical depth, 0.16 as
    written, is ~1 and about two thirds of the photons are absorbed.  The line is
    narrowed from sigma 200 to 20 km/s and centred on the outflow, x0 =
    200 km/s / vtherm (12.844 km/s at 1e4 K), so that every photon meets the
    shell near its line centre and scatters a few times: the per-photon
    spread of the scatterings stays small enough to compare means to 5% at
    a few thousand photons (at 200 km/s most photons pass the shell
    unscattered and a few scatter hundreds of times).  With `stokes` the
    dust scatters by the Mueller table of Ly-alpha, else by
    Henyey-Greenstein."""
    base = dict(nphotons=nphotons, temperature=1e4, N_HI=N_HI, DGR=DGR,
                velocity_type='constant_radial', Vexp=200.0, rmin=0.6,
                rmax=1.0, nx=n, ny=n, nz=n, use_stokes=stokes,
                spectral_type='gaussian', gaussian_sigma_vel=20.0,
                xfreq0=200.0 / 12.844236, nxfreq=231, xfreq_min=-140.0,
                xfreq_max=90.0, save_Jin=True, batch_size=batch,
                fly_substeps=8, scatter_rounds=4, chunk_cycles=16,
                refill_every=4)
    base.update(kw)
    return Params(**base)


# The metal-line cases of the tests and chip_smoke.py: (line_id, the
# namelist keys of its frequency axis and source), each the line of one
# committed example (or, for the doublet, of its catalog family) with that
# example's axis: MgII_2796 over 2790-2810 A (line type 2; no committed
# doublet example runs without a 3-D density file), SiII_1527 with its
# continuum (type 4, examples/SiII_1527), SiII_1193 with its continuum and
# recoil (type 5, examples/SiII_1193), He I 10833 with and without
# HeI_coherent (type 6, examples/HeI_sphere, HeI_coherent_test) and H + D
# Ly-alpha with D/H 3e-5 and a monochromatic source (type 7,
# examples/lya_HD).
LINE_CASES = {
    'doublet': ('MgII_2796', dict(wavelength_min=2790.0,
                                  wavelength_max=2810.0, nwavelength=200)),
    'fluorescent': ('SiII_1527', dict(wavelength_min=1516.0,
                                      wavelength_max=1546.0, nwavelength=300,
                                      spectral_type='continuum')),
    'multiplet': ('SiII_1193', dict(wavelength_min=1188.0,
                                    wavelength_max=1200.0, nwavelength=240,
                                    spectral_type='continuum', recoil=True)),
    'helium': ('HeI_10833', dict(nvelocity=201, velocity_min=-120.0,
                                 velocity_max=60.0)),
    'helium_coherent': ('HeI_10833', dict(nvelocity=201, velocity_min=-120.0,
                                          velocity_max=60.0,
                                          HeI_coherent=True)),
    'hd': ('ly_alpha_HD', dict(D_to_H_ratio=3e-5, xfreq_min=-16.0,
                               xfreq_max=16.0, nxfreq=201,
                               spectral_type='monochromatic')),
}


def line_params(case: str, tau0: float = 10.0, n: int = 17,
                nphotons: int = 2000, batch: int = 2048, **kw) -> Params:
    """A uniform static sphere (sphere_params: R = 1 in an n^3 box, a
    central point source, T = 1e4 K) of the metal line of LINE_CASES[case],
    with that case's frequency axis and spectrum (a Voigt one where the case
    names none)."""
    line_id, extra = LINE_CASES[case]
    base = dict(line_id=line_id, save_Jmu=False, **extra)
    base.update(kw)
    return sphere_params(tau0=tau0, n=n, nphotons=nphotons, batch=batch,
                         **base)


def line_state(meta, batch: int, seed: int, offsets, width: float = 4.0,
               device='cpu') -> BatchState:
    """mixed_state's lanes, all at a scattering inside the unit ball, with
    xfreq drawn around the line's components: a normal of sigma `width`
    about one of `offsets` (Doppler units) picked at random per lane, 10%
    of the lanes uniform in the far wing (|x| < 300)."""
    rng = np.random.default_rng([seed, 3])
    s = mixed_state(meta, batch, seed, device, phases=(AT_SCATTER,),
                    r_max=0.9)
    off = np.asarray(offsets, np.float64)[rng.integers(0, len(offsets),
                                                       batch)]
    x = np.where(rng.random(batch) < 0.9,
                 off + rng.normal(0.0, width, batch),
                 rng.uniform(-300.0, 300.0, batch))
    s.xfreq.copy_(torch.as_tensor(x, dtype=torch.float32))
    s.wgt.fill_(1.0)
    return s


def lyb_params(tau0: float = 30.0, n: int = 17, nphotons: int = 400,
               batch: int = 512, DGR: float = 0.0, **kw) -> Params:
    """A Ly-beta sphere like examples/ly_beta_sphere/t4tau1e4.in (line type
    8 with its 3p -> 2s conversion to H-alpha: a static uniform sphere of R
    = 1 at T = 1e4 K, a monochromatic central source at x = 0, 121
    frequency bins), cut to a CPU's size: an n^3 grid, tau0 lowered from
    1e4, and, where DGR > 0, dust in both bands (the example's 1e-3 is a
    dust tau of ~1e-6: the tests raise it to reach the dust branches)."""
    base = dict(line_id='ly_beta', spectral_type='monochromatic',
                xfreq0=0.0, DGR=DGR, save_Jmu=False)
    base.update(kw)
    return sphere_params(tau0=tau0, n=n, nphotons=nphotons, batch=batch,
                         **base)


def h2_params(tau0: float = 10.0, n: int = 17, nphotons: int = 400,
              batch: int = 512, **kw) -> Params:
    """Ly-alpha with the Neufeld two-line H2 pumping, like
    examples/h2_test/h2_on.in (f_H2 0.03, T_H2 8000 K, a Voigt source,
    core-skip, 241 bins over |x| < 12, a uniform sphere at T = 1e4 K), cut
    to a CPU's size: an n^3 grid and tau0 lowered from 1e5."""
    base = dict(h2_model='neufeld', f_H2=0.03, h2_temperature=8000.0,
                core_skip=True, xfreq_min=-12.0, xfreq_max=12.0, nxfreq=241,
                save_Jmu=False)
    base.update(kw)
    return sphere_params(tau0=tau0, n=n, nphotons=nphotons, batch=batch,
                         **base)


def band2_lanes(state: BatchState, seed: int, frac: float = 0.3,
                xmax: float = 10.0) -> BatchState:
    """state with a share `frac` of its FLYING and AT_SCATTER lanes moved
    to the H-alpha band of line type 8 (iband 2), their frequencies
    (already lab ones there) uniform in [-xmax, xmax]; in place."""
    rng = np.random.default_rng([seed, 4])
    B = state.batch
    ph = state.phase.cpu().numpy()
    pick = ((ph == FLYING) | (ph == AT_SCATTER)) & (rng.random(B) < frac)
    dev = state.device
    on = torch.as_tensor(pick, device=dev)
    state.iband.copy_(torch.where(on, 2, state.iband).to(torch.int32))
    x = torch.as_tensor(rng.uniform(-xmax, xmax, B), dtype=torch.float32,
                        device=dev)
    state.xfreq.copy_(torch.where(on, x, state.xfreq))
    return state


def peel_params(par: Params, stokes: bool = True, nim: int = 33,
                **kw) -> Params:
    """par with peel-off at test size: two external observers at distance
    1e3, one on the +z axis and one oblique (alpha 30, beta 60 degrees),
    nim x nim TAN images with the automatic field of view."""
    return dataclasses.replace(par, save_peeloff=True, use_stokes=stokes,
                               nxim=nim, nyim=nim, distance=1e3,
                               alpha=(0.0, 30.0), beta=(0.0, 60.0), **kw)


def peel_record(state: BatchState, seed: int, line=None):
    """A PeelRecord that flags every lane of `state` with a resonance
    event: the lane's direction, triad and Stokes vector (before the turn),
    xfreq_atom = xfreq - u_par and a thermal atom velocity (u_par, ux, uy)
    drawn with numpy from `seed`; for a line whose phase weights differ
    from event to event (physics.line.LineConsts `line`, types 2, 4-6),
    each lane's E1, E2, E3 of a branch of the line picked at random (the
    doublet's E1 uniform in [0, 1], as its formula spans)."""
    from .instruments.peel import PeelRecord
    rng = np.random.default_rng(seed)
    B, dev = state.batch, state.device
    rec = PeelRecord.zeros(B, dev)
    rec.flag.fill_(1)
    for f in ('kx', 'ky', 'kz', 'mx', 'my', 'mz', 'nnx', 'nny', 'nnz', 'Q',
              'U', 'V'):
        getattr(rec, f).copy_(getattr(state, f))
    u = rng.normal(0.0, np.sqrt(0.5), (3, B))
    rec.xatom.copy_(state.xfreq - torch.as_tensor(u[2], dtype=torch.float32,
                                                  device=dev))
    for f, v in zip(('ux', 'uy', 'uz'), u):
        getattr(rec, f).copy_(torch.as_tensor(v, dtype=torch.float32,
                                              device=dev))
    if line is not None and line.per_lane_E:
        if line.line_type == 2:
            E1 = rng.random(B)
            E = (E1, 1.0 - E1, (E1 + 2.0) / 3.0)
        else:
            table = np.array([[v[i][j] for v in (line.E1, line.E2, line.E3)]
                              for i in range(3) for j in range(
                                  line.ndown[i])])
            E = table[rng.integers(0, len(table), B)].T
        for f, v in zip(('E1', 'E2', 'E3'), E):
            getattr(rec, f).copy_(torch.as_tensor(v, dtype=torch.float32,
                                                  device=dev))
    return rec


def peel_closure(res, cubes=('scatt', 'direc'), w_esc=None) -> list:
    """Per observer of a RunResult with peel-off (either package's): 4 pi
    d^2 times its peeled flux (over the image and the spectrum of the
    `cubes`, scattered + direct by default, undone of the cubes'
    normalization) over the escaped weight (W_escape, or w_esc: the
    H-alpha band's W_esc2 for its cube Ha).  Where the source and the
    medium are isotropic (a central source in a uniform sphere) each is 1
    up to the Monte Carlo error."""
    par, om = res.cfg.par, res.obs_meta
    bin_unit = res.meta.dwave if par.intensity_unit == 1 else res.meta.dxfreq
    d2c = par.distance2cm if par.distance2cm > 0.0 else 1.0
    scale = om.steradian_pix * bin_unit * d2c ** 2 * 4.0 * np.pi \
        * om.distance ** 2 / (res.W_escape if w_esc is None else w_esc)
    return [float(sum(res.peel[c][o].sum() for c in cubes)) * scale
            for o in range(om.nobs)]


# the per-photon variance of a peeled flux, in units of its mean squared:
# a photon deposits at every scattering near the surface, so its share
# varies (the 17^3 uniform sphere, tau0 = 100, of tests/
# test_torch_peel_slice.py: the peeled flux of 2000 photons varied by 3.7%
# over five seeded runs of the two packages)
PEEL_V_PHOTON = 2.7
# the same for the dusty shell of dust_params with Stokes, seen from +z:
# its forward-peaked dust phase function makes the peel vary more
# (tools/dust_cpu_runs.py spread, eight seeded runs of 2000 photons through
# the port: Stokes I 1.810 +- 0.127, 9.8 a photon; 4 pi d^2 flux / W_esc
# 1.000 +- 0.084, 14.1 a photon, the larger, which this holds)
PEEL_V_DUST = 14.1
# and of the scatterings per photon there, gas and dust (the same runs:
# 2.892 +- 0.076 and 1.018 +- 0.018)
DUST_V_NSCATT, DUST_V_NDUST = 1.4, 0.65


def spectra_chi2(a, b, n_a: float, n_b: float):
    """(chi2/dof, bins) of two spectra's shapes, each normalized to unit
    sum, over the populated bins, with the counting variance of the n_a and
    n_b photons that make them (the escaped or absorbed ones: the photon
    count times W_esc or W_abs)."""
    p1, p2 = a / a.sum(), b / b.sum()
    sel = (p1 + p2) > (p1 + p2).max() * 1e-3
    var = p1 / n_a + p2 / n_b
    return float(np.sum((p1[sel] - p2[sel]) ** 2 / var[sel])
                 / max(sel.sum(), 1)), int(sel.sum())


def peel_spectra_chi2(r1, r2, o: int, nphotons: int):
    """(chi2/dof, bins) of observer o's peeled Stokes-I (or scattered +
    direct) spectra of two RunResults, each normalized to unit sum, over the
    populated bins, with the counting variance: the normalization takes out
    the photon-to-photon spread of the total (PEEL_V_PHOTON), which moves
    every bin together."""
    def spec(r):
        c = r.peel['I'][o] if 'I' in r.peel else \
            r.peel['scatt'][o] + r.peel['direc'][o]
        p = c.sum(axis=(1, 2))
        return p / p.sum()
    p1, p2 = spec(r1), spec(r2)
    sel = (p1 + p2) > (p1 + p2).max() * 1e-3
    var = (p1 + p2) / nphotons
    return float(np.sum((p1[sel] - p2[sel]) ** 2 / var[sel])
                 / max(sel.sum(), 1)), int(sel.sum())


def ring_polarization(res, o: int) -> list:
    """(ring, q, error) per ring of observer o's frequency-integrated
    image: q is the ring's tangential Stokes Q over its I (the frame of
    instruments/profiles.radial_stokes) and the error comes from the
    scatter of the ring's pixels about that ratio; rings of fewer than 8
    pixels are left out."""
    from .instruments.profiles import radial_axes
    I, Q, U = (res.peel[k][o].sum(axis=0) for k in 'IQU')
    n = I.shape[0]
    nr, _ = radial_axes(n, n)
    c = (n + 1.0) / 2.0
    ii, jj = np.meshgrid(np.arange(1, n + 1) - c, np.arange(1, n + 1) - c,
                         indexing='ij')
    rr = np.sqrt(ii ** 2 + jj ** 2)
    ring = (np.floor(rr + 0.5) if nr % 2 else np.floor(rr)).astype(int)
    r2 = np.maximum(rr, 1e-9) ** 2
    cos2 = np.where(rr > 0, (jj ** 2 - ii ** 2) / r2, 1.0)
    sin2 = np.where(rr > 0, -2.0 * ii * jj / r2, 0.0)
    Qt = Q * cos2 + U * sin2
    out = []
    for r in range(1, nr):
        m = ring == r
        if m.sum() < 8:
            continue
        q = Qt[m].sum() / I[m].sum()
        err = np.sqrt(np.sum((Qt[m] - q * I[m]) ** 2)) / I[m].sum()
        out.append((r, float(q), float(err)))
    return out


def ring_polarization_chi2(r1, r2, o: int) -> float:
    """chi2 per ring of the two runs' ring_polarization profiles."""
    p1, p2 = ring_polarization(r1, o), ring_polarization(r2, o)
    assert [r for r, _, _ in p1] == [r for r, _, _ in p2] and len(p1) >= 5
    return sum((q1 - q2) ** 2 / (e1 ** 2 + e2 ** 2)
               for (_, q1, e1), (_, q2, e2) in zip(p1, p2)) / len(p1)


def cells_of(meta, x, y, z):
    """(ic, jc, kc) of f32 positions: the clamped floor of lart_tpu's
    refill (engine.py:2760-2765), in f32."""
    f32 = np.float32
    out = []
    for v, amin, d, n in ((x, meta.xmin, meta.dx, meta.nx),
                          (y, meta.ymin, meta.dy, meta.ny),
                          (z, meta.zmin, meta.dz, meta.nz)):
        c = np.floor((np.asarray(v, f32) - f32(amin)) / f32(d))
        out.append(np.clip(c, 0, n - 1).astype(np.int32))
    return out


def _positions(rng, meta, batch, r_max):
    """Uniform in the box, or in the ball r < r_max (folded onto the
    grid's octant where a symmetry axis starts at or near 0)."""
    lo = (meta.xmin, meta.ymin, meta.zmin)
    hi = (meta.xmax, meta.ymax, meta.zmax)
    if r_max is None:
        return [rng.uniform(a, b, batch) for a, b in zip(lo, hi)]
    v = rng.normal(size=(3, batch))
    v *= r_max * rng.random(batch) ** (1.0 / 3.0) / np.linalg.norm(v, axis=0)
    return [np.abs(c) if a > -0.5 * b else c for c, a, b in zip(v, lo, hi)]


def mixed_state(meta, batch: int, seed: int, device='cpu',
                phases=(DEAD, FFS, FLYING, AT_SCATTER),
                r_max: Optional[float] = None) -> BatchState:
    """A batch with lanes in every phase, inside the grid of `meta` (inside
    the ball r < r_max when it is given): each lane's cell is the clamped
    floor of its position, FFS lanes sit at their birth snapshot with a
    stashed xi; 10% of the lanes carry far-wing frequencies, some outside
    the frequency grid."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    phase = rng.choice(np.asarray(phases, np.int32), batch)
    x, y, z = _positions(rng, meta, batch, r_max)
    cost = rng.uniform(-1.0, 1.0, batch)
    cost[rng.random(batch) < 0.01] = 0.0          # flights parallel to z faces
    sint = np.sqrt(1.0 - cost * cost)
    phi = rng.uniform(0.0, 2.0 * np.pi, batch)
    kx, ky, kz = sint * np.cos(phi), sint * np.sin(phi), cost
    kind = rng.random(batch)
    xfreq = np.where(kind < 0.7, rng.normal(0.0, 3.0, batch),
                     np.where(kind < 0.9, rng.uniform(-50.0, 50.0, batch),
                              rng.uniform(-3000.0, 3000.0, batch)))
    tau_target = rng.exponential(1.0, batch)
    tau_run = rng.uniform(0.0, 0.5, batch) * tau_target
    is_ffs = phase == FFS
    tau_target[is_ffs] = rng.uniform(1e-6, 1.0, is_ffs.sum())
    tau_run[is_ffs] = 0.0
    ic, jc, kc = cells_of(meta, x, y, z)
    fields = dict(phase=phase, x=x, y=y, z=z, kx=kx, ky=ky, kz=kz,
                  ic=ic, jc=jc, kc=kc,
                  xfreq=xfreq, wgt=rng.uniform(0.5, 1.0, batch),
                  tau_target=tau_target, tau_run=tau_run,
                  iband=np.ones(batch), vfy_shear=np.zeros(batch))
    bx, by, bz = _positions(rng, meta, batch, r_max)
    birth = dict(bx=bx, by=by, bz=bz, bxfreq=rng.normal(0.0, 3.0, batch))
    bcost = rng.uniform(-1.0, 1.0, batch)
    bphi = rng.uniform(0.0, 2.0 * np.pi, batch)
    bsint = np.sqrt(1.0 - bcost * bcost)
    birth.update(bkx=bsint * np.cos(bphi), bky=bsint * np.sin(bphi),
                 bkz=bcost)
    birth.update(zip(('bic', 'bjc', 'bkc'), cells_of(meta, bx, by, bz)))
    for k in ('x', 'y', 'z', 'kx', 'ky', 'kz', 'ic', 'jc', 'kc', 'xfreq'):
        birth['b' + k] = np.where(is_ffs, fields[k], birth['b' + k])
    fields.update(birth)
    fields.update(polarization(np.random.default_rng([seed, 1]), kx, ky, kz))
    # the all-photons bookkeeping: every lane its own id, some events
    ev = np.random.default_rng([seed, 9]).integers(0, 50, (2, batch))
    fields.update(pid=np.arange(batch), nsg=ev[0], nsd=ev[1])
    out = {f: torch.as_tensor(np.asarray(fields[f], np.int32 if f in
                                         INT_FIELDS else f32),
                              device=device) for f in LANE_FIELDS}
    return BatchState(**out, n_launched=torch.zeros((1,), dtype=torch.int32,
                                                    device=device))


def hot_state(meta, batch: int, seed: int, device='cpu', cell=None,
              xfreq: Optional[float] = None) -> BatchState:
    """mixed_state's lanes, every one moved to a uniform point inside one
    cell (the centre cell by default, a centred point source's) with its
    cell indices, the FFS lanes' birth snapshots with them; with `xfreq`,
    every lane's frequency (and an FFS lane's birth one) xfreq + U(-w, w),
    w a quarter of the frequency bin.  Every map deposit of a flight or a
    scatter then falls into one bin, or one bin and one frequency bin."""
    s = mixed_state(meta, batch, seed, device)
    rng = np.random.default_rng([seed, 11])
    n = (meta.nx, meta.ny, meta.nz)
    cell = tuple(v // 2 for v in n) if cell is None else cell
    ffs = s.phase == FFS
    for ax, (p, c) in enumerate((('x', 'ic'), ('y', 'jc'), ('z', 'kc'))):
        lo = (meta.xmin, meta.ymin, meta.zmin)[ax]
        d = (meta.dx, meta.dy, meta.dz)[ax]
        pos = torch.as_tensor(lo + (cell[ax] + rng.uniform(0.05, 0.95, batch))
                              * d, dtype=torch.float32, device=device)
        getattr(s, p).copy_(pos)
        getattr(s, c).fill_(cell[ax])
        getattr(s, 'b' + p).copy_(torch.where(ffs, pos, getattr(s, 'b' + p)))
        getattr(s, 'b' + c).copy_(torch.where(
            ffs, getattr(s, c), getattr(s, 'b' + c)))
    if xfreq is not None:
        x = torch.as_tensor(xfreq + rng.uniform(-0.25, 0.25, batch)
                            * meta.dxfreq, dtype=torch.float32, device=device)
        s.xfreq.copy_(x)
        s.bxfreq.copy_(torch.where(ffs, x, s.bxfreq))
    return s


def amr_state(meta, amr, batch: int, seed: int, device='cpu',
              phases=(DEAD, FFS, FLYING, AT_SCATTER),
              r_max: Optional[float] = None,
              face_frac: float = 0.1) -> BatchState:
    """mixed_state's lanes on the AMR grid `amr` (a flight.AmrGrid): each
    lane's cell and birth cell the node amr_find_cell gives its position
    (jc = kc = 0), and a share face_frac of the lanes moved onto a face of
    their node (the walk then crosses a zero-length step)."""
    rng = np.random.default_rng([seed, 3])
    s = mixed_state(meta, batch, seed, device, phases, r_max)
    for f in ('jc', 'kc', 'bjc', 'bkc'):
        getattr(s, f).zero_()
    s.ic.copy_(amr.find_cell(s.x, s.y, s.z))
    d = amr.dev
    c = s.ic.long()
    on = torch.as_tensor(rng.random(batch) < face_frac, device=device)
    axis = torch.as_tensor(rng.integers(0, 3, batch), device=device)
    up = torch.as_tensor(rng.random(batch) < 0.5, device=device)
    for a, (pos, cen) in enumerate(((s.x, d.node_cx), (s.y, d.node_cy),
                                    (s.z, d.node_cz))):
        face = cen[c] + torch.where(up, d.node_ch[c], -d.node_ch[c])
        pos.copy_(torch.where(on & (axis == a), face, pos))
    s.ic.copy_(amr.find_cell(s.x, s.y, s.z))
    ffs = s.phase == FFS
    for f in ('x', 'y', 'z', 'ic'):
        getattr(s, 'b' + f).copy_(torch.where(ffs, getattr(s, f),
                                              getattr(s, 'b' + f)))
    s.bic.copy_(torch.where(ffs, s.ic, amr.find_cell(s.bx, s.by, s.bz)))
    return s


def amr_params(n_base: int = 16, levels_extra: int = 1, tau0: float = 100.0,
               nphotons: int = 2000, batch: int = 4096, **kw) -> Params:
    """A uniform AMR sphere (grid.amr.make_amr_sphere, passed in memory as
    amr_data): Ly-alpha, T = 1e4 K, R = 1, a central point source with a
    Voigt input spectrum (examples/amr_sphere at a smaller base)."""
    base = dict(nphotons=nphotons, use_amr_grid=True, geometry='sphere',
                taumax=tau0, temperature=1e4, spectral_type='voigt',
                source_geometry='point', save_Jmu=True, nmu=8,
                batch_size=batch, fly_substeps=8, scatter_rounds=4,
                chunk_cycles=16, refill_every=4)
    base.update(kw)
    return Params(**base)


def amr_gaps(data: dict, frac: float = 0.05, seed: int = 0) -> dict:
    """The leaf dict without a share frac of its finest-level leaves: each
    one dropped leaves a gap cell, a missing octant of its parent node,
    which carries no gas (engine.py:279-287)."""
    rng = np.random.default_rng(seed)
    lev = np.asarray(data['level'])
    drop = (lev == lev.max()) & (rng.random(len(lev)) < frac)
    return {k: v[~drop] if isinstance(v, np.ndarray) and v.shape == lev.shape
            else v for k, v in data.items()}


def jellyfish_amr(base: int = 16, levels_extra: int = 2,
                  boxsize: float = 4.0) -> dict:
    """The leaf list of examples/jellyfish_rmhd/mk_amr.py (an exponential
    gas disk with a ram-pressure-stripped tail in a 4 kpc box, refined two
    levels where dense; T 8e3 K in the disk and 3e5 K outside; vy; xHI,
    n_e, ndust and emissivity columns), as the dict build_amr takes."""
    import math

    def density(x, y, z):
        r = np.sqrt(x ** 2 + y ** 2)
        disk = np.exp(-r / 0.8) * np.exp(-np.abs(z) / 0.15)
        tail = (0.15 * np.exp(-((x / 0.5) ** 2 + (z / 0.4) ** 2))
                * np.exp(-np.maximum(-y, 0) / 2.0) * (y < 0.2)
                * (1.0 + 0.5 * np.cos(7.0 * y) * np.cos(5.0 * x)))
        return disk + tail + 1e-4

    lev0 = int(round(math.log2(base)))
    h0 = boxsize / base
    xs = (np.arange(base) + 0.5) * h0 - boxsize / 2
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing='ij')
    cells = np.stack([X.ravel(), Y.ravel(), Z.ravel(),
                      np.full(base ** 3, lev0, float)], axis=1)
    for lev in range(lev0, lev0 + levels_extra):
        h = boxsize / 2.0 ** lev
        at = cells[:, 3] == lev
        rho = density(cells[:, 0], cells[:, 1], cells[:, 2])
        split = at & (rho > 0.3 * 2.0 ** (lev - lev0))
        keep = cells[~split]
        parents = cells[split]
        kids = []
        for di, dj, dk in np.ndindex(2, 2, 2):
            off = (np.array([di, dj, dk]) - 0.5) * h / 2
            k = parents.copy()
            k[:, :3] += off
            k[:, 3] += 1
            kids.append(k)
        cells = np.concatenate([keep] + kids) if len(parents) else keep
    x, y, z, lev = cells.T
    nH = density(x, y, z)
    T = np.where(nH > 0.3, 8.0e3, 3.0e5)
    xHI = np.where(nH > 0.3, 0.9, 1e-4)
    n_e = nH * (1.0 - xHI) * 1.2
    return {'x': x, 'y': y, 'z': z, 'level': lev.astype(np.int32),
            'nH': nH, 'T': T, 'vx': np.zeros_like(nH),
            'vy': np.where(y < 0, -80.0 * np.exp(np.minimum(y, 0)), 10.0 * y),
            'vz': np.zeros_like(nH), 'xHI': xHI, 'n_e': n_e,
            'ndust': 6.0e-3 * nH * xHI,
            'emissivity': n_e * nH * (1.0 - xHI) * 4.1e-25,
            'boxlen': boxsize,
            'origin': (-boxsize / 2, -boxsize / 2, -boxsize / 2)}


# the volume and table sources' examples and the cuts chip_smoke.py phase 4
# and tools/sources_cpu_runs.py run them at: name -> (namelist under
# examples/, the keys replaced)
SOURCE_CASES = {
    # He I 10833 in a 65^3 sphere at tau 100, uniform_sphere, continuum
    't4tau2': ('HeI_sphere_cont/t4tau2.in', {}),
    # the coherent He I sphere at tau 100, uniform_sphere, Stokes peel-off
    'un_tau100_coh': ('HeI_coherent_test/un_tau100_coh.in', {}),
    # star_file with composite weights in a 201^3 cube; as written (tau
    # 1e5, its local core-skip idle at a tau of 0.47 a cell) each photon
    # scatters ~1.6e5 times, one scattering a cycle, and the drain of 2e4
    # photons took 150 s on the card (46 s at tau 1e4)
    'stars1': ('many_stars/stars1.in', {'nphotons': 20000,
                                        'taumax': 3e3}),
    # the ssh Sersic source and velocity field, dust, Stokes, tau maps
    'halo_0053': ('SSH_MUSE/halo_0053.in', {'taumax': 1e4}),
    # diffuse_emissivity over the AMR leaves' emissivity column; the AMR
    # build ignores velocity_min/max (ROADMAP queue 3), so xfreq +-80 keeps
    # every birth of the 3e5 K leaves in the band, where Jin counts it
    'jellyfish_emiss': ('jellyfish_rmhd/jellyfish_emiss.in',
                        {'taumax': 3e3, 'xfreq_min': -80.0,
                         'xfreq_max': 80.0}),
    # the 1-D emissivity profile in a 101^3 sphere with its 1-D temperature
    # profile (8900 K at the centre to 7100 K at the edge), as written
    'AlII': ('emiss_1D_AlII/AlII_ex.in', {}),
    # the WASP-52b-like escaping atmosphere lit by its star: a 101^3
    # spherical atmosphere with 1-D density, temperature and velocity
    # profiles, a masked core (r <= 0.55), stellar illumination with
    # Eddington limb darkening, the line_prof_file spectrum, recoil,
    # save_Jin and one observer in the xy plane (129^2 x 101), as written
    'a090': ('star_planet/star_planet_a090.in', {}),
    # the same with its observer on +z, behind the planet, and Direct0:
    # the transit shadow (the namelists' observers never see it)
    'a090_transit': ('star_planet/star_planet_a090.in',
                     {'beta': (0.0,), 'save_direc0': True}),
    # a 65^3 spherical atmosphere at tau 1e4 with a masked core, static
    # at uniform T, stellar illumination, a Voigt spectrum, as written
    'wasp52b': ('atmosphere/wasp52b_like.in', {}),
    # save_all_photons (chip_smoke.py phase 4, tools/allph_cpu_runs.py):
    # t4tau7 at taumax 1e4 (1e5 before: 82 s of the card's run; 129^3,
    # core-skip) with its 1e5 photons as written, through K5 (the table
    # takes it off K6): a drain tail, so the photons cost little beside
    # the tau
    't4tau7_allph': ('sphere/t4tau7.in', {'taumax': 1e4,
                                          'save_all_photons': True}),
    # DL20e_dust at phase 4's cut of the DL2008 shell (5000 photons, N_HI
    # 1e18 with DGR 100: the dust's tau as written), Stokes: the I, Q, U, V
    # columns and the absorption deaths
    'DL20e_dust_allph': ('DL2008/DL20e_dust.in', {
        'no_photons': 5000.0, 'N_HI': 1e18, 'DGR': 100.0,
        'save_all_photons': True}),
    # the AMR sphere (its leaves in memory, make_amr_sphere(32, 1)) and the
    # overlapping clumps (K9), as written
    'amr_sphere_allph': ('amr_sphere/amr_sphere.in',
                         {'save_all_photons': True}),
    'clumps_overlap_allph': ('clump_sphere/clumps_overlap.in',
                             {'save_all_photons': True}),
    # the bicone's 6837 clumps through K10 as written (save_clump_info off:
    # the card's machine has no h5py)
    'bicone_clump_allph': ('bicone/bicone_clump.in', {
        'save_all_photons': True, 'save_clump_info': False}),
    # chip_smoke.py phase 4's depth cuts of earlier paths, made to give the
    # table's runs room (drain tails: a run's wall scales with its tau):
    # the flagship slab at tauhomo 3e3 (1e4 before), vel_effect V0200 and
    # its peel example at N_HI 5e17 (2e18 before), slab_peel at taumax 3e3
    # and sphere_peel at 2e3 (as written 1e4), DL20e.in (dust-free) at N_HI
    # 2e17 (1e18 before; DL20e_dust.in keeps 1e18), sphere_HD at N_HImax
    # 1e17 (3e17 before), h2_on.in at taumax 1e4 (as written 1e5)
    't1tau6_cut': ('slab/t1tau6.in', {'tauhomo': 3e3, 'nphotons': 5e4}),
    'vel_effect_cut': ('vel_effect/t4NHI2_20_V0200.in',
                       {'N_HI': 5e17, 'no_photons': 1e4}),
    'vel_effect_peel_cut': ('vel_effect_peel/t4NHI2_20_V0200_peel.in',
                            {'N_HI': 5e17, 'no_photons': 1e4}),
    'slab_peel_cut': ('slab_peel/t1tau4.in',
                      {'no_photons': 1e4, 'taumax': 3e3}),
    'sphere_peel_cut': ('sphere_peel/t4tau4_peel.in',
                        {'nphotons': 20000, 'taumax': 2e3}),
    'DL20e_cut': ('DL2008/DL20e.in', {'no_photons': 5000.0, 'N_HI': 2e17}),
    'sphere_HD_cut': ('lya_HD/sphere_HD_dijkstra2006.in',
                      {'no_photons': 2000.0, 'N_HImax': 1e17}),
    'h2_on_cut': ('h2_test/h2_on.in', {'taumax': 1e4}),
}
# the namelist keys that name a file beside the namelist
SOURCE_FILES = ('star_file', 'emiss_file', 'dens_file', 'temp_file',
                'velo_file', 'line_prof_file')


def plane_atmosphere_params(nphotons: int = 2000, nz: int = 32,
                            taumax: float = 1e3, **kw) -> Params:
    """The plane atmosphere of lart_tpu's tests/test_atmosphere.py
    (test_plane_atmosphere_thick_conserves): a 1 x 1 x nz column at taumax,
    T = 1e4 K, lit from the top by plane_illumination with a Voigt
    spectrum; its bottom face destroys (Jabs2)."""
    kw = dict(dict(nphotons=nphotons, geometry='plane_atmosphere', nx=1,
                   ny=1, nz=nz, xmax=1, ymax=1, zmax=1, taumax=taumax,
                   temperature=1e4, xfreq_min=-40.0, xfreq_max=40.0,
                   source_geometry='plane_illumination',
                   spectral_type='voigt', batch_size=1024,
                   chunk_cycles=16), **kw)
    return Params(**kw)


def stellar_params(nphotons: int = 1500, n: int = 25, **kw) -> Params:
    """The transit case of lart_tpu's tests/test_atmosphere.py
    (test_stellar_disk_direct_peel_transit): an n^3 spherical atmosphere
    (rmax 1, no core) at taumax 50, lit by a star of radius 2 at distance
    50 with Eddington limb darkening, a monochromatic spectrum, and one
    observer on +z behind the planet with Direct0."""
    kw = dict(dict(nphotons=nphotons, geometry='spherical_atmosphere',
                   nx=n, ny=n, nz=n, xmax=1, ymax=1, zmax=1, rmax=1.0,
                   rmin=0.0, taumax=50.0, temperature=1e4,
                   xfreq_min=-20.0, xfreq_max=20.0,
                   source_geometry='stellar_illumination',
                   stellar_radius=2.0, distance_star_to_planet=50.0,
                   stellar_limb_darkening=2, spectral_type='monochromatic',
                   save_peeloff=True, save_peeloff_3D=True, save_direc0=True,
                   obsx=(0.0,), obsy=(0.0,), obsz=(2000.0,), nxim=33,
                   nyim=33, batch_size=1024, chunk_cycles=16), **kw)
    return Params(**kw)


def transit(res, o: int = 0):
    """(depth, its sigma, pairs in the image) of a stellar run's
    observer o: 1 - sum(Direct) / sum(Direct0), the mean attenuation over
    the pairs in the image, sigma from the spread of a pair's attenuation
    (in [0, 1]: at most sqrt(d (1 - d) / n)))."""
    d0 = float(res.peel['direc0'][o].sum())
    d1 = float(res.peel['direc'][o].sum())
    pos = np.asarray(res.obs_meta.pos_host[o], np.float64)
    D = res.cfg.par.distance_star_to_planet
    w0 = 1.0 / ((pos + np.array([0.0, 0.0, D])) ** 2).sum()
    bin_unit = res.meta.dwave if res.cfg.par.intensity_unit == 1 \
        else res.meta.dxfreq
    d2cm = res.cfg.par.distance2cm if res.cfg.par.distance2cm > 0 else 1.0
    scale = (res.nphotons * res.obs_meta.steradian_pix * bin_unit
             * d2cm ** 2)
    n_in = d0 * scale / w0
    depth = 1.0 - d1 / d0 if d0 > 0 else 0.0
    return depth, math.sqrt(max(depth * (1.0 - depth), 1e-12)
                            / max(n_in, 1.0)), n_in


def atmosphere_budget(res) -> dict:
    """A run's budget per photon (either package's RunResult): the
    escaped W_esc, the destroyed W_abs2 (Jabs2's sum with normalize's
    division undone), W_oor, the Jabs2 share of their sum, and the birth
    weights in the band (Jin's sum)."""
    from .tally import spectrum_denom
    den = spectrum_denom(res.cfg, res.meta, 1)
    w_abs2 = float(np.sum(res.Jabs2)) * den if res.Jabs2 is not None \
        else 0.0
    tot = res.W_escape + w_abs2 + res.W_oor
    return {'W_esc': res.W_escape, 'W_abs2': w_abs2, 'W_oor': res.W_oor,
            'total': tot, 'share': w_abs2 / tot if tot > 0 else 0.0,
            'birth': birth_weight(res) if res.Jin is not None else None,
            'N': res.nscatt_gas, 'ff': res.flux_factor}


def source_files(path) -> dict:
    """The file keys of the namelist at path that name files beside it,
    made absolute (the namelists give them relative to their folder)."""
    par = Params.from_namelist(str(path))
    out = {}
    for k in SOURCE_FILES:
        v = getattr(par, k).strip()
        if v and (Path(path).parent / v).is_file():
            out[k] = str((Path(path).parent / v).resolve())
    return out


def source_params(name: str, root, cut: bool = True, **over) -> Params:
    """SOURCE_CASES[name] under the repository root `root` as Params, its
    files made absolute, its cut (unless cut is False: as written) and
    `over` applied."""
    rel, cuts = SOURCE_CASES[name]
    path = Path(root) / 'examples' / rel
    par = Params.from_namelist(str(path))
    for k, v in {**source_files(path), **(cuts if cut else {}),
                 **over}.items():
        setattr(par, k, v)
    return par


def turb_cube(n: int = 65, mach: float = 10.0, b: float = 0.4,
              seed: int = 20260820) -> np.ndarray:
    """The lognormal Mach-10 density cube of the FeII_turb examples, (n, n,
    n) f32 with <rho> = 1: the numpy body of examples/FeII_turb/
    mk_turb_cube.py make_cube (a Gaussian random field of k^-11/3 power,
    exponentiated with sigma^2 = ln(1 + (b M)^2)), without its h5py
    writer."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(n) * n
    kx, ky, kz = np.meshgrid(k, k, k, indexing='ij')
    kk = np.sqrt(kx ** 2 + ky ** 2 + kz ** 2)
    kk[0, 0, 0] = 1.0
    amp = kk ** (-11.0 / 6.0)
    amp[0, 0, 0] = 0.0
    phase = rng.standard_normal((n, n, n)) \
        + 1j * rng.standard_normal((n, n, n))
    g = np.fft.ifftn(amp * phase).real
    g = (g - g.mean()) / g.std()
    sigma = np.sqrt(np.log(1.0 + (b * mach) ** 2))
    rho = np.exp(sigma * g - 0.5 * sigma ** 2)
    return rho.astype(np.float32)


def prochaska_dens(n0: float = 0.1, abund: float = 10.0 ** (-5.47),
                   rinner: float = 1.0, router: float = 20.0,
                   n: int = 150) -> np.ndarray:
    """The r^-2 wind of the Prochaska examples, (n, n, n) f32 in (x, y, z):
    n_ion = abund n0 (rinner / r)^2 between rinner and router, 0 elsewhere
    (examples/Prochaska/mk_model.py make_dens, which writes its transpose
    as a FITS primary HDU)."""
    nion0 = abund * n0
    ax = (np.arange(n) + 0.5) / (n / 2.0) * router - router
    X, Y, Zc = np.meshgrid(ax, ax, ax, indexing='ij')
    r = np.sqrt(X * X + Y * Y + Zc * Zc)
    dens = np.zeros((n, n, n), np.float32)
    shell = (r >= rinner) & (r <= router)
    dens[shell] = nion0 * (rinner / r[shell]) ** 2
    return dens


def temperature_cube(n: int, seed: int, t_min: float = 1e3,
                     t_max: float = 1e5) -> np.ndarray:
    """A (n, n, n) temperature cube [K], log-uniform between t_min and
    t_max cell by cell, from a seed: every crossing changes the Doppler
    width by up to a factor 10."""
    rng = np.random.default_rng([seed, 12])
    return np.exp(rng.uniform(np.log(t_min), np.log(t_max),
                              (n, n, n))).astype(np.float32)


def write_cube(path, arr: np.ndarray) -> str:
    """Write an (x, y, z[, 3]) array as a grid file the readers take back:
    HDF5 (first dataset, h5py) where path ends in .h5, else a FITS primary
    HDU (minifits; .gz compresses), stored (z, y, x) (a velocity cube
    (z, y, x, 3))."""
    path = str(path)
    a = np.asarray(arr)
    disk = np.ascontiguousarray(np.transpose(a, (2, 1, 0, 3)) if a.ndim == 4
                                else a.T)
    if path.endswith('.h5'):
        from .io.iofile import write_hdf5_array
        write_hdf5_array(path, disk)
    else:
        from .io.minifits import HDU, write_hdus
        write_hdus(path, [HDU(data=disk)])
    return path


def birth_weight(res) -> float:
    """The sum of a run's birth weights over its photons (either package's
    RunResult): its Jin, the births that fall in the frequency band, with
    tally.normalize's division undone (not for a continuum spectrum with
    continuum_normalize)."""
    from .tally import spectrum_denom
    return float(np.sum(res.Jin)) * spectrum_denom(res.cfg, res.meta, 1)


def clump_params(nphotons: int = 4000, batch: int = 2048, **kw) -> Params:
    """The 40-clump sphere of lart_tpu's tests/test_clump_overlap.py
    (_base_par): Ly-alpha, T = 1e4 K, R = 1, 40 clumps of radius 0.15 at
    tau0 5, a central point source with a Voigt input spectrum, the
    frequency axis +-30."""
    base = dict(nphotons=nphotons, use_clump_medium=True, geometry='sphere',
                rmax=1.0, xmax=1.0, ymax=1.0, zmax=1.0, clump_radius=0.15,
                clump_N_clumps=40, clump_tau0=5.0, temperature=1e4,
                xfreq_min=-30.0, xfreq_max=30.0, batch_size=batch,
                chunk_cycles=16)
    base.update(kw)
    return Params(**base)


def clump_state(meta, cl, batch: int, seed: int, device='cpu',
                phases=(DEAD, FFS, FLYING, AT_SCATTER),
                in_frac: float = 0.3, edge_frac: float = 0.1) -> BatchState:
    """mixed_state's lanes on the clump medium `cl` (a flight.ClumpGrid):
    a share in_frac of them moved inside a clump, a share edge_frac onto a
    clump's surface within two nudges (eps_csr) of it, the rest where
    mixed_state put them (mostly in the vacuum); each lane's cell and birth
    cell the clump clump_find gives its position (jc = kc = 0)."""
    rng = np.random.default_rng([seed, 5])
    s = mixed_state(meta, batch, seed, device)
    d = cl.dev
    cx, cy, cz = (np.asarray(v.cpu().numpy(), np.float64)
                  for v in (d.x, d.y, d.z))
    rad = np.asarray(d.radius.cpu().numpy(), np.float64)
    pick = rng.integers(0, cl.n, batch)
    v = rng.normal(size=(3, batch))
    v /= np.linalg.norm(v, axis=0)
    kind = rng.random(batch)
    inner = rad[pick] * 0.95 * rng.random(batch) ** (1.0 / 3.0)
    edge = rad[pick] + rng.uniform(-2.0, 2.0, batch) * cl.eps_csr
    dist = np.where(kind < in_frac, inner, edge)
    move = kind < in_frac + edge_frac
    for f, c, comp in (('x', cx, v[0]), ('y', cy, v[1]), ('z', cz, v[2])):
        new = torch.as_tensor((c[pick] + dist * comp).astype(np.float32),
                              device=device)
        getattr(s, f).copy_(torch.where(torch.as_tensor(move, device=device),
                                        new, getattr(s, f)))
    for f in ('jc', 'kc', 'bjc', 'bkc'):
        getattr(s, f).zero_()
    s.ic.copy_(cl.find(s.x, s.y, s.z))
    ffs = s.phase == FFS
    for f in ('x', 'y', 'z', 'ic'):
        getattr(s, 'b' + f).copy_(torch.where(ffs, getattr(s, f),
                                              getattr(s, 'b' + f)))
    s.bic.copy_(torch.where(ffs, s.ic, cl.find(s.bx, s.by, s.bz)))
    if phases != (DEAD, FFS, FLYING, AT_SCATTER):
        s.phase.copy_(torch.as_tensor(rng.choice(np.asarray(phases, np.int32),
                                                 batch), device=device))
    return s


def polarization(rng, kx, ky, kz) -> dict:
    """Random Stokes (Q, U, V) inside the unit ball and a random reference
    triad (m, n) of each direction k: m, n, k orthonormal, n = k x m."""
    batch = len(kx)
    stokes = rng.normal(size=(3, batch))
    stokes *= rng.random(batch) ** (1.0 / 3.0) / np.linalg.norm(stokes,
                                                                 axis=0)
    k = np.stack([kx, ky, kz]).astype(np.float64)
    k /= np.linalg.norm(k, axis=0)
    a = np.where(np.abs(k[2]) < 0.9, 2, 0)       # an axis away from k
    e = np.zeros_like(k)
    e[a, np.arange(batch)] = 1.0
    m = e - np.sum(e * k, axis=0) * k
    m /= np.linalg.norm(m, axis=0)
    n = np.cross(k, m, axis=0)
    psi = rng.uniform(0.0, 2.0 * np.pi, batch)
    m, n = np.cos(psi) * m + np.sin(psi) * n, np.cos(psi) * n - np.sin(psi) * m
    return dict(Q=stokes[0], U=stokes[1], V=stokes[2], mx=m[0], my=m[1],
                mz=m[2], nnx=n[0], nny=n[1], nnz=n[2])


def dust_state(meta, grid, batch: int, seed: int, xmax: float,
               device='cpu') -> BatchState:
    """mixed_state's lanes, all at a scattering, moved into the grid's dusty
    cells (uniform inside each), with xfreq uniform in [-xmax, xmax] (from
    the line core, where the gas wins the event split, to the wing, where
    the dust does) and unit weights."""
    rng = np.random.default_rng([seed, 2])
    s = mixed_state(meta, batch, seed, device, phases=(AT_SCATTER,))
    cells = np.argwhere(grid.rhokapD.cpu().numpy() > 0.0)
    pick = cells[rng.integers(0, len(cells), batch)]
    for a, (pos, c, amin, d) in enumerate((
            ('x', 'ic', meta.xmin, meta.dx), ('y', 'jc', meta.ymin, meta.dy),
            ('z', 'kc', meta.zmin, meta.dz))):
        v = amin + (pick[:, a] + rng.uniform(0.05, 0.95, batch)) * d
        getattr(s, pos).copy_(torch.as_tensor(v, dtype=torch.float32))
        getattr(s, c).copy_(torch.as_tensor(pick[:, a], dtype=torch.int32))
    s.xfreq.copy_(torch.as_tensor(rng.uniform(-xmax, xmax, batch),
                                  dtype=torch.float32))
    s.wgt.fill_(1.0)
    return s


def clone_state(state: BatchState) -> BatchState:
    return BatchState(**{f: getattr(state, f).clone() for f in LANE_FIELDS},
                      n_launched=state.n_launched.clone())


def copy_state_(dst: BatchState, src: BatchState) -> None:
    """Overwrite dst's buffers with src's (dst keeps its pointer table)."""
    for f in LANE_FIELDS:
        getattr(dst, f).copy_(getattr(src, f))
    dst.n_launched.copy_(src.n_launched)


def run_tallies(res):
    """(Jout in photon weight per bin, Jmu, <N_scatt>) of a RunResult: the
    normalized spectrum scaled back so that it sums to the escaped weight."""
    J = res.Jout * (res.W_escape * res.nphotons / res.Jout.sum())
    return J, res.Jmu, res.nscatt_gas


def spectra_agree(J1, Jmu1, N1, J2, Jmu2, N2, nphotons: int, nmu: int):
    """ROADMAP's statistical rules for two runs of one slab, from their f64
    tallies (Jout and Jmu summed over the run, and <N_scatt>): every
    launched photon's weight escapes (to 1e-3 each), <N> within 5%,
    chi2/dof < 3 over the populated Jout bins, and the Jmu angular
    distribution to atol 0.02.  Returns (chi2/dof, max Jmu difference)."""
    for J in (J1, J2):
        assert abs(J.sum() / nphotons - 1.0) < 1e-3, J.sum() / nphotons
    assert abs(N1 / N2 - 1.0) < 0.05, (N1, N2)
    p1, p2 = J1 / J1.sum(), J2 / J2.sum()
    sel = (p1 + p2) > (p1 + p2).max() * 1e-3
    var = (np.maximum(p1, 1e-12) + np.maximum(p2, 1e-12)) / nphotons
    chi2 = float(np.sum((p1[sel] - p2[sel]) ** 2 / var[sel])
                 / max(sel.sum(), 1))
    assert chi2 < 3.0, chi2
    m1 = np.reshape(Jmu1, (-1, nmu)).sum(axis=0)
    m2 = np.reshape(Jmu2, (-1, nmu)).sum(axis=0)
    dmu = float(np.abs(m1 / m1.sum() - m2 / m2.sum()).max())
    assert dmu < 0.02, dmu
    return chi2, dmu


def compare_states(a: BatchState, b: BatchState, rtol: float = 1e-5,
                   atol: float = 1e-6, skip: tuple = ()):
    """(fraction of lanes that differ, max |a - b| over the other lanes),
    the fields `skip` left out.

    A lane differs when an integer field differs or a float field misses
    |a - b| <= atol + rtol |b|."""
    bad = torch.zeros(a.batch, dtype=torch.bool, device=a.device)
    for f in LANE_FIELDS:
        if f in skip:
            continue
        u, v = getattr(a, f), getattr(b, f)
        if f in INT_FIELDS:
            bad |= u != v
        else:
            bad |= ~torch.isclose(u, v, rtol=rtol, atol=atol, equal_nan=True)
    good = ~bad
    err = 0.0
    for f in LANE_FIELDS:
        if f not in INT_FIELDS and f not in skip and bool(good.any()):
            d = (getattr(a, f) - getattr(b, f)).abs()[good]
            err = max(err, float(d.max()))
    return float(bad.float().mean()), err


# --- the Dijkstra sphere acceptance test (tools/acceptance.py:41-106)
CHI2_DOF_MAX = 3.0
XPEAK_RTOL = 0.12
SYS_COEF = 0.8      # finite-(a tau0) model-error floor, in peak units


def dijkstra_J(x, atau0):
    """Dijkstra+2006 eq. A7 central-source uniform-sphere spectrum."""
    c = np.sqrt(2.0 * np.pi ** 3 / 27.0)
    return x ** 2 / (1.0 + np.cosh(np.clip(c * np.abs(x) ** 3 / atau0,
                                           0, 700)))


def _trapezoid(y, x):
    dx = np.diff(x)
    return float(np.sum(0.5 * (y[1:] + y[:-1]) * dx))


def shape_chi2(x, J_model, J_analytic, n_eff, atau0=None):
    """chi2/dof of the unit-area-normalized model vs analytic shape, with
    the MC sigma under the analytic hypothesis and, when atau0 is given,
    the SYS_COEF floor in quadrature.  Returns (chi2, chi2_raw, ndof, pm,
    pa) with chi2_raw the MC-noise-only statistic."""
    pa = J_analytic / _trapezoid(J_analytic, x)
    norm = _trapezoid(J_model, x)
    pm = J_model / norm if norm > 0 else J_model
    dx = x[1] - x[0]
    sel = pa > pa.max() * 3e-3
    frac = np.maximum(pa * dx, 1e-12)           # expected prob. per bin
    sig_mc = np.sqrt(frac / n_eff) / dx         # sigma of pm (density units)
    chi2_raw = float(np.sum(((pm[sel] - pa[sel]) / sig_mc[sel]) ** 2))
    sig_sys = SYS_COEF * atau0 ** (-1.0 / 3.0) * pa.max() if atau0 else 0.0
    sigma = np.sqrt(sig_mc ** 2 + sig_sys ** 2)
    chi2 = float(np.sum(((pm[sel] - pa[sel]) / sigma[sel]) ** 2))
    return chi2, chi2_raw, int(sel.sum()), pm, pa


# --- the all-photons table (save_all_photons; transport/allph.py)
# the bins of each column's histogram: the birth frequencies of a Voigt
# source fill a few Doppler widths of the band, the escapes most of it
ALLPH_BINS = {'xfreq1': 240, 'xfreq2': 48, 'rp': 24}
ALLPH_Q = (0.05, 0.5, 0.95)


def allph_edges(xfreq_min: float, xfreq_max: float, rmax: float) -> dict:
    """The histogram edges of the table's xfreq1, xfreq2 (the spectrum's
    band) and rp ([0, sqrt 3 rmax], the box's corner) columns."""
    n = ALLPH_BINS
    return {'xfreq1': np.linspace(xfreq_min, xfreq_max, n['xfreq1'] + 1),
            'xfreq2': np.linspace(xfreq_min, xfreq_max, n['xfreq2'] + 1),
            'rp': np.linspace(0.0, np.sqrt(3.0) * rmax, n['rp'] + 1)}


def allph_summary(ap: dict, edges: dict) -> dict:
    """What a run's table says, in a few numbers (either package's
    {column: (n,)} table): its rows, <nscatt_gas> and one photon's spread,
    <nscatt_dust>, the share of rows never written (xfreq1 and nscatt_gas
    both 0), rp's largest value and 95% quantile, rp0's largest, the sums
    of nscatt_gas and I, the quantiles ALLPH_Q and the histograms over
    `edges` of xfreq1, xfreq2 and rp."""
    a = {k: np.asarray(v, np.float64) for k, v in ap.items()}
    ns = a['nscatt_gas']
    out = {'n': int(ns.size), 'N': float(ns.mean()),
           'N_spread': float(ns.std()), 'Nd': float(a['nscatt_dust'].mean()),
           'zero_rows': float(((a['xfreq1'] == 0.0) & (ns == 0.0)).mean()),
           'rp_max': float(a['rp'].max()),
           'rp_q95': float(np.quantile(a['rp'], 0.95)),
           'rp0_max': float(np.abs(a['rp0']).max()),
           'sum_nsg': float(ns.sum()),
           'sum_I': float(a['I'].sum()) if 'I' in a else None,
           'quantiles': {}, 'hist': {}}
    for k, e in edges.items():
        out['quantiles'][k] = [float(q) for q in np.quantile(a[k], ALLPH_Q)]
        out['hist'][k] = np.histogram(a[k], bins=e)[0].tolist()
    return out


def hist_chi2(h1, h2, min_count: int = 10):
    """(chi^2/dof, dof) of two histograms of different totals over the
    bins holding at least min_count counts in all: sum (K1 h1 - K2 h2)^2 /
    (h1 + h2), K1 = sqrt(n2 / n1), K2 = 1 / K1, with dof the bins less
    one."""
    h1, h2 = np.asarray(h1, np.float64), np.asarray(h2, np.float64)
    use = (h1 + h2) >= min_count
    n1, n2 = h1[use].sum(), h2[use].sum()
    k1 = np.sqrt(n2 / n1)
    chi2 = float(np.sum((k1 * h1[use] - h2[use] / k1) ** 2
                        / (h1[use] + h2[use])))
    dof = int(use.sum()) - 1
    return chi2 / max(dof, 1), dof


def allph_closures(res, summary: dict) -> dict:
    """The checks every run's table passes (either package's RunResult and
    its allph_summary), as {name: (value, limit)}, each value within its
    limit: at most 2% of the rows never written; rp0 0 for a source at
    the centre; rp at most sqrt(3) rmax and its 95% quantile at most rmax;
    sum nscatt_gas the run's nscatt_events to 1e-5; with Stokes, sum I at
    most W_esc + W_abs + W_oor (the rows carry the weight after the forced
    first scattering, which leaves the birth weight's escaped fraction in
    Jout: engine.py:1390-1392)."""
    par, n = res.cfg.par, res.nphotons
    rmax = par.rmax
    events = res.nscatt_events * n
    out = {'zero_rows': (summary['zero_rows'], 0.02),
           'rp_max': (summary['rp_max'], np.sqrt(3.0) * rmax + 1e-4),
           'rp_q95': (summary['rp_q95'], rmax + 1e-4),
           'nsg_closure': (abs(summary['sum_nsg'] - events)
                           / max(events, 1.0), 1e-5)}
    if (par.xs_point, par.ys_point, par.zs_point) == (0.0, 0.0, 0.0) \
            and par.source_geometry.strip().lower() in ('', 'point'):
        out['rp0_max'] = (summary['rp0_max'], 1e-6)
    if summary['sum_I'] is not None:
        w = (res.W_escape + (res.W_absorb or 0.0) + res.W_oor) * n
        out['I_excess'] = ((summary['sum_I'] - w) / n, 1e-6)
    return out


def shrink_rank(n_lanes: int, alive_share: float, B_new: int, seed: int,
                device) -> dict:
    """One rank of a process group on synthetic lanes, through the drain's
    shrink across ranks (parallel/reduce.shrink): rank r's n_lanes lanes
    carry the photon ids r * n_lanes + i (and x = id), a seeded share of
    them alive.  Returns the rank's lanes before and after as numpy
    {'alive', 'pid', 'x'}, and its n_launched after."""
    from .parallel.distributed import process_index
    from .parallel.reduce import shrink
    rank = process_index()
    g = torch.Generator().manual_seed(seed + rank)
    alive = torch.rand(n_lanes, generator=g) < alive_share
    st = init_state(n_lanes, device)
    st.phase.copy_(torch.where(alive, FLYING, DEAD))
    st.pid.copy_(torch.arange(n_lanes, dtype=torch.int32) + rank * n_lanes)
    st.x.copy_(st.pid.float())
    st.n_launched.fill_(n_lanes + rank)
    new = shrink(st, B_new)

    def lanes(s):
        return {'alive': (s.phase != DEAD).cpu().numpy(),
                'pid': s.pid.cpu().numpy(), 'x': s.x.cpu().numpy()}
    return {'before': lanes(st), 'after': lanes(new),
            'n_launched': int(new.n_launched[0])}


def rank_table_closures(res, launched: int) -> dict:
    """The closures of a run of several ranks with save_all_photons (its
    RunResult and its launched photons, summed over the ranks), as {name:
    (value, limit)}: every photon of the budget launched; no row without
    its birth (xfreq1) or its death (xfreq2); the table's nscatt_gas sums
    to the run's events to 1e-5.  With n launches over n ids every id
    then has one birth row, and with n deaths one death row: no two
    ranks wrote one id."""
    a, n = res.allph, res.nphotons
    events = res.nscatt_events * n
    return {'launched': (abs(launched - n), 0),
            'unborn': (int((a['xfreq1'] == 0.0).sum()), 0),
            'undead': (int((a['xfreq2'] == 0.0).sum()), 0),
            'nsg_closure': (abs(float(a['nscatt_gas'].sum()) - events)
                            / max(events, 1.0), 1e-5)}
