"""Inputs and comparisons shared by the tests and chip_smoke.py.

Everything random here is drawn with numpy from a seed, so the JAX
reference, the plain PyTorch versions and the CUDA kernels can be handed
the identical input.  The analytic sphere spectrum and its shape test are
jax-free copies of tools/acceptance.py's (which imports lart_tpu.driver,
and so jax).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lart_tpu.config import Params

from .transport.state import (AT_SCATTER, DEAD, FFS, FLYING, INT_FIELDS,
                              LANE_FIELDS, BatchState)


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
                  tau_target=tau_target, tau_run=tau_run)
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
    out = {f: torch.as_tensor(np.asarray(fields[f], np.int32 if f in
                                         INT_FIELDS else f32),
                              device=device) for f in LANE_FIELDS}
    return BatchState(**out, n_launched=torch.zeros((1,), dtype=torch.int32,
                                                    device=device))


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
                   atol: float = 1e-6):
    """(fraction of lanes that differ, max |a - b| over the other lanes).

    A lane differs when an integer field differs or a float field misses
    |a - b| <= atol + rtol |b|."""
    bad = torch.zeros(a.batch, dtype=torch.bool, device=a.device)
    for f in LANE_FIELDS:
        u, v = getattr(a, f), getattr(b, f)
        if f in INT_FIELDS:
            bad |= u != v
        else:
            bad |= ~torch.isclose(u, v, rtol=rtol, atol=atol, equal_nan=True)
    good = ~bad
    err = 0.0
    for f in LANE_FIELDS:
        if f not in INT_FIELDS and bool(good.any()):
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
