"""Observer geometry: Euler-angle / coordinate placement + TAN image plane.

Port of lart_tpu/instruments/observer.py:53-224 (observer_create_outside,
reference src/observer_rect.f90:10-338) for external observers: up to
MAX_OBSERVERS observers, each defined either by Euler angles (alpha, beta,
gamma) or by coordinates (obsx, obsy, obsz); the rotation matrix grid ->
observer; the auto field of view from the 8 box vertices (or the sphere
radius); the steradian of a pixel.  Host numpy in float64; the positions
and rotation matrices go to the device as f32, as lart_tpu places them.
With nside > 0 (observer.py:59-84, observer_create_inside, reference
src/observer_heal.f90:10-75) the observers sit inside the grid and see the
whole sky in HEALPix RING maps: the first obsx/obsy/obsz triple (a NaN
component taken as 0) and every further finite triple, identity rotation
matrices, nxim = npix and nyim = 1 (so every cube keeps its layout), and
4 pi / npix steradian a pixel.
"""


from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ResolvedConfig

DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi
MAX_OBSERVERS = 181


@dataclasses.dataclass(frozen=True)
class ObserverSetMeta:
    nobs: int
    nxim: int
    nyim: int
    dxim: float          # deg/pixel
    dyim: float
    distance: float
    steradian_pix: float
    # interior all-sky observer (nside > 0): HEALPix RING maps instead of
    # TAN images (observer_create_inside, reference src/observer_heal.f90:
    # 10-75); nxim = npix, nyim = 1 so every cube keeps its layout
    inside: bool = False
    nside: int = 0
    npix: int = 0
    pos_host: object = None   # (nobs, 3) host copy of observer positions


class ObserverDevice(NamedTuple):
    pos: torch.Tensor       # (nobs, 3) f32
    rmat: torch.Tensor      # (nobs, 3, 3) f32, grid -> observer


def _fin(v):
    return v == v and abs(v) != math.inf


def build_observers(cfg: ResolvedConfig, device='cpu'
                    ) -> Optional[Tuple[ObserverSetMeta, ObserverDevice]]:
    par = cfg.par
    if not par.save_peeloff:
        return None
    if par.nside > 0:
        return _build_inside(par, device)

    def arr(t, n):
        out = list(t) + [float('nan')] * (n - len(t))
        return np.array(out[:n], np.float64)

    nmax = MAX_OBSERVERS
    alpha = arr(par.alpha, nmax)
    beta = arr(par.beta, nmax)
    gamma = arr(par.gamma, nmax)
    # angle aliases (observer_rect.f90:41-44): alpha = -phase_angle, etc.
    pa = arr(par.phase_angle, nmax)
    ia = arr(par.inclination_angle, nmax)
    po = arr(par.position_angle, nmax)
    alpha = np.where(np.isfinite(pa), -pa, alpha)
    beta = np.where(np.isfinite(ia), -ia, beta)
    gamma = np.where(np.isfinite(po), -po, gamma)
    obsx = arr(par.obsx, nmax)
    obsy = arr(par.obsy, nmax)
    obsz = arr(par.obsz, nmax)

    # fill missing alpha/beta with 0 when the other is given
    m = np.isfinite(beta) & ~np.isfinite(alpha)
    alpha[m] = 0.0
    m = np.isfinite(alpha) & ~np.isfinite(beta)
    beta[m] = 0.0

    distance = par.distance
    box = max(par.xmax, par.ymax, par.zmax)

    use_angles = np.isfinite(alpha[0]) and np.isfinite(beta[0])
    use_coords = (np.isfinite(obsx[0]) and np.isfinite(obsy[0])
                  and np.isfinite(obsz[0]))
    if not use_angles and not use_coords:
        # default single observer on the +z axis (observer_rect.f90:61-75)
        if not _fin(distance) or distance <= 0:
            distance = box * 100.0
        alpha[0], beta[0] = 0.0, 0.0
        use_angles = True

    rc = np.array([par.rotation_center_x if _fin(par.rotation_center_x) else 0.0,
                   par.rotation_center_y if _fin(par.rotation_center_y) else 0.0,
                   par.rotation_center_z if _fin(par.rotation_center_z) else 0.0])

    positions, rmats = [], []
    if use_angles:
        nobs = int(np.sum(np.isfinite(alpha) & np.isfinite(beta)))
        if not _fin(distance) or distance <= 0:
            distance = box * 100.0
        for i in range(nobs):
            g = gamma[i]
            if not np.isfinite(g):
                g = 90.0 if 0.0 < beta[i] <= 90.0 else \
                    (-90.0 if beta[i] > 90.0 else 0.0)
            ca, sa = math.cos(alpha[i] * DEG2RAD), math.sin(alpha[i] * DEG2RAD)
            cb, sb = math.cos(beta[i] * DEG2RAD), math.sin(beta[i] * DEG2RAD)
            cg, sg = math.cos(g * DEG2RAD), math.sin(g * DEG2RAD)
            pos = np.array([distance * ca * sb, distance * sa * sb,
                            distance * cb]) + rc
            R = np.array([
                [ca * cb * cg - sa * sg, sa * cb * cg + ca * sg, -sb * cg],
                [-ca * cb * sg - sa * cg, -sa * cb * sg + ca * cg, sb * sg],
                [ca * sb, sa * sb, cb]])
            positions.append(pos)
            rmats.append(R)
    else:
        nobs = int(np.sum(np.isfinite(obsx) & np.isfinite(obsy)
                          & np.isfinite(obsz)))
        if not _fin(distance) or distance <= 0:
            distance = math.sqrt(obsx[0] ** 2 + obsy[0] ** 2 + obsz[0] ** 2)
            if distance < 10.0 * box:
                distance = box * 100.0
        for i in range(nobs):
            norm = math.sqrt(obsx[i] ** 2 + obsy[i] ** 2 + obsz[i] ** 2)
            scale = distance / norm
            if scale > 1.001:
                pos = np.array([obsx[i], obsy[i], obsz[i]]) * scale + rc
            else:
                pos = np.array([obsx[i], obsy[i], obsz[i]])
            cb = (pos[2] - rc[2]) / distance
            cb = max(-1.0, min(1.0, cb))
            sb = math.sqrt(1.0 - cb * cb)
            beta_i = math.atan2(sb, cb) * RAD2DEG
            g = gamma[i]
            if not np.isfinite(g):
                g = 90.0 if 0.0 < beta_i <= 90.0 else \
                    (-90.0 if beta_i > 90.0 else 0.0)
            cg, sg = math.cos(g * DEG2RAD), math.sin(g * DEG2RAD)
            if sb == 0.0:
                ca, sa = 1.0, 0.0
            else:
                aa = math.atan2(pos[1] - rc[1], pos[0] - rc[0])
                ca, sa = math.cos(aa), math.sin(aa)
            R = np.array([
                [ca * cb * cg - sa * sg, sa * cb * cg + ca * sg, -sb * cg],
                [-ca * cb * sg - sa * cg, -sa * cb * sg + ca * cg, sb * sg],
                [ca * sb, sa * sb, cb]])
            positions.append(pos)
            rmats.append(R)

    positions = np.stack(positions)
    rmats = np.stack(rmats)

    # image plane: auto FOV (observer_rect.f90:243-276)
    dxim, dyim = par.dxim, par.dyim
    if not (_fin(dxim) and dxim > 0 and _fin(dyim) and dyim > 0):
        if par.geometry.strip().lower() == 'sphere':
            half = math.asin(min(par.rmax / distance, 1.0))
            dxim = half / (par.nxim / 2.0) * RAD2DEG
            dyim = half / (par.nyim / 2.0) * RAD2DEG
        else:
            vx = np.array([1, 1, 1, -1, -1, -1, 1, -1]) * par.xmax
            vy = np.array([1, 1, -1, 1, -1, 1, -1, -1]) * par.ymax
            vz = np.array([1, -1, 1, 1, 1, -1, -1, -1]) * par.zmax
            max_ax = max_ay = -999.0
            for i in range(len(positions)):
                px = positions[i, 0] - vx
                py = positions[i, 1] - vy
                pz = positions[i, 2] - vz
                k = rmats[i] @ np.stack([px, py, pz])
                ang_x = np.abs(np.arctan2(-k[0], k[2]))
                ang_y = np.abs(np.arctan2(-k[1], k[2]))
                max_ax = max(max_ax, float(ang_x.max()))
                max_ay = max(max_ay, float(ang_y.max()))
            if par.nxim == par.nyim:
                half = max(max_ax, max_ay)
                dxim = half / (par.nxim / 2.0) * RAD2DEG
                dyim = half / (par.nyim / 2.0) * RAD2DEG
            else:
                dxim = max_ax / (par.nxim / 2.0) * RAD2DEG
                dyim = max_ay / (par.nyim / 2.0) * RAD2DEG

    meta = ObserverSetMeta(
        nobs=len(positions), nxim=par.nxim, nyim=par.nyim,
        dxim=float(dxim), dyim=float(dyim), distance=float(distance),
        steradian_pix=float(dxim * dyim * DEG2RAD ** 2),
        pos_host=positions)
    dev = ObserverDevice(
        pos=torch.as_tensor(positions, dtype=torch.float32, device=device),
        rmat=torch.as_tensor(rmats, dtype=torch.float32, device=device))
    return meta, dev


def _build_inside(par, device) -> Tuple[ObserverSetMeta, ObserverDevice]:
    """Interior all-sky observers (nside > 0): HEALPix RING maps."""
    from .healpix import nside2npix
    nside = par.nside
    npix = nside2npix(nside)

    def fin_or(t, d):
        v = t[0] if t else float('nan')
        return float(v) if _fin(v) else d
    xs = [fin_or(par.obsx, 0.0)]
    ys = [fin_or(par.obsy, 0.0)]
    zs = [fin_or(par.obsz, 0.0)]
    # additional finite coordinate triples -> more interior observers
    for i in range(1, min(len(par.obsx), len(par.obsy), len(par.obsz))):
        if _fin(par.obsx[i]) and _fin(par.obsy[i]) and _fin(par.obsz[i]):
            xs.append(par.obsx[i])
            ys.append(par.obsy[i])
            zs.append(par.obsz[i])
    positions = np.stack([np.array([x, y, z]) for x, y, z in zip(xs, ys, zs)])
    rmats = np.broadcast_to(np.eye(3), (len(xs), 3, 3)).copy()
    meta = ObserverSetMeta(
        nobs=len(xs), nxim=npix, nyim=1, dxim=0.0, dyim=0.0, distance=0.0,
        steradian_pix=4.0 * math.pi / npix, inside=True, nside=nside,
        npix=npix, pos_host=positions)
    dev = ObserverDevice(
        pos=torch.as_tensor(positions, dtype=torch.float32, device=device),
        rmat=torch.as_tensor(rmats, dtype=torch.float32, device=device))
    return meta, dev
