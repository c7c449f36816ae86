"""Radial intensity / Stokes profiles from peel-off images.

Rebuilds make_radial_intensity / make_radial_stokes (reference:
src/output_sum_rect.f90:489-659): azimuthal averages of the peel cubes
around the image center, with the tangential-frame Stokes rotation for the
polarization profile (Q rotated so +Q = tangential).

The port's own copy of lart_tpu/instruments/profiles.py, which is numpy
only: lart_tpu_torch imports nothing of lart_tpu.  Keep the two in step.
"""

from __future__ import annotations

import numpy as np


def radial_axes(nxim: int, nyim: int):
    nr = (max(nxim, nyim) + 1) // 2
    i = np.arange(1, nr + 1)
    if nr % 2 == 0:
        r = (i - 0.5) / nr
    else:
        r = (i - 1.0) / (nr - 0.5)
    return nr, r


def _ring_index(nxim: int, nyim: int, nr: int):
    xcen = (nxim + 1.0) / 2.0
    ycen = (nxim + 1.0) / 2.0
    ii, jj = np.meshgrid(np.arange(1, nxim + 1), np.arange(1, nyim + 1),
                         indexing='ij')
    xx = ii - xcen
    yy = jj - ycen
    rr = np.sqrt(xx * xx + yy * yy)
    ir = (np.floor(rr).astype(int) if nr % 2 == 0
          else np.floor(rr + 0.5).astype(int))
    return ir, xx, yy, rr


def radial_intensity(scatt, direc, bin_unit: float):
    """scatt/direc: (nxfreq, nxim, nyim) cubes -> (r, I(r))."""
    nxf, nxim, nyim = scatt.shape
    nr, r = radial_axes(nxim, nyim)
    ir, _, _, _ = _ring_index(nxim, nyim, nr)
    img = (scatt.sum(axis=0) + direc.sum(axis=0)) * bin_unit
    valid = ir < nr
    num = np.bincount(ir[valid], weights=img[valid], minlength=nr)[:nr]
    cnt = np.bincount(ir[valid], minlength=nr)[:nr]
    out = np.where(cnt > 0, num / np.maximum(cnt, 1), 0.0)
    return r, out


def radial_stokes(I, Q, U, V, bin_unit: float):
    """Tangential-frame radial Stokes profiles + polarization degree."""
    nxf, nxim, nyim = I.shape
    nr, r = radial_axes(nxim, nyim)
    ir, xx, yy, rr = _ring_index(nxim, nyim, nr)
    with np.errstate(invalid='ignore', divide='ignore'):
        cosp = np.where(rr > 0, yy / np.maximum(rr, 1e-300), 1.0)
        sinp = np.where(rr > 0, -xx / np.maximum(rr, 1e-300), 0.0)
    cos2p = 2.0 * cosp ** 2 - 1.0
    sin2p = 2.0 * cosp * sinp
    Ii = I.sum(axis=0) * bin_unit
    Qi = Q.sum(axis=0) * bin_unit
    Ui = U.sum(axis=0) * bin_unit
    Vi = V.sum(axis=0) * bin_unit
    Qt = Qi * cos2p + Ui * sin2p
    Ut = -Qi * sin2p + Ui * cos2p
    valid = ir < nr
    cnt = np.bincount(ir[valid], minlength=nr)[:nr].astype(float)

    def rad(img):
        s = np.bincount(ir[valid], weights=img[valid], minlength=nr)[:nr]
        return np.where(cnt > 0, s / np.maximum(cnt, 1.0), 0.0)

    rI, rQ, rU, rV = rad(Ii), rad(Qt), rad(Ut), rad(Vi)
    with np.errstate(invalid='ignore', divide='ignore'):
        pol = np.where(rI > 0, np.sqrt(rQ ** 2 + rU ** 2)
                       / np.maximum(rI, 1e-300), 0.0)
    return r, rI, rQ, rU, rV, pol
