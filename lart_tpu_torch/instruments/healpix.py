"""HEALPix RING-scheme pixelization for the interior all-sky observer.

Port of lart_tpu/instruments/healpix.py (the reference's native HEALPix
subset, src/healpix.f90:29-186): nside2npix, vec2pix_ring and
pix2vec_ring, with 0-based pixel ids.  The arithmetic is lart_tpu's in f32,
operation for operation; csrc/healpix.cuh repeats it for the kernels (K7
pixelizes each peel direction with vec2pix_ring, K11 casts each map ray
along pix2vec_ring).  lart_tpu's vec2pix_ring runs inside the jitted peel,
where XLA divides by the constant pi/2 as a multiply by its f32 reciprocal
and rounds z 0.75 before adding it to 0.5 + tt (with one fused
multiply-add there, directions on the ring boundary z = 2/3 land in the
next ring); its pix2vec_ring runs eagerly in the sightline's set-up, one
operation at a time, each rounded on its own.  Python's and torch's // and
% floor toward minus infinity, as jnp's do; csrc/healpix.cuh uses
floor-division helpers where an operand can be negative.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWOTHIRD = 2.0 / 3.0
HALFPI = 0.5 * math.pi
TWOPI = 2.0 * math.pi
# x / (pi/2) as XLA computes it inside a jit: x times the f32 reciprocal
INV_HALFPI = float(np.float32(1.0) / np.float32(HALFPI))


def nside2npix(nside: int) -> int:
    if nside < 1 or nside > 8192 or (nside & (nside - 1)) != 0:
        raise ValueError(f'invalid nside {nside} (power of 2, <= 8192)')
    return 12 * nside * nside


def vec2pix_ring(nside: int, vx, vy, vz) -> torch.Tensor:
    """RING-scheme pixel id (0-based, int32) holding direction (vx, vy,
    vz), f32 tensors."""
    norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
    z = vz / norm
    phi = torch.atan2(vy, vx)
    phi = torch.where(phi < 0.0, phi + np.float32(TWOPI), phi)
    tt = phi * INV_HALFPI                      # in [0, 4)
    za = torch.abs(z)
    fn = float(nside)
    nl4 = 4 * nside
    ncap = 2 * nside * (nside - 1)
    npix = 12 * nside * nside

    # equatorial region
    half_tt = 0.5 + tt
    z34 = z * 0.75
    jp = torch.floor(fn * (half_tt - z34)).to(torch.int32)
    jm = torch.floor(fn * (half_tt + z34)).to(torch.int32)
    ir = nside + 1 + jp - jm                   # ring index from z = 2/3
    kshift = torch.where(ir % 2 == 0, 1, 0).to(torch.int32)
    ip = (jp + jm - nside + kshift + 1) // 2 + 1
    ip = torch.where(ip > nl4, ip - nl4, ip)
    pix_eq = ncap + nl4 * (ir - 1) + ip

    # polar caps
    tp = tt - torch.floor(tt)
    tmp = fn * torch.sqrt(3.0 * (1.0 - za))
    jpc = torch.floor(tp * tmp).to(torch.int32)
    jmc = torch.floor((1.0 - tp) * tmp).to(torch.int32)
    irc = jpc + jmc + 1
    ipc = torch.floor(tt * irc.to(torch.float32)).to(torch.int32) + 1
    ipc = torch.where(ipc > 4 * irc, ipc - 4 * irc, ipc)
    pix_n = 2 * irc * (irc - 1) + ipc
    pix_s = npix - 2 * irc * (irc + 1) + ipc

    pix_cap = torch.where(z > 0.0, pix_n, pix_s)
    pix1 = torch.where(za <= np.float32(TWOTHIRD), pix_eq, pix_cap)
    return (pix1 - 1).to(torch.int32)


def _cap_ring(h: torch.Tensor) -> torch.Tensor:
    """The ring (1-based) of a polar-cap pixel from h = ipix1 / 2."""
    fih = torch.floor(h)
    return torch.floor(torch.sqrt(torch.clamp_min(
        h - torch.sqrt(fih), 0.0))).to(torch.int32) + 1


def pix2vec_ring(nside: int, ipix: torch.Tensor):
    """Unit vector (f32 x, y, z) of the centre of 0-based RING pixels
    ipix (an integer tensor), each operation rounded on its own."""
    f = torch.float32
    ipix1 = ipix.to(torch.int32) + 1
    npix = 12 * nside * nside
    nl2 = 2 * nside
    nl4 = 4 * nside
    ncap = 2 * nside * (nside - 1)
    dev = ipix.device

    def c(v):
        return torch.full((), v, dtype=f, device=dev)
    fact1 = c(1.5 * nside)
    fact2 = c(3.0 * nside * nside)
    pi = c(math.pi)

    # north polar cap
    iring_n = _cap_ring(ipix1.to(f) / c(2.0))
    iphi_n = ipix1 - 2 * iring_n * (iring_n - 1)
    z_n = 1.0 - (iring_n * iring_n).to(f) / fact2
    phi_n = (iphi_n.to(f) - 0.5) * pi / (2.0 * iring_n.to(f))

    # equatorial region
    ipe = ipix1 - ncap - 1
    iring_e = ipe // nl4 + nside
    iphi_e = ipe % nl4 + 1
    fodd = 0.5 * (1 + (iring_e + nside) % 2).to(f)
    z_e = (nl2 - iring_e).to(f) / fact1
    phi_e = (iphi_e.to(f) - fodd) * pi / c(2.0 * nside)

    # south polar cap
    ips = npix - ipix1 + 1
    iring_s = _cap_ring(ips.to(f) / c(2.0))
    iphi_s = 4 * iring_s + 1 - (ips - 2 * iring_s * (iring_s - 1))
    z_s = -1.0 + (iring_s * iring_s).to(f) / fact2
    phi_s = (iphi_s.to(f) - 0.5) * pi / (2.0 * iring_s.to(f))

    in_n = ipix1 <= ncap
    in_e = ~in_n & (ipix1 <= nl2 * (5 * nside + 1))
    z = torch.where(in_n, z_n, torch.where(in_e, z_e, z_s))
    phi = torch.where(in_n, phi_n, torch.where(in_e, phi_e, phi_s))
    sth = torch.sqrt(torch.clamp_min((1.0 - z) * (1.0 + z), 0.0))
    return sth * torch.cos(phi), sth * torch.sin(phi), z
