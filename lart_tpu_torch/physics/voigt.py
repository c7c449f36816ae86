"""Voigt-Hjerting function H(x, a) = Re[w(x + i a)], Humlicek (1982) w4.

`voigt_plain` is the plain PyTorch version of lart_tpu/physics/voigt.py
(:23 _humlicek_w4_real, :104 voigt): the same four regions, formulas and
operation order, every region evaluated and one selected per element.
`voigt` is the wrapper of kernel K1 (csrc/voigt.cu): it launches the
kernel for a CUDA tensor and takes the plain version for a CPU tensor.
The flight kernel inlines the same device function (csrc/voigt.cuh).
"""

from __future__ import annotations

import torch

from ..kernels import build as kbuild

_ONE_OVER_SQRTPI = 0.5641895835477563


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv_re(ar, ai, br, bi):
    """Re[(ar + i ai) / (br + i bi)] with a safe denominator."""
    den = br * br + bi * bi
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    return (ar * br + ai * bi) / den


def voigt_plain(x: torch.Tensor, a) -> torch.Tensor:
    """H(x, a) for f32 x and a (a broadcast to x)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(a, dtype=torch.float32, device=x.device)
    x, y = torch.broadcast_tensors(x, y)
    ax = torch.abs(x)
    s = ax + y
    tr, ti = y, -x                       # t = y - i x
    ur = tr * tr - ti * ti               # u = t^2
    ui = 2.0 * tr * ti

    # region I: w = t / sqrt(pi) / (0.5 + t^2)
    w1 = _cdiv_re(_ONE_OVER_SQRTPI * tr, _ONE_OVER_SQRTPI * ti, 0.5 + ur, ui)

    # region II: w = t (1.410474 + 0.5641896 u) / (0.75 + u (3 + u))
    nr, ni = _cmul(tr, ti, 1.410474 + 0.5641896 * ur, 0.5641896 * ui)
    br, bi = _cmul(ur, ui, 3.0 + ur, ui)
    w2 = _cdiv_re(nr, ni, 0.75 + br, bi)

    # region III: degree-4/5 rational in t
    def poly_t(coefs):
        pr = torch.full_like(x, coefs[0])
        pi = torch.zeros_like(x)
        for c in coefs[1:]:
            pr, pi = _cmul(pr, pi, tr, ti)
            pr = pr + c
        return pr, pi

    nr, ni = poly_t([0.5642236, 3.778987, 11.96482, 20.20933, 16.4955])
    br, bi = poly_t([1.0, 6.699398, 21.69274, 39.27121, 38.82363, 16.4955])
    w3 = _cdiv_re(nr, ni, br, bi)

    # region IV: w = exp(u) - t P(u) / Q(u), nested from the highest power
    def poly_u_down(coefs):
        pr = torch.full_like(x, coefs[-1])
        pi = torch.zeros_like(x)
        for c in coefs[-2::-1]:
            qr, qi = _cmul(ur, ui, pr, pi)
            pr, pi = c - qr, -qi
        return pr, pi

    pr, pi = poly_u_down([36183.31, 3321.9905, 1540.787, 219.0313, 35.76683,
                          1.320522, 0.56419])
    dr, di = poly_u_down([32066.6, 24322.84, 9022.228, 2186.181, 364.2191,
                          61.57037, 1.841439, 1.0])
    nr, ni = _cmul(tr, ti, pr, pi)
    e_r = torch.exp(torch.clamp(ur, -88.0, 50.0)) * torch.cos(ui)
    w4 = e_r - _cdiv_re(nr, ni, dr, di)

    in1 = s >= 15.0
    in2 = ~in1 & (s >= 5.5)
    in3 = (s < 5.5) & (y >= 0.195 * ax - 0.176)
    return torch.where(in1, w1, torch.where(in2, w2,
                                            torch.where(in3, w3, w4)))


def voigt(x: torch.Tensor, a) -> torch.Tensor:
    """H(x, a): kernel K1 for a CUDA tensor, the plain version on the CPU."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device.type == 'cpu':
        return voigt_plain(x, a)
    if isinstance(a, torch.Tensor):
        x, y = (t.contiguous() for t in torch.broadcast_tensors(
            x, a.to(x.device, torch.float32)))
    else:   # a fill on the device, not a host-to-device copy
        x = x.contiguous()
        y = torch.full_like(x, float(a))
    out = torch.empty_like(x)
    kbuild.require_cuda('voigt_h', x, y, out)
    kbuild.check(kbuild.library().lart_voigt_h(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
        kbuild.stream_of(x)), 'voigt_h')
    kbuild.LAUNCHES['voigt_h'] += 1
    return out
