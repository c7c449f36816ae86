"""Plain PyTorch versions of the batched samplers, uniforms from the caller.

Counterparts of lart_tpu/physics/samplers.py: vz_envelope (:70) and
vz_round_xi (:128), the Voigt-conditional parallel atom velocity by
composite-envelope rejection in masked rounds; rand_resonance_cost (:210),
the dipole cos(theta); rand_voigt_x (:237), the Voigt input spectrum.  Each
takes its uniforms (and the Voigt draw its normal's uniforms) as arguments,
so the tests feed the JAX functions and these the same numbers, and the
CUDA kernels' per-lane twins (csrc/samplers.cuh) see the same Philox
uniforms as these do.  There is no kernel here: the twins are inlined into
the refill and scatter kernels.
"""

from __future__ import annotations

import dataclasses
import math

import torch

PI = math.pi
TWOPI = 2.0 * math.pi
TWO_OVER_PI = 2.0 / math.pi
XC_SEON = 1.0 + math.sqrt(2.0)   # piecewise-envelope switch
X0_CRIT = 1.0                    # core/wing switch


@dataclasses.dataclass
class VzEnvelope:
    """Per-lane envelope constants (fields as samplers.VzEnvelope)."""
    core: torch.Tensor
    x0: torch.Tensor
    sgn: torch.Tensor
    a: torch.Tensor
    S0: torch.Tensor
    S01: torch.Tensor
    Stot: torch.Tensor
    beta0: torch.Tensor
    lo1: torch.Tensor
    w1: torch.Tensor
    C1: torch.Tensor
    lo2: torch.Tensor
    w2: torch.Tensor
    C2: torch.Tensor


def _sel(cond, a, b):
    return torch.where(cond, a, b)


def vz_envelope(xin: torch.Tensor, a) -> VzEnvelope:
    """Envelope constants for f(u) ~ exp(-u^2) / ((x0 - u)^2 + a^2)."""
    x0 = torch.abs(xin)
    a = torch.as_tensor(a, dtype=torch.float32, device=x0.device
                        ).expand_as(x0).contiguous()
    sgn = _sel(xin < 0.0, torch.full_like(x0, -1.0), torch.ones_like(x0))
    core = x0 <= X0_CRIT

    x0s = torch.clamp_min(x0, 1.001)
    x0sq = x0s * x0s
    beta0 = torch.exp(-0.5 * x0sq)
    h0 = beta0 / (2.0 * a)
    h0_two = beta0 / a

    dbeta = torch.sqrt(TWO_OVER_PI * a * (1.0 - beta0) * beta0 * x0s)
    beta1 = beta0 + dbeta
    pb1sq = -2.0 * torch.log(beta1)
    denom1 = torch.clamp_min(x0sq - pb1sq, 1e-20)
    h1 = TWO_OVER_PI * beta1 * torch.sqrt(torch.clamp_min(pb1sq, 0.0)) / denom1
    h2 = 0.3861 / torch.clamp_min(x0sq - 1.373, 1e-20)

    in_A = x0s < XC_SEON
    b1 = ~in_A & (h0_two < h2)
    b2 = ~in_A & ~b1 & (h0 < h2)
    b3 = ~in_A & ~b1 & ~b2
    hmax = torch.maximum(h1, h2)
    zero = torch.zeros_like(x0)

    S0 = _sel(b1, zero, beta0 * h0)
    S1 = _sel(in_A, dbeta * h0,
              _sel(b1, h2, _sel(b2, (1.0 - beta0) * h2, dbeta * h0)))
    S2 = _sel(in_A, (1.0 - beta1) * h1, _sel(b3, (1.0 - beta1) * hmax, zero))
    lo1 = _sel(b1, zero, beta0)
    w1 = _sel(in_A | b3, dbeta,
              _sel(b1, torch.ones_like(x0), 1.0 - beta0))
    C1 = _sel(in_A | b3, h0, h2)
    C2 = _sel(in_A, h1, hmax)
    return VzEnvelope(core=core, x0=x0, sgn=sgn, a=a, S0=S0, S01=S0 + S1,
                      Stot=torch.clamp_min(S0 + S1 + S2, 1e-30),
                      beta0=beta0, lo1=lo1, w1=w1, C1=C1,
                      lo2=beta1, w2=1.0 - beta1, C2=C2)


def vz_round_xi(xi: torch.Tensor, env: VzEnvelope, accepted: torch.Tensor,
                vz: torch.Tensor, active: torch.Tensor):
    """One masked rejection round, xi of shape (4, B); returns
    (accepted, vz) updated where a lane that needed a sample accepted."""
    need = active & ~accepted

    # core: Lorentzian proposal, accept exp(-u^2)
    vz_core = env.x0 + env.a * torch.tan(PI * (xi[0] - 0.5))
    acc_core = xi[1] <= torch.exp(-vz_core * vz_core)

    # wing: composite envelope in beta
    r = xi[0] * env.Stot
    p0 = r < env.S0
    p1 = ~p0 & (r < env.S01)
    beta = _sel(p0, env.beta0 * torch.sqrt(xi[1]),
                _sel(p1, env.lo1 + env.w1 * xi[1], env.lo2 + env.w2 * xi[1]))
    beta = torch.clamp(beta, 1e-35, 1.0)
    Cb = _sel(p0, beta / env.a, _sel(p1, env.C1, env.C2))
    pb = torch.sqrt(torch.clamp_min(-2.0 * torch.log(beta), 0.0))
    u_hi = (pb - env.x0) / env.a
    u_lo = (-pb - env.x0) / env.a
    # atan(u_hi) - atan(u_lo) by the difference identity (far-wing lanes
    # would cancel to 0 and never accept)
    delt = torch.atan2(u_hi - u_lo, 1.0 + u_hi * u_lo)
    acc_wing = xi[2] * Cb < (beta / (env.a * PI)) * delt
    t1 = torch.atan(u_lo)
    vz_tan = env.x0 + env.a * torch.tan(delt * xi[3] + t1)
    # far wing: exact inverse CDF of the inverse-square law in x0 - vz
    far = env.x0 - pb > 1e3 * env.a
    y1 = torch.clamp_min(env.x0 - pb, 1e-20)
    y2 = env.x0 + pb
    y = 1.0 / torch.clamp_min(1.0 / y1 - xi[3] * (1.0 / y1 - 1.0 / y2), 1e-30)
    vz_wing = _sel(far, env.x0 - y, vz_tan)

    new_acc = _sel(env.core, acc_core, acc_wing)
    new_vz = _sel(env.core, vz_core, vz_wing) * env.sgn
    take = need & new_acc
    return accepted | take, _sel(take, new_vz, vz)


def cbrt(v: torch.Tensor) -> torch.Tensor:
    """Cube root of positive v (torch has no cbrt; the kernels use the
    same powf(v, 1/3))."""
    return torch.pow(v, 1.0 / 3.0)


def rand_resonance_cost(xi: torch.Tensor, E1: float) -> torch.Tensor:
    """Direct inversion of P(mu) = (3/8) E1 mu^2 + (4 - E1)/8, scalar E1."""
    xi = torch.as_tensor(xi, dtype=torch.float32)
    E1 = float(E1)
    if abs(E1) < 1e-12:
        return torch.clamp(2.0 * xi - 1.0, -1.0, 1.0)
    E1f = torch.tensor(E1, dtype=torch.float32, device=xi.device)
    p2 = torch.sqrt(torch.abs((4.0 - E1f) / (3.0 * E1f)))
    Q = (4.0 * xi - 2.0) / (E1f * (p2 * (p2 * p2)))
    if E1 > 0.0:
        W = cbrt(Q + torch.sqrt(Q * Q + 1.0))
        cost = p2 * (W - 1.0 / W)
    else:
        Qc = torch.clamp(Q, -1.0, 1.0)
        cost = 2.0 * p2 * torch.cos((torch.acos(Qc) + 4.0 * PI) / 3.0)
    return torch.clamp(cost, -1.0, 1.0)


def rand_voigt_x(a, u_cauchy: torch.Tensor, u_g1: torch.Tensor,
                 u_g2: torch.Tensor) -> torch.Tensor:
    """Voigt-profile frequency: Cauchy(a) via tan plus a Box-Muller normal
    over sqrt(2) (samplers.py:237-244)."""
    a = torch.as_tensor(a, dtype=torch.float32, device=u_cauchy.device)
    cauchy = torch.tan(PI * u_cauchy - 0.5 * PI)
    g = torch.sqrt(-2.0 * torch.log(u_g1)) * torch.cos(TWOPI * u_g2)
    return a * cauchy + g * (1.0 / math.sqrt(2.0))
