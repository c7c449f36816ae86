// Per-lane twins of the batched samplers in lart_tpu/physics/samplers.py
// (vz_envelope :70, vz_round_xi :128, rand_resonance_cost :210,
// rand_voigt_x :237, rand_henyey_greenstein :247) and of make_scatter's
// rotate_direction
// (lart_tpu/transport/engine.py:1854).
//
// The JAX versions evaluate every branch for every lane and select with
// `where`; here a lane evaluates only its own branch, with the same
// formulas in the same operation order, so a lane's result equals the plain
// PyTorch version's (lart_tpu_torch/physics/samplers.py) on the same
// uniforms.  The library is built without FMA contraction for that reason.
#pragma once

#include "lart.cuh"

#define LART_TWO_OVER_PI 0.6366197723675814f
#define LART_XC_SEON 2.414213562373095f  // 1 + sqrt(2)
#define LART_HALF_PI 1.5707963267948966f
#define LART_INV_SQRT2 0.7071067811865475f

// Seon composite-rejection envelope of f(u) ~ exp(-u^2)/((x0-u)^2 + a^2)
struct VzEnv {
  bool core;
  float x0, sgn, a, S0, S01, Stot, beta0, lo1, w1, C1, lo2, w2, C2;
};

__device__ inline VzEnv vz_envelope(float xin, float a) {
  VzEnv e;
  const float x0 = fabsf(xin);
  e.sgn = xin < 0.0f ? -1.0f : 1.0f;
  e.core = x0 <= 1.0f;
  e.x0 = x0;
  e.a = a;

  const float x0s = fmaxf(x0, 1.001f);
  const float x0sq = x0s * x0s;
  const float beta0 = expf(-0.5f * x0sq);
  const float h0 = beta0 / (2.0f * a);
  const float h0_two = beta0 / a;

  const float dbeta = sqrtf(LART_TWO_OVER_PI * a * (1.0f - beta0) * beta0 * x0s);
  const float beta1 = beta0 + dbeta;
  const float pb1sq = -2.0f * logf(beta1);
  const float denom1 = fmaxf(x0sq - pb1sq, 1e-20f);
  const float h1 = LART_TWO_OVER_PI * beta1 * sqrtf(fmaxf(pb1sq, 0.0f)) / denom1;
  const float h2 = 0.3861f / fmaxf(x0sq - 1.373f, 1e-20f);

  const bool in_A = x0s < LART_XC_SEON;
  const bool b1 = !in_A && h0_two < h2;
  const bool b2 = !in_A && !b1 && h0 < h2;
  const bool b3 = !in_A && !b1 && !b2;
  const float hmax = fmaxf(h1, h2);

  const float S0 = b1 ? 0.0f : beta0 * h0;
  const float S1 = in_A ? dbeta * h0
                        : (b1 ? h2 : (b2 ? (1.0f - beta0) * h2 : dbeta * h0));
  const float S2 = in_A ? (1.0f - beta1) * h1 : (b3 ? (1.0f - beta1) * hmax : 0.0f);

  e.beta0 = beta0;
  e.lo1 = b1 ? 0.0f : beta0;
  e.w1 = (in_A || b3) ? dbeta : (b1 ? 1.0f : 1.0f - beta0);
  e.C1 = (in_A || b3) ? h0 : h2;
  e.lo2 = beta1;
  e.w2 = 1.0f - beta1;
  e.C2 = in_A ? h1 : hmax;
  e.S0 = S0;
  e.S01 = S0 + S1;
  e.Stot = fmaxf(S0 + S1 + S2, 1e-30f);
  return e;
}

// One rejection round for a lane that still needs a sample; returns true
// and sets *vz on acceptance.
__device__ inline bool vz_round(const float xi[4], const VzEnv& e, float* vz) {
  float v;
  bool acc;
  if (e.core) {
    v = e.x0 + e.a * tanf(LART_PI * (xi[0] - 0.5f));
    acc = xi[1] <= expf(-v * v);
  } else {
    const float r = xi[0] * e.Stot;
    const bool p0 = r < e.S0;
    const bool p1 = !p0 && r < e.S01;
    float beta = p0 ? e.beta0 * sqrtf(xi[1])
                    : (p1 ? e.lo1 + e.w1 * xi[1] : e.lo2 + e.w2 * xi[1]);
    beta = fminf(fmaxf(beta, 1e-35f), 1.0f);
    const float Cb = p0 ? beta / e.a : (p1 ? e.C1 : e.C2);
    const float pb = sqrtf(fmaxf(-2.0f * logf(beta), 0.0f));
    const float u_hi = (pb - e.x0) / e.a;
    const float u_lo = (-pb - e.x0) / e.a;
    // atan(u_hi) - atan(u_lo) by the difference identity (samplers.py:155)
    const float delt = atan2f(u_hi - u_lo, 1.0f + u_hi * u_lo);
    acc = xi[2] * Cb < (beta / (e.a * LART_PI)) * delt;
    if (e.x0 - pb > 1e3f * e.a) {
      // far wing: exact inverse CDF of the inverse-square law in x0 - vz
      const float y1 = fmaxf(e.x0 - pb, 1e-20f);
      const float y2 = e.x0 + pb;
      const float y = 1.0f / fmaxf(1.0f / y1 - xi[3] * (1.0f / y1 - 1.0f / y2), 1e-30f);
      v = e.x0 - y;
    } else {
      const float t1 = atanf(u_lo);
      v = e.x0 + e.a * tanf(delt * xi[3] + t1);
    }
  }
  if (acc) *vz = v * e.sgn;
  return acc;
}

// cube root as the plain version computes it (torch has no cbrt)
__device__ inline float cbrt_pow(float v) { return powf(v, 1.0f / 3.0f); }

// cos(theta) from the E1-weighted dipole phase function, by inversion
__device__ inline float rand_resonance_cost(float xi, float E1) {
  const bool iso = fabsf(E1) < 1e-12f;
  const float E1s = iso ? 1.0f : E1;
  const float p2 = sqrtf(fabsf((4.0f - E1s) / (3.0f * E1s)));
  const float Q = (4.0f * xi - 2.0f) / (E1s * (p2 * (p2 * p2)));
  float cost;
  if (iso) {
    cost = 2.0f * xi - 1.0f;
  } else if (E1 > 0.0f) {
    const float W = cbrt_pow(Q + sqrtf(Q * Q + 1.0f));
    cost = p2 * (W - 1.0f / W);
  } else {
    const float Qc = fminf(fmaxf(Q, -1.0f), 1.0f);
    cost = 2.0f * p2 * cosf((acosf(Qc) + 12.566370614359172f) / 3.0f);
  }
  return fminf(fmaxf(cost, -1.0f), 1.0f);
}

// a standard normal from two uniforms (Box-Muller)
__device__ inline float box_muller(float u_g1, float u_g2) {
  return sqrtf(-2.0f * logf(u_g1)) * cosf(LART_TWOPI * u_g2);
}

// Voigt-profile frequency: Cauchy(a) via tan plus a Box-Muller normal / sqrt2
__device__ inline float rand_voigt_x(float a, float u_cauchy, float u_g1, float u_g2) {
  const float cauchy = tanf(LART_PI * u_cauchy - LART_HALF_PI);
  return a * cauchy + box_muller(u_g1, u_g2) * LART_INV_SQRT2;
}

// Henyey-Greenstein cos(theta) by inversion; isotropic for |g| < 1e-8
__device__ inline float rand_henyey_greenstein(float xi, float g) {
  if (fabsf(g) < 1e-8f) return 2.0f * xi - 1.0f;
  const float g2 = g * g;
  const float q = (1.0f - g2) / (1.0f - g + 2.0f * g * xi);
  return fminf(fmaxf(((1.0f + g2) - q * q) / (2.0f * g), -1.0f), 1.0f);
}

// New direction from scattering angles about (kx, ky, kz), renormalized
__device__ inline void rotate_direction(float& kx, float& ky, float& kz, float cost,
                                        float sint, float cosp, float sinp) {
  float kx2, ky2, kz2;
  if (fabsf(kz) >= 0.99999999999f) {
    kx2 = sint * cosp;
    ky2 = sint * sinp;
    kz2 = kz > 0.0f ? cost : -cost;
  } else {
    const float kr = sqrtf(fmaxf(kx * kx + ky * ky, LART_TINY));
    kx2 = cost * kx + sint * (kz * kx * cosp - ky * sinp) / kr;
    ky2 = cost * ky + sint * (kz * ky * cosp + kx * sinp) / kr;
    kz2 = cost * kz - sint * cosp * kr;
  }
  const float norm = rsqrtf(kx2 * kx2 + ky2 * ky2 + kz2 * kz2);
  kx = kx2 * norm;
  ky = ky2 * norm;
  kz = kz2 * norm;
}
