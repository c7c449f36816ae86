// The resonance line on the device: its constants (LineC), its opacity
// profile, its frequency redistribution at a scattering, and the birth
// shift of a multi-level line, for line types 1, 2, 4, 5, 6, 7 and 8.
//
// Replaces lart_tpu/transport/engine.py:621 line_profile (with the profile
// wrappers of lart_tpu/physics/voigt.py:121-142), make_scatter's
// redistribute, _vz and _branch_select (:1907-2086), and :2923
// branch_init_shift.  The TPU specializes each on the line type when it
// traces; here the line type is data in LineC, and every kernel that
// evaluates the opacity or redistributes comes in two instances: kMulti
// false runs line type 1 only (the profile is one Voigt function and the
// redistribution draws nothing beyond the u_par rounds, so those kernels
// keep the code and the registers they had for Ly-alpha), kMulti true every
// line type.  Each formula keeps the JAX order of its f32 operations, so a
// lane's result equals the plain PyTorch version's
// (lart_tpu_torch/physics/line.py) on the same uniforms.  Bound: a profile
// costs one Voigt function a component (at most three); a redistribution
// adds one Philox block and up to three Voigt functions to the u_par rounds.
// lart.cuh includes this file below the definitions it uses (STREAM_SCATTER,
// LART_TINY) and above FlightParams, which embeds LineC: a kernel source
// includes lart.cuh, not this file first.
#pragma once

#include "philox.cuh"
#include "voigt.cuh"

#define LART_LINE_MAX 3
#define LINE_THIRD 0.3333333333333333f
#define LINE_TWO_THIRDS 0.6666666666666666f

// The line's constants, each the f64 catalog value (sums and ratios taken
// in f64) rounded once to f32.  lart_tpu_torch/physics/line.py LineC
// mirrors this layout field for field; the structs that embed it are
// checked against their size exports.  Per upper level i and downward
// branch j the arrays hold [i * LART_LINE_MAX + j].
struct LineC {
  int line_type;
  int nup;               // upper levels: 2 for the doublet, 1 for types 1, 4, 7
  int ndown[LART_LINE_MAX];   // downward branches of each upper level (types 4-6)
  int branch_init;       // types 2, 4, 5, 6: births are shifted to a branch
  int per_lane_E;        // types 2, 4, 5, 6: E1, E2, E3 per scattering
  int he_coherent;       // type 6 with HeI_coherent
  float P_cum[LART_LINE_MAX * LART_LINE_MAX];  // cumulative P_down of each level
  float f_cum[LART_LINE_MAX];             // cumulative f12 / sum f12 (births)
  float Elow_Hz[LART_LINE_MAX * LART_LINE_MAX];
  float E1[LART_LINE_MAX * LART_LINE_MAX];
  float E2[LART_LINE_MAX * LART_LINE_MAX];
  float E3[LART_LINE_MAX * LART_LINE_MAX];
  float delE_Hz[LART_LINE_MAX];
  float f12[LART_LINE_MAX];
  float f_ratio[LART_LINE_MAX];  // f12_i / f12_1
  float a_ratio[LART_LINE_MAX];  // damping_i / damping_1
  float DnuHK_Hz;
  float dnu_HD_Hz, ratio_Dfreq_HD, ratio_voigta_HD;
  float nD_HD;              // D_to_H_ratio * ratio_Dfreq_HD
  float perp_D;             // 1 / ratio_Dfreq_HD
  float E1s, E2s, E3s;      // the line's own weights (types 1 and 7)
  float g_recoil0, g_recoil0_D;
  float P_conv;             // type 8: P_down of the 3p -> 2s channel
};

// The profile's components at one cell: offsets dx (Doppler units) and
// damping parameters a, component 0 at line centre.  physics/line.py
// LineProfC mirrors it.
struct LineProf {
  float dx[LART_LINE_MAX];
  float a[LART_LINE_MAX];
};

// the components at damping a and Doppler width D (Hz), in f32
__device__ inline LineProf line_prof(const LineC& L, float a, float D) {
  LineProf q;
#pragma unroll
  for (int i = 0; i < LART_LINE_MAX; ++i) {
    q.dx[i] = 0.0f;
    q.a[i] = a;
  }
  if (L.line_type == 2) {
    q.dx[1] = L.DnuHK_Hz / D;
  } else if (L.line_type == 5 || L.line_type == 6) {
    for (int i = 1; i < L.nup; ++i) {
      q.dx[i] = L.delE_Hz[i] / D;
      q.a[i] = a * L.a_ratio[i];
    }
  } else if (L.line_type == 7) {
    q.dx[1] = L.dnu_HD_Hz / D;
    q.a[1] = a * L.ratio_voigta_HD;
  }
  return q;
}

// H_eff(x) with the components q (calc_voigt's dispatch)
__device__ inline float line_profile_q(const LineC& L, const LineProf& q, float x) {
  switch (L.line_type) {
    case 2:
      return voigt_h(x + q.dx[1], q.a[0]) * LINE_THIRD + voigt_h(x, q.a[0]) * LINE_TWO_THIRDS;
    case 5:
    case 6: {
      float out = voigt_h(x, q.a[0]);
      for (int i = 1; i < L.nup; ++i) out = out + voigt_h(x + q.dx[i], q.a[i]) * L.f_ratio[i];
      return out;
    }
    case 7: {
      const float x_D = (x - q.dx[1]) * L.ratio_Dfreq_HD;
      return voigt_h(x, q.a[0]) + L.nD_HD * voigt_h(x_D, q.a[1]);
    }
    default:
      return voigt_h(x, q.a[0]);
  }
}

// the opacity profile at a cell of damping a and Doppler width D
template <bool kMulti>
__device__ inline float line_profile(const LineC& L, float x, float a, float D) {
  if (!kMulti) return voigt_h(x, a);
  return line_profile_q(L, line_prof(L, a, D), x);
}

// _branch_select: the first downward branch of level iup whose cumulative
// P_down exceeds xi, else the last
__device__ inline int branch_select(const LineC& L, int iup, float xi) {
  const int n = L.ndown[iup];
  for (int j = 0; j < n; ++j)
    if (xi < L.P_cum[iup * LART_LINE_MAX + j]) return j;
  return n - 1;
}

// branch_init_shift (engine.py:2923): the shift of a birth frequency from
// two uniforms at Doppler width D; 0 where no draw hits, as the TPU's
__device__ inline float branch_init_shift(const LineC& L, float u0, float u1, float D) {
  if (L.line_type == 2) return u0 <= LINE_THIRD ? -(L.DnuHK_Hz / D) : 0.0f;
  if (L.line_type == 4) {
    for (int j = 0; j < L.ndown[0]; ++j)
      if (u0 < L.P_cum[j]) return -(L.Elow_Hz[j] / D);
    return 0.0f;
  }
  if (L.line_type == 5 || L.line_type == 6) {
    for (int i = 0; i < L.nup; ++i) {
      if (!(u0 < L.f_cum[i])) continue;
      const float sh_up = i > 0 ? -(L.delE_Hz[i] / D) : 0.0f;
      float sh_dn = 0.0f;
      if (L.ndown[i] > 1) {
        for (int j = 0; j < L.ndown[i]; ++j)
          if (u1 < L.P_cum[i * LART_LINE_MAX + j]) {
            sh_dn = -(L.Elow_Hz[i * LART_LINE_MAX + j] / D);
            break;
          }
      }
      return sh_up + sh_dn;
    }
  }
  return 0.0f;
}

#include "samplers.cuh"

// What a redistribution gives a lane: whether a u_par round accepted, u_par,
// xfreq_atom (with the fluorescent shift), the phase weights, the scale of
// the perpendicular velocity and the recoil constant; for line type 8,
// whether the scattering converts the photon to H-alpha.
struct Redist {
  bool acc, conv;
  float uz, xatom, E1, E2, E3, perp, g0;
};

// The coherent He I 10833 weights at xfreq_atom D2v, from the level offsets
// Dx2, Dx3 (compute_HeI_E_coherent, engine.py:2032-2050).
__device__ inline void he_coherent_E(float D2v, float Dx2, float Dx3, float& E1, float& E2,
                                     float& E3) {
  const float D1v = D2v + Dx2;
  const float D0v = D2v + Dx3;
  const float D2D0 = D2v * D0v;
  const float D2D1 = D2v * D1v;
  const float D0D1 = D0v * D1v;
  const float pqq = D2v * D0v * D1v;
  float den = 4.0f * (D2D1 * D2D1 + 3.0f * D2D0 * D2D0 + 5.0f * D0D1 * D0D1);
  if (den == 0.0f) den = 1.0f;
  E1 = (3.0f * D2D0 * D2D0 + 7.0f * D0D1 * D0D1 + 8.0f * pqq * D1v + 18.0f * pqq * D0v) / den;
  E3 = (3.0f * D2D0 * D2D0 + 15.0f * D0D1 * D0D1 + 8.0f * D2v * pqq + 10.0f * pqq * D0v) / den;
  E2 = 1.0f - E1;
}

// redistribute (engine.py:1931-2086) of lane i at frequency x, damping a and
// Doppler width D: u_par round r draws block r of the scatter's Philox
// stream, and every line type but 1 draws block sel_block (after every block
// a lane of earlier slices draws): its first uniform picks the upper level
// (types 2, 5, 6; H or D in type 7) or, in type 4, the downward branch, its
// second the downward branch of types 5 and 6; in type 8 its first decides
// the conversion (the downward channel 3p -> 2s, whose phase weights the
// scattering then takes).  A round stops the lane at
// its first acceptance; the later rounds' uniforms would be ignored anyway.
template <bool kMulti>
__device__ inline Redist redistribute(const LineC& L, float x, float a, float D, uint32_t seed,
                                      uint32_t counter, int i, int rounds, int sel_block) {
  Redist r;
  r.E1 = L.E1s;
  r.E2 = L.E2s;
  r.E3 = L.E3s;
  r.perp = 1.0f;
  r.g0 = L.g_recoil0;
  r.conv = false;
  const int lt = kMulti ? L.line_type : 1;
  float sel[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  LineProf q;
  float x0 = x, va = a;
  int iup = 0;
  bool other = false;  // type 2 the H level; type 7 a deuterium event
  if (lt != 1) {
    uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)sel_block, sel);
    q = line_prof(L, a, D);
  }
  if (lt == 2) {
    float pH = voigt_h(x + q.dx[1], q.a[0]) * LINE_THIRD;
    const float pK = voigt_h(x, q.a[0]) * LINE_TWO_THIRDS;
    pH = pH / (pH + pK);
    other = sel[0] < pH;
    if (other) x0 = x + q.dx[1];
  } else if (lt == 5 || lt == 6) {
    float ps[LART_LINE_MAX];
    float ptot = 0.0f;
    for (int k = 0; k < L.nup; ++k) {
      ps[k] = voigt_h(x + q.dx[k], q.a[k]) * L.f12[k];
      ptot = k ? ptot + ps[k] : ps[k];
    }
    const float xi_up = sel[0] * ptot;
    float cum = 0.0f;
    for (int k = 0; k < L.nup; ++k) {
      cum = cum + ps[k];
      if (xi_up < cum) {
        iup = k;
        break;
      }
    }
    if (iup > 0) {
      x0 = x + q.dx[iup];
      va = q.a[iup];
    }
  } else if (lt == 7) {
    const float x_D = (x - q.dx[1]) * L.ratio_Dfreq_HD;
    const float pH = voigt_h(x, q.a[0]);
    const float pD = L.nD_HD * voigt_h(x_D, q.a[1]);
    other = !(sel[0] < pH / (pH + pD));
    if (other) {
      x0 = x_D;
      va = q.a[1];
    }
  }
  const VzEnv env = vz_envelope(x0, va);
  float uz = 0.0f, u[4];
  r.acc = false;
  for (int k = 0; k < rounds && !r.acc; ++k) {
    uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)k, u);
    r.acc = vz_round(u, env, &uz);
  }
  if (lt == 7 && other) {
    // a deuterium event: u_par back to H Doppler units
    uz = uz / L.ratio_Dfreq_HD;
    r.perp = L.perp_D;
    r.g0 = L.g_recoil0_D;
  }
  r.uz = uz;
  r.xatom = x - uz;
  if (lt == 2) {
    const float qH = r.xatom + q.dx[1], qK = r.xatom;
    r.E1 = (2.0f * qK * qH + qH * qH) / fmaxf(qK * qK + 2.0f * qH * qH, LART_TINY);
    r.E2 = 1.0f - r.E1;
    r.E3 = (r.E1 + 2.0f) / 3.0f;
  } else if (lt == 8) {
    r.conv = sel[0] < L.P_conv;
    const int b = r.conv ? 1 : 0;
    r.E1 = L.E1[b];
    r.E2 = L.E2[b];
    r.E3 = L.E3[b];
  } else if (lt == 4 || lt == 5 || lt == 6) {
    // type 4: sel[0] picks the branch; types 5, 6: sel[1], for levels with
    // more than one branch
    const int j = lt == 4 ? branch_select(L, 0, sel[0])
                          : (L.ndown[iup] > 1 ? branch_select(L, iup, sel[1]) : 0);
    const int b = iup * LART_LINE_MAX + j;
    r.E1 = L.E1[b];
    r.E2 = L.E2[b];
    r.E3 = L.E3[b];
    if (lt == 6 && L.he_coherent) he_coherent_E(r.xatom, q.dx[1], q.dx[2], r.E1, r.E2, r.E3);
    if (lt == 4 || L.ndown[iup] > 1) r.xatom = r.xatom - L.Elow_Hz[b] / D;
  }
  return r;
}
