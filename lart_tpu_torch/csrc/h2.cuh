// H2 pumping of Ly-alpha on the device: the Neufeld two-line table (H2C)
// and its opacity as a multiplier of the local H I rhokap, whole and by
// line.
//
// Replaces lart_tpu/physics/h2.py:109 h2_kappa and :123 h2_line_weights.
// The TPU evaluates the two Voigt terms over the whole batch inside each
// traced opacity (the flight's total_opacity, the scatter's event split
// and line choice, the peel's sightline); here they are device functions
// inlined into K4, K5 and K7, in the instances those kernels build with
// H2 on (template flag kH2), so the instances without H2 keep their code.
// With ratio = D / Dfreq_H2 (1 with h2_hi_width), line i adds
// (strength_i ratio) H((x - dnu_i / D) ratio, a_i): every division and
// product in f32, in lart_tpu's order, as the plain PyTorch version
// (lart_tpu_torch/physics/h2.py) takes it.  Bound: two Voigt functions
// (~40 flops each) and two divisions a call; it reads nothing but its
// arguments.
#pragma once

#include "voigt.cuh"

#define LART_H2_LINES 2

// The line table, each value the f64 one rounded once to f32.
// lart_tpu_torch/physics/h2.py H2C mirrors this layout field for field.
struct H2C {
  int n_lines;     // LART_H2_LINES
  int hi_width;    // the lines take the H I Doppler width (ratio 1)
  float Dfreq;     // the H2 Doppler width (Hz)
  float dnu[LART_H2_LINES];       // nu_line - nu_Lya (Hz)
  float strength[LART_H2_LINES];  // relative to the H I line centre
  float a_damp[LART_H2_LINES];    // Voigt a in H2 Doppler units
  float p_scat[LART_H2_LINES];    // chance of scattering back to Ly-alpha
};

// D / Dfreq_H2, or 1 with h2_hi_width
__device__ inline float h2_ratio(const H2C& h, float D) {
  return h.hi_width ? 1.0f : D / h.Dfreq;
}

// line i's opacity multiplier at comoving frequency x, Doppler width D
__device__ inline float h2_line_weight(const H2C& h, int i, float x, float D) {
  const float ratio = h2_ratio(h, D);
  const float x_h2 = (x - h.dnu[i] / D) * ratio;
  return h.strength[i] * ratio * voigt_h(x_h2, h.a_damp[i]);
}

// the H2 opacity as a multiplier of rhokap
__device__ inline float h2_kappa(const H2C& h, float x, float D) {
  return h2_line_weight(h, 0, x, D) + h2_line_weight(h, 1, x, D);
}
