// Voigt-Hjerting function H(x, a) = Re[w(x + i a)], Humlicek (1982) w4.
//
// Replaces lart_tpu/physics/voigt.py:23 _humlicek_w4_real / :104 voigt.
// The TPU evaluates all four regional forms and blends them with `where`;
// here each lane takes the branch of its own region, with the same
// formulas in the same operation order.  Inlined into the flight kernel;
// voigt.cu launches it elementwise.
#pragma once

#define LART_ONE_OVER_SQRTPI 0.5641895835477563f

__device__ inline void cmul(float ar, float ai, float br, float bi, float& rr,
                            float& ri) {
  rr = ar * br - ai * bi;
  ri = ar * bi + ai * br;
}

// Re[(ar + i ai) / (br + i bi)] with a safe denominator
__device__ inline float cdiv_re(float ar, float ai, float br, float bi) {
  float den = br * br + bi * bi;
  if (den == 0.0f) den = 1.0f;
  return (ar * br + ai * bi) / den;
}

__device__ inline float voigt_h(float x, float y) {
  const float ax = fabsf(x);
  const float s = ax + y;
  // t = y - i x, u = t^2
  const float tr = y, ti = -x;
  const float ur = tr * tr - ti * ti;
  const float ui = 2.0f * tr * ti;
  float nr, ni, br, bi;

  if (s >= 15.0f) {  // region I: w = t / sqrt(pi) / (0.5 + t^2)
    return cdiv_re(LART_ONE_OVER_SQRTPI * tr, LART_ONE_OVER_SQRTPI * ti,
                   0.5f + ur, ui);
  }
  if (s >= 5.5f) {  // region II
    const float ar = 1.410474f + 0.5641896f * ur, ai = 0.5641896f * ui;
    cmul(tr, ti, ar, ai, nr, ni);
    cmul(ur, ui, 3.0f + ur, ui, br, bi);
    return cdiv_re(nr, ni, 0.75f + br, bi);
  }
  if (y >= 0.195f * ax - 0.176f) {  // region III: rational in t
    const float cn[5] = {0.5642236f, 3.778987f, 11.96482f, 20.20933f, 16.4955f};
    const float cd[6] = {1.0f, 6.699398f, 21.69274f, 39.27121f, 38.82363f,
                         16.4955f};
    float pr = cn[0], pi = 0.0f;
#pragma unroll
    for (int i = 1; i < 5; ++i) {
      cmul(pr, pi, tr, ti, pr, pi);
      pr = pr + cn[i];
    }
    nr = pr;
    ni = pi;
    pr = cd[0];
    pi = 0.0f;
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      cmul(pr, pi, tr, ti, pr, pi);
      pr = pr + cd[i];
    }
    return cdiv_re(nr, ni, pr, pi);
  }
  // region IV: w = exp(u) - t P(u) / Q(u), nested from the highest power
  const float cp[7] = {36183.31f, 3321.9905f, 1540.787f, 219.0313f,
                       35.76683f, 1.320522f, 0.56419f};
  const float cq[8] = {32066.6f,  24322.84f, 9022.228f, 2186.181f,
                       364.2191f, 61.57037f, 1.841439f, 1.0f};
  float pr = cp[6], pi = 0.0f, qr, qi;
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    cmul(ur, ui, pr, pi, qr, qi);
    pr = cp[i] - qr;
    pi = -qi;
  }
  float dr = cq[7], di = 0.0f;
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    cmul(ur, ui, dr, di, qr, qi);
    dr = cq[i] - qr;
    di = -qi;
  }
  cmul(tr, ti, pr, pi, nr, ni);
  const float e_r = expf(fminf(fmaxf(ur, -88.0f), 50.0f)) * cosf(ui);
  return e_r - cdiv_re(nr, ni, dr, di);
}
