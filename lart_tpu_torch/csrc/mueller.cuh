// Tabulated Mueller-matrix dust scattering on the device: the per-lane twins
// of lart_tpu/physics/mueller.py sample_cost (:80) and interp_S (:101), and
// of the alias draw they use (lart_tpu/physics/samplers.py:287
// alias_sample), inlined into K4 (the dust branch of the scatter) and K7
// (the dust peel).
//
// The TPU draws a batch at a time and gathers from the table with jnp.take;
// here a lane reads its few table entries through the read-only cache.  The
// Ly-alpha table has 161 angles: seven arrays of a few KB, which stay in L1
// and L2, so a draw costs three dependent loads and no shared memory.  The
// operations are those of the plain versions in lart_tpu_torch/physics/
// mueller.py, in their order, and the library is built without FMA
// contraction, so a lane's result equals the plain version's.
#pragma once

#include "lart.cuh"

// lart_tpu_torch/physics/mueller.py MuellerC mirrors this layout field for
// field; the structs that embed it are checked against their size exports
struct MuellerTable {
  const float* coss;  // (n,) the uniform cos grid
  const float* S11;   // (n,) normalized: Integral S11 dcos = 1
  const float* S12;
  const float* S33;
  const float* S34;
  const float* prob;  // (n - 1,) alias table of the bins
  const int* alias;
  int n;
  float dcos;
};

// bin of the alias table from two uniforms
__device__ inline int alias_sample(const float* prob, const int* alias, int n, float u_bin,
                                   float u_alias) {
  const int idx = min((int)(u_bin * (float)n), n - 1);
  return u_alias >= __ldg(prob + idx) ? __ldg(alias + idx) : idx;
}

// cos(theta) from S11: the bin by alias, then the inverse of the linear pdf
// between (c0, f0) and (c1, f1) inside it
__device__ inline float mueller_sample_cost(const MuellerTable& t, float u_bin, float u_alias,
                                            float u_lin) {
  const int ib = alias_sample(t.prob, t.alias, t.n - 1, u_bin, u_alias);
  const float c0 = __ldg(t.coss + ib), c1 = __ldg(t.coss + ib + 1);
  const float f0 = __ldg(t.S11 + ib), f1 = __ldg(t.S11 + ib + 1);
  const float df = f1 - f0;
  const bool flat = fabsf(df) < 1e-12f * fmaxf(f0, 1e-30f);
  const float disc = fmaxf(f0 * f0 + u_lin * (f1 * f1 - f0 * f0), 0.0f);
  const float tt = flat ? u_lin : (sqrtf(disc) - f0) / df;
  return fminf(fmaxf(c0 + (c1 - c0) * tt, -1.0f), 1.0f);
}

// (S11, S12, S33, S34) at cost, linear on the uniform cos grid
__device__ inline void mueller_interp_S(const MuellerTable& t, float cost, float S[4]) {
  const float f = (cost - __ldg(t.coss)) / t.dcos;
  const int i = (int)fminf(fmaxf(floorf(f), 0.0f), (float)(t.n - 2));
  const float w = fminf(fmaxf(f - (float)i, 0.0f), 1.0f);
  const float* col[4] = {t.S11, t.S12, t.S33, t.S34};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    S[c] = __ldg(col[c] + i) * (1.0f - w) + __ldg(col[c] + i + 1) * w;
}
