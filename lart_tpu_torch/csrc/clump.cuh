// The clump medium on the device, and the lookups shared by K2 (the birth
// clump), K4 (the owner draw and the clump frame), K7 (the clump sightline)
// and the clump flights K9 and K10, as amr.cuh is shared by the AMR kernels.
//
// Replaces lart_tpu/transport/engine.py:421 clump_find, :487
// clump_sample_owner (with :460 _clump_dense_kq_at), the clump branches of
// :290-348 (clump_xloc_ratio, cell_voigt_a, cell_Dfreq, cell_rhokap,
// cell_rhokapD, cell_velocity_dot), and the per-CSR-cell candidate chord sum
// of lart_tpu/instruments/peel.py:86-170 tau_to_edge_clump.  A lane's cell
// index ic is its clump, -1 in the vacuum between clumps, which has no gas,
// no dust and no velocity.  Photons carry global frequencies in reference
// Doppler units; a clump sees x_loc = (x - u) r_loc, u its bulk velocity in
// reference units, r_loc = Dfreq_ref / Dfreq_cl, with the clump's damping
// a_cl and Doppler width D_cl.  lart_tpu scales a clump's velocity into
// reference units three ways, by vr = 1 / r_loc in the flights, by vscale =
// Dfreq_cl / Dfreq_ref in cell_velocity_dot and by dividing by r_loc in the
// peel and the owner draw; the functions below take the form as an argument
// so that each caller rounds as lart_tpu does.  XLA divides by a constant as
// a multiply by its f32 reciprocal, so x / r_loc and x / cg_dx are x times
// inv_r_loc and inv_cg_dx here.  Every expression keeps
// lart_tpu's order of f32 operations, with the fused multiply-adds XLA
// contracts on the CPU (a1 b1 + a2 b2 + a3 b3 = fma(a3, b3, fma(a1, b1,
// a2 b2)), b^2 - c, a position advanced along the ray, a CSR face, the chord
// sum of a cell), as transport/flight.py's plain versions compute them.
#pragma once

// lart_tpu_torch/transport/flight.py ClumpC mirrors this layout field for
// field; lart_clump_grid_size() lets it check the size.  n == 0 on the other
// grids, where no kernel reads the rest.
struct ClumpGrid {
  const float* x;        // (n,) centres
  const float* y;
  const float* z;
  const float* r2;       // (n,) radius^2
  const float* rhokap;   // (n,) line opacity per length at line centre
  const float* rhokapD;  // (n,) dust opacity, or null without dust
  const float* vx;       // (n,) bulk velocity / vtherm_cl; null if static
  const float* vy;
  const float* vz;
  const int* table;      // (cg_n^3, K) CSR candidates, -1 pads
  int n;
  int dense;             // n <= clump_dense_max: the dense forms
  int overlap;           // clump_allow_overlap
  int shift;             // a moving medium or r_loc != 1: K4 moves a
                         //   scattering lane into its clump's frame and back
  int cg_n, K;
  float R;               // the bounding cube [-R, R]^3
  float cg_dx;
  float inv_cg_dx;       // 1 / cg_dx in f32 (XLA divides by a constant so)
  float eps_dense;       // 1e-6 R + 1e-7: the dense flight's nudge
  float eps_csr;         // 1e-4 cg_dx / cg_n + 1e-6 R: the CSR walker's
  float eps_peel;        // 1e-6 R: the clump sightline's
  float r_loc;           // Dfreq_ref / Dfreq_cl
  float inv_r_loc;       // 1 / r_loc in f32: lart_tpu's x / r_loc
  float vr;              // 1 / r_loc, rounded once from f64
  float vscale;          // Dfreq_cl / Dfreq_ref
  float a_cl, D_cl;      // the clumps' damping and Doppler width
};

enum { CLUMP_U_SCALE = 0, CLUMP_U_VR = 1, CLUMP_U_DIV = 2 };

// a1 b1 + a2 b2 + a3 b3 as XLA contracts it
__device__ inline float dot3f(float a1, float b1, float a2, float b2, float a3, float b3) {
  return fmaf(a3, b3, fmaf(a1, b1, a2 * b2));
}

// _leaf_gather of a per-clump array: 0 in the vacuum
__device__ inline float clump_gather(const float* a, int ic) {
  return ic >= 0 ? __ldg(&a[ic]) : 0.0f;
}

// the CSR cell index of a coordinate, clamped
__device__ inline int clump_cell_index(const ClumpGrid& g, float v) {
  return (int)fminf(fmaxf(floorf((v + g.R) * g.inv_cg_dx), 0.0f), (float)(g.cg_n - 1));
}

// distance along k to the exit face of CSR cell index idx on one axis
// (engine.py:3398-3405)
__device__ inline float clump_face_dist(const ClumpGrid& g, float pos, float k, int idx) {
  if (fabsf(k) < 1e-12f) return LART_BIG;
  const float face = fmaf((float)(k > 0.0f ? idx + 1 : idx), g.cg_dx, -g.R);
  return fmaxf((face - pos) / k, 0.0f);
}

// the flat CSR cell of pos and the distance to its exit face along k
__device__ inline float clump_cell_exit(const ClumpGrid& g, const float pos[3],
                                        const float k[3], int& cell) {
  int idx[3];
  float t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    idx[a] = clump_cell_index(g, pos[a]);
    t[a] = clump_face_dist(g, pos[a], k[a], idx[a]);
  }
  cell = (idx[0] * g.cg_n + idx[1]) * g.cg_n + idx[2];
  return fminf(fminf(t[0], t[1]), t[2]);
}

// the q-th candidate of a CSR cell (the flat index clamped like jnp.take)
__device__ inline int clump_candidate(const ClumpGrid& g, int cell, int q) {
  const int f = cell * g.K + q;
  return __ldg(&g.table[min(max(f, 0), g.cg_n * g.cg_n * g.cg_n * g.K - 1)]);
}

// the ray pos + t k against clump c (c >= 0): b = p.k and det = b^2 -
// (|p|^2 - r2), p = pos - centre; the chord is -b -+ sqrt(det) where det > 0
__device__ inline void clump_chord(const ClumpGrid& g, int c, const float pos[3],
                                   const float k[3], float& b, float& det) {
  const float px = pos[0] - __ldg(&g.x[c]), py = pos[1] - __ldg(&g.y[c]),
              pz = pos[2] - __ldg(&g.z[c]);
  b = dot3f(px, k[0], py, k[1], pz, k[2]);
  const float cc = dot3f(px, px, py, py, pz, pz) - __ldg(&g.r2[c]);
  det = fmaf(b, b, -cc);
}

// the chord of candidate c clipped to [0, t_end] (c = -1, the table's pad:
// a sphere of radius 0 at the origin, as lart_tpu's gathers give it);
// returns det, the chord's discriminant
__device__ inline float clump_cand_chord(const ClumpGrid& g, int c, const float pos[3],
                                         const float k[3], float t_end, float& t0,
                                         float& t1) {
  const float px = pos[0] - clump_gather(g.x, c), py = pos[1] - clump_gather(g.y, c),
              pz = pos[2] - clump_gather(g.z, c);
  const float b = dot3f(px, k[0], py, k[1], pz, k[2]);
  const float cc = dot3f(px, px, py, py, pz, pz) - clump_gather(g.r2, c);
  const float det = fmaf(b, b, -cc);
  const float sq = sqrtf(fmaxf(det, 0.0f));
  t0 = fminf(fmaxf(-b - sq, 0.0f), t_end);
  t1 = fminf(fmaxf(-b + sq, 0.0f), t_end);
  return det;
}

// clump c contains (x, y, z): |p|^2 < r2
__device__ inline bool clump_contains(const ClumpGrid& g, int c, float x, float y, float z) {
  const float px = x - __ldg(&g.x[c]), py = y - __ldg(&g.y[c]), pz = z - __ldg(&g.z[c]);
  return dot3f(px, px, py, py, pz, pz) < __ldg(&g.r2[c]);
}

// clump_find (engine.py:421-450): the first clump containing the point, over
// all clumps (dense) or the CSR cell's candidates in table order; -1 in the
// vacuum
__device__ inline int clump_find(const ClumpGrid& g, float x, float y, float z) {
  if (g.dense) {
    for (int c = 0; c < g.n; ++c)
      if (clump_contains(g, c, x, y, z)) return c;
    return -1;
  }
  const int cell = (clump_cell_index(g, x) * g.cg_n + clump_cell_index(g, y)) * g.cg_n +
                   clump_cell_index(g, z);
  for (int q = 0; q < g.K; ++q) {
    const int c = clump_candidate(g, cell, q);
    if (c >= 0 && clump_contains(g, c, x, y, z)) return c;
  }
  return -1;
}

// a clump's bulk velocity along k in reference Doppler units, in one of
// lart_tpu's three roundings; 0 in the vacuum and in a static medium
__device__ inline float clump_vel_dot(const ClumpGrid& g, int ic, const float k[3], int form) {
  if (!g.vx || ic < 0) return 0.0f;
  const float u = dot3f(__ldg(&g.vx[ic]), k[0], __ldg(&g.vy[ic]), k[1], __ldg(&g.vz[ic]), k[2]);
  return u * (form == CLUMP_U_DIV ? g.inv_r_loc : form == CLUMP_U_SCALE ? g.vscale : g.vr);
}

// rhokap H_eff(x_loc; a_cl, D_cl) (+ rhokapD) of clump ic (0 in the vacuum)
template <bool kMulti>
__device__ inline float clump_kappa(const ClumpGrid& g, const LineC& line, int ic,
                                    float x_loc) {
  float k = clump_gather(g.rhokap, ic) * line_profile<kMulti>(line, x_loc, g.a_cl, g.D_cl);
  if (g.rhokapD) k = k + clump_gather(g.rhokapD, ic);
  return k;
}

// the optical depth of the segment [0, t_end] of the ray from pos along k in
// CSR cell `cell` at the global frequency xf: its candidates' chord
// overlaps, each at its local frequency with its velocity in the form
// `uform`, summed in table order as lart_tpu's unrolled loop contracts it,
// dtau = fma(k_q, t1 - t0, dtau) (peel.py:126-158; engine.py:3464-3500)
template <bool kMulti>
__device__ inline float clump_cell_tau(const ClumpGrid& g, const LineC& line, int cell,
                                       const float pos[3], const float k[3], float xf,
                                       float t_end, int uform) {
  float dtau = 0.0f;
  for (int q = 0; q < g.K; ++q) {
    const int c = clump_candidate(g, cell, q);
    if (c < 0) continue;
    float t0, t1;
    if (!(clump_cand_chord(g, c, pos, k, t_end, t0, t1) > 0.0f)) continue;
    const float u = clump_vel_dot(g, c, k, uform);
    dtau = fmaf(clump_kappa<kMulti>(g, line, c, (xf - u) * g.r_loc), t1 - t0, dtau);
  }
  return dtau;
}

// clump_sample_owner (engine.py:487-545): the clump that owns a scattering
// at (x, y, z), drawn by opacity among the clumps containing the point at
// the global frequency xfreq (each at its local frequency) with the uniform
// xi: the first clump whose running sum in index order reaches xi times the
// total, over all clumps (dense; no gas there: the first containing clump,
// or -1) or over the CSR cell's candidates (no gas: the first candidate)
template <bool kMulti>
__device__ inline int clump_owner(const ClumpGrid& g, const LineC& line, const float pos[3],
                                  const float k[3], float xfreq, float xi) {
  const bool dense = g.dense != 0;
  int cell = 0;
  if (!dense)
    cell = (clump_cell_index(g, pos[0]) * g.cg_n + clump_cell_index(g, pos[1])) * g.cg_n +
           clump_cell_index(g, pos[2]);
  const int m = dense ? g.n : g.K;
  const float xs = xfreq * g.r_loc;  // the static medium's local frequency
  // two passes: the total, then the first running sum >= xi * total (the
  // same sums in the same order, so the same partial sums)
  float tot = 0.0f, thr = 0.0f;
  int first_in = -1;
  for (int pass = 0; pass < 2; ++pass) {
    float cum = 0.0f;
    for (int j = 0; j < m; ++j) {
      const int c = dense ? j : clump_candidate(g, cell, j);
      if (c < 0 || !clump_contains(g, c, pos[0], pos[1], pos[2])) {
        if (pass == 1 && cum >= thr) return dense ? j : c;
        continue;
      }
      if (first_in < 0) first_in = c;
      const float xl = g.vx ? (xfreq - clump_vel_dot(g, c, k, CLUMP_U_DIV)) * g.r_loc : xs;
      cum = cum + clump_kappa<kMulti>(g, line, c, xl);
      if (pass == 1 && cum >= thr) return c;
    }
    tot = cum;
    if (!(tot > 0.0f)) return dense ? first_in : clump_candidate(g, cell, 0);
    thr = xi * tot;
  }
  return dense ? g.n - 1 : clump_candidate(g, cell, g.K - 1);
}
