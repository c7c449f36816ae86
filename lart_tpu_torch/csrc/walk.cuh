// Grid helpers shared by the flights and the peel-off sightlines: the flat
// gather index, a cell's opacity (on the AMR grid a leaf's), the fluid
// velocity along a direction, the distance to a cell's exit face, the
// boundary op of a crossing (K5 fly_cartesian and the K7 peel walk, so both
// follow one set of conventions), and the chord through the uniform sphere
// (K6 fly_uniform_sphere and the K7 chord).
#pragma once

#include "lart.cuh"
#include "voigt.cuh"

// engine._gather: flat C-order index, clamped like jnp.take(mode='clip')
__device__ inline int flat_index(const FlightParams& p, int i, int j, int k) {
  const int f = (i * p.n[1] + j) * p.n[2] + k;
  return min(max(f, 0), p.n[0] * p.n[1] * p.n[2] - 1);
}

// damping a and Doppler width D of flat Cartesian cell f (engine.py:297-317
// cell_voigt_a / cell_Dfreq): the cell's own at non-uniform temperature,
// else the reference values
__device__ inline void cell_a_D(const FlightParams& p, int f, float& a, float& D) {
  if (p.cell_D) {
    a = __ldg(&p.cell_a[f]);
    D = __ldg(&p.cell_D[f]);
  } else {
    a = p.a_ref;
    D = p.Dfreq;
  }
}

__device__ inline float cell_D_of(const FlightParams& p, int f) {
  return p.cell_D ? __ldg(&p.cell_D[f]) : p.Dfreq;
}

// opacity of flat cell f at comoving frequency xf and the cell's damping a
// and Doppler width D: rhokap times the line's profile (line.cuh), plus
// rhokap times the H2 multiplier in the instances with H2 (h2.cuh), plus
// the dust's rhokapD (engine.py:1106-1121 total_opacity)
template <bool kMulti, bool kH2>
__device__ inline float cell_opacity(const FlightParams& p, int f, float xf, float a, float D,
                                     float& rhoH) {
  const float rk = p.rhokap[f];
  rhoH = rk * line_profile<kMulti>(p.line, xf, a, D);
  float rho = rhoH;
  if (kH2) rho = rho + rk * h2_kappa(p.h2, xf, D);
  if (p.rhokapD) rho = rho + p.rhokapD[f];
  return rho;
}

// the same without its line part rhoH = rhokap H_eff(x)
template <bool kMulti, bool kH2>
__device__ inline float cell_opacity(const FlightParams& p, int f, float xf, float a, float D) {
  float rhoH;
  return cell_opacity<kMulti, kH2>(p, f, xf, a, D, rhoH);
}

// cell_opacity with its line profile H = H_eff(x) and H2 multiplier h2m
// taken before (a walk whose x, a and D stay the same): the same
// operations in the same order
template <bool kH2>
__device__ inline float cell_opacity_at(const FlightParams& p, int f, float H, float h2m) {
  const float rk = p.rhokap[f];
  float rho = rk * H;
  if (kH2) rho = rho + rk * h2m;
  if (p.rhokapD) rho = rho + p.rhokapD[f];
  return rho;
}

// the H-alpha band's opacity (line type 8): the dust's, scaled to H-alpha
// (engine.py:1121-1126), and none without dust
__device__ inline float band2_opacity(const FlightParams& p, int f) {
  return p.rhokapD ? p.rhokapD[f] * p.R_Ha : 0.0f;
}

// the AMR grid's per-leaf physics (engine.py:297-356): leaf il's damping and
// Doppler width (the reference values at uniform temperature and in a gap),
// its opacity at comoving frequency xf (0 gas and dust in a gap), the
// H-alpha band's, and the fluid velocity along k (0 in a gap)
__device__ inline void leaf_a_D(const FlightParams& p, int il, float& a, float& D) {
  a = p.amr.voigt_a ? leaf_gather(p.amr.voigt_a, il, p.a_ref) : p.a_ref;
  D = p.amr.Dfreq ? leaf_gather(p.amr.Dfreq, il, p.Dfreq) : p.Dfreq;
}

template <bool kMulti, bool kH2>
__device__ inline float leaf_opacity(const FlightParams& p, int il, float xf, float a,
                                     float D) {
  const float rk = leaf_gather(p.rhokap, il, 0.0f);
  float rho = rk * line_profile<kMulti>(p.line, xf, a, D);
  if (kH2) rho = rho + rk * h2_kappa(p.h2, xf, D);
  if (p.rhokapD) rho = rho + leaf_gather(p.rhokapD, il, 0.0f);
  return rho;
}

// leaf_opacity with H and h2m taken before, as cell_opacity_at
template <bool kH2>
__device__ inline float leaf_opacity_at(const FlightParams& p, int il, float H, float h2m) {
  const float rk = leaf_gather(p.rhokap, il, 0.0f);
  float rho = rk * H;
  if (kH2) rho = rho + rk * h2m;
  if (p.rhokapD) rho = rho + leaf_gather(p.rhokapD, il, 0.0f);
  return rho;
}

__device__ inline float leaf_band2_opacity(const FlightParams& p, int il) {
  return p.rhokapD ? leaf_gather(p.rhokapD, il, 0.0f) * p.R_Ha : 0.0f;
}

__device__ inline float leaf_vel_dot(const FlightParams& p, int il, const float k[3]) {
  return leaf_gather(p.vfx, il, 0.0f) * k[0] + leaf_gather(p.vfy, il, 0.0f) * k[1] +
         leaf_gather(p.vfz, il, 0.0f) * k[2];
}

// distance to an octree node's exit face along one axis (engine.py:
// 1571-1576): c the node's centre, h its half-width
__device__ inline float node_face_dist(float pos, float k, float c, float h) {
  if (fabsf(k) < 1e-12f) return LART_BIG;
  return fmaxf((c + (k > 0.0f ? h : -h) - pos) / k, 0.0f);
}

// u . k in thermal units of flat cell f or cell (i, j, k)
// (engine.cell_velocity_dot), as XLA contracts the sum of products:
// fma(vz, kz, fma(vx, kx, vy ky))
__device__ inline float vel_dot_at(const FlightParams& p, int f, const float k[3]) {
  return fmaf(p.vfz[f], k[2], fmaf(p.vfx[f], k[0], p.vfy[f] * k[1]));
}

__device__ inline float vel_dot(const FlightParams& p, const int c[3], const float k[3]) {
  return vel_dot_at(p, flat_index(p, c[0], c[1], c[2]), k);
}

// distance to the exit face along one axis (engine.py:1075-1079)
__device__ inline float face_dist(float pos, float k, int idx, float amin, float d) {
  if (fabsf(k) < 1e-12f) return LART_BIG;
  const float face = fmaf((float)(k > 0.0f ? idx + 1 : idx), d, amin);
  return fmaxf((face - pos) / k, 0.0f);
}

// the step of a walk from path length trav with the next face dmin away:
// min(dmin, cap - trav), and whether it reaches the cap (dmin >= cap -
// trav); cap < 0: no cap (an interior observer's sightline stops at the
// observer: peel.py:260-265, sightline.py:89-95)
__device__ inline float capped_step(float dmin, float cap, float trav, bool& hit) {
  if (cap < 0.0f) {
    hit = false;
    return dmin;
  }
  const float dleft = fmaxf(cap - trav, 0.0f);
  hit = dmin >= dleft;
  return fminf(dmin, dleft);
}

// boundary op after stepping cell index idx along axis a (engine.py:
// 1081-1104); returns whether the lane escaped.  Reflect mirrors the
// position to -amin, restarts in cell cell0 - 1 and flips k; its upper face
// escapes.
__device__ inline bool cross_axis(const FlightParams& p, int a, int& idx, float& pos,
                                  float& k) {
  const int nidx = idx + (k > 0.0f ? 1 : -1);
  const bool lo = nidx < 0, hi = nidx >= p.n[a];
  if (p.bc[a] == BC_PERIODIC) {
    idx = lo ? p.n[a] - 1 : (hi ? 0 : nidx);
    pos = lo ? p.amax[a] : (hi ? p.amin[a] : pos);
    return false;
  }
  if (p.bc[a] == BC_REFLECT) {
    idx = lo ? p.cell0[a] - 1 : nidx;
    if (lo) {
      pos = p.neg_amin[a];
      k = -k;
    }
    return hi;
  }
  idx = nidx;
  return lo || hi;
}

// sphere_chord (engine.py:871): the ray-parameter interval [t_in, t_out]
// inside r < R, both 0 when the ray misses; the dot products and the
// discriminant are the fused multiply-adds XLA computes them with
// (transport/flight.py)
__device__ inline void sphere_chord(const FlightParams& p, float x, float y, float z,
                                    float kx, float ky, float kz, float& t_in,
                                    float& t_out) {
  const float b = fmaf(z, kz, fmaf(y, ky, x * kx));
  const float r2 = fmaf(z, z, fmaf(y, y, x * x));
  const float det = fmaf(b, b, -(r2 - p.sphere_R2));
  const float sq = sqrtf(fmaxf(det, 0.0f));
  t_out = fmaxf(-b + sq, 0.0f);
  t_in = fminf(fmaxf(-b - sq, 0.0f), t_out);
  if (!(det > 0.0f)) {
    t_in = 0.0f;
    t_out = 0.0f;
  }
}
