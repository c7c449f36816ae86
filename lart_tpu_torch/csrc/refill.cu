// K2 refill: rebirth of dead lanes for a point source or an extended one
// (the instances below) with a Voigt, voigt0, monochromatic, Gaussian, flat
// continuum or continuum+gaussian input spectrum, with the
// forced-first-scattering snapshot and the birth weight, in a static or
// moving medium, and the birth shift of a multi-level line.
//
// Replaces lart_tpu/transport/engine.py:2557 make_refill / :2689 refill
// (every source_geometry and spectral_type) with lart_tpu/physics/
// sources.py:322-474 (the illumination samplers) and :2923
// branch_init_shift (line.cuh), which the TPU runs as a
// pass of its own over the batch and which here is a device function of the
// births: a line of type 2, 4, 5 or 6 starts from xfreq0 shifted to a branch
// by the two uniforms of block 3.  The continuum (engine.py:2804-2807)
// replaces the frequency, the branch shift included, by xfreq_min + u
// (xfreq_max - xfreq_min), u from block 2, which only the Gaussian also
// reads; the D_loc / Dfreq_ref it is divided by is 1 at uniform temperature.  The TPU
// ranks dead lanes with a cumsum over the whole batch (:2700), a pass the
// card would need a second kernel for.  Here each warp counts its dead
// lanes with a ballot and takes a block of tickets from the device photon
// counter with one atomicAdd; a ticket below the budget launches its lane.
// A warp whose block overshoots the budget clamps the counter back with
// atomicMin, so once the kernel ends n_launched == min(old + #dead, budget)
// and exactly that many lanes were launched.  Which lanes launch when the
// budget runs out depends on warp order; nothing downstream depends on lane
// order.  In a moving medium the drawn frequency is a lab-frame one: unless
// comoving_source, the lane flies at xfreq - u1 with u1 = v(source cell) . k
// (engine.py:2836-2841), and Jin is tallied at the lab frequency xfreq + u1;
// the source cell's velocity (vsx, vsy, vsz) is 0 in a static medium.
// The Gaussian spectrum (engine.py:2799-2803) adds a normal times sigma_x,
// drawn by Box-Muller from block 2, which only the continuum also reads; the
// D_loc / Dfreq_ref it is divided by is 1 at uniform temperature.
// A launched lane is unpolarized (Q = U = V = 0) with the reference triad
// m = (cos t cos p, cos t sin p, -sin t), n = (-sin p, cos p, 0) of its
// direction (engine.py:2863-2873), in the resonance line's band (iband 1,
// engine.py:2888; line type 8's conversions move it to 2), unsheared
// (vfy_shear 0, engine.py:2883; one store).  With peel-off
// on, the record's flag is written on every lane: 1 where this call
// launched, else 0; K7 then peels exactly those lanes (engine.py:2909-2913).
// On the AMR grid (engine.py:2755-2775, :2839) each launched lane finds the
// source's node itself (csrc/amr.cuh amr_find_cell: one fine-map gather or
// the octant descent from the root) and reads its leaf's velocity and, at
// non-uniform temperature, its damping a_loc, which the Voigt spectrum
// draws with, and Doppler width D_loc: the Gaussian and the continuum are
// divided by D_loc / Dfreq_ref and Jin is tallied at (x + u1) D_loc /
// Dfreq_ref.  A Cartesian grid at non-uniform temperature does the same
// with the birth cell's a and D: the point source's (its fixed cell's, a
// and D_src from the host), an extended source's per lane from the grid's
// per-cell arrays; they also set the branch shift's offsets dnu / D_loc.
// On a clump medium (engine.py:2750-2772) each launched lane finds its
// birth clump itself (csrc/clump.cuh clump_find: the dense scan over all
// clumps, or the CSR cell's candidates; -1 in the vacuum); the spectrum is
// drawn at the reference a and D (photons carry global frequencies) and u1
// is the birth clump's velocity along k in reference units.
// The extended sources (engine.py:2577-2687 gen_position) draw each launched
// lane's position from the uniforms of block 4 and, where they need more,
// the words of block 5, after every earlier block, so a point source draws as
// before.  K2 has one template instance per family (kSrc), so the point
// source's code stays as it was:
// - SRC_POINT: the point source with a monochromatic, Voigt, Gaussian or
//   continuum spectrum (the flagship's);
// - SRC_RADIAL: the exponential cylinder, exponential sphere, sersic and ssh
//   (lart_tpu/physics/sources.py:478 sample_radius_loglog): the radius by a
//   binary search of the f32 log-log inverse-CDF table (at most 2049 knots,
//   read through the L1 by __ldg) and jnp.interp's arithmetic (the clamps at
//   the ends, fp[i-1] + (x - xp[i-1]) / dx df as one fused multiply-add),
//   then the cylinder's azimuth and z (the truncated exponential _zexp
//   :2569-2575, or uniform over the box) or a point on the sphere
//   (_iso_sphere :2563);
// - SRC_VOLUME: the uniform sphere (radius powf(u, 1/3) rmax), cylinder,
//   box, xy disk or box, the Gaussian slab (a normal by Box-Muller from
//   block 5) and the exponential slab; a point source with the voigt0 or
//   continuum+gaussian spectrum also runs here;
// - SRC_ALIAS: the alias draw (lart_tpu/physics/sources.py:486
//   sample_alias_linear, lart_tpu/physics/samplers.py:287 alias_sample) of a
//   star, a Cartesian cell (a uniform point in it), an AMR leaf (centre +
//   (2u - 1) half-size) or a 1-D profile's bin (the linear density's inverse
//   CDF within it, the radius put on the sphere), with its composite weight.
//   The bin is (bits n) >> 32 of 32 random bits, so every bin of a table of
//   millions of cells is reachable and equally likely before its alias.
// With xyz_symmetry every non-point position is taken in absolute value.
// The lane's cell is then its own: on a Cartesian grid clip(floor((x -
// amin) / d)) per axis, with its velocity gathered in a moving medium; on
// the AMR grid and the clump medium the lookups above run at the lane's
// position.  The birth weight (1, or the table's composite weight) goes into
// the lane's wgt and into Jin (engine.py:2843-2850, :2876).
// The voigt0 spectrum (engine.py:2783) draws a Voigt x at the source
// temperature's damping va0 scaled by Dfreq0 / D_loc; continuum+gaussian
// (:2808) the line, xfreq0 + a Box-Muller normal sigma_x, with probability
// f_line (the third uniform of block 2), else the flat continuum (the
// fourth), divided by D_loc / Dfreq_ref.
// SRC_ILLUM, the illuminations (engine.py:2707-2719, lart_tpu/physics/
// sources.py:354-474): a stellar or point illumination draws its birth by
// masked rejection rounds, round r from the four uniforms of block 6 + r, at
// most 8 rounds and the fallback after them (the sub-planet point aiming
// at the centre, straight down the axis); the lane's direction is the
// sampler's, not the isotropic draw, and its weight the limb weight.  Each
// launched lane's flux factor and its rejected rounds are summed by a warp
// shuffle into one atomicAdd a warp (engine.py:2900-2908): the TPU's two
// sums over the batch.  plane_illumination (engine.py:2645-2660) births at
// the top face of a plane atmosphere beaming -z, else on the disk of
// radius rmax at zmin beaming +z.  With peel-off on, a stellar source's
// lane also draws its one limb-darkened surface sample (cos theta by
// sample_limb_cost's rounds, two a block from block 14, and vphi from block
// 18) into the record, so that K7's PEEL_STELLAR pairs of every observer
// read the same one (lart_tpu/instruments/peel.py:732-737) and K7 draws
// nothing.  The line_prof_file spectrum (engine.py:2826-2834), in every
// instance: the alias bin of the profile from the 32 bits of word 0 of
// block 2 (its alias by word 1), uniform within the bin by word 2, divided
// by D_loc / Dfreq_ref; it replaces the frequency, a branch shift too.  A
// plane atmosphere's 1-D emissivity profile (engine.py:2661-2667,
// GEOM_PROFILE_PLANE in the alias instance) puts the drawn height at a
// uniform point of the box's x-y extent.
// With save_all_photons (the kAllph instances, the table's pointer non-null;
// csrc/allph.cuh) a launched lane's ticket is its photon id, pid = pid_base +
// ticket (pid_base 0 on one card; lart_tpu's n_shard offset), its event
// counts start at 0, and it writes its birth row: the impact parameter of
// the birth ray and the comoving birth frequency (engine.py:2884-2899).
// lart_tpu ranks the dead lanes by a cumsum, so the two assign the same ids
// to other lanes; a run without the table runs the instances without it.
// Bound: one pass over the state (about 130 bytes a launched lane written,
// 4 a lane read), memory-bound; the ticket atomics are one per warp; a
// radial table adds ~11 dependent table reads a lane (L1/L2-resident), an
// alias table two to four (the bin's probability and alias, its entry).
#include "lart.cuh"
#include "philox.cuh"
#include "samplers.cuh"

enum {
  SPECTRUM_MONO = 0,
  SPECTRUM_VOIGT = 1,
  SPECTRUM_GAUSS = 2,
  SPECTRUM_CONT = 3,
  SPECTRUM_VOIGT0 = 4,
  SPECTRUM_CONT_GAUSS = 5,
  SPECTRUM_LINE_PROF = 6
};
enum { SRC_POINT = 0, SRC_RADIAL = 1, SRC_VOLUME = 2, SRC_ALIAS = 3, SRC_ILLUM = 4 };
enum {
  GEOM_POINT = 0,
  GEOM_EXP_CYLINDER,
  GEOM_RADIAL_SPHERE,
  GEOM_UNIFORM_SPHERE,
  GEOM_CYLINDER,
  GEOM_BOX,
  GEOM_XY_DISK,
  GEOM_XY_BOX,
  GEOM_GAUSSIAN,
  GEOM_EXPONENTIAL,
  GEOM_STARS,
  GEOM_CELLS,
  GEOM_LEAVES,
  GEOM_PROFILE,
  GEOM_PROFILE_PLANE,
  GEOM_STELLAR,
  GEOM_POINT_ILLUM,
  GEOM_PLANE_ILLUM
};
#define SOURCE_P_FLOOR 9.999999960041972e-13f  // f32(1e-12)
#define SOURCE_TINY_DP 1.0000000031710769e-30f  // f32(1e-30)
#define BLOCK_SPECTRUM 2u
#define BLOCK_SOURCE 4u
#define BLOCK_SOURCE2 5u
#define BLOCK_ILLUM 6u   // round r of an illumination sampler: block 6 + r
#define BLOCK_LIMB 14u   // the stellar peel's limb rounds, two a block, then vphi
#define ILLUM_ROUNDS 8
// the limb-darkening polynomial (lart_tpu/physics/sources.py:302), its
// norm c0/2 + c1/3 + c2/4 rounded to f32
#define LIMB_C0 0.55f
#define LIMB_C1 0.12f
#define LIMB_C2 0.33f
#define LIMB_NORM 0.3975f

// An extended source, or a point source of the voigt0 or continuum+gaussian
// spectrum; lart_tpu_torch/transport/refill.py SourceC mirrors it field for
// field.
struct SourceC {
  int geom;
  const float* log_p;  // (n,) f32 logs of the f32 cumulative probabilities
  const float* log_r;  // (n,) f32 logs of the f32 radii
  int n;
  int zexp;            // z from the truncated exponential, else uniform
  float neg_zs, zexp_c;
  float rmax;          // the uniform sphere's, cylinder's or disk's radius
  float zgauss;        // source_zscale / sqrt(2)
  int abs_xyz;         // xyz_symmetry
  int cells[3];        // the Cartesian grid a birth's cell is found in
  float amin[3];       // the box's lower corner
  float d[3];
  float span[3];       // the box's extent
  const float* prob;   // (nbin,) alias table
  const int* alias;
  int nbin;
  const float* wgt;    // composite weight of each bin (of each knot), or null
  const float* px;     // stars: x y z; leaves: cx cy cz ch; profile: axis,
  const float* py;     //   density
  const float* pz;
  const float* ph;
  float va0, dfreq0;   // voigt0: the source's damping and Doppler width
  float f_line;        // continuum+gaussian: the line's share
  // the illuminations: the star (radius Rs at distance Dsp), the
  // atmosphere's radius (the plane disk's) and its square, the cone
  // bounds (1 - cosvt_max, cosvt_max, 1 - cost_max, cost_max), a birth's
  // flux factor, the limb model and its rejection envelope; the point
  // source's wall distance and cone (1 - costm, costm), the face it lights
  // (the plane's too) and the box's x, y bounds, whether it is below;
  // the plane disk's azimuth range (< 0: the plane atmosphere's top face)
  float Rs, Dsp, atm_r, atm_r2;
  float cosvt_c1, cosvt_max, cost_c1, cost_max;
  float flux_fac1;
  int limb;
  float limb_pmax;
  float dist_wall, costm_c1, costm, zface;
  float ibox[4];
  int below;
  float dphi;
};

// the line_prof_file spectrum's table (lart_tpu_torch/physics/sources.py
// LineProfTable; transport/refill.py ProfC): alias probabilities and
// aliases of its n bins, and their n + 1 edges in xfreq units
struct ProfC {
  const float* prob;
  const int* alias;
  const float* edges;
  int n;
};

// the limb weight of an illumination birth at cos_ang (sources.py:304-320)
__device__ inline float limb_poly(float mu) {
  return (LIMB_C0 + LIMB_C1 * mu + LIMB_C2 * mu * mu) * mu / LIMB_NORM / 2.0f;
}

__device__ inline float limb_wgt(int model, float ca) {
  if (model <= 0) return 1.0f;
  if (model == 1) return 2.0f * ca;
  if (model == 2) return ca * (1.5f * ca + 1.0f);
  return limb_poly(ca);
}

// sample_limb_cost (sources.py:322-351): round r's two uniforms are words
// 2 (r % 2) and 2 (r % 2) + 1 of block BLOCK_LIMB + r / 2; models 0 and 1
// read the first uniform alone
__device__ inline float limb_cost(const SourceC& src, uint32_t seed, uint32_t i,
                                  uint32_t counter) {
  float w[4];
  uniforms4(seed, STREAM_REFILL, i, counter, BLOCK_LIMB, w);
  if (src.limb <= 0) return w[0];
  if (src.limb == 1) return sqrtf(w[0]);
  for (int r = 0; r < ILLUM_ROUNDS; ++r) {
    if (r > 0 && (r & 1) == 0)
      uniforms4(seed, STREAM_REFILL, i, counter, BLOCK_LIMB + (uint32_t)(r >> 1), w);
    const float mu = w[2 * (r & 1)], xi1 = w[2 * (r & 1) + 1];
    const float pdf = src.limb == 2 ? mu * (1.5f * mu + 1.0f) : limb_poly(mu);
    if (xi1 * src.limb_pmax < pdf) return mu;
  }
  return 1.0f;
}

// an illumination's birth of lane i: position, direction, weight; ff and
// nrej get its flux factor and rejected rounds (stellar and point)
__device__ inline float illuminate(const SourceC& src, uint32_t seed, uint32_t i,
                                   uint32_t counter, float& xs, float& ys, float& zs,
                                   float& kx, float& ky, float& kz, float& ff,
                                   float& nrej) {
  float wgt = 1.0f;
  if (src.geom == GEOM_PLANE_ILLUM) {
    if (src.dphi < 0.0f) {
      xs = 0.0f;
      ys = 0.0f;
      kz = -1.0f;
    } else {
      float w[4];
      uniforms4(seed, STREAM_REFILL, i, counter, BLOCK_SOURCE, w);
      const float rp = sqrtf(w[0]) * src.atm_r;
      const float phi = src.dphi * w[1];
      xs = rp * cosf(phi);
      ys = rp * sinf(phi);
      kz = 1.0f;
    }
    zs = src.zface;
    kx = 0.0f;
    ky = 0.0f;
  } else if (src.geom == GEOM_STELLAR) {
    bool acc = false;
    float ca = 1.0f;
    for (int r = 0; r < ILLUM_ROUNDS && !acc; ++r) {
      float u[4];
      uniforms4(seed, STREAM_REFILL, i, counter, BLOCK_ILLUM + (uint32_t)r, u);
      const float cosvt = src.cosvt_c1 * u[0] + src.cosvt_max;
      const float sinvt = sqrtf(fmaxf(1.0f - cosvt * cosvt, 0.0f));
      const float vphi = LART_TWOPI * u[1];
      const float x0 = sinvt * cosf(vphi), y0 = sinvt * sinf(vphi), z0 = cosvt;
      const float x = src.Rs * x0, y = src.Rs * y0, z = src.Rs * z0 - src.Dsp;
      const float rr = sqrtf(x * x + y * y + z * z);
      const float kx0 = -x / rr, ky0 = -y / rr, kz0 = -z / rr;
      const float cost = src.cost_c1 * u[2] + src.cost_max;
      const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
      const float phi = LART_TWOPI * u[3];
      const float cosp = cosf(phi), sinp = sinf(phi);
      const float kr = sqrtf(fmaxf(kx0 * kx0 + ky0 * ky0, 1e-24f));
      const float dx = cost * kx0 + sint * (kz0 * kx0 * cosp - ky0 * sinp) / kr;
      const float dy = cost * ky0 + sint * (kz0 * ky0 * cosp + kx0 * sinp) / kr;
      const float dz = cost * kz0 - sint * cosp * kr;
      const float r_dot_k = x * dx + y * dy + z * dz;
      const float det = r_dot_k * r_dot_k - (rr * rr - src.atm_r2);
      const float cos_ang = x0 * dx + y0 * dy + z0 * dz;
      if (cos_ang >= 0.0f && det >= 0.0f) {
        const float dist = -r_dot_k - sqrtf(fmaxf(det, 0.0f));
        xs = x + dx * dist;
        ys = y + dy * dist;
        zs = z + dz * dist;
        kx = dx;
        ky = dy;
        kz = dz;
        ca = cos_ang;
        acc = true;
      } else {
        nrej = nrej + 1.0f;
      }
    }
    if (!acc) {
      // stragglers: aim at the planet centre from the sub-planet point
      xs = 0.0f;
      ys = 0.0f;
      zs = -src.atm_r;
      kx = 0.0f;
      ky = 0.0f;
      kz = 1.0f;
    }
    wgt = limb_wgt(src.limb, ca);
    ff = src.flux_fac1 * wgt;
  } else {
    bool acc = false;
    float cz = 1.0f;
    for (int r = 0; r < ILLUM_ROUNDS && !acc; ++r) {
      float u[4];
      uniforms4(seed, STREAM_REFILL, i, counter, BLOCK_ILLUM + (uint32_t)r, u);
      const float cost = u[0] * src.costm_c1 + src.costm;
      const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
      const float phi = LART_TWOPI * u[1];
      const float dx = sint * cosf(phi), dy = sint * sinf(phi);
      const float dist = src.dist_wall / cost;
      const float x = dist * dx, y = dist * dy;
      if (x >= src.ibox[0] && x <= src.ibox[1] && y >= src.ibox[2] && y <= src.ibox[3]) {
        xs = x;
        ys = y;
        kx = dx;
        ky = dy;
        cz = cost;
        acc = true;
      } else {
        nrej = nrej + 1.0f;
      }
    }
    if (!acc) {
      // stragglers: straight down the axis
      xs = 0.0f;
      ys = 0.0f;
      kx = 0.0f;
      ky = 0.0f;
    }
    zs = src.zface;
    kz = src.below ? cz : -cz;
    ff = src.flux_fac1 * wgt;
  }
  if (src.abs_xyz) {
    xs = fabsf(xs);
    ys = fabsf(ys);
    zs = fabsf(zs);
  }
  return wgt;
}

// the sum of v over the warp, added to *dst by its lane 0 (every lane of
// the warp must call it)
__device__ inline void warp_sum_atomic(float v, float* dst) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0 && v != 0.0f) atomicAdd(dst, v);
}

// sample_radius_loglog: jnp.interp(log(max(u, 1e-12)), log_p, log_r), exp
__device__ inline float radius_loglog(const SourceC& src, float u) {
  const float x = logf(fmaxf(u, SOURCE_P_FLOOR));
  int lo = 0, hi = src.n;  // searchsorted(side='right'): #knots <= x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(&src.log_p[mid]) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int i = min(max(lo, 1), src.n - 1);
  const float xp0 = __ldg(&src.log_p[i - 1]), xp1 = __ldg(&src.log_p[i]);
  const float fp0 = __ldg(&src.log_r[i - 1]), fp1 = __ldg(&src.log_r[i]);
  float f = fmaf((x - xp0) / (xp1 - xp0), fp1 - fp0, fp0);
  if (x < __ldg(&src.log_p[0])) f = __ldg(&src.log_r[0]);
  if (x > __ldg(&src.log_p[src.n - 1])) f = __ldg(&src.log_r[src.n - 1]);
  return expf(f);
}

__device__ inline void iso_sphere(float rp, float xi1, float xi2, float& x, float& y,
                                  float& z) {
  const float cost = 2.0f * xi1 - 1.0f;
  const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
  const float phi = LART_TWOPI * xi2;
  x = rp * sint * cosf(phi);
  y = rp * sint * sinf(phi);
  z = rp * cost;
}

__device__ inline float source_zexp(const SourceC& src, float u_a, float u_b) {
  const float zmag = src.neg_zs * log1pf(-(u_a * src.zexp_c));
  return u_b < 0.5f ? -zmag : zmag;
}

// the birth position of lane i of an extended source (blocks 4 and 5); returns
// its weight
template <int kSrc>
__device__ inline float source_position(const SourceC& src, uint32_t seed, uint32_t i,
                                        uint32_t counter, float& xs, float& ys, float& zs) {
  float w[4];
  float wgt = 1.0f;
  uniforms4(seed, STREAM_REFILL, i, counter, BLOCK_SOURCE, w);
  const int g = src.geom;
  if (kSrc == SRC_RADIAL) {
    const float rp = radius_loglog(src, w[0]);
    if (g == GEOM_RADIAL_SPHERE) {
      iso_sphere(rp, w[1], w[2], xs, ys, zs);
    } else {
      const float phi = LART_TWOPI * w[1];
      xs = rp * cosf(phi);
      ys = rp * sinf(phi);
      zs = src.zexp ? source_zexp(src, w[2], w[3]) : fmaf(w[2], src.span[2], src.amin[2]);
    }
  } else if (kSrc == SRC_VOLUME) {
    if (g == GEOM_POINT) return 1.0f;
    if (g == GEOM_UNIFORM_SPHERE) {
      iso_sphere(powf(w[0], 1.0f / 3.0f) * src.rmax, w[1], w[2], xs, ys, zs);
    } else if (g == GEOM_CYLINDER || g == GEOM_XY_DISK) {
      const float rp = sqrtf(w[0]) * src.rmax;
      const float phi = LART_TWOPI * w[1];
      xs = rp * cosf(phi);
      ys = rp * sinf(phi);
      zs = g == GEOM_CYLINDER ? fmaf(w[2], src.span[2], src.amin[2]) : 0.0f;
    } else {
      xs = fmaf(w[0], src.span[0], src.amin[0]);
      ys = fmaf(w[1], src.span[1], src.amin[1]);
      if (g == GEOM_BOX) {
        zs = fmaf(w[2], src.span[2], src.amin[2]);
      } else if (g == GEOM_XY_BOX) {
        zs = 0.0f;
      } else if (g == GEOM_GAUSSIAN) {
        float v[4];
        uniforms4(seed, STREAM_REFILL, i, counter, BLOCK_SOURCE2, v);
        zs = src.zgauss * box_muller(v[0], v[1]);
      } else {
        zs = source_zexp(src, w[2], w[3]);
      }
    }
  } else if (kSrc == SRC_ALIAS) {
    // the bin from 32 random bits, its alias by the uniform of the next word
    uint32_t c[4] = {i, counter, BLOCK_SOURCE2, 0u};
    philox4x32_10(c, seed, STREAM_REFILL);
    int idx = (int)(((uint64_t)c[0] * (uint64_t)src.nbin) >> 32);
    if (u01_from_bits(c[1]) >= __ldg(&src.prob[idx])) idx = __ldg(&src.alias[idx]);
    if (g == GEOM_PROFILE || g == GEOM_PROFILE_PLANE) {
      // sample_alias_linear: the linear density's inverse CDF in the bin
      const float xi = u01_from_bits(c[2]);
      const float x0 = __ldg(&src.px[idx]), x1 = __ldg(&src.px[idx + 1]);
      const float p0 = __ldg(&src.py[idx]), p1 = __ldg(&src.py[idx + 1]);
      const float dp = p1 - p0;
      const float root = sqrtf(fmaxf(p0 * p0 + (p1 * p1 - p0 * p0) * xi, 0.0f));
      const float r = fabsf(dp) > SOURCE_TINY_DP
                          ? (root - p0) * (x1 - x0) / (dp == 0.0f ? 1.0f : dp) + x0
                          : x0 + xi * (x1 - x0);
      if (src.wgt) {
        const float w0 = __ldg(&src.wgt[idx]), w1 = __ldg(&src.wgt[idx + 1]);
        wgt = (w1 - w0) / fmaxf(x1 - x0, SOURCE_TINY_DP) * (r - x0) + w0;
      }
      if (g == GEOM_PROFILE_PLANE) {
        // the height of a plane atmosphere, at a uniform point of the box
        xs = fmaf(w[0], src.span[0], src.amin[0]);
        ys = fmaf(w[1], src.span[1], src.amin[1]);
        zs = r;
      } else {
        iso_sphere(r, w[1], w[2], xs, ys, zs);
      }
    } else {
      if (src.wgt) wgt = __ldg(&src.wgt[idx]);
      if (g == GEOM_STARS) {
        xs = __ldg(&src.px[idx]);
        ys = __ldg(&src.py[idx]);
        zs = __ldg(&src.pz[idx]);
      } else if (g == GEOM_LEAVES) {
        const float ch = __ldg(&src.ph[idx]);
        xs = fmaf(2.0f * w[1] - 1.0f, ch, __ldg(&src.px[idx]));
        ys = fmaf(2.0f * w[2] - 1.0f, ch, __ldg(&src.py[idx]));
        zs = fmaf(2.0f * w[3] - 1.0f, ch, __ldg(&src.pz[idx]));
      } else {
        const int nz = src.cells[2], nyz = src.cells[1] * nz;
        const int c0 = idx / nyz, c1 = (idx / nz) % src.cells[1], c2 = idx % nz;
        xs = fmaf((float)c0 + w[1], src.d[0], src.amin[0]);
        ys = fmaf((float)c1 + w[2], src.d[1], src.amin[1]);
        zs = fmaf((float)c2 + w[3], src.d[2], src.amin[2]);
      }
    }
  }
  if (src.abs_xyz) {
    xs = fabsf(xs);
    ys = fabsf(ys);
    zs = fabsf(zs);
  }
  return wgt;
}

template <int kSrc, bool kAllph>
__global__ void refill_point_kernel(Lanes s, PeelRecord rec, int B, int* n_launched,
                                    int budget, uint32_t seed, uint32_t counter, float xs,
                                    float ys, float zs, int ic, int jc, int kc,
                                    float xfreq0, int spectrum, float sigma_x, float a,
                                    float vsx,
                                    float vsy, float vsz, int comoving_source,
                                    float xfreq_min, float dxfreq, int nxfreq, float* Jin,
                                    float xfreq_span, float Dfreq, float D_src, LineC line,
                                    AmrGrid amr, ClumpGrid clump, const float* vfx,
                                    const float* vfy, const float* vfz, const float* cell_a,
                                    const float* cell_D, SourceC src, ProfC lp,
                                    float* flux_factor, float* nrejected, AllPh allph,
                                    int pid_base) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool dead = i < B && s.phase[i] == DEAD;
  const unsigned full = 0xffffffffu;
  const unsigned mask = __ballot_sync(full, dead);
  const int lane = threadIdx.x & 31;
  const int n = __popc(mask);
  int base = 0;
  if (lane == 0 && n > 0) {
    base = atomicAdd(n_launched, n);
    if (base + n > budget) atomicMin(n_launched, budget);
  }
  base = __shfl_sync(full, base, 0);
  const bool launch = dead && base + __popc(mask & ((1u << lane) - 1u)) < budget;
  if (rec.flag && i < B) rec.flag[i] = launch ? 1 : 0;
  // an illumination's beamed direction, flux factor and rejected rounds
  float kdx = 0.0f, kdy = 0.0f, kdz = 1.0f, ff = 0.0f, nrej = 0.0f;
  float wgt = 1.0f;  // the birth weight: 1 but for a composite-biased table
  if (kSrc == SRC_ILLUM) {
    if (launch)
      wgt = illuminate(src, seed, (uint32_t)i, counter, xs, ys, zs, kdx, kdy, kdz, ff, nrej);
    // every lane of the warp is here: one shuffle sum and one atomic a warp
    if (flux_factor) {
      warp_sum_atomic(ff, flux_factor);
      warp_sum_atomic(nrej, nrejected);
    }
  }
  if (!launch) return;

  // the source cell: on the AMR grid the deepest node holding the source
  // (amr_find_cell, engine.py:2755-2758) with its leaf's damping, Doppler
  // width and velocity (the reference values and none in a gap); the point
  // source's Cartesian cell's a and D_src (engine.py:2771-2775)
  float a_loc = a, D_loc = D_src;
  if (kSrc != SRC_POINT) {
    // an extended source: the lane's own position (an illumination's
    // above) and, on a Cartesian grid, its cell (and that cell's velocity)
    if (kSrc != SRC_ILLUM)
      wgt = source_position<kSrc>(src, seed, (uint32_t)i, counter, xs, ys, zs);
    if (src.geom != GEOM_POINT && !clump.n && !amr.ncells) {
      const float pos[3] = {xs, ys, zs};
      int c[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        c[q] = (int)fminf(fmaxf(floorf((pos[q] - src.amin[q]) / src.d[q]), 0.0f),
                          (float)(src.cells[q] - 1));
      ic = c[0];
      jc = c[1];
      kc = c[2];
      const int f = (ic * src.cells[1] + jc) * src.cells[2] + kc;
      if (vfx) {
        vsx = __ldg(&vfx[f]);
        vsy = __ldg(&vfy[f]);
        vsz = __ldg(&vfz[f]);
      }
      if (cell_D) {
        // the birth cell's damping and Doppler width (non-uniform T)
        a_loc = __ldg(&cell_a[f]);
        D_loc = __ldg(&cell_D[f]);
      }
    }
  }
  if (clump.n) {
    ic = clump_find(clump, xs, ys, zs);
    jc = kc = 0;
  } else if (amr.ncells) {
    ic = amr_find_cell(amr, xs, ys, zs);
    jc = kc = 0;
    const int il = amr_leaf(amr, ic);
    if (amr.voigt_a) {
      a_loc = leaf_gather(amr.voigt_a, il, a);
      D_loc = leaf_gather(amr.Dfreq, il, Dfreq);
    }
    if (vfx) {
      vsx = leaf_gather(vfx, il, 0.0f);
      vsy = leaf_gather(vfy, il, 0.0f);
      vsz = leaf_gather(vfz, il, 0.0f);
    }
  }
  // D_loc / Dfreq_ref: exactly 1 at uniform temperature
  const float ratio = D_loc / Dfreq;

  float u[4], v[4];
  uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 0u, u);
  uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 1u, v);

  float cost, sint, cosp, sinp, kx, ky, kz;
  if (kSrc == SRC_ILLUM) {
    // beamed: the sampler's direction and its triad (engine.py:2740-2749)
    kx = kdx;
    ky = kdy;
    kz = kdz;
    cost = kz;
    sint = sqrtf(fmaxf(1.0f - kz * kz, 0.0f));
    const float safe = fmaxf(sint, 1e-20f);
    cosp = sint > 0.0f ? kx / safe : 1.0f;
    sinp = sint > 0.0f ? ky / safe : 0.0f;
    if (rec.limb_cost && src.geom == GEOM_STELLAR) {
      // the stellar direct peel's one surface sample of this photon
      float w[4];
      uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, BLOCK_LIMB + ILLUM_ROUNDS / 2, w);
      rec.limb_cost[i] = limb_cost(src, seed, (uint32_t)i, counter);
      rec.limb_vphi[i] = LART_TWOPI * w[0];
    }
  } else {
    // isotropic direction
    cost = 2.0f * u[0] - 1.0f;
    sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
    const float phi = LART_TWOPI * u[1];
    cosp = cosf(phi);
    sinp = sinf(phi);
    kx = sint * cosp;
    ky = sint * sinp;
    kz = cost;
  }

  float xfreq = xfreq0;
  if (line.branch_init) {
    float w[4];
    uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 3u, w);
    xfreq = xfreq + branch_init_shift(line, w[0], w[1], D_loc);
  }
  if (spectrum == SPECTRUM_VOIGT) {
    xfreq = xfreq + rand_voigt_x(a_loc, u[2], u[3], v[0]);
  } else if (spectrum == SPECTRUM_GAUSS) {
    float w[4];
    uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 2u, w);
    xfreq = (xfreq + box_muller(w[0], w[1]) * sigma_x) / ratio;
  } else if (spectrum == SPECTRUM_CONT) {
    float w[4];
    uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 2u, w);
    xfreq = (xfreq_min + w[0] * xfreq_span) / ratio;
  } else if (kSrc != SRC_POINT && spectrum == SPECTRUM_VOIGT0) {
    xfreq = xfreq + rand_voigt_x(src.va0, u[2], u[3], v[0]) * (src.dfreq0 / D_loc);
  } else if (kSrc != SRC_POINT && spectrum == SPECTRUM_CONT_GAUSS) {
    float w[4];
    uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 2u, w);
    xfreq = (w[2] < src.f_line ? xfreq + box_muller(w[0], w[1]) * sigma_x
                               : xfreq_min + w[3] * xfreq_span) /
            ratio;
  } else if (spectrum == SPECTRUM_LINE_PROF) {
    // the profile's alias bin from 32 bits, uniform within it
    uint32_t c[4] = {(uint32_t)i, counter, BLOCK_SPECTRUM, 0u};
    philox4x32_10(c, seed, STREAM_REFILL);
    int idx = (int)(((uint64_t)c[0] * (uint64_t)lp.n) >> 32);
    if (u01_from_bits(c[1]) >= __ldg(&lp.prob[idx])) idx = __ldg(&lp.alias[idx]);
    const float lo = __ldg(&lp.edges[idx]), hi = __ldg(&lp.edges[idx + 1]);
    xfreq = (lo + u01_from_bits(c[2]) * (hi - lo)) / ratio;
  }

  // lab-frame source -> comoving frequency; Jin at the lab frequency
  const float kdir[3] = {kx, ky, kz};
  const float u1 = clump.n ? clump_vel_dot(clump, ic, kdir, CLUMP_U_SCALE)
                           : vsx * kx + vsy * ky + vsz * kz;
  if (!comoving_source) xfreq = xfreq - u1;
  const float fx = floorf(((xfreq + u1) * ratio - xfreq_min) / dxfreq);
  if (fx >= 0.0f && fx < (float)nxfreq) atomicAdd(&Jin[(int)fx], wgt);

  s.phase[i] = FFS;
  s.x[i] = xs;
  s.y[i] = ys;
  s.z[i] = zs;
  s.kx[i] = kx;
  s.ky[i] = ky;
  s.kz[i] = kz;
  s.ic[i] = ic;
  s.jc[i] = jc;
  s.kc[i] = kc;
  s.xfreq[i] = xfreq;
  s.wgt[i] = wgt;
  // the FFS restart draws tau = -log(1 - xi*wgt1): xi waits in tau_target
  s.tau_target[i] = v[1];
  s.tau_run[i] = 0.0f;
  s.bx[i] = xs;
  s.by[i] = ys;
  s.bz[i] = zs;
  s.bic[i] = ic;
  s.bjc[i] = jc;
  s.bkc[i] = kc;
  s.bxfreq[i] = xfreq;
  s.bkx[i] = kx;
  s.bky[i] = ky;
  s.bkz[i] = kz;
  // unpolarized, with the reference triad of the birth direction
  s.Q[i] = 0.0f;
  s.U[i] = 0.0f;
  s.V[i] = 0.0f;
  s.mx[i] = cost * cosp;
  s.my[i] = cost * sinp;
  s.mz[i] = -sint;
  s.nnx[i] = -sinp;
  s.nny[i] = cosp;
  s.nnz[i] = 0.0f;
  s.iband[i] = 1;  // the resonance line's band (engine.py:2888)
  s.vfy_shear[i] = 0.0f;  // unsheared (engine.py:2883)
  if (kAllph) {
    // the ticket is the photon's id; no events yet; the birth row
    const int id = pid_base + base + __popc(mask & ((1u << lane) - 1u));
    s.pid[i] = id;
    s.nsg[i] = 0.0f;
    s.nsd[i] = 0.0f;
    allph_birth(allph, id, xs, ys, zs, kx, ky, kz, xfreq);
  }
}

// record: the PeelRecord pointer table, or null with peel-off off; amr: the
// octree, or null on a Cartesian grid, with vfx/vfy/vfz its per-leaf
// velocities (null in a static medium; an extended source on a moving
// Cartesian grid: the cells' velocities); clump: the clumps, or null;
// source: the extended source, or null for the point source; a and D_src
// the point source's cell's damping and Doppler width (the reference ones
// at uniform temperature and on AMR and clump grids), cell_a and cell_D an
// extended source's per-cell ones on a Cartesian grid at non-uniform
// temperature (null else); allph: the all-photons table, or null, and
// pid_base the first photon id of this device
LART_API int lart_refill_point(void* const* lanes, void* const* record, int B,
                               void* n_launched, int budget, unsigned seed,
                               unsigned counter, float xs, float ys, float zs, int ic,
                               int jc, int kc, float xfreq0, int spectrum, float sigma_x,
                               float a,
                               float vsx, float vsy, float vsz, int comoving_source,
                               float xfreq_min, float dxfreq, int nxfreq, void* Jin,
                               float xfreq_span, float Dfreq, float D_src,
                               const LineC* line, const AmrGrid* amr,
                               const ClumpGrid* clump, const float* vfx, const float* vfy,
                               const float* vfz, const float* cell_a, const float* cell_D,
                               const SourceC* source, const ProfC* prof,
                               void* flux_factor, void* nrejected, const AllPh* allph,
                               int pid_base, void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    const SourceC src = source ? *source : SourceC{};
    const ProfC lp = prof ? *prof : ProfC{};
    const int family = !source                     ? SRC_POINT
                       : src.geom >= GEOM_STELLAR  ? SRC_ILLUM
                       : src.geom >= GEOM_STARS    ? SRC_ALIAS
                       : src.geom == GEOM_EXP_CYLINDER || src.geom == GEOM_RADIAL_SPHERE
                           ? SRC_RADIAL
                           : SRC_VOLUME;
    const AllPh table = allph ? *allph : AllPh{};
    // one instance a source family (kSrc) and all-photons table (kAllph)
#define LART_REFILL(K, A)                                                                   \
  refill_point_kernel<K, A><<<blocks, threads, 0, (cudaStream_t)stream>>>(                  \
      unpack_lanes(lanes), unpack_record(record), B, (int*)n_launched, budget, seed, counter, \
      xs, ys, zs, ic, jc, kc, xfreq0, spectrum, sigma_x, a, vsx, vsy, vsz, comoving_source,  \
      xfreq_min, dxfreq, nxfreq, (float*)Jin, xfreq_span, Dfreq, D_src, *line,              \
      amr ? *amr : AmrGrid{}, clump ? *clump : ClumpGrid{}, vfx, vfy, vfz, cell_a, cell_D,   \
      src, lp, (float*)flux_factor, (float*)nrejected, table, pid_base)
#define LART_REFILL_FAMILY(K) \
  if (table.rp0)              \
    LART_REFILL(K, true);     \
  else                        \
    LART_REFILL(K, false);    \
  break;
    switch (family) {
      case SRC_POINT: LART_REFILL_FAMILY(SRC_POINT)
      case SRC_RADIAL: LART_REFILL_FAMILY(SRC_RADIAL)
      case SRC_VOLUME: LART_REFILL_FAMILY(SRC_VOLUME)
      case SRC_ILLUM: LART_REFILL_FAMILY(SRC_ILLUM)
      default: LART_REFILL_FAMILY(SRC_ALIAS)
    }
#undef LART_REFILL_FAMILY
#undef LART_REFILL
  }
  return (int)cudaGetLastError();
}

LART_API int lart_source_params_size() { return (int)sizeof(SourceC); }
