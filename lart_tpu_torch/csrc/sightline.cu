// K11 sightline: sight-line optical-depth and column-density maps of every
// observer, on a Cartesian grid, the octree AMR grid or a clump medium, for
// external (TAN) and interior (HEALPix) observers.
//
// Replaces lart_tpu/instruments/sightline.py:31 make_sightline: the
// Cartesian integrate (:48-134), the ray origins (:137-192), the entry
// cell's comoving shift (:226-238), the clump walker _make_sightline_clump
// (:268-411) and the AMR walker _make_sightline_amr (:414-560).  A map has
// nxfreq + 2 columns: N_gas (mode 1, rhokap D / cross0 a cell), tau_dust
// (mode 2, rhokapD) and tau_gas at each bin's centre frequency (mode 0,
// rhokap times the line's profile, line.cuh).  One thread takes one
// (observer, column, pixel), t = (o ncol + c) npix + pix, so a warp walks
// neighbouring pixels of one column.  It builds its own ray as lart_tpu's
// numpy does, in f64: the inverse TAN projection of an external observer's
// pixel centre, rotated by R^T and clipped to the box (a ray that misses it
// maps to 0), or for an interior observer the HEALPix pixel centre v
// (pix2vec_ring in f32, healpix.cuh), the distance to where v leaves the
// box, the ray starting there and walking back along -v, capped at that
// distance; the start and direction then go to f32.  The walk: the
// Cartesian DDA without boundary ops, stopping at the box's faces or at
// the cap (a partial last step), at most 2 (nx+ny+nz) + 8 crossings; the
// AMR node walk (exit face, neighbor hop and descent, amr.cuh; no snap of
// the crossed coordinate), at most 8 2^levelmax + 16 nodes; the clump CSR
// walk (a cell's candidates' chord overlaps clipped to the cell segment
// plus 1e-6 R, summed in table order, fmaf each), at most 3 cg_n + 8 cells.
// At non-uniform temperature a cell's profile and N_gas take the cell's
// damping and Doppler width (:65-67, rhokap D_cell / cross0).  In a moving
// medium or at non-uniform temperature a tau_gas ray starts at its entry
// cell's comoving frequency xf0 D_ref / D1 - u1 and follows the comoving
// update at each crossing.  No tau cutoff:
// lart_tpu has none here.  The TPU walks every ray of a column in one
// lockstep while_loop until the last leaves; here a ray stops on its own,
// and its sum runs in the same order either way.
// Bound: a dependent gather walk, one rhokap read (two velocities and a
// Voigt evaluation in mode 0) a crossing.  CIV_test's interior map is 6.05M
// rays over a 520,251-cell grid (2 MB of rhokap, L2-resident); the bound
// counted in chip_smoke.py is the bytes of the maps written once and each
// distinct cell read once, or the crossings' flops (~60 a gas crossing, ~30
// a column one) over 67 TFLOP/s, whichever is larger.
#include "healpix.cuh"
#include "lart.cuh"
#include "voigt.cuh"
#include "walk.cuh"

enum { SL_MODE_GAS = 0, SL_MODE_NGAS = 1, SL_MODE_DUST = 2 };
enum { SL_CART = 0, SL_AMR = 1, SL_CLUMP = 2 };

#define SL_RAD2DEG 57.29577951308232
#define SL_INF __longlong_as_double(0x7ff0000000000000LL)

// lart_tpu_torch/instruments/sightline.py SightParams mirrors this layout
// field for field; lart_sightline_params_size() lets it check the size.
struct SightParams {
  const float* obs_pos;   // (nobs, 3)
  const float* obs_rmat;  // (nobs, 3, 3), grid -> observer
  const float* xf_axis;   // (nxfreq,) the tau_gas columns' lab frequencies
  float* out;             // (nobs, nxfreq + 2, npix)
  int nobs, npix, nxim, nyim, nside, nxfreq, max_steps;
  int healpix;            // interior observers: HEALPix rays, capped
  int comoving;           // tau_gas: the entry shift and comoving updates
  int grid;               // SL_CART, SL_AMR or SL_CLUMP
  float cross0;           // N_gas: rhokap D / cross0 a cell
  float ngas_fac;         // N_gas on clumps: rhokap f32(D_cl / cross0)
  double dxim, dyim;      // TAN pixel, degrees
  double lo[3], hi[3];    // the box the rays are clipped to
  double eps;             // the start's nudge into the box
};

// numpy's minimum and maximum: NaN if either is NaN
__device__ inline double nan_min(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmin(a, b);
}
__device__ inline double nan_max(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmax(a, b);
}

// the ray of observer o's pixel (ray_origins, :137-192): f32 start and
// direction, whether it enters the box, and the cap (< 0: none)
__device__ inline bool sl_ray(const SightParams& p, int o, int pix, float pos[3], float k[3],
                              float& cap) {
  double op[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) op[a] = (double)p.obs_pos[3 * o + a];
  if (p.healpix) {
    float v[3];
    pix2vec_ring(p.nside, pix, v);
    double dist = SL_INF;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double kv = (double)v[a];
      const double t_lo = (p.lo[a] - op[a]) / kv, t_hi = (p.hi[a] - op[a]) / kv;
      if (isfinite(t_lo) && t_lo > 0.0) dist = fmin(dist, t_lo);
      if (isfinite(t_hi) && t_hi > 0.0) dist = fmin(dist, t_hi);
    }
    if (!isfinite(dist)) return false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pos[a] = (float)(op[a] + (dist - p.eps) * (double)v[a]);
      k[a] = -v[a];
    }
    cap = (float)dist;
    return true;
  }
  const int i = pix / p.nyim, j = pix % p.nyim;
  const double ang_x = ((double)i + 0.5 - p.nxim / 2.0) * p.dxim / SL_RAD2DEG;
  const double ang_y = ((double)j + 0.5 - p.nyim / 2.0) * p.dyim / SL_RAD2DEG;
  const double kx_o = -tan(ang_x), ky_o = -tan(ang_y), kz_o = -1.0;
  const double nrm = sqrt(kx_o * kx_o + ky_o * ky_o + kz_o * kz_o);
  const double kob[3] = {kx_o / nrm, ky_o / nrm, kz_o / nrm};
  const float* R = p.obs_rmat + 9 * o;
  double kd[3];
  double t0 = -SL_INF, t1 = SL_INF;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    kd[a] = (double)R[a] * kob[0] + (double)R[3 + a] * kob[1] + (double)R[6 + a] * kob[2];
    const double t_lo = (p.lo[a] - op[a]) / kd[a], t_hi = (p.hi[a] - op[a]) / kd[a];
    const double t_near = nan_min(t_lo, t_hi), t_far = nan_max(t_lo, t_hi);
    if (isfinite(t_near)) t0 = fmax(t0, t_near);
    if (isfinite(t_far)) t1 = fmin(t1, t_far);
  }
  if (!(t1 > t0 && t0 > 0.0)) return false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pos[a] = (float)(op[a] + (t0 + p.eps) * kd[a]);
    k[a] = (float)kd[a];
  }
  cap = -1.0f;
  return true;
}

// the Cartesian DDA (integrate, :48-134)
template <bool kMulti>
__device__ float sl_walk_cart(const FlightParams& g, const SightParams& p, int mode, float pos[3],
                              const float k[3], float xf, float cap) {
  int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) cell[a] = clamp_floor((pos[a] - g.amin[a]) / g.d[a], g.n[a]);
  // a tau_gas ray's entry cell's comoving frequency xf0 D_ref / D1 - u1
  const bool update = mode == SL_MODE_GAS && p.comoving && (g.moving || g.cell_D);
  if (update) {
    if (g.cell_D) xf = xf * (g.Dfreq / cell_D_of(g, flat_index(g, cell[0], cell[1], cell[2])));
    xf = xf - (g.moving ? vel_dot(g, cell, k) : 0.0f);
  }
  float tau = 0.0f, trav = 0.0f;
  for (int n = 0; n < p.max_steps; ++n) {
    const int f = flat_index(g, cell[0], cell[1], cell[2]);
    const float rk = __ldg(&g.rhokap[f]);
    float a_c, D_c;
    cell_a_D(g, f, a_c, D_c);
    const float rho = mode == SL_MODE_GAS ? rk * line_profile<kMulti>(g.line, xf, a_c, D_c)
                      : mode == SL_MODE_NGAS ? rk * D_c / p.cross0
                                             : (g.rhokapD ? __ldg(&g.rhokapD[f]) : 0.0f);
    float t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) t[a] = face_dist(pos[a], k[a], cell[a], g.amin[a], g.d[a]);
    const float dmin = fminf(fminf(t[0], t[1]), t[2]);
    const int axis = dmin == t[0] ? 0 : (dmin == t[1] ? 1 : 2);
    bool hit;
    const float dstep = capped_step(dmin, cap, trav, hit);
    tau = tau + dstep * rho;
    if (hit) break;
    trav = trav + dstep;
    const int nidx = cell[axis] + (k[axis] > 0.0f ? 1 : -1);
    if (nidx < 0 || nidx >= g.n[axis]) break;
#pragma unroll
    for (int a = 0; a < 3; ++a) pos[a] = fmaf(dmin, k[a], pos[a]);
    if (update) {
      const float u1 = g.moving ? vel_dot(g, cell, k) : 0.0f;
      cell[axis] = nidx;
      const float u2 = g.moving ? vel_dot(g, cell, k) : 0.0f;
      xf = (xf + u1) * D_c / cell_D_of(g, flat_index(g, cell[0], cell[1], cell[2])) - u2;
    } else {
      cell[axis] = nidx;
    }
  }
  return tau;
}

// the AMR node walk (_make_sightline_amr, :414-560)
template <bool kMulti>
__device__ float sl_walk_amr(const FlightParams& g, const SightParams& p, int mode, float pos[3],
                             const float k[3], float xf) {
  const AmrGrid& a = g.amr;
  const bool update = mode == SL_MODE_GAS && p.comoving;
  int ic = amr_find_cell(a, pos[0], pos[1], pos[2]);
  if (update) {
    const int il = amr_leaf(a, ic);
    float a1, D1;
    leaf_a_D(g, il, a1, D1);
    if (a.Dfreq) xf = xf * (g.Dfreq / D1);
    xf = xf - (g.moving ? leaf_vel_dot(g, il, k) : 0.0f);
  }
  float tau = 0.0f;
  for (int n = 0; n < p.max_steps; ++n) {
    const int il = amr_leaf(a, ic);
    float a_c, D_c;
    leaf_a_D(g, il, a_c, D_c);
    const float rk = leaf_gather(g.rhokap, il, 0.0f);
    const float rho = mode == SL_MODE_GAS ? rk * line_profile<kMulti>(g.line, xf, a_c, D_c)
                      : mode == SL_MODE_NGAS
                          ? rk * D_c / p.cross0
                          : (g.rhokapD ? leaf_gather(g.rhokapD, il, 0.0f) : 0.0f);
    const int c = amr_clip_cell(a, ic);
    const float cen[3] = {__ldg(&a.node_cx[c]), __ldg(&a.node_cy[c]), __ldg(&a.node_cz[c])};
    const float h = __ldg(&a.node_ch[c]);
    float t[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) t[q] = node_face_dist(pos[q], k[q], cen[q], h);
    const float dmin = fminf(fminf(t[0], t[1]), t[2]);
    const int axis = dmin == t[0] ? 0 : (dmin == t[1] ? 1 : 2);
    const int face = axis * 2 + (k[axis] > 0.0f ? 0 : 1);
    tau = tau + dmin * rho;
#pragma unroll
    for (int q = 0; q < 3; ++q) pos[q] = fmaf(dmin, k[q], pos[q]);
    const int nb = __ldg(&a.neighbor[c * 6 + face]);
    if (nb < 0) break;
    const int icn = amr_descend_from_face(a, nb, face, pos[0], pos[1], pos[2]);
    if (update) {
      const float u1 = g.moving ? leaf_vel_dot(g, il, k) : 0.0f;
      const int il2 = amr_leaf(a, icn);
      float a2, D2;
      leaf_a_D(g, il2, a2, D2);
      const float u2 = g.moving ? leaf_vel_dot(g, il2, k) : 0.0f;
      xf = (xf + u1) * D_c / D2 - u2;
    }
    ic = icn;
  }
  return tau;
}

// the clump CSR walk (_make_sightline_clump, :268-411)
template <bool kMulti>
__device__ float sl_walk_clump(const FlightParams& g, const SightParams& p, int mode,
                               float pos[3], const float k[3], float xf) {
  const ClumpGrid& c = g.clump;
  float tau = 0.0f;
  for (int n = 0; n < p.max_steps; ++n) {
    int cell;
    const float t_end = clump_cell_exit(c, pos, k, cell) + c.eps_peel;
    float add = 0.0f;
    for (int q = 0; q < c.K; ++q) {
      const int cand = clump_candidate(c, cell, q);
      if (cand < 0) continue;
      float t0, t1;
      if (!(clump_cand_chord(c, cand, pos, k, t_end, t0, t1) > 0.0f)) continue;
      const float rk = clump_gather(c.rhokap, cand);
      float kq;
      if (mode == SL_MODE_GAS) {
        const float u = clump_vel_dot(c, cand, k, CLUMP_U_DIV);
        kq = rk * line_profile<kMulti>(g.line, (xf - u) * c.r_loc, c.a_cl, c.D_cl);
      } else if (mode == SL_MODE_NGAS) {
        kq = rk * p.ngas_fac;
      } else {
        kq = c.rhokapD ? clump_gather(c.rhokapD, cand) : 0.0f;
      }
      add = fmaf(kq, t1 - t0, add);
    }
    tau = tau + add;
#pragma unroll
    for (int a = 0; a < 3; ++a) pos[a] = fmaf(t_end, k[a], pos[a]);
    if (fabsf(pos[0]) >= c.R || fabsf(pos[1]) >= c.R || fabsf(pos[2]) >= c.R) break;
  }
  return tau;
}

template <bool kMulti, int kGrid>
__global__ void sightline_kernel(FlightParams g, SightParams p) {
  const int ncol = p.nxfreq + 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)p.nobs * ncol * p.npix) return;
  const int pix = (int)(t % p.npix);
  const int col = (int)((t / p.npix) % ncol);
  const int o = (int)(t / ((long long)p.npix * ncol));
  float pos[3], k[3], cap;
  if (!sl_ray(p, o, pix, pos, k, cap)) {
    p.out[t] = 0.0f;
    return;
  }
  const int mode = col == 0 ? SL_MODE_NGAS : (col == 1 ? SL_MODE_DUST : SL_MODE_GAS);
  const float xf = mode == SL_MODE_GAS ? p.xf_axis[col - 2] : 0.0f;
  float tau;
  if (kGrid == SL_AMR)
    tau = sl_walk_amr<kMulti>(g, p, mode, pos, k, xf);
  else if (kGrid == SL_CLUMP)
    tau = sl_walk_clump<kMulti>(g, p, mode, pos, k, xf);
  else
    tau = sl_walk_cart<kMulti>(g, p, mode, pos, k, xf, cap);
  p.out[t] = tau;
}

template <bool kMulti>
static void launch(const FlightParams* g, const SightParams* p, unsigned blocks, int threads,
                   cudaStream_t st) {
  if (p->grid == SL_AMR)
    sightline_kernel<kMulti, SL_AMR><<<blocks, threads, 0, st>>>(*g, *p);
  else if (p->grid == SL_CLUMP)
    sightline_kernel<kMulti, SL_CLUMP><<<blocks, threads, 0, st>>>(*g, *p);
  else
    sightline_kernel<kMulti, SL_CART><<<blocks, threads, 0, st>>>(*g, *p);
}

LART_API int lart_sightline(const FlightParams* g, const SightParams* p, void* stream) {
  const long long n = (long long)p->nobs * (p->nxfreq + 2) * p->npix;
  if (n > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    if (g->line.line_type != 1)
      launch<true>(g, p, blocks, threads, (cudaStream_t)stream);
    else
      launch<false>(g, p, blocks, threads, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

LART_API int lart_sightline_params_size() { return (int)sizeof(SightParams); }
