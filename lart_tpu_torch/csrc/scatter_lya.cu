// K4 scatter_lya: resonant scattering of line types 1, 2, 4, 5, 6, 7 and 8,
// dust events (absorption, Henyey-Greenstein or Mueller-matrix scattering)
// and H2 pumping events, with or without recoil, core-skip, Stokes and the
// peel record.
//
// Replaces lart_tpu/transport/engine.py:1838 make_scatter / :2087 scatter
// (redistribute, :1931-2086, through line.cuh; the recoil of :2224-2229;
// the dust branch, :2111-2142, :2270-2381; the H2 branch, :2383-2435; the
// Ly-beta conversion, :2510-2528).  The TPU runs
// scatter_rounds masked rejection rounds of the u_par sampler over the whole
// batch; here each thread runs the rounds for its own lane and stops at the
// first acceptance (the later rounds' uniforms would be ignored anyway).  A
// lane still rejected after the rounds stays AT_SCATTER and retries next
// cycle, as on the TPU (`done`, :2438).  A warp runs as many rounds as its
// slowest lane (3.51 a warp against 1.27 a lane on the flagship) and both
// branches of a round, the line core's and the wings', where its lanes
// mix; so in the line-type-1 instances, dusty ones too, a block takes its
// lanes core first (core_first_lane), and every lane loads its direction
// and weight and draws its angle and optical-depth blocks before the
// rounds, whose latency then covers theirs (PERF.md §6, K4).  The metal
// lines keep their lanes in order.  Uniforms come from Philox keyed by
// (seed, STREAM_SCATTER) at counter (lane, cycle, block): block r < rounds
// feeds round r, block `rounds` the angles and the perpendicular velocity,
// block rounds+1 the next optical depth.  nscatt_gas (sum of weights) and
// nscatt_events are summed in the block and added with one atomic each.
// Core-skip (local_xcrit, engine.py:1872-1905, and :2197-2202) draws
// nothing: a lane with |x| < xcrit takes uxy = sqrt(xcrit^2 - log xi).  The
// global xcrit is a constant; the local one is cbrt(a rk dl) / 5 where
// a rk dl > 1, from the distance dl of the lane to its cell's nearest face
// and the cell's rhokap (one gather), or the constant rk_const > 0 on the
// uniform-sphere fast path.
// With use_stokes the azimuth is drawn by rejection over `rounds` more rounds
// (blocks rounds + 2 + r, after every block a lane without Stokes draws); a
// lane that fails them stays AT_SCATTER like one that fails the u_par rounds.
// The direction then turns with the reference triad and the Stokes vector
// (stokes_turn).  With peel-off on, the record's flag is written on every
// lane (EVENT_RESONANCE where this call scattered resonantly, EVENT_DUST at
// a dust scattering, else 0), and a scattered lane's pre-scatter direction,
// with Stokes also its triad and Stokes vector, and at a resonance
// xfreq_atom and the atom velocity (engine.py:2207-2218), which K7 reads
// next.
// With dust, block D = 2 rounds + 2 (after every block a lane without dust
// draws) splits the event: dust with probability kap_D / (kap_HI + kap_D),
// kap_HI = rk H(x, a) (voigt.cuh inlined) and kap_D the cell's rhokapD (the
// constants on the sphere fast path).  A dust lane skips the resonance
// rounds; it is absorbed where the block's second uniform exceeds the albedo
// (never under use_reduced_wgt), else scatters: Henyey-Greenstein from the
// block's third uniform with the resonance azimuth of block `rounds`, or the
// Mueller table (mueller.cuh: cos(theta) from block D + 1, the azimuth by
// rejection from blocks D + 2 + r; a lane that fails stays AT_SCATTER).  An
// absorption (every dust event under use_reduced_wgt, with the weight times
// 1 - albedo) adds to Jabs at the lab frequency of the lane's cell by one f32
// atomic; nscatt_dust sums the weight of every dust event in the block.
// The line (line.cuh): a redistribution picks the upper level and the
// downward branch from Philox block 3 rounds + 4 (after every block a lane
// of line type 1 draws, so a Ly-alpha run draws as before), runs the u_par
// rounds at that level's frequency and damping, and returns the phase
// weights E1, E2, E3 of the branch (per lane for types 2, 4, 5, 6, which
// the peel record then carries), xfreq_atom with the fluorescent shift,
// the scale of the perpendicular velocity (1 / r_D at a deuterium event)
// and the recoil constant; with recoil, xfreq_new -= (g0 / D)(1 - cos).
// The dust split's kap_HI is rk times the line's profile.  The kernel has
// two instances (line.cuh kMulti): line type 1, and the others.
// Bound: arithmetic (tan/atan2/log/exp per round, pow/cos/sin after), with
// the state read and written once (about 60 bytes a scattering lane, 100
// with Stokes, plus 28 of record, 64 with Stokes); a dust event adds its
// cell's two opacities, a few table reads and one f32 Jabs atomic an
// absorption, in every instance: on DL20e_dust.in's steady state the
// absorptions do not crowd, and the aggregated path of the maps
// (deposit_aggregated) made K4 slower there (PERF.md §6, K4).
// H2 pumping (the instances with kH2; h2.cuh): the event split draws block
// H = 3 rounds + 5 (after every block an earlier slice draws, so a run
// without H2 draws as before): an H2 event with probability kap_H2 /
// (kap_HI + kap_H2 + kap_D), kap_H2 = rk h2_kappa, then the dust split on
// the rest.  An H2 event picks its line by h2_line_weight, is destroyed with
// probability 1 - p_scat (the lane dies, W_H2abs), else draws u_par on the
// H2 line from blocks H + 2 + r (x_h2 = (x - dnu / D) ratio, the line's
// damping), an isotropic direction from blocks H and H + 1, and the
// frequency x_h2' / ratio + dnu / D (W_H2scat, nscatt_gas); W_H2pump sums
// each H2 event's weight by line.  It costs two Voigt functions at the
// split, two more at the line choice, and the u_par rounds.
// Line type 8 (the kMulti instance): a resonance converts to H-alpha where
// the redistribution's conversion draw says (line.cuh): no recoil, the band
// set to 2, the lab frequency (x_new - x_atom) + u.k of the new direction,
// W_conv; the record marks it EVENT_CONVERSION.  A lane of the H-alpha band
// meets dust only: each of its events is a dust event with albedo_Ha and
// hgg_Ha, its absorptions going to Jabs_Ha at its lab frequency; W_abs1 and
// W_abs2 sum each band's absorbed weight by block sums.
// On a clump medium (engine.py:2087-2105, :2533-2540; csrc/clump.cuh) a
// lane's cell is its clump.  In overlap mode the owner is drawn first among
// the clumps that contain the point, by opacity at each clump's local
// frequency (clump_owner: all clumps, or the CSR cell's candidates), from
// the first uniform of block 4 rounds + 7 (after every block an earlier
// slice draws, so the other grids draw as before).  Then, in a moving
// medium or at a clump temperature other than the reference one, the lane's
// frequency in memory becomes (x - u) r_loc in the owner's frame and
// Doppler units for the whole event (the dust split on the clump's rhokap
// and rhokapD, the profile, redistribution and recoil at a_cl and D_cl, Jabs
// at (x_loc + u) D_cl / Dfreq_ref), and at the end x' / r_loc + u' with u'
// along the new direction, on every lane that was AT_SCATTER.  A dust event's
// record keeps that local frequency in xatom for K7.  The owner draw costs
// two passes over the clumps (or candidates) that contain the point.
// With calcP (jpa.Pa non-null) each resonance scattering, a conversion too,
// in a cell with rhokap_phys = rhokap D / cross0 > 0 adds wgt / rhokap_phys
// to Pa at the cell's bin (lart.cuh jpa_bin; engine.py:2541-2547), the f32
// quotient summed in f64; rhokap is then the grid's, also on the sphere
// fast path.  The scatterings crowd into a few bins (on t1tau6.in 2.0
// distinct bins a warp, 6.4 a block, 99% in five), where one atomic each
// serialized (0.227 ms against 0.015 without the map): the deposit waits
// for the end of the kernel and goes through the warp level and the
// block's copy of Pa (lart.cuh deposit_aggregated).  A run with calcP runs
// the kMaps instances, which do so; the others keep no deposit code.
// With save_all_photons (the kAllph instances, the table's pointer non-null;
// csrc/allph.cuh) each resonance scattering adds one to the lane's nsg and
// each dust scattering one to its nsd (events, not weight; engine.py:
// 2478-2479), and a lane absorbed by dust or destroyed by H2 writes its
// death row from its state before the event, at the lab frequency (x + u)
// D / D_ref of its cell (engine.py:2455-2464); a run without the table runs
// the instances without it.
#include "lart.cuh"
#include "mueller.cuh"
#include "philox.cuh"
#include "samplers.cuh"
#include "line.cuh"
#include "voigt.cuh"

enum { CORE_SKIP_OFF = 0, CORE_SKIP_LOCAL = 1, CORE_SKIP_GLOBAL = 2 };
enum { DUST_OFF = 0, DUST_HG = 1, DUST_MUELLER = 2 };
enum { EVENT_RESONANCE = 1, EVENT_DUST = 2, EVENT_CONVERSION = 4 };

// The scatter's constants, grid and tallies; the host passes it by pointer
// and the kernel by value.  lart_tpu_torch/transport/scatter.py ScatterC
// mirrors this layout field for field; lart_scatter_params_size() lets it
// check the size.
struct ScatterParams {
  const float* rhokap;   // flat (nx, ny, nz): local core-skip and dust, off
  const float* rhokapD;  //   the sphere fast path; rhokapD with dust only
  const float* vfx;      // velocities for Jabs in a moving medium, else null
  const float* vfy;
  const float* vfz;
  float* nscatt_gas;
  float* nscatt_events;
  float* Jabs;
  float* nscatt_dust;
  MuellerTable mueller;  // DUST_MUELLER
  int rounds, stokes, core_skip, dust, reduced_wgt, nxfreq;
  int n[3];
  float a;
  float xcrit, xcrit2;   // CORE_SKIP_GLOBAL
  float rk_const;        // > 0: the uniform sphere's rhokap, else gather
  float rkD_const;       //   and its rhokapD
  float albedo, one_m_albedo, hgg;
  float xfreq_min, dxfreq;
  float amin[3], d[3];
  float Dfreq;           // Doppler width of every cell (uniform temperature)
  int recoil;
  LineC line;
  H2C h2;                // H2 pumping (the kH2 instances)
  float* Jabs_Ha;        // line type 8: the H-alpha band's absorbed
  float* W_conv;         //   spectrum, the conversions' weight and each
  float* W_abs1;         //   band's absorbed weight
  float* W_abs2;
  float* W_H2abs;        // H2: destroyed, scattered and pumped (2) weight
  float* W_H2scat;
  float* W_H2pump;
  float albedo_Ha, one_m_albedo_Ha, hgg_Ha;
  AmrGrid amr;           // the octree: rhokap, rhokapD and the velocities are
                         //   then per leaf; ncells 0 on a Cartesian grid
  ClumpGrid clump;       // the clumps: rhokap, rhokapD and the velocities are
                         //   then per clump; n 0 on the other grids
  const float* cell_a;   // a Cartesian grid at non-uniform temperature: each
  const float* cell_D;   //   cell's damping and Doppler width (flat); null else
  JpaBins jpa;           // the Pa deposit (jpa.Pa null: none), rhokap the
                         //   grid's then, also on the sphere fast path
  AllPh allph;           // the all-photons table (the kAllph instances)
};

// the index of lane i's cell into the grid arrays: the flat cell, or on the
// AMR grid its node's leaf (-1 in a gap, where cell_gather() gives 0)
__device__ inline int scatter_cell(const ScatterParams& p, const Lanes& s, int i) {
  if (p.clump.n) return s.ic[i];
  if (p.amr.ncells) return amr_leaf(p.amr, s.ic[i]);
  const int f = (s.ic[i] * p.n[1] + s.jc[i]) * p.n[2] + s.kc[i];
  return min(max(f, 0), p.n[0] * p.n[1] * p.n[2] - 1);
}

__device__ inline float cell_gather(const float* a, int f) { return f >= 0 ? a[f] : 0.0f; }

// the in-core boost xcrit^2 of lane i, or 0 outside the core; a_c its cell's
// damping parameter
__device__ inline float core_boost(const ScatterParams& c, const Lanes& s, int i,
                                   float xfreq, float a_c) {
  if (c.core_skip == CORE_SKIP_OFF) return 0.0f;
  float xc = c.xcrit, xc2 = c.xcrit2;
  if (c.core_skip == CORE_SKIP_LOCAL) {
    const float pos[3] = {s.x[i], s.y[i], s.z[i]};
    float dl = 0.0f;
    if (c.amr.ncells) {
      // the distance to the node's nearest face (engine.py:1880-1887)
      const int n = amr_clip_cell(c.amr, s.ic[i]);
      const float h = c.amr.node_ch[n];
      dl = h - fmaxf(fmaxf(fabsf(pos[0] - c.amr.node_cx[n]), fabsf(pos[1] - c.amr.node_cy[n])),
                     fabsf(pos[2] - c.amr.node_cz[n]));
    } else {
      const int cell[3] = {s.ic[i], s.jc[i], s.kc[i]};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float f = c.amin[k] + (float)cell[k] * c.d[k];
        const float dla = fminf(pos[k] - f, f + c.d[k] - pos[k]);
        dl = k == 0 ? dla : fminf(dl, dla);
      }
    }
    const float rk = c.rk_const > 0.0f ? c.rk_const : cell_gather(c.rhokap, scatter_cell(c, s, i));
    const float atau = a_c * rk * fmaxf(dl, 0.0f);
    xc = atau > 1.0f ? cbrtf(atau) / 5.0f : 0.0f;
    xc2 = xc * xc;
  }
  return fabsf(xfreq) < xc ? xc2 : 0.0f;
}

// The triad and Stokes update of a Stokes scattering (engine.py:2231-2265):
// the triad turned by phi about k and by theta in the (k, m) plane,
// re-orthonormalized (k normalized, m := m - (m.k) k normalized, n = k x m)
// in lart_tpu's order, and the Stokes vector through the line's matrix.
__device__ inline void stokes_turn(const Lanes& s, int i, float cost, float sint,
                                   float cosp, float sinp, float S11, float S12,
                                   float S22, float S33, float S44) {
  const float kx0 = s.kx[i], ky0 = s.ky[i], kz0 = s.kz[i];
  const float mx0 = s.mx[i], my0 = s.my[i], mz0 = s.mz[i];
  const float nx0 = s.nnx[i], ny0 = s.nny[i], nz0 = s.nnz[i];
  const float px = cosp * mx0 + sinp * nx0;
  const float py = cosp * my0 + sinp * ny0;
  const float pz = cosp * mz0 + sinp * nz0;
  float mx = cost * px - sint * kx0;
  float my = cost * py - sint * ky0;
  float mz = cost * pz - sint * kz0;
  float kx = sint * px + cost * kx0;
  float ky = sint * py + cost * ky0;
  float kz = sint * pz + cost * kz0;
  const float knorm = rsqrtf(kx * kx + ky * ky + kz * kz);
  kx = kx * knorm;
  ky = ky * knorm;
  kz = kz * knorm;
  const float mk = mx * kx + my * ky + mz * kz;
  mx = mx - mk * kx;
  my = my - mk * ky;
  mz = mz - mk * kz;
  const float mnorm = rsqrtf(fmaxf(mx * mx + my * my + mz * mz, LART_TINY));
  mx = mx * mnorm;
  my = my * mnorm;
  mz = mz * mnorm;
  const float Q = s.Q[i], U = s.U[i], V = s.V[i];
  const float cos2p = 2.0f * cosp * cosp - 1.0f;
  const float sin2p = 2.0f * sinp * cosp;
  const float Q0 = cos2p * Q + sin2p * U;
  const float U0 = -sin2p * Q + cos2p * U;
  const float I1 = fmaxf(S11 + S12 * Q0, LART_TINY);
  s.kx[i] = kx;
  s.ky[i] = ky;
  s.kz[i] = kz;
  s.mx[i] = mx;
  s.my[i] = my;
  s.mz[i] = mz;
  s.nnx[i] = ky * mz - kz * my;
  s.nny[i] = kz * mx - kx * mz;
  s.nnz[i] = kx * my - ky * mx;
  s.Q[i] = (S12 + S22 * Q0) / I1;
  s.U[i] = (S33 * U0) / I1;
  s.V[i] = (S44 * V) / I1;
}

// the event as the peel reads it: before the turn; the triad and the Stokes
// vector only where the peel reads them, with Stokes
__device__ inline void write_record_dir(const PeelRecord& r, const Lanes& s, int i,
                                        int stokes) {
  r.kx[i] = s.kx[i];
  r.ky[i] = s.ky[i];
  r.kz[i] = s.kz[i];
  if (stokes) {
    r.mx[i] = s.mx[i];
    r.my[i] = s.my[i];
    r.mz[i] = s.mz[i];
    r.nnx[i] = s.nnx[i];
    r.nny[i] = s.nny[i];
    r.nnz[i] = s.nnz[i];
    r.Q[i] = s.Q[i];
    r.U[i] = s.U[i];
    r.V[i] = s.V[i];
  }
}

// azimuth by rejection from 1 + S12o (Q cos 2phi + U sin 2phi), round r from
// block block0 + r; returns whether a round accepted (engine.py:2165-2190)
__device__ inline bool azimuth_rounds(const Lanes& s, int i, uint32_t seed, uint32_t counter,
                                      int block0, int rounds, float S12o, float& phi) {
  const float Q = s.Q[i], U = s.U[i];
  const float pmag = sqrtf(Q * Q + U * U);
  for (int r = 0; r < rounds; ++r) {
    float v[4];
    uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(block0 + r), v);
    const float phi_p = LART_TWOPI * v[0];
    const float prand = (1.0f + fabsf(S12o) * pmag) * v[1];
    const float pcomp = 1.0f + S12o * (Q * cosf(2.0f * phi_p) + U * sinf(2.0f * phi_p));
    if (prand <= pcomp) {
      phi = phi_p;
      return true;
    }
  }
  return false;
}

// The triad and Stokes update of a Mueller dust scattering (engine.py:
// 2309-2328): turned by phi about k and by theta in the (k, m) plane, not
// re-orthonormalized, and the Stokes vector through S11, S12, S33, S34.
__device__ inline void mueller_turn(const Lanes& s, int i, float cost, float sint,
                                    float cosp, float sinp, const float S[4]) {
  float* kk[3] = {s.kx, s.ky, s.kz};
  float* mm[3] = {s.mx, s.my, s.mz};
  float* nn[3] = {s.nnx, s.nny, s.nnz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float k = kk[a][i], m = mm[a][i], n = nn[a][i];
    const float p = cosp * m + sinp * n;
    nn[a][i] = cosp * n - sinp * m;
    mm[a][i] = cost * p - sint * k;
    kk[a][i] = sint * p + cost * k;
  }
  const float Q = s.Q[i], U = s.U[i], V = s.V[i];
  const float c2p = 2.0f * cosp * cosp - 1.0f;
  const float s2p = 2.0f * sinp * cosp;
  const float Q0 = c2p * Q + s2p * U;
  const float U0 = -s2p * Q + c2p * U;
  const float I1 = fmaxf(S[0] + S[1] * Q0, LART_TINY);
  s.Q[i] = (S[1] + S[0] * Q0) / I1;
  s.U[i] = (S[2] * U0 + S[3] * V) / I1;
  s.V[i] = (-S[3] * U0 + S[2] * V) / I1;
}

// u . k of lane i's cell along its direction (moving medium; a clump's in
// reference units, cell_velocity_dot)
__device__ inline float lane_vel_dot(const ScatterParams& p, const Lanes& s, int i) {
  if (p.clump.n) {
    const float k[3] = {s.kx[i], s.ky[i], s.kz[i]};
    return clump_vel_dot(p.clump, s.ic[i], k, CLUMP_U_SCALE);
  }
  const int f = scatter_cell(p, s, i);
  return cell_gather(p.vfx, f) * s.kx[i] + cell_gather(p.vfy, f) * s.ky[i] +
         cell_gather(p.vfz, f) * s.kz[i];
}

// A dust event of lane i (engine.py:2270-2381): absorption or scattering,
// the Jabs deposit; returns EVENT_DUST where the lane scattered, else 0.
// d is block D's uniforms, cosp/sinp the resonance azimuth (HG's); b2 marks
// a lane of the H-alpha band (line type 8: its albedo and g, Jabs_Ha at its
// lab frequency); wabs receives the absorbed weight.
__device__ int dust_event(const ScatterParams& p, const Lanes& s, const PeelRecord& rec,
                          int i, uint32_t seed, uint32_t counter, const float d[4],
                          float cosp, float sinp, float tau_u, bool b2, float ratio,
                          float& wabs) {
  const float wgt = s.wgt[i];
  const float albedo = b2 ? p.albedo_Ha : p.albedo;
  const bool absorbed = !p.reduced_wgt && d[1] > albedo;
  if (absorbed || p.reduced_wgt) {
    // Jabs at the lab frequency of the lane's cell
    float xlab = s.xfreq[i];
    if (p.vfx && !b2) xlab = xlab + lane_vel_dot(p, s, i);
    // at the cell's Doppler width: D / Dfreq_ref, 1 at uniform temperature
    if (!b2) xlab = xlab * ratio;
    const float wab = p.reduced_wgt ? wgt * (b2 ? p.one_m_albedo_Ha : p.one_m_albedo) : wgt;
    wabs = wab;
    const float fx = floorf((xlab - p.xfreq_min) / p.dxfreq);
    if (fx >= 0.0f && fx < (float)p.nxfreq) atomicAdd(&(b2 ? p.Jabs_Ha : p.Jabs)[(int)fx], wab);
  }
  if (absorbed) {
    // dead, with the next optical depth drawn as for any event (engine.py:
    // 2475-2476), so the lane's fields match lart_tpu's
    s.phase[i] = DEAD;
    s.tau_target[i] = -logf(fmaxf(tau_u, 1e-12f));
    s.tau_run[i] = 0.0f;
    return 0;
  }
  float cost, phi = 0.0f, S[4];
  const int D = 2 * p.rounds + 2;
  if (p.dust == DUST_MUELLER) {
    float m[4];
    uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(D + 1), m);
    cost = mueller_sample_cost(p.mueller, m[0], m[1], m[2]);
    mueller_interp_S(p.mueller, cost, S);
    if (!azimuth_rounds(s, i, seed, counter, D + 2, p.rounds, S[1] / fmaxf(S[0], LART_TINY),
                        phi))
      return 0;  // stays AT_SCATTER
  } else {
    cost = rand_henyey_greenstein(d[2], b2 ? p.hgg_Ha : p.hgg);
  }
  const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
  if (rec.flag) {
    write_record_dir(rec, s, i, p.stokes);
    // the peel's frequency in the owner's units (the lane's is shifted back)
    if (p.clump.n) rec.xatom[i] = s.xfreq[i];
  }
  if (p.dust == DUST_MUELLER) {
    mueller_turn(s, i, cost, sint, cosf(phi), sinf(phi), S);
  } else {
    float kx = s.kx[i], ky = s.ky[i], kz = s.kz[i];
    rotate_direction(kx, ky, kz, cost, sint, cosp, sinp);
    s.kx[i] = kx;
    s.ky[i] = ky;
    s.kz[i] = kz;
  }
  s.phase[i] = FLYING;
  if (p.reduced_wgt) s.wgt[i] = wgt * albedo;
  s.tau_target[i] = -logf(fmaxf(tau_u, 1e-12f));
  s.tau_run[i] = 0.0f;
  return EVENT_DUST;
}

// What an H2 event adds to the tallies.
struct H2Tally {
  float abs, scat, pump0, pump1;
};

// An H2 event of lane i (engine.py:2383-2435): hu is block H's uniforms
// (the split, the line, the destruction, the cosine); returns the weight
// scattered back to Ly-alpha (0 if destroyed or if the u_par rounds fail,
// where the lane stays AT_SCATTER).
__device__ float h2_event(const ScatterParams& p, const Lanes& s, int i, uint32_t seed,
                          uint32_t counter, const float hu[4], float D, H2Tally& t) {
  const int H = 3 * p.rounds + 5;
  const float xfreq = s.xfreq[i], wgt = s.wgt[i];
  const float w0 = h2_line_weight(p.h2, 0, xfreq, D), w1 = h2_line_weight(p.h2, 1, xfreq, D);
  const int il = hu[1] * fmaxf(w0 + w1, LART_TINY) > w0 ? 1 : 0;
  if (il) {
    t.pump1 = wgt;
  } else {
    t.pump0 = wgt;
  }
  float v[4];
  if (hu[2] > p.h2.p_scat[il]) {
    // fluorescent destruction; the next optical depth drawn as for any event
    t.abs = wgt;
    uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(p.rounds + 1), v);
    s.phase[i] = DEAD;
    s.tau_target[i] = -logf(fmaxf(v[0], 1e-12f));
    s.tau_run[i] = 0.0f;
    return 0.0f;
  }
  // u_par on the H2 line, in its Doppler units
  const float ratio = h2_ratio(p.h2, D);
  const float dx_l = p.h2.dnu[il] / D;
  const float x_h2 = (xfreq - dx_l) * ratio;
  const VzEnv env = vz_envelope(x_h2, p.h2.a_damp[il]);
  float uz = 0.0f;
  bool acc = false;
  for (int k = 0; k < p.rounds && !acc; ++k) {
    uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(H + 2 + k), v);
    acc = vz_round(v, env, &uz);
  }
  if (!acc) return 0.0f;
  // an isotropic direction and the atom's perpendicular velocity
  float hv[4];
  uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(H + 1), hv);
  const float cost = 2.0f * hu[3] - 1.0f;
  const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
  const float phi = LART_TWOPI * hv[0], phi2 = LART_TWOPI * hv[1];
  const float uxy = sqrtf(-logf(hv[2]));
  const float ux = uxy * cosf(phi2), uy = uxy * sinf(phi2);
  const float cosp = cosf(phi), sinp = sinf(phi);
  const float x_new = (x_h2 - uz) + uz * cost + (ux * cosp + uy * sinp) * sint;
  float kx = s.kx[i], ky = s.ky[i], kz = s.kz[i];
  rotate_direction(kx, ky, kz, cost, sint, cosp, sinp);
  s.kx[i] = kx;
  s.ky[i] = ky;
  s.kz[i] = kz;
  uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(p.rounds + 1), v);
  s.phase[i] = FLYING;
  s.xfreq[i] = x_new / ratio + dx_l;
  s.tau_target[i] = -logf(fmaxf(v[0], 1e-12f));
  s.tau_run[i] = 0.0f;
  t.scat = wgt;
  return wgt;
}

#define K4_THREADS 256

// The lane a thread of the block takes when the block's lanes are put in
// order, the AT_SCATTER lanes in the line core (|x| <= 1) first and the
// rest after (each kept in its order): a warp then runs mostly one branch
// of vz_round, the core's or the wings', where nearly every warp of lanes
// in their own order ran both.  The math stays keyed by the lane.  Every
// thread of the block calls it.
__device__ inline int core_first_lane(const Lanes& s, int B) {
  __shared__ int perm[K4_THREADS], wcore[K4_THREADS / 32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool core = i < B && s.phase[i] == AT_SCATTER && fabsf(s.xfreq[i]) <= 1.0f;
  const unsigned cb = __ballot_sync(0xffffffffu, core);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wcore[warp] = __popc(cb);
  __syncthreads();
  int before = 0, ncore = 0;  // core lanes in the warps before, in all
  for (int w = 0; w < K4_THREADS / 32; ++w) {
    if (w < warp) before += wcore[w];
    ncore += wcore[w];
  }
  const unsigned lt = (1u << lane) - 1u;
  perm[core ? before + __popc(cb & lt) : ncore + (warp * 32 - before) + __popc(~cb & lt)] = i;
  __syncthreads();
  return perm[threadIdx.x];
}

// The kMaps instances run with the Pa map (calcP) and add Pa through the
// aggregated path; the instances without it keep no deposit code (in a run
// without the maps the path's code cost K4 2-4%, PERF.md §6, K4).
// pa_slots: the block copy of Pa (f64), 0 where the wrapper's plan gives it
// none.  The line-type-1 instances are held to
// 64 registers, 4 blocks an SM: the whole batch of 131072 lanes in one wave
// of 528 resident blocks.
template <bool kMulti, bool kH2, bool kAllph, bool kMaps>
__global__ void __launch_bounds__(K4_THREADS, kMulti ? 3 : 4)
    scatter_lya_kernel(Lanes s, PeelRecord rec, int B, uint32_t seed, uint32_t counter,
                       ScatterParams p, int pa_slots) {
  // Ly-alpha takes its lanes core first; the metal lines, whose levels
  // and branches split the rounds otherwise, in their own order
  const int i = kMulti ? blockIdx.x * blockDim.x + threadIdx.x : core_first_lane(s, B);
  if (kMaps) block_copy_zero(lart_block_copy, pa_slots);
  // this lane's Pa deposit, made at the end where the warp has converged
  int pa_key = -1;
  double pa_val = 0.0;
  float w_sum = 0.0f, n_sum = 0.0f, wd_sum = 0.0f;
  float conv_w = 0.0f, abs1 = 0.0f, abs2 = 0.0f;  // line type 8
  H2Tally h2t = {0.0f, 0.0f, 0.0f, 0.0f};
  int kind = 0;
  const int rounds = p.rounds;
  const bool lyb = kMulti && p.line.line_type == 8;
  const ClumpGrid& cl = p.clump;
  const bool at_sc = i < B && s.phase[i] == AT_SCATTER;
  // the direction and weight a resonance reads after its rounds, loaded
  // here so that their latency overlaps the rounds (the batch is one wave:
  // a load where it is used stalls every warp at once)
  float pkx = 0.0f, pky = 0.0f, pkz = 1.0f, pw = 0.0f;
  if (at_sc) {
    pkx = s.kx[i];
    pky = s.ky[i];
    pkz = s.kz[i];
    pw = s.wgt[i];
    if (cl.n) {
      // the owner (overlap mode), then the owner's frame and units
      const float k[3] = {s.kx[i], s.ky[i], s.kz[i]};
      if (cl.overlap) {
        float o[4];
        uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(4 * rounds + 7), o);
        const float pos[3] = {s.x[i], s.y[i], s.z[i]};
        s.ic[i] = clump_owner<kMulti>(cl, p.line, pos, k, s.xfreq[i], o[0]);
      }
      if (cl.shift)
        s.xfreq[i] = (s.xfreq[i] - clump_vel_dot(cl, s.ic[i], k, CLUMP_U_SCALE)) * cl.r_loc;
    }
    const float xfreq = s.xfreq[i];
    // the cell's damping and Doppler width: per leaf on an AMR grid and per
    // cell on a Cartesian one at non-uniform temperature (the reference
    // values in a gap), the clumps'
    float a_c = p.a, D_c = p.Dfreq;
    if (p.amr.voigt_a) {
      const int il = amr_leaf(p.amr, s.ic[i]);
      a_c = leaf_gather(p.amr.voigt_a, il, p.a);
      D_c = leaf_gather(p.amr.Dfreq, il, p.Dfreq);
    }
    if (cl.n) {
      a_c = cl.a_cl;
      D_c = cl.D_cl;
    }
    if (p.cell_D) {
      // a Cartesian cell's own (engine.py:2107-2108)
      const int f = scatter_cell(p, s, i);
      a_c = __ldg(&p.cell_a[f]);
      D_c = __ldg(&p.cell_D[f]);
    }
    const float ratio = D_c / p.Dfreq;
    // the H-alpha band (line type 8) meets dust only; without dust it
    // stays as it is
    const bool b2 = lyb && s.iband[i] == 2;
    bool is_dust = false, is_h2 = false;
    float d[4], hu[4];
    if (b2) {
      is_dust = p.dust != DUST_OFF;
      if (is_dust)
        uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(2 * rounds + 2), d);
    } else if (p.dust || kH2) {
      float rk = p.rk_const, kD = p.rkD_const;
      if (!(rk > 0.0f)) {
        const int f = scatter_cell(p, s, i);
        rk = cell_gather(p.rhokap, f);
        kD = p.dust ? cell_gather(p.rhokapD, f) : 0.0f;
      }
      const float kap_HI = rk * line_profile<kMulti>(p.line, xfreq, a_c, D_c);
      if (kH2) {
        // the H2 split: H2 with probability kap_H2 / (kap_HI + kap_H2 + kap_D)
        uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(3 * rounds + 5), hu);
        const float kap_H2 = rk * h2_kappa(p.h2, xfreq, D_c);
        float ktot = kap_HI + kap_H2;
        if (p.dust) ktot = ktot + kD;
        is_h2 = hu[0] * fmaxf(ktot, LART_TINY) <= kap_H2;
      }
      if (p.dust && !is_h2) {
        // the dust split: dust with probability kap_D / (kap_HI + kap_D)
        uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(2 * rounds + 2), d);
        is_dust = d[0] <= kD / fmaxf(kap_HI + kD, LART_TINY);
      }
    }
    float u[4];
    if (kH2 && is_h2) {
      w_sum = h2_event(p, s, i, seed, counter, hu, D_c, h2t);
    } else if (is_dust) {
      wd_sum = s.wgt[i];
      float t[4], wab = 0.0f;
      uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)rounds, u);
      uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(rounds + 1), t);
      const float phi = LART_TWOPI * u[1];
      kind = dust_event(p, s, rec, i, seed, counter, d, cosf(phi), sinf(phi), t[0], b2, ratio,
                        wab);
      if (b2) {
        abs2 = wab;
      } else {
        abs1 = wab;
      }
    } else if (!b2) {
      // the angles' and the next optical depth's Philox blocks, drawn
      // before the rounds so that their integer chains overlap round 0's
      float ua[4], ut[4];
      uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)rounds, ua);
      uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(rounds + 1), ut);
      const Redist r = redistribute<kMulti>(p.line, xfreq, a_c, D_c, seed, counter, i,
                                            rounds, 3 * rounds + 4);
      bool acc = r.acc;
      if (acc) {
        for (int k = 0; k < 4; ++k) u[k] = ua[k];
        const float cost = rand_resonance_cost(u[0], r.E1);
        const float cost2 = cost * cost;
        const float sint = sqrtf(fmaxf(1.0f - cost2, 0.0f));
        float phi = LART_TWOPI * u[1];
        float S11 = 0.0f, S12 = 0.0f, S22 = 0.0f, S33 = 0.0f, S44 = 0.0f;
        if (p.stokes) {
          // the line's scattering matrix (engine.py:2165-2190)
          S22 = 0.75f * r.E1 * (cost2 + 1.0f);
          S11 = S22 + r.E2;
          S12 = 0.75f * r.E1 * (cost2 - 1.0f);
          S33 = 1.5f * r.E1 * cost;
          S44 = 1.5f * r.E3 * cost;
          acc = azimuth_rounds(s, i, seed, counter, rounds + 2, rounds,
                               S12 / fmaxf(S11, LART_TINY), phi);
        }
        if (acc) {
          const float cosp = cosf(phi), sinp = sinf(phi);
          const float phi2 = LART_TWOPI * u[2];
          const float uxy = sqrtf(core_boost(p, s, i, xfreq, a_c) - logf(u[3]));
          const float ux = uxy * cosf(phi2) * r.perp, uy = uxy * sinf(phi2) * r.perp;
          const float uz = r.uz, xfreq_atom = r.xatom;
          float xfreq_new = xfreq_atom + uz * cost + (ux * cosp + uy * sinp) * sint;
          // no recoil at a conversion (engine.py:2224-2229)
          if (p.recoil && !r.conv) xfreq_new = xfreq_new - (r.g0 / D_c) * (1.0f - cost);
          if (rec.flag) {
            write_record_dir(rec, s, i, p.stokes);
            rec.xatom[i] = xfreq_atom;
            rec.ux[i] = ux;
            rec.uy[i] = uy;
            rec.uz[i] = uz;
            if (kMulti && p.line.per_lane_E) {
              rec.E1[i] = r.E1;
              rec.E2[i] = r.E2;
              rec.E3[i] = r.E3;
            }
          }
          if (p.stokes) {
            stokes_turn(s, i, cost, sint, cosp, sinp, S11, S12, S22, S33, S44);
          } else {
            float kx = pkx, ky = pky, kz = pkz;
            rotate_direction(kx, ky, kz, cost, sint, cosp, sinp);
            s.kx[i] = kx;
            s.ky[i] = ky;
            s.kz[i] = kz;
          }
          for (int k = 0; k < 4; ++k) u[k] = ut[k];
          s.phase[i] = FLYING;
          if (lyb && r.conv) {
            // 3p -> 2s: the H-alpha photon at the atom's line centre, its lab
            // frequency along the new direction (engine.py:2510-2528)
            const float u_new = p.vfx ? lane_vel_dot(p, s, i) : 0.0f;
            s.xfreq[i] = (xfreq_new - xfreq_atom + u_new) * ratio;
            s.iband[i] = 2;
            conv_w = pw;
          } else {
            s.xfreq[i] = xfreq_new;
          }
          s.tau_target[i] = -logf(fmaxf(u[0], 1e-12f));
          s.tau_run[i] = 0.0f;
          w_sum = pw;
          n_sum = 1.0f;
          if (kMaps) {
            // the scatterings per atom at the scattering cell (engine.py:
            // 2541-2547), rhokap_phys = rhokap D / cross0; a conversion
            // counts as one
            const float rkp = p.rhokap[scatter_cell(p, s, i)] * D_c / p.jpa.cross0;
            if (rkp > 0.0f) {
              pa_key = jpa_bin(p.jpa, s.ic[i], s.jc[i], s.kc[i]);
              pa_val = (double)(w_sum / fmaxf(rkp, LART_TINY));
            }
          }
          kind = r.conv ? EVENT_CONVERSION : EVENT_RESONANCE;
        }
      }
    }
    if (kAllph) {
      if (s.phase[i] == DEAD) {
        // absorbed or destroyed: the death row from the state before the
        // event (which moved nothing), at the lab frequency of its cell
        float xlab = s.xfreq[i];
        if (p.vfx) xlab = xlab + lane_vel_dot(p, s, i);
        const float pos[3] = {s.x[i], s.y[i], s.z[i]};
        const float k[3] = {s.kx[i], s.ky[i], s.kz[i]};
        allph_death(p.allph, s, i, pos, k, s.wgt[i], xlab * ratio);
      }
      // the scattering events (a conversion is a resonance event)
      if (n_sum != 0.0f) s.nsg[i] = s.nsg[i] + 1.0f;
      if (kind == EVENT_DUST) s.nsd[i] = s.nsd[i] + 1.0f;
    }
  }
  if (at_sc && cl.n && cl.shift) {
    // back into global units along the new direction (engine.py:2533-2540)
    const float k[3] = {s.kx[i], s.ky[i], s.kz[i]};
    s.xfreq[i] = s.xfreq[i] * cl.inv_r_loc + clump_vel_dot(cl, s.ic[i], k, CLUMP_U_SCALE);
  }
  if (rec.flag && i < B) rec.flag[i] = kind;
  if (kMaps) {
    // the Pa deposit (lart.cuh deposit_aggregated), once the block copy
    // zeroed at the top is seen zeroed by every thread
    if (pa_slots) __syncthreads();
    double* Pa = p.jpa.Pa;
    deposit_aggregated(pa_key, pa_val, [Pa](int b) { return &Pa[b]; }, lart_block_copy,
                       pa_slots);
  }
  block_sum_atomic(w_sum, p.nscatt_gas);
  block_sum_atomic(n_sum, p.nscatt_events);
  if (p.dust) block_sum_atomic(wd_sum, p.nscatt_dust);
  if (kH2) {
    block_sum_atomic(h2t.abs, p.W_H2abs);
    block_sum_atomic(h2t.scat, p.W_H2scat);
    block_sum_atomic(h2t.pump0, p.W_H2pump);
    block_sum_atomic(h2t.pump1, p.W_H2pump + 1);
  }
  if (lyb) {
    block_sum_atomic(conv_w, p.W_conv);
    if (p.dust) {
      block_sum_atomic(abs1, p.W_abs1);
      block_sum_atomic(abs2, p.W_abs2);
    }
  }
}

// record: the PeelRecord pointer table, or null with peel-off off;
// pa_slots: the slots of the block copy of Pa (transport/scatter.py
// deposit_plan), 8 bytes each of dynamic shared memory a block
LART_API int lart_scatter_lya(void* const* lanes, void* const* record, int B, unsigned seed,
                              unsigned counter, const ScatterParams* p, int pa_slots,
                              void* stream) {
  if (B > 0) {
    const int threads = K4_THREADS;
    const int blocks = (B + threads - 1) / threads;
    const size_t smem = 8 * (size_t)pa_slots;
    const Lanes s = unpack_lanes(lanes);
    const PeelRecord r = unpack_record(record);
    cudaStream_t st = (cudaStream_t)stream;
    const bool multi = p->line.line_type != 1, h2 = p->h2.n_lines > 0;
    const bool allph = p->allph.rp != nullptr, maps = p->jpa.Pa != nullptr;
    // one instance a combination: the line type (kMulti), H2 (kH2), the
    // all-photons table (kAllph), the Pa map (kMaps)
    switch ((multi ? 8 : 0) + (h2 ? 4 : 0) + (allph ? 2 : 0) + (maps ? 1 : 0)) {
#define LART_SCATTER(M, H, A, P)                                                       \
  case (M ? 8 : 0) + (H ? 4 : 0) + (A ? 2 : 0) + (P ? 1 : 0):                           \
    scatter_lya_kernel<M, H, A, P>                                                     \
        <<<blocks, threads, smem, st>>>(s, r, B, seed, counter, *p, pa_slots);             \
    break;
#define LART_SCATTER_2(M, H, A) \
  LART_SCATTER(M, H, A, false)  \
  LART_SCATTER(M, H, A, true)
      LART_SCATTER_2(false, false, false)
      LART_SCATTER_2(false, false, true)
      LART_SCATTER_2(false, true, false)
      LART_SCATTER_2(false, true, true)
      LART_SCATTER_2(true, false, false)
      LART_SCATTER_2(true, false, true)
      LART_SCATTER_2(true, true, false)
      LART_SCATTER_2(true, true, true)
#undef LART_SCATTER_2
#undef LART_SCATTER
    }
  }
  return (int)cudaGetLastError();
}

LART_API int lart_scatter_params_size() { return (int)sizeof(ScatterParams); }
