// K7 peel: peeling-off to external observers at a photon's birth (direct) and
// at each resonance or dust scattering, with and without Stokes, on a
// Cartesian grid (the DDA sightline), on the uniform-sphere fast path (one
// chord) or on the octree AMR grid (the node walk of K8, csrc/amr.cuh; the
// event cell's leaf velocity and, at non-uniform temperature, its Doppler
// width in freq_bin and the recoil).
//
// Replaces lart_tpu/instruments/peel.py:62 make_peel: peel_direct (:446),
// peel_resonance (:476), peel_dust (:577), peel_conversion_Ha (:656) and
// their sightline optical depth
// tau_to_edge_cart (:176-356; a cell's opacity rhokap times the line's
// profile, line.cuh, + rhokapD) or the sphere chord (:367-382; its profile's
// offsets and damping parameters from the host, f64 quotients rounded once
// as lart_tpu's Python floats give them), with obs_geometry (TAN and HEALPix),
// flat_idx and freq_bin (:394-441).  A resonance peels with the event's
// phase weights (from the record for line types 2, 4, 5 and 6) and, with
// recoil, at xfreq - (g_recoil0 / D)(1 - cos theta) (:513-514), the hydrogen
// constant for a deuterium event of line type 7 too, as lart_tpu's peel
// takes it.  With H2 pumping the walk's opacity adds rhokap times the H2
// multiplier (h2.cuh, :229-231).  Line type 8: K4 marks a scattering that
// converts to H-alpha EVENT_CONVERSION, and its pair peels the newborn
// photon (peel_conversion_Ha): the atom velocity's projection as its
// frequency, no recoil, the conversion channel's dipole phase, the
// H-alpha band's dust-only sightline (rhokapD R_Ha, :234-241; nothing to
// walk without dust), into the Ha cube; a dust event of a lane in the
// H-alpha band peels along that sightline at its lab frequency with
// hgg_Ha into Ha.  Four kernel instances: line type 1 or the others
// (line.cuh kMulti), each with H2 or without (kH2).  The TPU walks all
// (observer, lane)
// pairs in one lockstep while_loop over the whole batch until the last pair
// leaves the grid; here one thread walks one (observer, lane) pair, thread
// t = o * B + lane, and stops on its own.  The lanes to peel are those the
// PeelRecord flags: K2 flags the lanes it launched (mode DIRECT reads their
// newborn state), K4 marks each lane's event with its kind, EVENT_RESONANCE
// or EVENT_DUST (a scatter mode, a mask of the kinds it peels, reads the
// record's pre-scatter direction, triad and Stokes vector, at a resonance
// xfreq_atom and the atom velocity, and the lane's unchanged position, cell
// and frequency and its weight).  The chunk loop peels both kinds in one
// launch (mode SCATTERED): dust events are a small share of a cycle's
// scatterings, too few to fill a launch of their own, and each pair takes
// its lane's branch.  A dust pair peels at the lane's comoving frequency
// with the Henyey-Greenstein phase, or with Stokes through the Mueller table
// (mueller.cuh) and the detector-frame rotation.  A pair
// whose pixel is outside the image or whose lab-frequency bin is outside the
// grid walks nothing.  The walk follows the flight's boundary ops and, in a
// moving medium or at non-uniform temperature, its comoving frequency update
// ((x + u1) D1) / D2 - u2 (walk.cuh, shared with K5): a cell's opacity then
// takes the cell's damping and Doppler width, and the event's bin and recoil
// the event cell's D (peel.py:225-226, :336-340, :434-436, :486);
// it stops after max_steps = 2 (nx+ny+nz) + 8 crossings or once tau
// reaches 110 (PEEL_TAU_STOP: exp(-110) is 0 in f32, so no deposit can
// change; lart_tpu walks on to 745.2, so such a pair's tau_out is >= 110,
// not the whole sightline's).  Deposits go into the flat (nobs, nxfreq,
// nxim, nyim) cubes by f32 atomics, so the sums come in no fixed order.
// No random numbers.
//
// On a clump medium (peel.py:86-170, :358-363; csrc/clump.cuh) the
// sightline walks the CSR grid cell by cell, at most 3 cg_n + 8 cells: a
// cell's optical depth is the sum of its candidates' chord overlaps clipped
// to the cell segment plus 1e-6 R (clump_cell_tau), each clump at its local
// frequency of the global peel frequency with its velocity over r_loc; the
// event's bin and recoil take D_cl and the event clump's velocity.  lart_tpu
// hands the sightline a resonance's frequency in the owner's units and
// treats it as global; the port follows.  A dust event on clumps peels at the
// record's xatom, the lane's frequency in the owner's units (K4 shifts the
// lane's back).
// An interior all-sky observer (nside > 0; peel.py:394-415, healpix.cuh)
// bins a pair at the HEALPix RING pixel of its arrival direction -pk, drops
// a pair within r^2 <= 1e-12 of the observer, and caps the sightline at the
// distance r to the observer (raytrace_to_dist): the DDA and AMR walks end
// with a partial step min(dmin, cap - trav), the last one where dmin >=
// cap - trav, and the chord is cut at the cap (:378-380).  The flat bin is
// (o nxfreq + ixf) npix + ipix.  Clumps, Stokes and line type 8 with an
// interior observer are vetoed (config.py:494-503).
// In a spherical atmosphere (peel.py:326-333) a Cartesian sightline that
// enters a masked core cell is opaque: tau becomes 2 x 745.2 and the walk
// ends (the crossing is taken even where an interior observer's cap ends
// the step, as lart_tpu takes it).
// Mode PEEL_STELLAR (peel.py:700-836 peel_direct_stellar; the reference's
// peeling_direct_stellar_illumination1, stellar_illumination.f90:953-1164)
// peels a stellar source's newborns in place of PEEL_DIRECT: a pair builds
// the point of the stellar disk facing its observer from the photon's one
// limb-darkened surface sample (cos theta, vphi), which K2 drew into the
// record so that every observer reads the same one and K7 draws nothing;
// it takes the TAN pixel of the star-point to observer ray and, where the
// ray crosses the atmosphere sphere (lart_tpu's corrected test r.k < 0 and
// det >= 0, peel.py:780-789), walks it from the entry point (the entry
// cell clip(floor) on a Cartesian grid, amr_find_cell on the AMR grid, 0
// on clumps) at the newborn's lab frequency shifted into the entry cell's
// comoving frame; it deposits 1 / d_so^2 exp(-min(tau, 700)) into Direct
// (and I with Stokes), and the unattenuated 1 / d_so^2 into Direct0, at
// the newborn's lab-frequency bin.  A pair outside the image or the
// frequency grid walks nothing; most pairs of an observer that does not
// look at the star through the planet fall outside the image.
// Bound: a dependent gather walk, one rhokap (and, moving, three velocity)
// reads and one profile evaluation per crossing, ~1e2 flops a crossing; the
// grid (up to 201^3 x 4 fields, 130 MB) does not fit the 50 MB L2, so a long
// sightline is latency-bound on its gathers, and a warp waits for its
// longest pair.  The bound counted in chip_smoke.py is the flops of the
// crossings this run's pairs made against 67 TFLOP/s, or the bytes that the
// mode reads and writes once (the flag, the lane and record fields it
// reads, each distinct grid cell walked, each distinct cube bin of the 1-5
// cubes it writes), whichever is larger.
// Design for the card (PERF.md row 13, measured there): a walk takes what
// does not change along it once (the profile and the H2 multiplier at a
// static medium's uniform temperature) and carries into each crossing what
// the last one read (the cell's index, a, D and u . k), the same functions
// of the same inputs, so tau is the same to the bit; it stops at tau 110
// (in thick media most crossings came after it).  Its arrays are indexed
// by constants only and its functions forced inline, so they stay in
// registers (the registers of each instance are those of the kernel
// before, without spills).  The deposits crowd into the few bins a
// source's line core fills, most of them 0 in a thick medium: every thread
// reaches one deposit point, and a pair whose deposits are all 0 adds
// nothing (summing a warp's or a block's equal bins first lost 1-3% once
// the zeros were gone: the nonzero deposits are ~1 bin a warp).  Where
// fewer than half the lanes are peeled (a thin medium's few scatterings)
// but enough to fill two warps on each multiprocessor, a first launch
// lists them and the walks run in full warps; fewer packed warps would
// leave the gathers' latency unhidden, and past half the warps are full
// enough.  The wrapper runs the first launch only where the count it last
// sampled packed (instruments/peel.py LaneList), so a state that never
// packs pays for it on one call in 64.
#include "healpix.cuh"
#include "lart.cuh"
#include "mueller.cuh"
#include "voigt.cuh"
#include "walk.cuh"

// modes; a scatter mode is a mask of the record's kinds of event (K4's
// EVENT_RESONANCE = 1, EVENT_DUST = 2, EVENT_CONVERSION = 4); PEEL_STELLAR
// peels a stellar source's newborns
enum {
  PEEL_DIRECT = 0,
  PEEL_RESONANCE = 1,
  PEEL_DUST = 2,
  PEEL_CONVERSION = 4,
  PEEL_STELLAR = 8
};
enum { DUST_OFF = 0, DUST_HG = 1, DUST_MUELLER = 2 };

#define LART_FOURPI 12.566370614359172f
#define LART_RAD2DEG 57.29577951308232f
#define PEEL_TAU_HUGE 745.2f
// a walk ends once tau >= PEEL_TAU_STOP: exp(-110) underflows f32 to 0,
// so no deposit of the pair can be nonzero (tau_out is then >= 110, not
// the whole sightline's)
#define PEEL_TAU_STOP 110.0f
#define PEEL_THREADS 128   // a block's pairs (instruments/peel.py THREADS)
#define PEEL_SELECT_THREADS 1024  // a block of the first pass's lanes

// The observers, the chord's line profile and this call's cubes; the host
// passes it by pointer and the kernel by value.  lart_tpu_torch/instruments/
// peel.py PeelParams mirrors this layout field for field;
// lart_peel_params_size() lets it check the size.
struct PeelParams {
  const float* obs_pos;   // (nobs, 3)
  const float* obs_rmat;  // (nobs, 3, 3), grid -> observer
  float* scatt;           // (nobs * nxfreq * nxim * nyim) cubes; I..V null
  float* direc;           //   without Stokes
  float* I;
  float* Q;
  float* U;
  float* V;
  float* Ha;       // line type 8: the H-alpha band's cube, else null
  float* direc0;   // the unattenuated stellar disk (save_direc0), else null
  float* tau_out;  // optional (nobs * B): tau of each depositing pair
  int* bin_out;    // optional (nobs * B): its flat cube index
  float* w_out;    // optional (4 * nobs * B): its deposits, I (scatt, Ha
                   //   or direc), then Q, U, V of a Stokes resonance peel
  int nobs, nxim, nyim, nxfreq, max_steps;
  int chord;       // uniform sphere: tau is one chord
  int stokes;
  int lab_source;  // moving medium without comoving_source
  int dust;        // DUST_OFF, DUST_HG or DUST_MUELLER
  float dxim, dyim;
  float hg_num, hg_1pg2, hg_2g;  // 1 - g^2, 1 + g^2 and 2 g (f64 rounded
                                 //   once; line type 8: f32 operations)
  MuellerTable mueller;          // DUST_MUELLER
  int recoil;
  LineProf chord_prof;           // the chord's profile components
  float hg_num_Ha, hg_1pg2_Ha, hg_2g_Ha;  // the H-alpha band's (type 8)
  int inside;      // interior all-sky observers: HEALPix maps, capped walks
  int nside;       // their HEALPix resolution (nxim = 12 nside^2, nyim = 1)
  // PEEL_STELLAR: the star's distance (on the -z axis) and radius, the
  // atmosphere sphere's radius and its square
  float star_D, star_R, atm_R, atm_R2;
};


// the AMR sightline (peel.py:242-290): node by node as K8 walks, the
// exit face, the snap to its plane, the neighbor hop and the descent, with
// K8's comoving update in a moving medium or at non-uniform temperature.
// A crossing carries the next leaf, its a and D and (moving) its u . k
// into the next crossing, which read them again before; in a static
// medium at uniform temperature the line profile and the H2 multiplier at
// xf are taken once for the walk.  Each is the same function of the same
// inputs, so tau is the same to the bit.
template <bool kMulti, bool kH2>
__device__ __forceinline__ float tau_to_edge_amr(const FlightParams& g, int max_steps, const float pos0[3],
                                 int ic, const float k[3], float xf, bool band2, float cap) {
  const AmrGrid& a = g.amr;
  const bool update = !band2 && (g.moving || a.Dfreq != nullptr);
  const bool hoist = !band2 && !g.moving && !a.voigt_a && !a.Dfreq;
  float pos[3] = {pos0[0], pos0[1], pos0[2]};
  float tau = 0.0f, trav = 0.0f;
  int il = amr_leaf(a, ic);
  float a_c, D_c;
  leaf_a_D(g, il, a_c, D_c);
  float u1 = update && g.moving ? leaf_vel_dot(g, il, k) : 0.0f;
  float H = 0.0f, h2m = 0.0f;
  if (hoist) {
    H = line_profile<kMulti>(g.line, xf, a_c, D_c);
    if (kH2) h2m = h2_kappa(g.h2, xf, D_c);
  }
  for (int n = 0; n < max_steps; ++n) {
    const float rho = band2 ? leaf_band2_opacity(g, il)
                      : hoist ? leaf_opacity_at<kH2>(g, il, H, h2m)
                              : leaf_opacity<kMulti, kH2>(g, il, xf, a_c, D_c);
    const int c = amr_clip_cell(a, ic);
    const float cen[3] = {__ldg(&a.node_cx[c]), __ldg(&a.node_cy[c]), __ldg(&a.node_cz[c])};
    const float h = __ldg(&a.node_ch[c]);
    float t[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) t[q] = node_face_dist(pos[q], k[q], cen[q], h);
    const float dmin = fminf(fminf(t[0], t[1]), t[2]);
    const int axis = dmin == t[0] ? 0 : (dmin == t[1] ? 1 : 2);
    // k, pos and cen indexed by constants only, so that they stay in
    // registers
    const bool up = axis == 0 ? k[0] > 0.0f : axis == 1 ? k[1] > 0.0f : k[2] > 0.0f;
    const int face = axis * 2 + (up ? 0 : 1);
    bool hit;
    const float dstep = capped_step(dmin, cap, trav, hit);
    tau = tau + dstep * rho;
    trav = trav + dstep;
    if (hit) break;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      pos[q] = q == axis ? cen[q] + (up ? h : -h) : fmaf(dmin, k[q], pos[q]);
    const int nb = __ldg(&a.neighbor[c * 6 + face]);
    if (nb < 0) break;
    ic = amr_descend_from_face(a, nb, face, pos[0], pos[1], pos[2]);
    il = amr_leaf(a, ic);
    if (!hoist && !band2) {
      float a2, D2;
      leaf_a_D(g, il, a2, D2);
      if (update) {
        const float u2 = g.moving ? leaf_vel_dot(g, il, k) : 0.0f;
        xf = (xf + u1) * D_c / D2 - u2;
        u1 = u2;
      }
      a_c = a2;
      D_c = D2;
    }
    if (!(tau < PEEL_TAU_STOP)) break;
  }
  return tau;
}

// the clump sightline (tau_to_edge_clump, peel.py:86-170): CSR cell by
// cell, each cell's candidates' chord overlaps at the global frequency xf,
// to the cube's faces, tau PEEL_TAU_STOP or max_steps cells
template <bool kMulti>
__device__ __forceinline__ float tau_to_edge_clump(const FlightParams& g, int max_steps, const float pos0[3],
                                   const float k[3], float xf) {
  const ClumpGrid& c = g.clump;
  float pos[3] = {pos0[0], pos0[1], pos0[2]};
  float tau = 0.0f;
  for (int n = 0; n < max_steps; ++n) {
    int cell;
    const float t_end = clump_cell_exit(c, pos, k, cell) + c.eps_peel;
    tau = tau + clump_cell_tau<kMulti>(c, g.line, cell, pos, k, xf, t_end, CLUMP_U_DIV);
#pragma unroll
    for (int a = 0; a < 3; ++a) pos[a] = fmaf(t_end, k[a], pos[a]);
    if (fabsf(pos[0]) >= c.R || fabsf(pos[1]) >= c.R || fabsf(pos[2]) >= c.R) break;
    if (!(tau < PEEL_TAU_STOP)) break;
  }
  return tau;
}

// optical depth from pos along k to the grid's edge at comoving frequency
// xf; band2: the H-alpha band's dust-only opacity (0 without dust); cap >=
// 0: the path length where the integration stops (an interior observer).
// The DDA carries the next cell's flat index, a, D and (moving) u . k into
// the next crossing, and in a static medium at uniform temperature takes
// the line profile (and the H2 multiplier) at xf once: the same functions
// of the same inputs as each crossing took them, so tau is the same to the
// bit.
template <bool kMulti, bool kH2>
__device__ __forceinline__ float tau_to_edge(const FlightParams& g, const PeelParams& p, const float pos0[3],
                             const int cell0[3], const float k0[3], float xf, bool band2,
                             float cap) {
  if (band2 && !g.rhokapD) return 0.0f;
  if (g.clump.n) return tau_to_edge_clump<kMulti>(g, p.max_steps, pos0, k0, xf);
  if (g.amr.ncells)
    return tau_to_edge_amr<kMulti, kH2>(g, p.max_steps, pos0, cell0[0], k0, xf, band2, cap);
  if (p.chord) {
    const float H = kMulti ? line_profile_q(g.line, p.chord_prof, xf) : voigt_h(xf, g.a_ref);
    const float rho = g.sphere_rho * H + g.sphere_rhoD;
    float t_in, t_out;
    sphere_chord(g, pos0[0], pos0[1], pos0[2], k0[0], k0[1], k0[2], t_in, t_out);
    if (cap >= 0.0f) {
      t_out = fminf(t_out, fmaxf(cap, t_in));
      t_in = fminf(t_in, t_out);
    }
    return (t_out - t_in) * rho;
  }
  const bool update = !band2 && (g.moving || g.cell_D);
  const bool hoist = !band2 && !update;
  float pos[3] = {pos0[0], pos0[1], pos0[2]};
  float k[3] = {k0[0], k0[1], k0[2]};
  int cell[3] = {cell0[0], cell0[1], cell0[2]};
  float tau = 0.0f, trav = 0.0f;
  int f = flat_index(g, cell[0], cell[1], cell[2]);
  float a_c, D_c;
  cell_a_D(g, f, a_c, D_c);
  float u1 = update && g.moving ? vel_dot_at(g, f, k) : 0.0f;
  float H = 0.0f, h2m = 0.0f;
  if (hoist) {
    H = line_profile<kMulti>(g.line, xf, a_c, D_c);
    if (kH2) h2m = h2_kappa(g.h2, xf, D_c);
  }
  for (int n = 0; n < p.max_steps; ++n) {
    float rho;
    if (band2) {
      rho = band2_opacity(g, f);
    } else if (hoist) {
      rho = cell_opacity_at<kH2>(g, f, H, h2m);
    } else {
      rho = cell_opacity<kMulti, kH2>(g, f, xf, a_c, D_c);
    }
    float t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      t[a] = g.walk[a] ? face_dist(pos[a], k[a], cell[a], g.amin[a], g.d[a]) : LART_BIG;
    const float dmin = fminf(fminf(t[0], t[1]), t[2]);
    const int axis = dmin == t[0] ? 0 : (dmin == t[1] ? 1 : 2);
    bool hit;
    const float dstep = capped_step(dmin, cap, trav, hit);
    tau = tau + dstep * rho;
    trav = trav + dstep;
    if (hit && !g.mask) break;
#pragma unroll
    for (int a = 0; a < 3; ++a) pos[a] = fmaf(dmin, k[a], pos[a]);
    // cell, pos and k indexed by constants only (registers)
    const bool esc = axis == 0   ? cross_axis(g, 0, cell[0], pos[0], k[0])
                     : axis == 1 ? cross_axis(g, 1, cell[1], pos[1], k[1])
                                 : cross_axis(g, 2, cell[2], pos[2], k[2]);
    f = flat_index(g, cell[0], cell[1], cell[2]);
    // a sightline into the masked core is opaque (peel.py:326-333)
    if (!esc && g.mask && g.mask[f]) {
      tau = 2.0f * PEEL_TAU_HUGE;
      break;
    }
    if (esc || hit) break;
    if (update) {
      // the comoving update (peel.py:336-340), at each cell's D
      float a2, D2;
      cell_a_D(g, f, a2, D2);
      const float u2 = g.moving ? vel_dot_at(g, f, k) : 0.0f;
      xf = (xf + u1) * D_c / D2 - u2;
      u1 = u2;
      a_c = a2;
      D_c = D2;
    }
    if (!(tau < PEEL_TAU_STOP)) break;
  }
  return tau;
}

// A pair's deposits: key, the flat cube bin (+ nobs nxfreq nxim nyim for
// the H-alpha cube), -1 for none, and its components v: Direct (and I)
// and Direct0 at a birth; scatt (and I), Q, U, V at a scattering, or Ha.
struct PeelDep {
  int key = -1;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  __device__ void set(int k, float a, float b, float c, float e) {
    key = k;
    v[0] = a;
    v[1] = b;
    v[2] = c;
    v[3] = e;
  }
};

__device__ inline void add_nonzero(float* at, float v) {
  if (v != 0.0f) atomicAdd(at, v);
}

// the components v of key into the cubes (a component of 0 adds nothing)
__device__ inline void peel_add(const PeelParams& p, int mode, int ncomp, int key,
                                const float v[4]) {
  const int nbin = p.nobs * p.nxfreq * p.nxim * p.nyim;
  if (key >= nbin) {
    add_nonzero(&p.Ha[key - nbin], v[0]);
  } else if (mode == PEEL_DIRECT || mode == PEEL_STELLAR) {
    add_nonzero(&p.direc[key], v[0]);
    if (p.stokes) add_nonzero(&p.I[key], v[0]);
    if (ncomp > 1) add_nonzero(&p.direc0[key], v[1]);
  } else {
    add_nonzero(&p.scatt[key], v[0]);
    if (ncomp > 1) {
      add_nonzero(&p.I[key], v[0]);
      add_nonzero(&p.Q[key], v[1]);
      add_nonzero(&p.U[key], v[2]);
      add_nonzero(&p.V[key], v[3]);
    }
  }
}

// PEEL_STELLAR's pair (observer o, lane i): cell and il the newborn's cell
// and AMR leaf, D_c its Doppler width
template <bool kMulti, bool kH2>
__device__ __forceinline__ PeelDep peel_stellar(const Lanes& s, const PeelRecord& rec, int i, int o,
                                long long t, const FlightParams& g, const PeelParams& p,
                                const int cell[3], int il, float D_c) {
  PeelDep d;
  const bool amr = g.amr.ncells != 0, clump = g.clump.n != 0;
  // the newborn's lab frequency in reference Doppler units and its bin
  float xr = s.xfreq[i];
  if (g.moving) {
    const float k[3] = {s.kx[i], s.ky[i], s.kz[i]};
    xr = xr + (clump ? clump_vel_dot(g.clump, cell[0], k, CLUMP_U_SCALE)
               : amr ? leaf_vel_dot(g, il, k) : vel_dot(g, cell, k));
  }
  xr = xr * (D_c / g.Dfreq);
  const float fx = floorf((xr - g.xfreq_min) / g.dxfreq);
  if (!(fx >= 0.0f && fx < (float)p.nxfreq)) return d;
  // the star -> observer axis, the star at (0, 0, -D)
  const float* op = p.obs_pos + 3 * o;
  const float* R = p.obs_rmat + 9 * o;
  float k0x = op[0], k0y = op[1], k0z = op[2] + p.star_D;
  const float d_so2 = k0x * k0x + k0y * k0y + k0z * k0z;
  const float d_so = sqrtf(d_so2);
  k0x = k0x / d_so;
  k0y = k0y / d_so;
  k0z = k0z / d_so;
  const float cosvt0 = p.star_R / d_so;
  // the point of the disk facing the observer, from the photon's sample
  const float cost = rec.limb_cost[i], vphi = rec.limb_vphi[i];
  const float cosvp = cosf(vphi), sinvp = sinf(vphi);
  const float c0c = cosvt0 * cost;
  const float cosvt =
      cost * sqrtf(1.0f - cosvt0 * cosvt0 + c0c * c0c) + cosvt0 * (1.0f - cost * cost);
  const float sinvt = sqrtf(fmaxf(1.0f - cosvt * cosvt, 0.0f));
  const float kr0 = sqrtf(fmaxf(k0x * k0x + k0y * k0y, 0.0f));
  float xx, yy, zz;
  if (kr0 < 1e-11f) {
    xx = sinvt * cosvp;
    yy = sinvt * sinvp;
    zz = (k0z > 0.0f ? 1.0f : (k0z < 0.0f ? -1.0f : 0.0f)) * cosvt;
  } else {
    const float kr0s = fmaxf(kr0, 1e-11f);
    xx = cosvt * k0x + sinvt * (k0z * k0x * cosvp - k0y * sinvp) / kr0s;
    yy = cosvt * k0y + sinvt * (k0z * k0y * cosvp + k0x * sinvp) / kr0s;
    zz = cosvt * k0z - sinvt * cosvp * kr0;
  }
  xx = p.star_R * xx;
  yy = p.star_R * yy;
  zz = p.star_R * zz - p.star_D;
  float pk[3] = {op[0] - xx, op[1] - yy, op[2] - zz};
  const float rr = sqrtf(pk[0] * pk[0] + pk[1] * pk[1] + pk[2] * pk[2]);
  pk[0] = pk[0] / rr;
  pk[1] = pk[1] / rr;
  pk[2] = pk[2] / rr;
  // the TAN pixel of the star-point -> observer ray
  const float okx = R[0] * pk[0] + R[1] * pk[1] + R[2] * pk[2];
  const float oky = R[3] * pk[0] + R[4] * pk[1] + R[5] * pk[2];
  const float okz = R[6] * pk[0] + R[7] * pk[1] + R[8] * pk[2];
  const int ix = (int)floorf(atan2f(-okx, okz) * LART_RAD2DEG / p.dxim + 0.5f * (float)p.nxim);
  const int iy = (int)floorf(atan2f(-oky, okz) * LART_RAD2DEG / p.dyim + 0.5f * (float)p.nyim);
  if (ix < 0 || ix >= p.nxim || iy < 0 || iy >= p.nyim) return d;
  const int idx = (o * p.nxfreq + (int)fx) * (p.nxim * p.nyim) + ix * p.nyim + iy;
  // the atmosphere sphere's crossing (lart_tpu's test r.k < 0, det >= 0)
  const float r_dot_k = xx * pk[0] + yy * pk[1] + zz * pk[2];
  const float rr2 = xx * xx + yy * yy + zz * zz;
  const float det = r_dot_k * r_dot_k - (rr2 - p.atm_R2);
  float tau = 0.0f, atten = 1.0f;
  if (r_dot_k < 0.0f && det >= 0.0f) {
    const float dist = -r_dot_k - sqrtf(fmaxf(det, 0.0f));
    const float e[3] = {xx + pk[0] * dist, yy + pk[1] * dist, zz + pk[2] * dist};
    int ec[3] = {0, 0, 0};
    float xf = xr;
    if (amr) {
      ec[0] = amr_find_cell(g.amr, e[0], e[1], e[2]);
    } else if (!clump) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        ec[a] = (int)fminf(fmaxf(floorf((e[a] - g.amin[a]) / g.d[a]), 0.0f),
                           (float)(g.n[a] - 1));
    }
    if (!clump && (g.moving || g.cell_D || g.amr.Dfreq)) {
      // the lab frequency into the entry cell's comoving frame
      float D2, u2 = 0.0f;
      if (amr) {
        const int il2 = amr_leaf(g.amr, ec[0]);
        float a2;
        leaf_a_D(g, il2, a2, D2);
        if (g.moving) u2 = leaf_vel_dot(g, il2, pk);
      } else {
        D2 = cell_D_of(g, flat_index(g, ec[0], ec[1], ec[2]));
        if (g.moving) u2 = vel_dot(g, ec, pk);
      }
      xf = xr * g.Dfreq / D2 - u2;
    }
    tau = tau_to_edge<kMulti, kH2>(g, p, e, ec, pk, xf, false, -1.0f);
    atten = expf(-fminf(tau, 700.0f));
  }
  const float w0 = 1.0f / d_so2;
  const float w = w0 * atten;
  if (p.tau_out) {
    p.tau_out[t] = tau;
    p.bin_out[t] = idx;
    p.w_out[t] = w;
  }
  // Direct (and I) w, Direct0 the unattenuated w0
  d.set(idx, w, w0, 0.0f, 0.0f);
  return d;
}

// The deposit of pair t = o B + i (observer o, lane i), t < B nobs: its
// tau_out, bin_out and w_out written where asked for, its deposits
// returned (key -1 where it makes none)
template <bool kMulti, bool kH2>
__device__ __forceinline__ PeelDep peel_pair(const Lanes& s, const PeelRecord& rec, int B, int mode,
                             const FlightParams& g, const PeelParams& p, long long t) {
  PeelDep d;
  const int o = (int)(t / B), i = (int)(t % B);
  const int kind = rec.flag[i];
  if (mode == PEEL_DIRECT || mode == PEEL_STELLAR ? kind == 0 : (kind & mode) == 0) return d;
  const float pos[3] = {s.x[i], s.y[i], s.z[i]};
  const int cell[3] = {s.ic[i], s.jc[i], s.kc[i]};
  // the event cell's leaf, damping and Doppler width on the AMR grid (the
  // reference values elsewhere)
  const bool amr = g.amr.ncells != 0, clump = g.clump.n != 0;
  const int il = amr ? amr_leaf(g.amr, cell[0]) : -1;
  float a_c = g.a_ref, D_c = g.Dfreq;
  if (amr) leaf_a_D(g, il, a_c, D_c);
  if (clump) D_c = g.clump.D_cl;
  if (!amr && !clump && g.cell_D) cell_a_D(g, flat_index(g, cell[0], cell[1], cell[2]), a_c, D_c);
  if (mode == PEEL_STELLAR)
    return peel_stellar<kMulti, kH2>(s, rec, i, o, t, g, p, cell, il, D_c);

  // obs_geometry: the unit direction to the observer and its pixel, TAN
  // (external) or the HEALPix pixel of the arrival direction -pk with the
  // sightline capped at the observer (interior)
  const float* op = p.obs_pos + 3 * o;
  const float* R = p.obs_rmat + 9 * o;
  float pk[3] = {op[0] - pos[0], op[1] - pos[1], op[2] - pos[2]};
  const float r2 = pk[0] * pk[0] + pk[1] * pk[1] + pk[2] * pk[2];
  const float r = sqrtf(fmaxf(r2, 1e-30f));
  pk[0] = pk[0] / r;
  pk[1] = pk[1] / r;
  pk[2] = pk[2] / r;
  int img;
  float cap = -1.0f;
  if (p.inside) {
    if (!(r2 > 1e-12f)) return d;
    img = vec2pix_ring(p.nside, -pk[0], -pk[1], -pk[2]);
    cap = r;
  } else {
    const float okx = R[0] * pk[0] + R[1] * pk[1] + R[2] * pk[2];
    const float oky = R[3] * pk[0] + R[4] * pk[1] + R[5] * pk[2];
    const float okz = R[6] * pk[0] + R[7] * pk[1] + R[8] * pk[2];
    const int ix =
        (int)floorf(atan2f(-okx, okz) * LART_RAD2DEG / p.dxim + 0.5f * (float)p.nxim);
    const int iy =
        (int)floorf(atan2f(-oky, okz) * LART_RAD2DEG / p.dyim + 0.5f * (float)p.nyim);
    if (ix < 0 || ix >= p.nxim || iy < 0 || iy >= p.nyim) return d;
    img = ix * p.nyim + iy;
  }

  // the comoving frequency toward the observer; a conversion's photon and
  // a dust event of a lane in the H-alpha band see the dust only, and the
  // latter's frequency is a lab one
  const bool conv = kMulti && mode != PEEL_DIRECT && kind == PEEL_CONVERSION;
  const bool b2 = kMulti && mode != PEEL_DIRECT && kind == PEEL_DUST &&
                  g.line.line_type == 8 && s.iband[i] == 2;
  float xf, cost = 0.0f, cosp = 1.0f, sinp = 0.0f;
  if (mode == PEEL_DIRECT) {
    xf = s.xfreq[i];
    if (p.lab_source) {
      const float k[3] = {s.kx[i], s.ky[i], s.kz[i]};
      xf = clump ? xf + clump_vel_dot(g.clump, cell[0], k, CLUMP_U_SCALE) -
                       clump_vel_dot(g.clump, cell[0], pk, CLUMP_U_SCALE)
           : amr ? xf + leaf_vel_dot(g, il, k) - leaf_vel_dot(g, il, pk)
                 : xf + vel_dot(g, cell, k) - vel_dot(g, cell, pk);
    }
  } else {
    const float kx = rec.kx[i], ky = rec.ky[i], kz = rec.kz[i];
    cost = kx * pk[0] + ky * pk[1] + kz * pk[2];
    const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
    if (kind == PEEL_DUST && !p.stokes) {
      // HG needs no azimuth
    } else if (p.stokes && !conv) {
      // azimuth relative to the (m, n) triad
      const float ss = fmaxf(sint, 1e-20f);
      if (sint != 0.0f) {
        cosp = (pk[0] * rec.mx[i] + pk[1] * rec.my[i] + pk[2] * rec.mz[i]) / ss;
        sinp = (pk[0] * rec.nnx[i] + pk[1] * rec.nny[i] + pk[2] * rec.nnz[i]) / ss;
      }
    } else {
      // azimuth from the propagation-vector geometry
      const float rho1 = sqrtf(fmaxf(1.0f - kz * kz, 0.0f)) * sint;
      const float inv = 1.0f / fmaxf(rho1, 1e-20f);
      if (rho1 != 0.0f) {
        cosp = inv * (cost * kz - pk[2]);
        sinp = inv * (kx * pk[1] - pk[0] * ky);
      }
    }
    // dust scatters coherently in the comoving frame; the H-alpha photon
    // leaves the atom's line centre, with no recoil
    if (kind == PEEL_DUST) {
      xf = clump ? rec.xatom[i] : s.xfreq[i];
    } else if (conv) {
      xf = (rec.ux[i] * cosp + rec.uy[i] * sinp) * sint + rec.uz[i] * cost;
    } else {
      xf = rec.xatom[i] + (rec.ux[i] * cosp + rec.uy[i] * sinp) * sint + rec.uz[i] * cost;
      if (p.recoil) xf = xf - (g.line.g_recoil0 / D_c) * (1.0f - cost);
    }
  }

  // freq_bin: the lab-frequency bin of xf at the event cell, along pk, at
  // its Doppler width (D / Dfreq_ref is 1 at uniform temperature)
  float xr = xf;
  if (g.moving && !b2)
    xr = xf + (clump ? clump_vel_dot(g.clump, cell[0], pk, CLUMP_U_SCALE)
                     : amr ? leaf_vel_dot(g, il, pk) : vel_dot(g, cell, pk));
  if (!b2) xr = xr * (D_c / g.Dfreq);
  const float fx = floorf((xr - g.xfreq_min) / g.dxfreq);
  if (!(fx >= 0.0f && fx < (float)p.nxfreq)) return d;
  const int idx = (o * p.nxfreq + (int)fx) * (p.nxim * p.nyim) + img;

  const float tau = tau_to_edge<kMulti, kH2>(g, p, pos, cell, pk, xf, conv || b2, cap);
  const float atten = expf(-fminf(tau, 700.0f));
  if (p.tau_out) {
    p.tau_out[t] = tau;
    p.bin_out[t] = idx;
  }
  const long long n = (long long)B * p.nobs;
  const float wgt = s.wgt[i];
  if (mode == PEEL_DIRECT) {
    const float w = atten / (LART_FOURPI * r2) * wgt;
    if (p.w_out) p.w_out[t] = w;
    d.set(idx, w, 0.0f, 0.0f, 0.0f);
    return d;
  }
  // the H-alpha cube's bins are keyed past the others'
  const int nbin = p.nobs * p.nxfreq * p.nxim * p.nyim;
  const float cost2 = cost * cost;
  if (conv) {
    // the dipole phase of the 3p -> 2s channel
    const float phase = 0.75f * g.line.E1[1] * (cost2 + 1.0f) + g.line.E2[1];
    const float w = phase / (LART_FOURPI * r2) * atten * wgt;
    if (p.w_out) p.w_out[t] = w;
    d.set(nbin + idx, w, 0.0f, 0.0f, 0.0f);
    return d;
  }
  // the resonance's phase weights: the event's own for line types 2, 4-6
  const bool lane_E = kMulti && g.line.per_lane_E;
  const float E1 = lane_E ? rec.E1[i] : g.line.E1s;
  const float E2 = lane_E ? rec.E2[i] : g.line.E2s;
  const float E3 = lane_E ? rec.E3[i] : g.line.E3s;
  if (!p.stokes) {
    float w;
    if (kind == PEEL_DUST) {
      // Henyey-Greenstein (1 - g^2) / (1 + g^2 - 2 g cos)^1.5 / 4 pi
      const float phase = b2 ? p.hg_num_Ha / powf(p.hg_1pg2_Ha - p.hg_2g_Ha * cost, 1.5f) /
                                   LART_FOURPI
                             : p.hg_num / powf(p.hg_1pg2 - p.hg_2g * cost, 1.5f) / LART_FOURPI;
      w = phase / r2 * atten * wgt;
    } else {
      const float phase = 0.75f * E1 * (cost2 + 1.0f) + E2;
      w = phase / (LART_FOURPI * r2) * atten * wgt;
    }
    if (p.w_out) p.w_out[t] = w;
    d.set(b2 ? nbin + idx : idx, w, 0.0f, 0.0f, 0.0f);
    return d;
  }
  // the scattered Stokes vector, rotated to the detector frame
  const float cos2p = 2.0f * cosp * cosp - 1.0f;
  const float sin2p = 2.0f * cosp * sinp;
  const float Q = rec.Q[i], U = rec.U[i], V = rec.V[i];
  const float Q0 = cos2p * Q + sin2p * U;
  const float U0 = -sin2p * Q + cos2p * U;
  float Iobs, Qobs, Uobs, Vobs;
  if (kind == PEEL_DUST) {
    float S[4];  // S11, S12, S33, S34 at the angle to the observer
    mueller_interp_S(p.mueller, cost, S);
    Iobs = (S[0] + S[1] * Q0) / LART_TWOPI;
    Qobs = (S[1] + S[0] * Q0) / LART_TWOPI;
    Uobs = (S[2] * U0 + S[3] * V) / LART_TWOPI;
    Vobs = (-S[3] * U0 + S[2] * V) / LART_TWOPI;
  } else {
    const float S22 = 0.75f * E1 * (cost2 + 1.0f);
    const float S11 = S22 + E2;
    const float S12 = 0.75f * E1 * (cost2 - 1.0f);
    const float S33 = 1.5f * E1 * cost;
    const float S44 = 1.5f * E3 * cost;
    Iobs = (S11 + S12 * Q0) / LART_FOURPI;
    Qobs = (S12 + S22 * Q0) / LART_FOURPI;
    Uobs = (S33 * U0) / LART_FOURPI;
    Vobs = (S44 * V) / LART_FOURPI;
  }
  const float pnx = -sinp * rec.mx[i] + cosp * rec.nnx[i];
  const float pny = -sinp * rec.my[i] + cosp * rec.nny[i];
  const float pnz = -sinp * rec.mz[i] + cosp * rec.nnz[i];
  const float cosg = -(R[0] * pnx + R[1] * pny + R[2] * pnz);
  const float sing = R[3] * pnx + R[4] * pny + R[5] * pnz;
  const float cos2g = 2.0f * cosg * cosg - 1.0f;
  const float sin2g = 2.0f * cosg * sing;
  const float Qdet = cos2g * Qobs + sin2g * Uobs;
  const float Udet = -sin2g * Qobs + cos2g * Uobs;
  const float w = atten / r2 * wgt;
  const float wI = w * Iobs, wQ = w * Qdet, wU = w * Udet, wV = w * Vobs;
  if (p.w_out) {
    p.w_out[t] = wI;
    p.w_out[n + t] = wQ;
    p.w_out[2 * n + t] = wU;
    p.w_out[3 * n + t] = wV;
  }
  d.set(idx, wI, wQ, wU, wV);
  return d;
}

// K7's first pass where the wrapper gives `order` (B + 2 ints): the lanes
// the mode peels, each lane's index written at order[ticket], in lane order
// within a block; a block takes its tickets by one atomic on the count
// order[B + parity] (a ticket a warp, as K2 takes them, would queue B / 32
// atomics on one address).  The count is 0 before the launch: the walk of
// the launch before, of the other parity, zeroed it.
__global__ void __launch_bounds__(PEEL_SELECT_THREADS)
    peel_select_kernel(PeelRecord rec, int B, int mode, int* order, int parity) {
  __shared__ int warp_at[PEEL_SELECT_THREADS / 32];
  const unsigned full = 0xffffffffu;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool on = false;
  if (i < B) {
    const int kind = rec.flag[i];
    on = mode == PEEL_DIRECT || mode == PEEL_STELLAR ? kind != 0 : (kind & mode) != 0;
  }
  const unsigned m = __ballot_sync(full, on);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_at[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    // the warps' counts, scanned; the block's base from the count
    const int own = lane < (int)(blockDim.x >> 5) ? warp_at[lane] : 0;
    int v = own;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(full, v, off);
      if (lane >= off) v += u;
    }
    const int total = __shfl_sync(full, v, 31);
    int base = 0;
    if (lane == 0 && total) base = atomicAdd(&order[B + parity], total);
    base = __shfl_sync(full, base, 0);
    if (lane < (int)(blockDim.x >> 5)) warp_at[lane] = base + v - own;
  }
  __syncthreads();
  if (on) order[warp_at[warp] + __popc(m & ((1u << lane) - 1u))] = i;
}

// K7: one thread a pair, t = o B + lane.  With order (the first pass's
// list of the c = order[B + parity] lanes to peel), where fewer than half
// the lanes are peeled but their pairs fill at least min_pack threads,
// thread j < c nobs takes the pair of observer j / c and lane order[j % c],
// so that the pairs walk in full warps; where more are peeled the warps
// are full enough as the lanes lie, and where fewer the packed warps would
// be too few to hide their gathers' latency.  Every thread, the grid's
// tail too, reaches the one deposit point, where a pair whose deposits
// are all 0 adds nothing; ncomp is the count of the mode's components, 1
// to 4 (PeelDep).
template <bool kMulti, bool kH2>
__global__ void __launch_bounds__(PEEL_THREADS)
    peel_kernel(Lanes s, PeelRecord rec, int B, int mode, FlightParams g, PeelParams p,
                int ncomp, int* order, int parity, int min_pack) {
  const long long n = (long long)B * p.nobs;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (order) {
    const int c = order[B + parity];
    if (2 * c < B && (long long)c * p.nobs >= min_pack)
      t = t < (long long)c * p.nobs ? (t / c) * B + order[t % c] : n;
    // the next launch's count (the launch before read it)
    if (blockIdx.x == 0 && threadIdx.x == 0) order[B + 1 - parity] = 0;
  }
  PeelDep d;
  if (t < n) d = peel_pair<kMulti, kH2>(s, rec, B, mode, g, p, t);
  // the cubes start at +0; the loop runs to 4 so that v stays in registers
  bool zero = true;
#pragma unroll
  for (int c = 0; c < 4; ++c) zero = zero && (c >= ncomp || d.v[c] == 0.0f);
  if (d.key >= 0 && !zero) peel_add(p, mode, ncomp, d.key, d.v);
}

template <bool kMulti, bool kH2>
void peel_launch(const Lanes& s, const PeelRecord& r, int B, int mode, const FlightParams& g,
                 const PeelParams& p, int ncomp, int* order, int parity, int min_pack,
                 unsigned blocks, cudaStream_t st) {
  if (order)
    peel_select_kernel<<<(B + PEEL_SELECT_THREADS - 1) / PEEL_SELECT_THREADS,
                         PEEL_SELECT_THREADS, 0, st>>>(r, B, mode, order, parity);
  peel_kernel<kMulti, kH2><<<blocks, PEEL_THREADS, 0, st>>>(s, r, B, mode, g, p, ncomp, order,
                                                            parity, min_pack);
}

// ncomp: the mode's components (instruments/peel.py n_components); order:
// null (one launch), or B + 2 ints for the lanes to peel and two counts,
// order[B + parity] 0 before the launch (two launches), the other zeroed
// by it; min_pack the fewest pairs the walk packs into full warps
LART_API int lart_peel(void* const* lanes, void* const* record, int B, int mode,
                       const FlightParams* g, const PeelParams* p, int ncomp, int* order,
                       int parity, int min_pack, void* stream) {
  const long long n = (long long)B * p->nobs;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + PEEL_THREADS - 1) / PEEL_THREADS);
    const Lanes s = unpack_lanes(lanes);
    const PeelRecord r = unpack_record(record);
    cudaStream_t st = (cudaStream_t)stream;
    const bool multi = g->line.line_type != 1, h2 = g->h2.n_lines > 0;
    if (!multi && !h2)
      peel_launch<false, false>(s, r, B, mode, *g, *p, ncomp, order, parity, min_pack, blocks,
                                st);
    else if (!multi)
      peel_launch<false, true>(s, r, B, mode, *g, *p, ncomp, order, parity, min_pack, blocks,
                               st);
    else if (!h2)
      peel_launch<true, false>(s, r, B, mode, *g, *p, ncomp, order, parity, min_pack, blocks,
                               st);
    else
      peel_launch<true, true>(s, r, B, mode, *g, *p, ncomp, order, parity, min_pack, blocks,
                              st);
  }
  return (int)cudaGetLastError();
}

LART_API int lart_peel_params_size() { return (int)sizeof(PeelParams); }
