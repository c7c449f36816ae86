// K5 fly_cartesian: the generic Cartesian flight, an Amanatides-Woo walk of
// the grid one cell crossing at a time, with escape, periodic and reflect
// boundaries and the comoving frequency update of a moving medium.
//
// Replaces lart_tpu/transport/engine.py:1057 make_fly / :1141 fly (the
// Cartesian DDA with its all-photons death rows).  The TPU runs a
// lax.while_loop of at most max_steps iterations over the whole batch; here
// one thread walks its own lane, at most max_steps crossings (the loop
// condition n < max_steps, no "+ 2" as in the slab), so a forced first
// scattering that completes restarts from birth and keeps flying within the
// same budget, as the while_loop counts it.  Every expression keeps the JAX
// order, and the cell faces and advanced positions are fused multiply-adds
// as XLA computes them (transport/flight.py); the opacity of the current
// cell is rhokap times the line's profile at the cell's damping a and
// Doppler width D (line.cuh: H(x, a) for line type 1, the doublet,
// multiplet or H+D sum for the others; two kernel instances; a and D the
// reference ones at uniform temperature, else gathered from the per-cell
// arrays cell_a and cell_D, walk.cuh cell_a_D), plus rhokap times the H2
// multiplier with H2 pumping (h2.cuh, the instances with kH2) and rhokapD
// with dust (walk.cuh cell_opacity).
// Line type 8 (engine.py:1276-1283, :1312-1340, :1466-1495): a lane of the
// H-alpha band sees the dust only (rhokapD R_Ha, or nothing), keeps its
// lab frequency across cells and escapes into Jout_Ha at it; each band's
// escaped weight, out-of-grid escapes included, goes to W_esc1 or W_esc2
// by a block sum, and W_esc1 also takes each completed forced first
// scattering's escaped fraction whose birth bin is on the grid.  In a moving
// medium or at non-uniform temperature a cell change updates the comoving
// frequency, x' = ((x + u1) D1) / D2 - u2 (two roundings, in lart_tpu's
// order); an escape is binned at (x + u) D / D_ref of the cell left, a
// completed forced first scattering at (x_b + u_b) D_b / D_ref of its birth
// cell.  Escapes go to Jout/Jmu with f32 atomics at once (a lane escapes at
// most once a call), weight outside the frequency grid through one block
// sum.  In an exoplanet atmosphere (engine.py:1259-1272, :1302-1310,
// :1322-1333, :1378-1382) a FLYING lane that leaves a plane atmosphere
// through its bottom z face, or enters a masked core cell of a spherical
// one (the mask, one byte a cell, read on each crossing), is destroyed
// into Jabs2 at the lab frequency of the cell it leaves (W_oor off the
// grid); a forced first scattering's birth ray that enters the core ends
// with the optical depth FFS_TAU_CAP and restarts from birth, one that
// leaves through the bottom completes as any escape.  Bound: the
// gathers.  Each crossing reads rhokap (and rhokapD) and, in a moving
// medium, three velocity components of the old and new cell, and at
// non-uniform temperature a and D of the cell and D of the next, 4-byte words
// scattered over arrays of 4 nx ny nz bytes each (32 MB at 201^3, against a
// 50 MB L2); the lane state is read and written once a call.  H2 adds two
// Voigt functions (~80 flops) a crossing and no bytes.
// The shearing box and the CALCJ/CALCPnew deposits live in the kExtra
// instances (a run without them keeps its code).  A crossing of the periodic
// x boundary moves the lane's vfy_shear by -+ omega_shear (engine.py:
// 1250-1257); the comoving update takes u1 = fma(vfy, ky, u.k) of the old
// value and u2 of the new one, also in a static medium, the escape the old
// one (:1282-1313); a completed forced first scattering restarts with vfy 0
// (:1406-1409).  Each step of a lane through gas (rhoH > 0) adds d wgt to
// J1 at its cell's bin (lart.cuh jpa_bin) and comoving frequency x D / D_ref
// (dropped off the frequency grid), and d rhoH wgt / max(rhokap D / cross0,
// TINY) to Pnew (:1199-1219), each the f32 deposit summed in f64 (the
// reference's f64 maps, define.f90:203-205).  The lanes crowd into a few
// bins round the source (on t1tau6.in 2.0 distinct Pnew bins a warp and
// 6.5 J1 bins, 99% of Pnew in five), where an atomic a step serialized
// (0.225 ms against 0.014 without the maps).  So a lane keeps one pending
// deposit in registers, its bin, frequency bin and two f64 sums, which
// grows while the lane stays in both bins and goes to the maps by plain
// atomics when either changes (a lane's own crossings, spread out); the
// last one goes, where the warp has converged at the end, through the warp
// level and the block's copies of the maps that fit one (lart.cuh
// deposit_aggregated; the wrapper's plan).
// The all-photons table (save_all_photons, csrc/allph.cuh) lives in the
// kAllph instances, so a run without it keeps its code: a lane that dies
// here writes its death row at once (engine.py:1434-1469): an escape and an
// atmosphere's destruction at the lab frequency of the cell it leaves (the
// H-alpha band's own frequency), a forced first scattering born in vacuum
// (tau0 0: it restarts from birth with weight 0 and dies) at its birth lab
// frequency.  lart_tpu writes the rows after its loop from the final state,
// which a dead lane no longer changes.  A row is one store a column, only
// where a lane dies.
#include "lart.cuh"
#include "voigt.cuh"
#include "walk.cuh"

// pnew_slots, j1_slots: the block copies of Pnew and J1 (f64), 0 where the
// wrapper's plan gives the map none
template <bool kMulti, bool kH2, bool kExtra, bool kAllph>
__global__ void fly_cartesian_kernel(Lanes s, int B, int max_steps, FlightParams p,
                                     int pnew_slots, int j1_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float oor = 0.0f, esc1 = 0.0f, esc2 = 0.0f;
  const bool lyb = kMulti && p.line.line_type == 8;
  // the shearing box and the segment deposits (the kExtra instances)
  const bool shear = kExtra && p.omega_shear != 0.0f;
  const JpaBins& q = p.jpa;
  const bool deposit = kExtra && (q.J1 || q.Pnew);
  double* pnew_copy = lart_block_copy;
  double* j1_copy = lart_block_copy + pnew_slots;
  if (kExtra) {
    block_copy_zero(pnew_copy, pnew_slots);
    block_copy_zero(j1_copy, j1_slots);
  }
  // the lane's pending deposit: its bin (-1 none) and frequency bin (-1 off
  // the frequency grid), and its J1 and Pnew sums there
  int pend_bp = -1, pend_fx = -1;
  double pend_j1 = 0.0, pend_pn = 0.0;
  // the all-photons table's death rows (the kAllph instances)
  const bool allph = kAllph;
  int phase = i < B ? s.phase[i] : DEAD;
  if (phase == FLYING || phase == FFS) {
    // the H-alpha band (line type 8), constant through a flight
    const bool b2 = lyb && s.iband[i] == 2;
    float pos[3] = {s.x[i], s.y[i], s.z[i]};
    float dir[3] = {s.kx[i], s.ky[i], s.kz[i]};
    int cell[3] = {s.ic[i], s.jc[i], s.kc[i]};
    float xfreq = s.xfreq[i], wgt = s.wgt[i];
    float tau_target = s.tau_target[i], tau_run = s.tau_run[i];
    float vfy = shear ? s.vfy_shear[i] : 0.0f;
    for (int n = 0; n < max_steps && (phase == FLYING || phase == FFS); ++n) {
      const bool is_ffs = phase == FFS;
      const int f = flat_index(p, cell[0], cell[1], cell[2]);
      float a_c, D_c, rhoH = 0.0f;
      cell_a_D(p, f, a_c, D_c);
      const float rho =
          b2 ? band2_opacity(p, f) : cell_opacity<kMulti, kH2>(p, f, xfreq, a_c, D_c, rhoH);
      float t[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        t[a] = p.walk[a] ? face_dist(pos[a], dir[a], cell[a], p.amin[a], p.d[a]) : LART_BIG;
      const float dmin = fminf(fminf(t[0], t[1]), t[2]);
      const int axis = dmin == t[0] ? 0 : (dmin == t[1] ? 1 : 2);
      const float tgt = is_ffs ? FFS_TAU_CAP : tau_target;
      const float dtau = dmin * rho;
      const bool hit = tau_run + dtau >= tgt;
      const float d_adv = hit ? (tgt - tau_run) / fmaxf(rho, LART_TINY) : dmin;
      float npos[3], ndir[3];
      int ncell[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        npos[a] = fmaf(d_adv, dir[a], pos[a]);
        ndir[a] = dir[a];
        ncell[a] = cell[a];
      }
      const float tau_n = hit ? tgt : tau_run + dtau;
      if (deposit && rhoH > 0.0f) {
        // the segment's deposits at its cell's bin (engine.py:1199-1219): J1
        // at the cell's comoving frequency x D / D_ref, Pnew over
        // rhokap_phys = rhokap D / cross0; they add to the pending deposit,
        // which goes to the maps by plain atomics when either bin changes
        const int bp = jpa_bin(q, cell[0], cell[1], cell[2]);
        int fxi = -1;
        if (q.J1) {
          const float fx = floorf((xfreq * (D_c / p.Dfreq) - p.xfreq_min) / p.dxfreq);
          if (fx >= 0.0f && fx < (float)p.nxfreq) fxi = (int)fx;
        }
        if (bp != pend_bp || fxi != pend_fx) {
          if (pend_bp >= 0) {
            if (pend_fx >= 0) atomicAdd(&q.J1[pend_fx * q.nbin + pend_bp], pend_j1);
            if (q.Pnew) atomicAdd(&q.Pnew[pend_bp], pend_pn);
          }
          pend_bp = bp;
          pend_fx = fxi;
          pend_j1 = 0.0;
          pend_pn = 0.0;
        }
        if (fxi >= 0) pend_j1 += (double)(d_adv * wgt);
        if (q.Pnew) {
          const float rkp = p.rhokap[f] * D_c / q.cross0;
          pend_pn += (double)(d_adv * rhoH * wgt / fmaxf(rkp, LART_TINY));
        }
      }
      bool escaped = false;
      if (!hit) escaped = cross_axis(p, axis, ncell[axis], npos[axis], ndir[axis]);
      // the shearing box: a periodic x wrap moves vfy by -+ omega_shear
      // (engine.py:1250-1257)
      float shear_new = vfy;
      if (shear && !hit && axis == 0) {
        const int nxt = cell[0] + (dir[0] > 0.0f ? 1 : -1);
        if (nxt < 0) shear_new = vfy - p.omega_shear;
        if (nxt >= p.n[0]) shear_new = vfy + p.omega_shear;
      }
      // an atmosphere's destruction: the bottom face of a plane one, a
      // masked core cell of a spherical one
      const bool bottom = p.atmosphere == 1 && escaped && axis == 2 && ncell[2] < 0;
      const bool hitmask = p.mask && !hit && !escaped &&
                           p.mask[flat_index(p, ncell[0], ncell[1], ncell[2])] != 0;
      // velocity of the cell being left, along the direction flown (in a
      // shearing box with the shear frame's, fma(vfy, ky, u): engine.py:
      // 1288-1290, :1312-1313)
      float u_old = p.moving ? vel_dot(p, cell, dir) : 0.0f;
      if (shear) u_old = fmaf(vfy, dir[1], u_old);
      const bool comoving = p.moving || p.cell_D || shear;

      if (is_ffs && (escaped || hit || hitmask)) {
        // forced first scattering done: the escaped fraction at the birth
        // lab frequency (birth cell, birth direction), then restart from
        // birth with wgt *= 1 - exp(-tau0); a birth ray ending in the core
        // escapes nothing
        const float tau0 = hitmask ? FFS_TAU_CAP : tau_n;
        const int bcell[3] = {s.bic[i], s.bjc[i], s.bkc[i]};
        const float bdir[3] = {s.bkx[i], s.bky[i], s.bkz[i]};
        const float bxfreq = s.bxfreq[i];
        const float u_b = p.moving ? vel_dot(p, bcell, bdir) : 0.0f;
        const float D_b = cell_D_of(p, flat_index(p, bcell[0], bcell[1], bcell[2]));
        const float wgt_esc = wgt * expf(-tau0);
        const float xlab_b = (bxfreq + u_b) * (D_b / p.Dfreq);
        const float w_oor = tally_out(p, p.Jout, xlab_b, bdir[2], wgt_esc);
        oor += w_oor;
        if (lyb && w_oor == 0.0f) esc1 += wgt_esc;
        const float wgt1 = -expm1f(-tau0);
        phase = tau0 <= 0.0f ? DEAD : FLYING;
        pos[0] = s.bx[i];
        pos[1] = s.by[i];
        pos[2] = s.bz[i];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          cell[a] = bcell[a];
          dir[a] = bdir[a];
        }
        xfreq = bxfreq;
        wgt = wgt * wgt1;
        tau_run = 0.0f;
        vfy = 0.0f;  // restarts unsheared (engine.py:1406-1409)
        // xi clamp margin 1e-5 (engine.py:1415-1428)
        tau_target = -log1pf(-fminf(tau_target, 0.99999f) * wgt1);
        // born in vacuum: dead, its row at the birth lab frequency
        if (allph && phase == DEAD) allph_death(p.allph, s, i, pos, dir, wgt, xlab_b);
        continue;
      }
      // the lab frequency of the cell being left (the H-alpha band's is its
      // own), where an escape or a destruction is binned
      const float xlab = b2 ? xfreq : (xfreq + u_old) * (D_c / p.Dfreq);
      if (allph && phase == FLYING && (escaped || hitmask))
        allph_death(p.allph, s, i, npos, ndir, wgt, xlab);
      if (phase == FLYING && (bottom || hitmask)) {
        // destroyed into Jabs2 at the lab frequency of the cell being left;
        // a lane entering the core takes the cell's comoving frequency, as
        // lart_tpu's state does
        oor += tally_bin(p, p.Jabs2, xlab, wgt);
        phase = DEAD;
        if (hitmask && comoving) {
          float u2 = p.moving ? vel_dot(p, ncell, ndir) : 0.0f;
          if (shear) u2 = fmaf(shear_new, ndir[1], u2);
          const float D2 = cell_D_of(p, flat_index(p, ncell[0], ncell[1], ncell[2]));
          xfreq = (xfreq + u_old) * D_c / D2 - u2;
        }
      } else if (escaped && phase == FLYING) {
        // escape, binned at the lab frequency of the cell being left (the
        // H-alpha band's frequency is a lab one)
        if (b2) {
          oor += tally_out(p, p.Jout_Ha, xlab, dir[2], wgt);
          esc2 += wgt;
        } else {
          oor += tally_out(p, p.Jout, xlab, dir[2], wgt);
          if (lyb) esc1 += wgt;
        }
        phase = DEAD;
      } else if (hit) {
        phase = AT_SCATTER;
      } else if (!escaped && comoving && !b2) {
        // comoving frequency on a cell change, in a moving medium, at
        // non-uniform temperature or in a shearing box: x' = (x + u1) D1/D2
        // - u2
        float u2 = p.moving ? vel_dot(p, ncell, ndir) : 0.0f;
        if (shear) u2 = fmaf(shear_new, ndir[1], u2);
        const float D2 = cell_D_of(p, flat_index(p, ncell[0], ncell[1], ncell[2]));
        xfreq = (xfreq + u_old) * D_c / D2 - u2;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        pos[a] = npos[a];
        dir[a] = ndir[a];
        cell[a] = ncell[a];
      }
      tau_run = tau_n;
      vfy = shear_new;
    }
    s.phase[i] = phase;
    s.x[i] = pos[0];
    s.y[i] = pos[1];
    s.z[i] = pos[2];
    s.kx[i] = dir[0];
    s.ky[i] = dir[1];
    s.kz[i] = dir[2];
    s.ic[i] = cell[0];
    s.jc[i] = cell[1];
    s.kc[i] = cell[2];
    s.xfreq[i] = xfreq;
    s.wgt[i] = wgt;
    s.tau_target[i] = tau_target;
    s.tau_run[i] = tau_run;
    if (shear) s.vfy_shear[i] = vfy;
  }
  if (deposit) {
    // the last pending deposits through the warp level and the block
    // copies (lart.cuh deposit_aggregated), the copies zeroed at the top
    double* J1 = q.J1;
    double* Pnew = q.Pnew;
    if (pnew_slots || j1_slots) __syncthreads();
    if (Pnew)
      deposit_aggregated(pend_bp, pend_pn, [Pnew](int b) { return &Pnew[b]; }, pnew_copy,
                         pnew_slots);
    if (J1)
      deposit_aggregated(pend_bp >= 0 && pend_fx >= 0 ? pend_fx * q.nbin + pend_bp : -1,
                         pend_j1, [J1](int b) { return &J1[b]; }, j1_copy, j1_slots);
  }
  block_sum_atomic(oor, p.W_oor);
  if (lyb) {
    block_sum_atomic(esc1, p.W_esc1);
    block_sum_atomic(esc2, p.W_esc2);
  }
}

LART_API int lart_flight_params_size() { return (int)sizeof(FlightParams); }

// pnew_slots, j1_slots: the block plan of the Pnew and J1 deposits
// (transport/fly_cartesian.py deposit_plan), 8 (pnew_slots + j1_slots)
// bytes of dynamic shared memory a block
LART_API int lart_fly_cartesian(void* const* lanes, int B, int max_steps,
                                const FlightParams* p, int pnew_slots, int j1_slots,
                                void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    const size_t smem = 8 * ((size_t)pnew_slots + (size_t)j1_slots);
    const Lanes s = unpack_lanes(lanes);
    cudaStream_t st = (cudaStream_t)stream;
    const bool multi = p->line.line_type != 1, h2 = p->h2.n_lines > 0;
    const bool extra = p->omega_shear != 0.0f || p->jpa.J1 || p->jpa.Pnew;
    const bool allph = p->allph.rp != nullptr;
    const int inst = (multi ? 8 : 0) + (h2 ? 4 : 0) + (extra ? 2 : 0) + (allph ? 1 : 0);
    // one instance a combination: the line type (kMulti), H2 (kH2), the
    // shearing box or the J1/Pnew deposits (kExtra), the all-photons table
    // (kAllph)
    switch (inst) {
#define LART_FLY_CARTESIAN(M, H, E, A)                                                   \
  case (M ? 8 : 0) + (H ? 4 : 0) + (E ? 2 : 0) + (A ? 1 : 0):                             \
    fly_cartesian_kernel<M, H, E, A><<<blocks, threads, smem, st>>>(s, B, max_steps, *p,  \
                                                                    pnew_slots, j1_slots); \
    break;
#define LART_FLY_CARTESIAN_2(M, H, E) \
  LART_FLY_CARTESIAN(M, H, E, false)  \
  LART_FLY_CARTESIAN(M, H, E, true)
      LART_FLY_CARTESIAN_2(false, false, false)
      LART_FLY_CARTESIAN_2(false, false, true)
      LART_FLY_CARTESIAN_2(false, true, false)
      LART_FLY_CARTESIAN_2(false, true, true)
      LART_FLY_CARTESIAN_2(true, false, false)
      LART_FLY_CARTESIAN_2(true, false, true)
      LART_FLY_CARTESIAN_2(true, true, false)
      LART_FLY_CARTESIAN_2(true, true, true)
#undef LART_FLY_CARTESIAN_2
#undef LART_FLY_CARTESIAN
    }
  }
  return (int)cudaGetLastError();
}
