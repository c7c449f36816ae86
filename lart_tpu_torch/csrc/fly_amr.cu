// K8 fly_amr: the octree AMR flight, one node crossing at a time: the exit
// face, the neighbor hop and the descent into the node entered (the fine
// map's one gather, or octant by octant), the per-leaf physics, and the
// comoving frequency update of a moving medium or a non-uniform temperature.
//
// Replaces lart_tpu/transport/engine.py:1507 make_fly_amr with :548
// amr_find_cell and :359 amr_descend_from_face (csrc/amr.cuh), without
// atmospheres or CALCJ/Pnew.  The TPU runs a
// lax.while_loop of at most max_steps iterations over the whole batch,
// each a batch of gathers; here one thread walks its own lane, at most
// max_steps crossings (the loop condition n < max_steps), so a forced first
// scattering that completes restarts from birth within the same budget, as
// the while_loop counts it.  A lane's cell index ic is an octree node (jc,
// kc unused); its leaf ileaf[ic] carries rhokap, rhokapD, the velocity and,
// at non-uniform temperature, the damping a and the Doppler width D (a gap
// cell has no gas and the reference a and D).  Each step: the node's
// opacity rhokap H_eff(x; a, D) (line.cuh, two instances by kMulti), + rhokap
// times the H2 multiplier (h2.cuh, kH2), + rhokapD; line type 8's H-alpha
// band sees rhokapD R_Ha only.  The exit face is the nearest of six (ties
// x, y, z; faces 0 = +x ... 5 = -z); the lane reaches its tau target
// (AT_SCATTER) or snaps the crossed coordinate to the face plane, hops to
// neighbor[ic][face] (none: it escapes) and descends to the node it enters.
// On a node change (band 1), with velocities or per-leaf D, x' = (x + u1)
// D1 / D2 - u2.  An escape is binned at (x + u) D / D_ref of the node left,
// a completed forced first scattering at its birth node's, along the birth
// direction.  Every expression keeps the JAX order; advanced positions are
// fused multiply-adds as XLA computes them (transport/flight.py).  Escapes
// go to Jout/Jmu with f32 atomics at once, out-of-grid weight and line type
// 8's band budgets through block sums.  With save_all_photons (the kAllph
// instances, the table's pointer non-null; csrc/allph.cuh) a lane that dies
// writes its death row at once (engine.py:1761-1796): an escape at the lab
// frequency of the node it leaves (the H-alpha band's own), a forced first
// scattering born in vacuum at its birth lab frequency; a run without the
// table runs the instances without it.
//
// Bound: dependent gathers.  A crossing reads its node's centre, half-width
// and leaf id (20 B), its leaf's physics (4-32 B), the neighbor id (4 B),
// and one fine-map voxel (4 B) or, without the map, up to levelmax + 1
// levels of leaf id, centre and child (20 B each); each read waits for the
// last.  The 3.06M-leaf sphere's arrays (~0.4 GB with its 256^3 map) far
// exceed the 50 MB L2, so a lane's first crossings into fresh nodes are
// DRAM-latency-bound; neighbouring lanes start near each other (Morton-
// ordered leaves), which shares some lines.  The lane state is read and
// written once a call.  A simple kernel first: no node caching in shared
// memory, no persistent walk.
#include "lart.cuh"
#include "voigt.cuh"
#include "walk.cuh"

template <bool kMulti, bool kH2, bool kAllph>
__global__ void fly_amr_kernel(Lanes s, int B, int max_steps, FlightParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float oor = 0.0f, esc1 = 0.0f, esc2 = 0.0f;
  const bool lyb = kMulti && p.line.line_type == 8;
  const AmrGrid& g = p.amr;
  // the comoving update runs in a moving medium or at non-uniform T
  const bool update = p.moving || g.Dfreq != nullptr;
  int phase = i < B ? s.phase[i] : DEAD;
  if (phase == FLYING || phase == FFS) {
    const bool b2 = lyb && s.iband[i] == 2;  // constant through a flight
    float pos[3] = {s.x[i], s.y[i], s.z[i]};
    float dir[3] = {s.kx[i], s.ky[i], s.kz[i]};
    int ic = s.ic[i];
    float xfreq = s.xfreq[i], wgt = s.wgt[i];
    float tau_target = s.tau_target[i], tau_run = s.tau_run[i];
    for (int n = 0; n < max_steps && (phase == FLYING || phase == FFS); ++n) {
      const bool is_ffs = phase == FFS;
      const int il = amr_leaf(g, ic);
      float a_c, D_c;
      leaf_a_D(p, il, a_c, D_c);
      const float rho =
          b2 ? leaf_band2_opacity(p, il) : leaf_opacity<kMulti, kH2>(p, il, xfreq, a_c, D_c);
      const int c = amr_clip_cell(g, ic);
      const float cen[3] = {__ldg(&g.node_cx[c]), __ldg(&g.node_cy[c]), __ldg(&g.node_cz[c])};
      const float h = __ldg(&g.node_ch[c]);
      float t[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) t[a] = node_face_dist(pos[a], dir[a], cen[a], h);
      const float dmin = fminf(fminf(t[0], t[1]), t[2]);
      const int axis = dmin == t[0] ? 0 : (dmin == t[1] ? 1 : 2);
      const int face = axis * 2 + (dir[axis] > 0.0f ? 0 : 1);
      const float tgt = is_ffs ? FFS_TAU_CAP : tau_target;
      const float dtau = dmin * rho;
      const bool hit = tau_run + dtau >= tgt;
      const float d_adv = hit ? (tgt - tau_run) / fmaxf(rho, LART_TINY) : dmin;
      float npos[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) npos[a] = fmaf(d_adv, dir[a], pos[a]);
      const float tau_n = hit ? tgt : tau_run + dtau;
      bool escaped = false;
      int ic_new = ic;
      if (!hit) {
        // snap to the face plane, hop across it, descend into the node
        npos[axis] = cen[axis] + (dir[axis] > 0.0f ? h : -h);
        const int nb = __ldg(&g.neighbor[c * 6 + face]);
        escaped = nb < 0;
        if (!escaped) ic_new = amr_descend_from_face(g, nb, face, npos[0], npos[1], npos[2]);
      }
      // the velocity of the node being left, along the direction flown
      const float u_old = p.moving ? leaf_vel_dot(p, il, dir) : 0.0f;

      if (is_ffs && (escaped || hit)) {
        // forced first scattering done: the escaped fraction at the birth
        // node's lab frequency along the birth direction, then restart from
        // birth with wgt *= 1 - exp(-tau0)
        const float tau0 = tau_n;
        const int bic = s.bic[i];
        const int ilb = amr_leaf(g, bic);
        float a_b, D_b;
        leaf_a_D(p, ilb, a_b, D_b);
        const float bdir[3] = {s.bkx[i], s.bky[i], s.bkz[i]};
        const float bxfreq = s.bxfreq[i];
        const float u_b = p.moving ? leaf_vel_dot(p, ilb, bdir) : 0.0f;
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
        for (int a = 0; a < 3; ++a) dir[a] = bdir[a];
        ic = bic;
        xfreq = bxfreq;
        wgt = wgt * wgt1;
        tau_run = 0.0f;
        // xi clamp margin 1e-5 (engine.py:1739-1750)
        tau_target = -log1pf(-fminf(tau_target, 0.99999f) * wgt1);
        // born in vacuum: dead, its row at the birth lab frequency
        if (kAllph && phase == DEAD) allph_death(p.allph, s, i, pos, dir, wgt, xlab_b);
        continue;
      }
      if (escaped && phase == FLYING) {
        // escape at the lab frequency of the node being left (the H-alpha
        // band's frequency is a lab one)
        const float xlab = b2 ? xfreq : (xfreq + u_old) * (D_c / p.Dfreq);
        if (b2) {
          oor += tally_out(p, p.Jout_Ha, xlab, dir[2], wgt);
          esc2 += wgt;
        } else {
          oor += tally_out(p, p.Jout, xlab, dir[2], wgt);
          if (lyb) esc1 += wgt;
        }
        phase = DEAD;
        if (kAllph) allph_death(p.allph, s, i, npos, dir, wgt, xlab);
      } else if (hit) {
        phase = AT_SCATTER;
      } else if (!escaped && update && !b2) {
        // comoving frequency on a node change: x' = (x + u1) D1/D2 - u2
        const int il2 = amr_leaf(g, ic_new);
        float a2, D2;
        leaf_a_D(p, il2, a2, D2);
        const float u2 = p.moving ? leaf_vel_dot(p, il2, dir) : 0.0f;
        xfreq = (xfreq + u_old) * D_c / D2 - u2;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) pos[a] = npos[a];
      if (!escaped) ic = ic_new;
      tau_run = tau_n;
    }
    s.phase[i] = phase;
    s.x[i] = pos[0];
    s.y[i] = pos[1];
    s.z[i] = pos[2];
    s.kx[i] = dir[0];
    s.ky[i] = dir[1];
    s.kz[i] = dir[2];
    s.ic[i] = ic;
    s.xfreq[i] = xfreq;
    s.wgt[i] = wgt;
    s.tau_target[i] = tau_target;
    s.tau_run[i] = tau_run;
  }
  block_sum_atomic(oor, p.W_oor);
  if (lyb) {
    block_sum_atomic(esc1, p.W_esc1);
    block_sum_atomic(esc2, p.W_esc2);
  }
}

LART_API int lart_amr_grid_size() { return (int)sizeof(AmrGrid); }

LART_API int lart_fly_amr(void* const* lanes, int B, int max_steps, const FlightParams* p,
                          void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    const Lanes s = unpack_lanes(lanes);
    cudaStream_t st = (cudaStream_t)stream;
    const bool multi = p->line.line_type != 1, h2 = p->h2.n_lines > 0;
    const bool allph = p->allph.rp != nullptr;
    // one instance a combination: the line type (kMulti), H2 (kH2), the
    // all-photons table (kAllph)
    switch ((multi ? 4 : 0) + (h2 ? 2 : 0) + (allph ? 1 : 0)) {
#define LART_FLY_AMR(M, H, A)                                                        \
  case (M ? 4 : 0) + (H ? 2 : 0) + (A ? 1 : 0):                                       \
    fly_amr_kernel<M, H, A><<<blocks, threads, 0, st>>>(s, B, max_steps, *p);       \
    break;
      LART_FLY_AMR(false, false, false)
      LART_FLY_AMR(false, false, true)
      LART_FLY_AMR(false, true, false)
      LART_FLY_AMR(false, true, true)
      LART_FLY_AMR(true, false, false)
      LART_FLY_AMR(true, false, true)
      LART_FLY_AMR(true, true, false)
      LART_FLY_AMR(true, true, true)
#undef LART_FLY_AMR
    }
  }
  return (int)cudaGetLastError();
}
