// K9 fly_clump_dense and K10 fly_clump_csr: the clump-medium flights.
//
// K9 replaces lart_tpu/transport/engine.py:3076 make_fly_clump_dense, K10
// :3342 make_fly_clump (seg_and_next :3380, overlap_segment :3441,
// overlap_scatter_dist :3510), without atmospheres; csrc/clump.cuh holds the lookups they share with K2, K4 and K7.  Photons
// carry global frequencies in reference Doppler units; clump n's opacity at
// a lane is rhokap_n H_eff((x - u_n) r_loc; a_cl, D_cl) (line.cuh, two
// instances by kMulti) + rhokapD_n.  An escape is binned at the lane's
// frequency, a completed forced first scattering (FFS) at its birth
// frequency along its birth direction; escapes go to Jout/Jmu by f32 atomics,
// out-of-grid weight through a block sum.  At most max_steps steps a call (the
// while_loop's n < max_steps); a lane that completes its FFS restarts from
// birth within the same budget.  Every expression keeps lart_tpu's order of
// f32 operations, with the fused multiply-adds of clump.cuh, as the plain
// versions (transport/fly_clump.py) compute them.  No random numbers.
// With save_all_photons (the kAllph instances, the table's pointer non-null;
// csrc/allph.cuh) a lane that dies writes its death row at once (engine.py:
// 3302-3327, :3684-3711): an escape at the lane's global frequency, a forced
// first scattering born in vacuum at its birth frequency; a run without the
// table runs the instances without it.
//
// K9, one thread a lane, resolves a flight in one step: the optical depth to
// distance t along the ray is F(t) = sum_n k_n |chord_n ^ [0, t]| over all N
// clumps in index order.  The TPU materialises (B, N) chord arrays and reads
// them again in each of its 12 bisection rounds; here a block stages the N
// clumps' fields in shared memory (up to 9 f32 a clump: 36 KB at N = 1024),
// and a thread tests its ray against all N once, keeping the chords it
// crosses (t0, t1, k, in index order) in a short local list, from which each
// bisection round recomputes F; a chord the ray misses adds exactly 0, so F
// is the plain version's sum to the bit.  A ray crossing more chords than the
// list holds recomputes F from shared memory each round.  The scatter point
// is 12 bisection rounds of F = tau_need and one interpolation in the last
// bracket; an FFS lane completes from F(t_box).  In non-overlap mode the
// first clump whose chord holds the scatter point within the nudge becomes
// the lane's cell; in overlap mode the cell is -1 and K4 draws the owner.
//
// K10, one thread a lane, walks the CSR grid a segment a step.  Non-overlap:
// inside clump ic to its far intersection (ic becomes -1), in the vacuum to
// the nearest entry among the cell's K candidates (tin > eps) or across the
// cell's exit face plus eps.  Overlap: one CSR cell a step, its optical depth
// the candidates' chord overlaps clipped to [0, t_end] summed in table
// order; a scatter point inverts that piecewise-linear sum at its 2K
// breakpoints, sorted by insertion in registers (K <= CLUMP_K_MAX, checked
// by the host), where the TPU sorts (2K, B) arrays.
//
// Bound: K9 does ~17 flops a clump a lane-step (the chord test against all N
// clumps; the bisection reads only the crossed chords), ~3.3e3 flops a step
// at N = 195, so it is bound by operations; K10 by its dependent gathers (the
// cell's candidate row, then each candidate's centre, radius^2 and opacity),
// which the 1.48M-clump population's 251 MB of table and arrays keep far
// beyond the 50 MB L2.  A simple kernel first: no warp-shared candidate
// rows, no persistent walk.
#include "lart.cuh"
#include "voigt.cuh"

#define CLUMP_K_MAX 16
#define CLUMP_N_BISECT 12
#define CLUMP_CHORDS 24  // chords a K9 thread keeps for its bisection

// the distance along k to the face of the bounding cube [-R, R]^3
__device__ inline float box_exit(float R, const float pos[3], const float k[3]) {
  float t = LART_BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float ta = LART_BIG;
    if (!(fabsf(k[a]) < 1e-12f)) ta = fmaxf(((k[a] > 0.0f ? R : -R) - pos[a]) / k[a], 0.0f);
    t = a == 0 ? ta : fminf(t, ta);
  }
  return t;
}

// The FFS completion of both flights: the escaped fraction at the birth
// frequency, the restart from birth with wgt *= 1 - exp(-tau0) and the
// forced target -log(1 - xi wgt1) (engine.py:3227-3306), and where tau0 is 0
// (born in vacuum) the death row; returns the weight that fell outside the
// frequency grid.
template <bool kAllph>
__device__ inline float ffs_restart(const Lanes& s, int i, const FlightParams& p, float tau0,
                                    int& phase, float pos[3], float dir[3], int& ic,
                                    float& wgt, float& tau_run, float& tau_target) {
  const float bdir[3] = {s.bkx[i], s.bky[i], s.bkz[i]};
  const float oor = tally_out(p, p.Jout, s.bxfreq[i], bdir[2], wgt * expf(-tau0));
  const float wgt1 = -expm1f(-tau0);
  phase = tau0 <= 0.0f ? DEAD : FLYING;
  pos[0] = s.bx[i];
  pos[1] = s.by[i];
  pos[2] = s.bz[i];
#pragma unroll
  for (int a = 0; a < 3; ++a) dir[a] = bdir[a];
  ic = s.bic[i];
  wgt = wgt * wgt1;
  tau_run = 0.0f;
  // xi clamp margin 1e-5 (engine.py:3283-3295)
  tau_target = -log1pf(-fminf(tau_target, 0.99999f) * wgt1);
  if (kAllph && phase == DEAD) allph_death(p.allph, s, i, pos, dir, wgt, s.bxfreq[i]);
  return oor;
}

// The clumps of a K9 block, staged in shared memory.
struct DenseClumps {
  const float *x, *y, *z, *r2, *rk, *rkD, *vx, *vy, *vz;
};

// clump c's chord along the ray clipped to [0, t_box], and whether the ray
// crosses it (det > 0 and t1 > t0; a chord it misses adds exactly 0 to F)
__device__ inline bool dense_chord(const DenseClumps& c, int n, const float pos[3],
                                   const float k[3], float t_box, float& t0, float& t1) {
  const float px = pos[0] - c.x[n], py = pos[1] - c.y[n], pz = pos[2] - c.z[n];
  const float b = dot3f(px, k[0], py, k[1], pz, k[2]);
  const float cc = dot3f(px, px, py, py, pz, pz) - c.r2[n];
  const float det = fmaf(b, b, -cc);
  const float sq = sqrtf(fmaxf(det, 0.0f));
  t0 = fminf(fmaxf(-b - sq, 0.0f), t_box);
  t1 = fminf(fmaxf(-b + sq, 0.0f), t_box);
  return det > 0.0f;
}

// clump n's opacity at the lane: prof_s the static medium's profile (the
// same for every clump of a lane), else its own at (x - u_n vr) r_loc
template <bool kMulti>
__device__ inline float dense_kappa(const ClumpGrid& g, const LineC& line, const DenseClumps& c,
                                    int n, const float k[3], float xfreq, float prof_s) {
  float prof = prof_s;
  if (c.vx) {
    const float u = dot3f(c.vx[n], k[0], c.vy[n], k[1], c.vz[n], k[2]) * g.vr;
    prof = line_profile<kMulti>(line, (xfreq - u) * g.r_loc, g.a_cl, g.D_cl);
  }
  float kq = c.rk[n] * prof;
  if (c.rkD) kq = kq + c.rkD[n];
  return kq;
}

template <bool kMulti, bool kAllph>
__global__ void fly_clump_dense_kernel(Lanes s, int B, int max_steps, FlightParams p) {
  extern __shared__ float sh[];
  const ClumpGrid& g = p.clump;
  const int N = g.n;
  DenseClumps c;
  float* f = sh;
  const float* src[9] = {g.x, g.y, g.z, g.r2, g.rhokap, g.rhokapD, g.vx, g.vy, g.vz};
  const float** dst[9] = {&c.x, &c.y, &c.z, &c.r2, &c.rk, &c.rkD, &c.vx, &c.vy, &c.vz};
  for (int a = 0; a < 9; ++a) {
    if (!src[a]) {
      *dst[a] = nullptr;
      continue;
    }
    for (int j = threadIdx.x; j < N; j += blockDim.x) f[j] = __ldg(&src[a][j]);
    *dst[a] = f;
    f += N;
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float oor = 0.0f;
  int phase = i < B ? s.phase[i] : DEAD;
  if (phase == FLYING || phase == FFS) {
    float pos[3] = {s.x[i], s.y[i], s.z[i]};
    float dir[3] = {s.kx[i], s.ky[i], s.kz[i]};
    int ic = s.ic[i];
    const float xfreq = s.xfreq[i];
    float wgt = s.wgt[i];
    float tau_target = s.tau_target[i], tau_run = s.tau_run[i];
    float lt0[CLUMP_CHORDS], lt1[CLUMP_CHORDS], lkq[CLUMP_CHORDS];
    for (int n = 0; n < max_steps && (phase == FLYING || phase == FFS); ++n) {
      const bool is_ffs = phase == FFS;
      const float t_box = box_exit(g.R, pos, dir);
      const float prof_s =
          c.vx ? 0.0f : line_profile<kMulti>(p.line, xfreq * g.r_loc, g.a_cl, g.D_cl);
      // the chords the ray crosses, in index order, and their optical depth
      float tau_tot = 0.0f;
      int nl = 0;
      bool over = false;
      for (int m = 0; m < N; ++m) {
        float t0, t1;
        if (!dense_chord(c, m, pos, dir, t_box, t0, t1) || !(t1 > t0)) continue;
        const float kq = dense_kappa<kMulti>(g, p.line, c, m, dir, xfreq, prof_s);
        tau_tot = tau_tot + kq * (t1 - t0);
        if (nl < CLUMP_CHORDS) {
          lt0[nl] = t0;
          lt1[nl] = t1;
          lkq[nl] = kq;
          ++nl;
        } else {
          over = true;
        }
      }
      const float tgt = is_ffs ? FFS_TAU_CAP : tau_target;
      const float tau_need = tgt - tau_run;
      const bool hit = tau_tot >= tau_need;
      if (is_ffs) {
        // the forced first scattering completes in one pass: tau_tot is the
        // exact optical depth to the edge
        oor += ffs_restart<kAllph>(s, i, p, fminf(tau_run + tau_tot, FFS_TAU_CAP), phase, pos, dir, ic,
                           wgt, tau_run, tau_target);
        continue;
      }
      if (!hit) {
        oor += tally_out(p, p.Jout, xfreq, dir[2], wgt);
        phase = DEAD;
#pragma unroll
        for (int a = 0; a < 3; ++a) pos[a] = fmaf(t_box + g.eps_dense, dir[a], pos[a]);
        tau_run = tgt;
        if (kAllph) allph_death(p.allph, s, i, pos, dir, wgt, xfreq);
        continue;
      }
      // F(t) from the list (or, past its end, from every clump)
      auto depth_to = [&](float t) {
        float acc = 0.0f;
        if (!over) {
          for (int l = 0; l < nl; ++l) acc = acc + lkq[l] * fmaxf(fminf(t, lt1[l]) - lt0[l], 0.0f);
          return acc;
        }
        for (int m = 0; m < N; ++m) {
          float t0, t1;
          if (!dense_chord(c, m, pos, dir, t_box, t0, t1) || !(t1 > t0)) continue;
          const float kq = dense_kappa<kMulti>(g, p.line, c, m, dir, xfreq, prof_s);
          acc = acc + kq * fmaxf(fminf(t, t1) - t0, 0.0f);
        }
        return acc;
      };
      float lo = 0.0f, hi = t_box, Flo = 0.0f, Fhi = tau_tot;
      for (int r = 0; r < CLUMP_N_BISECT; ++r) {
        const float mid = 0.5f * (lo + hi);
        const float Fm = depth_to(mid);
        if (Fm < tau_need) {
          lo = mid;
          Flo = Fm;
        } else {
          hi = mid;
          Fhi = Fm;
        }
      }
      const float frac =
          fminf(fmaxf((tau_need - Flo) / fmaxf(Fhi - Flo, LART_TINY), 0.0f), 1.0f);
      const float d = fmaf(frac, hi - lo, lo);
      int owner = -1;
      if (!g.overlap) {
        // owner_at: the first clump whose chord holds d within the nudge
        for (int m = 0; m < N && owner < 0; ++m) {
          float t0, t1;
          if (!dense_chord(c, m, pos, dir, t_box, t0, t1)) continue;
          if (t0 - g.eps_dense <= d && d <= t1 + g.eps_dense &&
              dense_kappa<kMulti>(g, p.line, c, m, dir, xfreq, prof_s) > 0.0f)
            owner = m;
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) pos[a] = fmaf(d, dir[a], pos[a]);
      ic = owner;
      phase = AT_SCATTER;
      tau_run = tgt;
    }
    s.phase[i] = phase;
    s.x[i] = pos[0];
    s.y[i] = pos[1];
    s.z[i] = pos[2];
    s.kx[i] = dir[0];
    s.ky[i] = dir[1];
    s.kz[i] = dir[2];
    s.ic[i] = ic;
    s.wgt[i] = wgt;
    s.tau_target[i] = tau_target;
    s.tau_run[i] = tau_run;
  }
  block_sum_atomic(oor, p.W_oor);
}

template <bool kMulti, bool kAllph>
__global__ void fly_clump_csr_kernel(Lanes s, int B, int max_steps, FlightParams p) {
  const ClumpGrid& g = p.clump;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float oor = 0.0f;
  int phase = i < B ? s.phase[i] : DEAD;
  if (phase == FLYING || phase == FFS) {
    float pos[3] = {s.x[i], s.y[i], s.z[i]};
    float dir[3] = {s.kx[i], s.ky[i], s.kz[i]};
    int ic = s.ic[i];
    const float xfreq = s.xfreq[i];
    float wgt = s.wgt[i];
    float tau_target = s.tau_target[i], tau_run = s.tau_run[i];
    for (int n = 0; n < max_steps && (phase == FLYING || phase == FFS); ++n) {
      const bool is_ffs = phase == FFS;
      const float tgt = is_ffs ? FFS_TAU_CAP : tau_target;
      float dtau, d_adv;
      bool hit;
      int ic_after = -1;
      if (g.overlap) {
        int cell;
        const float t_end = clump_cell_exit(g, pos, dir, cell) + g.eps_csr;
        float q0[CLUMP_K_MAX], q1[CLUMP_K_MAX], qk[CLUMP_K_MAX];
        dtau = 0.0f;
        for (int q = 0; q < g.K; ++q) {
          const int cq = clump_candidate(g, cell, q);
          const float det = clump_cand_chord(g, cq, pos, dir, t_end, q0[q], q1[q]);
          qk[q] = 0.0f;
          if (cq >= 0 && det > 0.0f) {
            const float u = clump_vel_dot(g, cq, dir, CLUMP_U_VR);
            qk[q] = clump_kappa<kMulti>(g, p.line, cq, (xfreq - u) * g.r_loc);
          }
          dtau = fmaf(qk[q], q1[q] - q0[q], dtau);
        }
        hit = tau_run + dtau >= tgt;
        d_adv = t_end;
        if (hit) {
          // invert F(t) = sum_q k_q max(min(t, t1_q) - t0_q, 0) at its 2K
          // breakpoints, sorted ascending
          const float tau_need = tgt - tau_run;
          float tb[2 * CLUMP_K_MAX];
          const int nb = 2 * g.K;
          for (int j = 0; j < nb; ++j) {
            const float v = j < g.K ? q0[j] : q1[j - g.K];
            int m = j;
            while (m > 0 && tb[m - 1] > v) {
              tb[m] = tb[m - 1];
              --m;
            }
            tb[m] = v;
          }
          float F0 = 0.0f, Fprev = 0.0f, Fj = 0.0f;
          int jf = 0;
          for (int j = 0; j < nb; ++j) {
            Fj = 0.0f;
            for (int q = 0; q < g.K; ++q) Fj = Fj + qk[q] * fmaxf(fminf(tb[j], q1[q]) - q0[q], 0.0f);
            if (j == 0) F0 = Fj;
            if (Fj >= tau_need) {
              jf = j;
              break;
            }
            Fprev = Fj;
          }
          float d;
          if (jf == 0) {
            d = tb[0] * fminf(fmaxf(tau_need / fmaxf(F0, LART_TINY), 0.0f), 1.0f);
          } else {
            const float frac =
                fminf(fmaxf((tau_need - Fprev) / fmaxf(Fj - Fprev, LART_TINY), 0.0f), 1.0f);
            d = fmaf(frac, fmaxf(tb[jf] - tb[jf - 1], 0.0f), tb[jf - 1]);
          }
          d_adv = fminf(fmaxf(d, 0.0f), t_end);
        }
      } else {
        // the clump's opacity at its local frequency (none in the vacuum)
        const bool inside = ic >= 0;
        float kap = 0.0f, t_seg;
        if (inside) {
          const float u = clump_vel_dot(g, ic, dir, CLUMP_U_SCALE);
          kap = clump_kappa<kMulti>(g, p.line, ic, (xfreq - u) * g.r_loc);
          // its far intersection
          float b, det;
          clump_chord(g, ic, pos, dir, b, det);
          t_seg = -b + sqrtf(fmaxf(det, 0.0f));
        } else {
          // the nearest entry among the cell's candidates, else its face
          int cell;
          const float t_cell = clump_cell_exit(g, pos, dir, cell);
          float t_entry = LART_BIG;
          for (int q = 0; q < g.K; ++q) {
            const int cq = clump_candidate(g, cell, q);
            if (cq < 0) continue;
            float b, det;
            clump_chord(g, cq, pos, dir, b, det);
            const float tin = -b - sqrtf(fmaxf(det, 0.0f));
            if (det > 0.0f && tin > g.eps_csr && tin <= t_cell + g.eps_csr && tin < t_entry) {
              t_entry = tin;
              ic_after = cq;
            }
          }
          t_seg = t_entry < LART_BIG ? t_entry : t_cell + g.eps_csr;
        }
        dtau = t_seg * kap;
        hit = tau_run + dtau >= tgt;
        d_adv = hit ? (tgt - tau_run) / fmaxf(kap, LART_TINY) : t_seg + g.eps_csr;
      }
      float npos[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) npos[a] = fmaf(d_adv, dir[a], pos[a]);
      const float tau_n = hit ? tgt : tau_run + dtau;
      const bool escaped =
          !hit && (fabsf(npos[0]) >= g.R || fabsf(npos[1]) >= g.R || fabsf(npos[2]) >= g.R);
      if (is_ffs && (escaped || hit)) {
        oor += ffs_restart<kAllph>(s, i, p, tau_n, phase, pos, dir, ic, wgt, tau_run, tau_target);
        continue;
      }
      if (hit) {
        phase = AT_SCATTER;
      } else {
        ic = ic_after;  // an escaping lane's too, as lart_tpu's
        if (escaped) {
          oor += tally_out(p, p.Jout, xfreq, dir[2], wgt);
          phase = DEAD;
          if (kAllph) allph_death(p.allph, s, i, npos, dir, wgt, xfreq);
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) pos[a] = npos[a];
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
    s.wgt[i] = wgt;
    s.tau_target[i] = tau_target;
    s.tau_run[i] = tau_run;
  }
  block_sum_atomic(oor, p.W_oor);
}

LART_API int lart_clump_grid_size() { return (int)sizeof(ClumpGrid); }

// the shared memory of a K9 block: the clump fields present, N each
static size_t dense_shared_bytes(const ClumpGrid& g) {
  const int fields = 5 + (g.rhokapD ? 1 : 0) + (g.vx ? 3 : 0);
  return (size_t)fields * g.n * sizeof(float);
}

LART_API int lart_fly_clump_dense(void* const* lanes, int B, int max_steps, const FlightParams* p,
                                  void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    const size_t shm = dense_shared_bytes(p->clump);
    cudaStream_t st = (cudaStream_t)stream;
    const Lanes s = unpack_lanes(lanes);
    // one instance a combination: the line type (kMulti), the all-photons
    // table (kAllph)
    switch ((p->line.line_type != 1 ? 2 : 0) + (p->allph.rp ? 1 : 0)) {
#define LART_DENSE(M, A)                                                                  \
  case (M ? 2 : 0) + (A ? 1 : 0):                                                          \
    cudaFuncSetAttribute(fly_clump_dense_kernel<M, A>,                                     \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);           \
    fly_clump_dense_kernel<M, A><<<blocks, threads, shm, st>>>(s, B, max_steps, *p);     \
    break;
      LART_DENSE(false, false)
      LART_DENSE(false, true)
      LART_DENSE(true, false)
      LART_DENSE(true, true)
#undef LART_DENSE
    }
  }
  return (int)cudaGetLastError();
}

LART_API int lart_fly_clump_csr(void* const* lanes, int B, int max_steps, const FlightParams* p,
                                void* stream) {
  if (B > 0) {
    if (p->clump.overlap && p->clump.K > CLUMP_K_MAX) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    const Lanes s = unpack_lanes(lanes);
    switch ((p->line.line_type != 1 ? 2 : 0) + (p->allph.rp ? 1 : 0)) {
#define LART_CSR(M, A)                                                              \
  case (M ? 2 : 0) + (A ? 1 : 0):                                                    \
    fly_clump_csr_kernel<M, A><<<blocks, threads, 0, st>>>(s, B, max_steps, *p);   \
    break;
      LART_CSR(false, false)
      LART_CSR(false, true)
      LART_CSR(true, false)
      LART_CSR(true, true)
#undef LART_CSR
    }
  }
  return (int)cudaGetLastError();
}
