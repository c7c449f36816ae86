// K4 scatter_lya: resonant scattering of Ly-alpha (line_type 1) without dust,
// H2 or recoil, with or without core-skip, Stokes and the peel record.
//
// Replaces lart_tpu/transport/engine.py:1838 make_scatter / :2087 scatter
// (the line_type 1 branch of redistribute, :1947-1953).  The TPU runs
// scatter_rounds masked rejection rounds of the u_par sampler over the whole
// batch; here each thread runs the rounds for its own lane and stops at the
// first acceptance (the later rounds' uniforms would be ignored anyway).  A
// lane still rejected after the rounds stays AT_SCATTER and retries next
// cycle, as on the TPU (`done`, :2438).  Uniforms come from Philox keyed by
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
// lane (1 where this call scattered), and a scattered lane's pre-scatter
// direction with xfreq_atom and the atom velocity (engine.py:2207-2218),
// with Stokes also its triad and Stokes vector, which K7 reads next.
// Bound: arithmetic (tan/atan2/log/exp per round, pow/cos/sin after), with
// the state read and written once (about 60 bytes a scattering lane, 100
// with Stokes, plus 28 of record, 64 with Stokes).
#include "lart.cuh"
#include "philox.cuh"
#include "samplers.cuh"

enum { CORE_SKIP_OFF = 0, CORE_SKIP_LOCAL = 1, CORE_SKIP_GLOBAL = 2 };

struct CoreSkip {
  int mode;
  float xcrit, xcrit2;  // CORE_SKIP_GLOBAL
  float rk_const;       // > 0: the uniform sphere's rhokap, else gather
  const float* rhokap;  // flat (nx, ny, nz)
  int n[3];
  float amin[3], d[3];
};

// the in-core boost xcrit^2 of lane i, or 0 outside the core
__device__ inline float core_boost(const CoreSkip& c, const Lanes& s, int i, float xfreq,
                                   float a) {
  if (c.mode == CORE_SKIP_OFF) return 0.0f;
  float xc = c.xcrit, xc2 = c.xcrit2;
  if (c.mode == CORE_SKIP_LOCAL) {
    const float pos[3] = {s.x[i], s.y[i], s.z[i]};
    const int cell[3] = {s.ic[i], s.jc[i], s.kc[i]};
    float dl = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float f = c.amin[k] + (float)cell[k] * c.d[k];
      const float dla = fminf(pos[k] - f, f + c.d[k] - pos[k]);
      dl = k == 0 ? dla : fminf(dl, dla);
    }
    float rk = c.rk_const;
    if (!(rk > 0.0f)) {
      const int f = (cell[0] * c.n[1] + cell[1]) * c.n[2] + cell[2];
      rk = c.rhokap[min(max(f, 0), c.n[0] * c.n[1] * c.n[2] - 1)];
    }
    const float atau = a * rk * fmaxf(dl, 0.0f);
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

// the event as the resonance peel reads it: before the turn; the triad and
// the Stokes vector only where the peel reads them, with Stokes
__device__ inline void write_record(const PeelRecord& r, const Lanes& s, int i,
                                    float xatom, float ux, float uy, float uz,
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
  r.xatom[i] = xatom;
  r.ux[i] = ux;
  r.uy[i] = uy;
  r.uz[i] = uz;
}

struct LineWeights {
  float E1, E2, E3;
  int stokes;
};

__global__ void scatter_lya_kernel(Lanes s, PeelRecord rec, int B, uint32_t seed,
                                   uint32_t counter, int rounds, float a, LineWeights lw,
                                   CoreSkip cs, float* nscatt_gas, float* nscatt_events) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float w_sum = 0.0f, n_sum = 0.0f;
  bool done = false;
  if (i < B && s.phase[i] == AT_SCATTER) {
    const float xfreq = s.xfreq[i];
    const VzEnv env = vz_envelope(xfreq, a);
    float u[4];
    float uz = 0.0f;
    bool acc = false;
    for (int r = 0; r < rounds && !acc; ++r) {
      uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)r, u);
      acc = vz_round(u, env, &uz);
    }
    if (acc) {
      uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)rounds, u);
      const float cost = rand_resonance_cost(u[0], lw.E1);
      const float cost2 = cost * cost;
      const float sint = sqrtf(fmaxf(1.0f - cost2, 0.0f));
      float phi = LART_TWOPI * u[1];
      float S11 = 0.0f, S12 = 0.0f, S22 = 0.0f, S33 = 0.0f, S44 = 0.0f;
      if (lw.stokes) {
        // azimuth by rejection from 1 + (S12/S11)(Q cos 2phi + U sin 2phi)
        // (engine.py:2165-2190), round r from block rounds + 2 + r
        S22 = 0.75f * lw.E1 * (cost2 + 1.0f);
        S11 = S22 + lw.E2;
        S12 = 0.75f * lw.E1 * (cost2 - 1.0f);
        S33 = 1.5f * lw.E1 * cost;
        S44 = 1.5f * lw.E3 * cost;
        const float S12o = S12 / fmaxf(S11, LART_TINY);
        const float Q = s.Q[i], U = s.U[i];
        const float pmag = sqrtf(Q * Q + U * U);
        acc = false;
        for (int r = 0; r < rounds && !acc; ++r) {
          float v[4];
          uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(rounds + 2 + r),
                    v);
          const float phi_p = LART_TWOPI * v[0];
          const float prand = (1.0f + fabsf(S12o) * pmag) * v[1];
          const float pcomp =
              1.0f + S12o * (Q * cosf(2.0f * phi_p) + U * sinf(2.0f * phi_p));
          if (prand <= pcomp) {
            phi = phi_p;
            acc = true;
          }
        }
      }
      if (acc) {
        const float cosp = cosf(phi), sinp = sinf(phi);
        const float phi2 = LART_TWOPI * u[2];
        const float uxy = sqrtf(core_boost(cs, s, i, xfreq, a) - logf(u[3]));
        const float ux = uxy * cosf(phi2), uy = uxy * sinf(phi2);
        const float xfreq_atom = xfreq - uz;
        const float xfreq_new = xfreq_atom + uz * cost + (ux * cosp + uy * sinp) * sint;
        if (rec.flag) write_record(rec, s, i, xfreq_atom, ux, uy, uz, lw.stokes);
        if (lw.stokes) {
          stokes_turn(s, i, cost, sint, cosp, sinp, S11, S12, S22, S33, S44);
        } else {
          float kx = s.kx[i], ky = s.ky[i], kz = s.kz[i];
          rotate_direction(kx, ky, kz, cost, sint, cosp, sinp);
          s.kx[i] = kx;
          s.ky[i] = ky;
          s.kz[i] = kz;
        }
        uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(rounds + 1), u);
        s.phase[i] = FLYING;
        s.xfreq[i] = xfreq_new;
        s.tau_target[i] = -logf(fmaxf(u[0], 1e-12f));
        s.tau_run[i] = 0.0f;
        w_sum = s.wgt[i];
        n_sum = 1.0f;
        done = true;
      }
    }
  }
  if (rec.flag && i < B) rec.flag[i] = done ? 1 : 0;
  block_sum_atomic(w_sum, nscatt_gas);
  block_sum_atomic(n_sum, nscatt_events);
}

// record: the PeelRecord pointer table, or null with peel-off off
LART_API int lart_scatter_lya(void* const* lanes, void* const* record, int B, unsigned seed,
                              unsigned counter, int rounds, float a, float E1, int stokes,
                              float E2, float E3, int core_skip, float xcrit, float xcrit2,
                              float rk_const, const void* rhokap, int nx, int ny, int nz,
                              float xmin, float ymin, float zmin, float dx, float dy,
                              float dz, void* nscatt_gas, void* nscatt_events,
                              void* stream) {
  if (B > 0) {
    const CoreSkip cs = {core_skip, xcrit,         xcrit2,        rk_const,
                         (const float*)rhokap, {nx, ny, nz}, {xmin, ymin, zmin},
                         {dx, dy, dz}};
    const LineWeights lw = {E1, E2, E3, stokes};
    const int threads = 256;
    scatter_lya_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        unpack_lanes(lanes), unpack_record(record), B, seed, counter, rounds, a, lw, cs,
        (float*)nscatt_gas, (float*)nscatt_events);
  }
  return (int)cudaGetLastError();
}
