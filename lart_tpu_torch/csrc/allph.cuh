// The all-photons table of save_all_photons (lart_tpu/transport/engine.py:
// 149-214; the reference's all_photons_type, define.f90:602-613): one row per
// photon id, f32 columns on the device for the whole run.  K2 writes a
// photon's birth row (rp0, xfreq1) where it launches it, K4 and the flights
// K5, K8, K9 and K10 its death row (rp, xfreq2, its gas and dust scattering
// events, with Stokes I, Q, U, V) where it dies: plain stores, one row per
// id, guarded by the table's pointer (null with save_all_photons off).
// lart_tpu_torch/transport/allph.py AllPhC mirrors the struct; its plain
// versions compute the same fma chains, which are XLA's contraction of
// lart_tpu's sums of products on the CPU.
#pragma once

struct AllPh {
  float* rp0;     // the impact parameter of the birth ray
  float* rp;      //   and of the escape (or death) ray
  float* xfreq1;  // the comoving birth frequency
  float* xfreq2;  // the lab frequency at death
  float* nsg;     // gas (resonance) scattering events
  float* nsd;     // dust scattering events
  float* I;       // with Stokes: the weight and the Stokes vector in the
  float* Q;       //   frame of the impact-parameter vector; null else
  float* U;
  float* V;
  int n;          // rows: the run's photons
  int advance;    // rmax > 0: the ray is first advanced to the rmax sphere
  float rmax2;    // rmax^2, rounded to f32
};

// The impact parameter |m| of the ray p + t k and its vector m, after p is
// advanced to the rmax sphere where it lies outside it (impact_parameter,
// engine.py:172-190; make_all_photons, run_simulation_mod.f90:294-331).
__device__ inline float allph_impact(const AllPh& t, float x, float y, float z, float kx,
                                     float ky, float kz, float& mx, float& my, float& mz) {
  if (t.advance) {
    const float rr = fmaf(z, z, fmaf(x, x, y * y));
    const float rk = fmaf(z, kz, fmaf(x, kx, y * ky));
    const float det = fmaf(rk, rk, -(rr - t.rmax2));
    const float dist = rr > t.rmax2 && det >= 0.0f ? -rk + sqrtf(fmaxf(det, 0.0f)) : 0.0f;
    x = fmaf(dist, kx, x);
    y = fmaf(dist, ky, y);
    z = fmaf(dist, kz, z);
  }
  const float rk = fmaf(z, kz, fmaf(x, kx, y * ky));
  mx = fmaf(-rk, kx, x);
  my = fmaf(-rk, ky, y);
  mz = fmaf(-rk, kz, z);
  return sqrtf(fmaf(mz, mz, fmaf(mx, mx, my * my)));
}

// The birth row of photon id (engine.py:2890-2899).
__device__ inline void allph_birth(const AllPh& t, int id, float x, float y, float z, float kx,
                                   float ky, float kz, float xfreq) {
  if (id < 0 || id >= t.n) return;
  float mx, my, mz;
  t.rp0[id] = allph_impact(t, x, y, z, kx, ky, kz, mx, my, mz);
  t.xfreq1[id] = xfreq;
}

// The death row of lane i (allph_record_death, engine.py:193-214) at the
// position p, direction k and weight wgt it dies with, its lab frequency
// xfreq2; its counts, triad and Stokes vector are read from the lanes.
__device__ inline void allph_death(const AllPh& t, const Lanes& s, int i, const float p[3],
                                   const float k[3], float wgt, float xfreq2) {
  const int id = s.pid[i];
  if (id < 0 || id >= t.n) return;
  float mx, my, mz;
  const float mm = allph_impact(t, p[0], p[1], p[2], k[0], k[1], k[2], mx, my, mz);
  t.rp[id] = mm;
  t.xfreq2[id] = xfreq2;
  t.nsg[id] = s.nsg[i];
  t.nsd[id] = s.nsd[i];
  if (!t.I) return;
  // the Stokes vector in the frame of m (engine.py:204-214)
  const float mmi = 1.0f / fmaxf(mm, 1e-30f);
  const float cosp =
      mm > 0.0f ? fmaf(mz, s.mz[i], fmaf(mx, s.mx[i], my * s.my[i])) * mmi : 1.0f;
  const float sinp =
      mm > 0.0f ? fmaf(mz, s.nnz[i], fmaf(mx, s.nnx[i], my * s.nny[i])) * mmi : 0.0f;
  const float cos2p = fmaf(2.0f * cosp, cosp, -1.0f);
  const float sin2p = 2.0f * sinp * cosp;
  const float Q = s.Q[i], U = s.U[i];
  t.I[id] = wgt;
  t.Q[id] = fmaf(sin2p, U, cos2p * Q) * wgt;
  t.U[id] = fmaf(cos2p, U, -(sin2p * Q)) * wgt;
  t.V[id] = s.V[i] * wgt;
}
