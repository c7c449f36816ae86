// K4 scatter_lya: resonant scattering of Ly-alpha (line_type 1) without dust,
// H2, Stokes, core-skip, recoil or peel-off.
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
// Bound: arithmetic (tan/atan2/log/exp per round, pow/cos/sin after), with
// the state read and written once (about 60 bytes a scattering lane).
#include "lart.cuh"
#include "philox.cuh"
#include "samplers.cuh"

__global__ void scatter_lya_kernel(Lanes s, int B, uint32_t seed, uint32_t counter,
                                   int rounds, float a, float E1, float* nscatt_gas,
                                   float* nscatt_events) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float w_sum = 0.0f, n_sum = 0.0f;
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
      const float cost = rand_resonance_cost(u[0], E1);
      const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
      const float phi = LART_TWOPI * u[1];
      const float cosp = cosf(phi), sinp = sinf(phi);
      const float phi2 = LART_TWOPI * u[2];
      const float uxy = sqrtf(0.0f - logf(u[3]));
      const float ux = uxy * cosf(phi2), uy = uxy * sinf(phi2);
      const float xfreq_atom = xfreq - uz;
      const float xfreq_new = xfreq_atom + uz * cost + (ux * cosp + uy * sinp) * sint;
      float kx = s.kx[i], ky = s.ky[i], kz = s.kz[i];
      rotate_direction(kx, ky, kz, cost, sint, cosp, sinp);
      uniforms4(seed, STREAM_SCATTER, (uint32_t)i, counter, (uint32_t)(rounds + 1), u);
      s.phase[i] = FLYING;
      s.kx[i] = kx;
      s.ky[i] = ky;
      s.kz[i] = kz;
      s.xfreq[i] = xfreq_new;
      s.tau_target[i] = -logf(fmaxf(u[0], 1e-12f));
      s.tau_run[i] = 0.0f;
      w_sum = s.wgt[i];
      n_sum = 1.0f;
    }
  }
  block_sum_atomic(w_sum, nscatt_gas);
  block_sum_atomic(n_sum, nscatt_events);
}

LART_API int lart_scatter_lya(void* const* lanes, int B, unsigned seed, unsigned counter,
                              int rounds, float a, float E1, void* nscatt_gas,
                              void* nscatt_events, void* stream) {
  if (B > 0) {
    const int threads = 256;
    scatter_lya_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        unpack_lanes(lanes), B, seed, counter, rounds, a, E1, (float*)nscatt_gas,
        (float*)nscatt_events);
  }
  return (int)cudaGetLastError();
}
