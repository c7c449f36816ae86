// K2 refill_point: rebirth of dead lanes for a point source with a Voigt or
// monochromatic input spectrum, with the forced-first-scattering snapshot.
//
// Replaces lart_tpu/transport/engine.py:2557 make_refill / :2689 refill
// (source_geometry point, spectral_type voigt or monochromatic).  The TPU
// ranks dead lanes with a cumsum over the whole batch (:2700), a pass the
// card would need a second kernel for.  Here each warp counts its dead
// lanes with a ballot and takes a block of tickets from the device photon
// counter with one atomicAdd; a ticket below the budget launches its lane.
// A warp whose block overshoots the budget clamps the counter back with
// atomicMin, so once the kernel ends n_launched == min(old + #dead, budget)
// and exactly that many lanes were launched.  Which lanes launch when the
// budget runs out depends on warp order; nothing downstream depends on lane
// order.  Bound: one pass over the state (about 100 bytes a lane written),
// memory-bound; the ticket atomics are one per warp.
#include "lart.cuh"
#include "philox.cuh"
#include "samplers.cuh"

__global__ void refill_point_kernel(Lanes s, int B, int* n_launched, int budget,
                                    uint32_t seed, uint32_t counter, float xs, float ys,
                                    float zs, int ic, int jc, int kc, float xfreq0,
                                    int voigt_spectrum, float a, float xfreq_min,
                                    float dxfreq, int nxfreq, float* Jin) {
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
  if (!dead || base + __popc(mask & ((1u << lane) - 1u)) >= budget) return;

  float u[4], v[4];
  uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 0u, u);
  uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 1u, v);

  // isotropic direction
  const float cost = 2.0f * u[0] - 1.0f;
  const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
  const float phi = LART_TWOPI * u[1];
  const float kx = sint * cosf(phi), ky = sint * sinf(phi), kz = cost;

  float xfreq = xfreq0;
  if (voigt_spectrum) xfreq = xfreq + rand_voigt_x(a, u[2], u[3], v[0]);

  // Jin tally at the birth frequency (static medium: lab == comoving)
  const float fx = floorf((xfreq - xfreq_min) / dxfreq);
  if (fx >= 0.0f && fx < (float)nxfreq) atomicAdd(&Jin[(int)fx], 1.0f);

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
  s.wgt[i] = 1.0f;
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
}

LART_API int lart_refill_point(void* const* lanes, int B, void* n_launched, int budget,
                               unsigned seed, unsigned counter, float xs, float ys,
                               float zs, int ic, int jc, int kc, float xfreq0,
                               int voigt_spectrum, float a, float xfreq_min,
                               float dxfreq, int nxfreq, void* Jin, void* stream) {
  if (B > 0) {
    const int threads = 256;
    refill_point_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        unpack_lanes(lanes), B, (int*)n_launched, budget, seed, counter, xs, ys, zs, ic,
        jc, kc, xfreq0, voigt_spectrum, a, xfreq_min, dxfreq, nxfreq, (float*)Jin);
  }
  return (int)cudaGetLastError();
}
