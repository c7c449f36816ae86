// K6 fly_uniform_sphere: closed-form flight through one constant-opacity
// static sphere in vacuum.
//
// Replaces lart_tpu/transport/engine.py:871 sphere_chord and :887
// make_fly_uniform_sphere / fly.  The opacity along a ray is
// sphere_rho * H(x, a) + sphere_rhoD on the chord [t_in, t_out] through
// r < R and zero outside (H the line's profile, line.cuh; two kernel
// instances, line type 1 and the others), so one step resolves a whole flight: the lane
// scatters at t_in + (tau_target - tau_run) / rho when the chord holds
// enough optical depth, and escapes otherwise.  As in K3, one thread loops
// its own lane until it no longer flies, at most max_iter (= fly_substeps +
// 2) times like the while_loop, so a forced first scattering finishes,
// restarts from its birth snapshot and flies again in the same call.  The
// scatter point's cell is the clamped floor of its position (engine.py:
// 995-1000), which core-skip reads.  Bound: memory (the lane state, about
// 70 bytes a flying lane read and written) and the inlined Voigt function;
// no grid is read.
#include "lart.cuh"
#include "voigt.cuh"
#include "walk.cuh"

template <bool kMulti>
__global__ void fly_sphere_kernel(Lanes s, int B, int max_iter, FlightParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float oor = 0.0f;
  int phase = i < B ? s.phase[i] : DEAD;
  if (phase == FLYING || phase == FFS) {
    float x = s.x[i], y = s.y[i], z = s.z[i];
    float kx = s.kx[i], ky = s.ky[i], kz = s.kz[i];
    int ic = s.ic[i], jc = s.jc[i], kc = s.kc[i];
    float xfreq = s.xfreq[i], wgt = s.wgt[i];
    float tau_target = s.tau_target[i], tau_run = s.tau_run[i];
    for (int n = 0; n < max_iter && (phase == FLYING || phase == FFS); ++n) {
      const bool is_ffs = phase == FFS;
      const float rho =
          p.sphere_rho * line_profile<kMulti>(p.line, xfreq, p.a_ref, p.Dfreq) + p.sphere_rhoD;
      float t_in, t_out;
      sphere_chord(p, x, y, z, kx, ky, kz, t_in, t_out);
      const float dtau_avail = (t_out - t_in) * rho;
      const float tgt = is_ffs ? FFS_TAU_CAP : tau_target;
      const bool hit = tau_run + dtau_avail >= tgt;
      const float d_adv = hit ? t_in + (tgt - tau_run) / fmaxf(rho, LART_TINY) : t_out;
      const float x_new = fmaf(d_adv, kx, x);
      const float y_new = fmaf(d_adv, ky, y);
      const float z_new = fmaf(d_adv, kz, z);
      const float tau_n = hit ? tgt : tau_run + dtau_avail;

      if (is_ffs) {
        // forced first scattering done: tally the escaped fraction at the
        // birth frequency, restart from birth with wgt *= 1 - exp(-tau0)
        const float tau0 = tau_n;
        const float bxfreq = s.bxfreq[i], bkz = s.bkz[i];
        const float wgt_esc = wgt * expf(-tau0);
        oor += tally_out(p, p.Jout, bxfreq, bkz, wgt_esc);
        const float wgt1 = -expm1f(-tau0);
        phase = tau0 <= 0.0f ? DEAD : FLYING;
        x = s.bx[i];
        y = s.by[i];
        z = s.bz[i];
        ic = s.bic[i];
        jc = s.bjc[i];
        kc = s.bkc[i];
        kx = s.bkx[i];
        ky = s.bky[i];
        kz = bkz;
        xfreq = bxfreq;
        wgt = wgt * wgt1;
        tau_run = 0.0f;
        // xi clamp margin 1e-5 (engine.py:1015-1028)
        tau_target = -log1pf(-fminf(tau_target, 0.99999f) * wgt1);
        continue;
      }
      if (!hit) {  // escape at the (lab == comoving) frequency
        oor += tally_out(p, p.Jout, xfreq, kz, wgt);
        phase = DEAD;
      } else {
        phase = AT_SCATTER;
      }
      x = x_new;
      y = y_new;
      z = z_new;
      ic = clamp_floor((x_new - p.amin[0]) / p.d[0], p.n[0]);
      jc = clamp_floor((y_new - p.amin[1]) / p.d[1], p.n[1]);
      kc = clamp_floor((z_new - p.amin[2]) / p.d[2], p.n[2]);
      tau_run = tau_n;
    }
    s.phase[i] = phase;
    s.x[i] = x;
    s.y[i] = y;
    s.z[i] = z;
    s.kx[i] = kx;
    s.ky[i] = ky;
    s.kz[i] = kz;
    s.ic[i] = ic;
    s.jc[i] = jc;
    s.kc[i] = kc;
    s.xfreq[i] = xfreq;
    s.wgt[i] = wgt;
    s.tau_target[i] = tau_target;
    s.tau_run[i] = tau_run;
  }
  block_sum_atomic(oor, p.W_oor);
}

LART_API int lart_fly_uniform_sphere(void* const* lanes, int B, int max_iter,
                                     const FlightParams* p, void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    if (p->line.line_type == 1)
      fly_sphere_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          unpack_lanes(lanes), B, max_iter, *p);
    else
      fly_sphere_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          unpack_lanes(lanes), B, max_iter, *p);
  }
  return (int)cudaGetLastError();
}
