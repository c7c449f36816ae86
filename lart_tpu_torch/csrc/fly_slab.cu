// K3 fly_uniform_slab: closed-form flight through a uniform static slab that
// is periodic in x and y and escapes through the z faces.
//
// Replaces lart_tpu/transport/engine.py:671 make_fly_uniform_slab / :699 fly.
// The TPU runs a lax.while_loop over the whole batch until no lane flies;
// here one thread loops its own lane until it is no longer FLYING or FFS,
// capped at max_iter (= fly_substeps + 2) like the while_loop, so a forced
// first scattering finishes, restarts from its birth snapshot and flies
// again in the same call.  The TPU keeps one escape record per lane and
// scatter-adds them after the loop; here an escape adds to Jout/Jmu with an
// f32 atomicAdd at once (a lane escapes at most once), and the weight that
// falls outside the frequency grid is summed in the block and added with one
// atomic.  The opacity is rho0 times the line's profile (line.cuh: H(x, a)
// for line type 1, the doublet, multiplet or H+D sum for the others; two
// kernel instances).  Bound: memory (about 60 bytes a flying lane read and written) and
// the Voigt function of voigt.cuh, inlined; the Jout atomics are spread over
// nxfreq bins and are rare next to the lanes that scatter.
#include "lart.cuh"
#include "voigt.cuh"

// jnp.mod / torch.remainder for floats: the result takes the sign of b
__device__ inline float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

template <bool kMulti>
__global__ void fly_slab_kernel(Lanes s, int B, int max_iter, float zmn, float zmx,
                                float xmn, float ymn, float Lx, float Ly, float dz, int nz,
                                float a_ref, float rho0, float xfreq_min, float dxfreq,
                                int nxfreq, int save_jmu, int nmu, float mu_min, float dmu,
                                int mu_abs, float* Jout, float* Jmu, float* W_oor, float Dfreq,
                                LineC line) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float oor = 0.0f;
  int phase = i < B ? s.phase[i] : DEAD;
  if (phase == FLYING || phase == FFS) {
    float x = s.x[i], y = s.y[i], z = s.z[i];
    float kx = s.kx[i], ky = s.ky[i], kz = s.kz[i];
    int kc = s.kc[i];
    float xfreq = s.xfreq[i], wgt = s.wgt[i];
    float tau_target = s.tau_target[i], tau_run = s.tau_run[i];
    for (int n = 0; n < max_iter && (phase == FLYING || phase == FFS); ++n) {
      const bool is_ffs = phase == FFS;
      const float rho = rho0 * line_profile<kMulti>(line, xfreq, a_ref, Dfreq);
      const float zsel = kz > 0.0f ? zmx : zmn;
      const bool flat = fabsf(kz) < 1e-12f;
      const float d_exit = flat ? LART_BIG : fmaxf((zsel - z) / kz, 0.0f);
      const float tgt = is_ffs ? FFS_TAU_CAP : tau_target;
      const float dtau_exit = d_exit * rho;
      const bool hit = tau_run + dtau_exit >= tgt;
      const float d_adv = hit ? (tgt - tau_run) / fmaxf(rho, LART_TINY) : d_exit;
      const float x_new = xmn + floor_mod(x + d_adv * kx - xmn, Lx);
      const float y_new = ymn + floor_mod(y + d_adv * ky - ymn, Ly);
      const float z_new = z + d_adv * kz;
      const int kcn = clamp_floor((z_new - zmn) / dz, nz);
      const float tau_n = hit ? tgt : tau_run + dtau_exit;

      if (!is_ffs && !hit) {  // escape: bin at the (lab == comoving) frequency
        const float fx = floorf((xfreq - xfreq_min) / dxfreq);
        if (fx >= 0.0f && fx < (float)nxfreq) {
          atomicAdd(&Jout[(int)fx], wgt);
          if (save_jmu) {
            const float mu = mu_abs ? fabsf(kz) : kz;
            atomicAdd(&Jmu[(int)fx * nmu + clamp_floor((mu - mu_min) / dmu, nmu)], wgt);
          }
        } else {
          oor += wgt;
        }
        phase = DEAD;
        x = x_new;
        y = y_new;
        z = z_new;
        kc = kcn;
        tau_run = tau_n;
      } else if (is_ffs) {
        // forced first scattering done: tally the escaped fraction at the
        // birth frequency, restart from birth with wgt *= 1 - exp(-tau0)
        const float tau0 = tau_n;
        const float bxfreq = s.bxfreq[i], bkz = s.bkz[i];
        const float wgt_esc = wgt * expf(-tau0);
        const float fb = floorf((bxfreq - xfreq_min) / dxfreq);
        if (fb >= 0.0f && fb < (float)nxfreq) {
          atomicAdd(&Jout[(int)fb], wgt_esc);
          if (save_jmu) {
            const float mu = mu_abs ? fabsf(bkz) : bkz;
            atomicAdd(&Jmu[(int)fb * nmu + clamp_floor((mu - mu_min) / dmu, nmu)], wgt_esc);
          }
        } else {
          oor += wgt_esc;
        }
        const float wgt1 = -expm1f(-tau0);
        phase = tau0 <= 0.0f ? DEAD : FLYING;
        x = s.bx[i];
        y = s.by[i];
        z = s.bz[i];
        kc = s.bkc[i];
        kx = s.bkx[i];
        ky = s.bky[i];
        kz = bkz;
        xfreq = bxfreq;
        wgt = wgt * wgt1;
        tau_run = 0.0f;
        // xi clamp margin 1e-5 (engine.py:812-825)
        tau_target = -log1pf(-fminf(tau_target, 0.99999f) * wgt1);
      } else {  // reached the tau target: scatter next
        phase = AT_SCATTER;
        x = x_new;
        y = y_new;
        z = z_new;
        kc = kcn;
        tau_run = tau_n;
      }
    }
    s.phase[i] = phase;
    s.x[i] = x;
    s.y[i] = y;
    s.z[i] = z;
    s.kx[i] = kx;
    s.ky[i] = ky;
    s.kz[i] = kz;
    s.kc[i] = kc;
    s.xfreq[i] = xfreq;
    s.wgt[i] = wgt;
    s.tau_target[i] = tau_target;
    s.tau_run[i] = tau_run;
  }
  block_sum_atomic(oor, W_oor);
}

LART_API int lart_fly_uniform_slab(void* const* lanes, int B, int max_iter, float zmn,
                                   float zmx, float xmn, float ymn, float Lx, float Ly,
                                   float dz, int nz, float a_ref, float rho0,
                                   float xfreq_min, float dxfreq, int nxfreq, int save_jmu,
                                   int nmu, float mu_min, float dmu, int mu_abs, void* Jout,
                                   void* Jmu, void* W_oor, float Dfreq, const LineC* line,
                                   void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    if (line->line_type == 1)
      fly_slab_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          unpack_lanes(lanes), B, max_iter, zmn, zmx, xmn, ymn, Lx, Ly, dz, nz, a_ref, rho0,
          xfreq_min, dxfreq, nxfreq, save_jmu, nmu, mu_min, dmu, mu_abs, (float*)Jout,
          (float*)Jmu, (float*)W_oor, Dfreq, *line);
    else
      fly_slab_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          unpack_lanes(lanes), B, max_iter, zmn, zmx, xmn, ymn, Lx, Ly, dz, nz, a_ref, rho0,
          xfreq_min, dxfreq, nxfreq, save_jmu, nmu, mu_min, dmu, mu_abs, (float*)Jout,
          (float*)Jmu, (float*)W_oor, Dfreq, *line);
  }
  return (int)cudaGetLastError();
}

LART_API int lart_line_params_size() { return (int)sizeof(LineC); }
