// K2 refill_point: rebirth of dead lanes for a point source with a Voigt,
// monochromatic, Gaussian or flat continuum input spectrum, with the
// forced-first-scattering snapshot, in a static or moving medium of uniform
// temperature, and the birth shift of a multi-level line.
//
// Replaces lart_tpu/transport/engine.py:2557 make_refill / :2689 refill
// (source_geometry point, spectral_type voigt, monochromatic, gaussian or
// continuum) and :2923 branch_init_shift (line.cuh), which the TPU runs as a
// pass of its own over the batch and which here is a device function of the
// births: a line of type 2, 4, 5 or 6 starts from xfreq0 shifted to a branch
// by the two uniforms of block 3.  The continuum (engine.py:2804-2807)
// replaces the frequency, the branch shift included, by xfreq_min + u
// (xfreq_max - xfreq_min), u from block 2, which only the Gaussian also
// reads; the D_loc / Dfreq_ref it is divided by is 1 at uniform temperature.  The TPU
// ranks dead lanes with a cumsum over the whole batch (:2700), a pass the
// card would need a second kernel for.  Here each warp counts its dead
// lanes with a ballot and takes a block of tickets from the device photon
// counter with one atomicAdd; a ticket below the budget launches its lane.
// A warp whose block overshoots the budget clamps the counter back with
// atomicMin, so once the kernel ends n_launched == min(old + #dead, budget)
// and exactly that many lanes were launched.  Which lanes launch when the
// budget runs out depends on warp order; nothing downstream depends on lane
// order.  In a moving medium the drawn frequency is a lab-frame one: unless
// comoving_source, the lane flies at xfreq - u1 with u1 = v(source cell) . k
// (engine.py:2836-2841), and Jin is tallied at the lab frequency xfreq + u1;
// the source cell's velocity (vsx, vsy, vsz) is 0 in a static medium.
// The Gaussian spectrum (engine.py:2799-2803) adds a normal times sigma_x,
// drawn by Box-Muller from block 2, which only the continuum also reads; the
// D_loc / Dfreq_ref it is divided by is 1 at uniform temperature.
// A launched lane is unpolarized (Q = U = V = 0) with the reference triad
// m = (cos t cos p, cos t sin p, -sin t), n = (-sin p, cos p, 0) of its
// direction (engine.py:2863-2873), in the resonance line's band (iband 1,
// engine.py:2888; line type 8's conversions move it to 2).  With peel-off
// on, the record's flag is written on every lane: 1 where this call
// launched, else 0; K7 then peels exactly those lanes (engine.py:2909-2913).
// On the AMR grid (engine.py:2755-2775, :2839) each launched lane finds the
// source's node itself (csrc/amr.cuh amr_find_cell: one fine-map gather or
// the octant descent from the root) and reads its leaf's velocity and, at
// non-uniform temperature, its damping a_loc, which the Voigt spectrum
// draws with, and Doppler width D_loc: the Gaussian and the continuum are
// divided by D_loc / Dfreq_ref and Jin is tallied at (x + u1) D_loc /
// Dfreq_ref.
// On a clump medium (engine.py:2750-2772) each launched lane finds its
// birth clump itself (csrc/clump.cuh clump_find: the dense scan over all
// clumps, or the CSR cell's candidates; -1 in the vacuum); the spectrum is
// drawn at the reference a and D (photons carry global frequencies) and u1
// is the birth clump's velocity along k in reference units.
// The exponential_cylinder source (engine.py:2629-2637 gen_position with
// _zexp :2569-2575, lart_tpu/physics/sources.py:478 sample_radius_loglog)
// draws each launched lane's position from the uniforms of block 4, after
// every earlier block, so a point source draws as before: the cylindrical
// radius by a binary search of the f32 log-log inverse-CDF table (at most
// 2049 knots, read through the L1 by __ldg) and jnp.interp's arithmetic
// (the clamps at the ends, fp[i-1] + (x - xp[i-1]) / dx df as one fused
// multiply-add), the azimuth, and z from the truncated exponential (or
// uniform over the box); with xyz_symmetry their absolute values.  The
// lane's cell is then its own: on a Cartesian grid clip(floor((x - amin) /
// d)) per axis, with its velocity gathered in a moving medium; on the AMR
// grid and the clump medium the lookups above run at the lane's position.
// Bound: one pass over the state (about 130 bytes a launched lane written,
// 4 a lane read), memory-bound; the ticket atomics are one per warp; an
// extended source adds ~11 dependent table reads a lane (L1/L2-resident).
#include "lart.cuh"
#include "philox.cuh"
#include "samplers.cuh"

enum { SPECTRUM_MONO = 0, SPECTRUM_VOIGT = 1, SPECTRUM_GAUSS = 2, SPECTRUM_CONT = 3 };
#define SOURCE_P_FLOOR 9.999999960041972e-13f  // f32(1e-12)
#define BLOCK_SOURCE 4u

// An extended source (exponential_cylinder); n 0: the point source.
// lart_tpu_torch/transport/refill.py SourceC mirrors it field for field.
struct SourceC {
  const float* log_p;  // (n,) f32 logs of the f32 cumulative probabilities
  const float* log_r;  // (n,) f32 logs of the f32 radii
  int n;
  int zexp;            // z from the truncated exponential, else uniform
  float neg_zs, zexp_c;
  float zmin, zrange;
  int abs_xyz;         // xyz_symmetry
  int cells[3];        // the Cartesian grid a birth's cell is found in
  float amin[3];
  float d[3];
};

// sample_radius_loglog: jnp.interp(log(max(u, 1e-12)), log_p, log_r), exp
__device__ inline float radius_loglog(const SourceC& src, float u) {
  const float x = logf(fmaxf(u, SOURCE_P_FLOOR));
  int lo = 0, hi = src.n;  // searchsorted(side='right'): #knots <= x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(&src.log_p[mid]) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int i = min(max(lo, 1), src.n - 1);
  const float xp0 = __ldg(&src.log_p[i - 1]), xp1 = __ldg(&src.log_p[i]);
  const float fp0 = __ldg(&src.log_r[i - 1]), fp1 = __ldg(&src.log_r[i]);
  float f = fmaf((x - xp0) / (xp1 - xp0), fp1 - fp0, fp0);
  if (x < __ldg(&src.log_p[0])) f = __ldg(&src.log_r[0]);
  if (x > __ldg(&src.log_p[src.n - 1])) f = __ldg(&src.log_r[src.n - 1]);
  return expf(f);
}

__global__ void refill_point_kernel(Lanes s, PeelRecord rec, int B, int* n_launched,
                                    int budget, uint32_t seed, uint32_t counter, float xs,
                                    float ys, float zs, int ic, int jc, int kc,
                                    float xfreq0, int spectrum, float sigma_x, float a,
                                    float vsx,
                                    float vsy, float vsz, int comoving_source,
                                    float xfreq_min, float dxfreq, int nxfreq, float* Jin,
                                    float xfreq_span, float Dfreq, LineC line, AmrGrid amr,
                                    ClumpGrid clump, const float* vfx, const float* vfy,
                                    const float* vfz, SourceC src) {
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
  const bool launch = dead && base + __popc(mask & ((1u << lane) - 1u)) < budget;
  if (rec.flag && i < B) rec.flag[i] = launch ? 1 : 0;
  if (!launch) return;

  // the source cell: on the AMR grid the deepest node holding the source
  // (amr_find_cell, engine.py:2755-2758) with its leaf's damping, Doppler
  // width and velocity (the reference values and none in a gap)
  float a_loc = a, D_loc = Dfreq;
  if (src.n) {
    // an extended source: the lane's own position and, on a Cartesian grid,
    // its cell (and that cell's velocity)
    float w[4];
    uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, BLOCK_SOURCE, w);
    const float rp = radius_loglog(src, w[0]);
    const float phi = LART_TWOPI * w[1];
    xs = rp * cosf(phi);
    ys = rp * sinf(phi);
    if (src.zexp) {
      const float zmag = src.neg_zs * log1pf(-(w[2] * src.zexp_c));
      zs = w[3] < 0.5f ? -zmag : zmag;
    } else {
      zs = fmaf(w[2], src.zrange, src.zmin);
    }
    if (src.abs_xyz) {
      xs = fabsf(xs);
      ys = fabsf(ys);
      zs = fabsf(zs);
    }
    if (!clump.n && !amr.ncells) {
      const float pos[3] = {xs, ys, zs};
      int c[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        c[q] = (int)fminf(fmaxf(floorf((pos[q] - src.amin[q]) / src.d[q]), 0.0f),
                          (float)(src.cells[q] - 1));
      ic = c[0];
      jc = c[1];
      kc = c[2];
      if (vfx) {
        const int f = (ic * src.cells[1] + jc) * src.cells[2] + kc;
        vsx = __ldg(&vfx[f]);
        vsy = __ldg(&vfy[f]);
        vsz = __ldg(&vfz[f]);
      }
    }
  }
  if (clump.n) {
    ic = clump_find(clump, xs, ys, zs);
    jc = kc = 0;
  } else if (amr.ncells) {
    ic = amr_find_cell(amr, xs, ys, zs);
    jc = kc = 0;
    const int il = amr_leaf(amr, ic);
    if (amr.voigt_a) {
      a_loc = leaf_gather(amr.voigt_a, il, a);
      D_loc = leaf_gather(amr.Dfreq, il, Dfreq);
    }
    if (vfx) {
      vsx = leaf_gather(vfx, il, 0.0f);
      vsy = leaf_gather(vfy, il, 0.0f);
      vsz = leaf_gather(vfz, il, 0.0f);
    }
  }
  // D_loc / Dfreq_ref: exactly 1 at uniform temperature
  const float ratio = D_loc / Dfreq;

  float u[4], v[4];
  uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 0u, u);
  uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 1u, v);

  // isotropic direction
  const float cost = 2.0f * u[0] - 1.0f;
  const float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
  const float phi = LART_TWOPI * u[1];
  const float cosp = cosf(phi), sinp = sinf(phi);
  const float kx = sint * cosp, ky = sint * sinp, kz = cost;

  float xfreq = xfreq0;
  if (line.branch_init) {
    float w[4];
    uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 3u, w);
    xfreq = xfreq + branch_init_shift(line, w[0], w[1], D_loc);
  }
  if (spectrum == SPECTRUM_VOIGT) {
    xfreq = xfreq + rand_voigt_x(a_loc, u[2], u[3], v[0]);
  } else if (spectrum == SPECTRUM_GAUSS) {
    float w[4];
    uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 2u, w);
    xfreq = (xfreq + box_muller(w[0], w[1]) * sigma_x) / ratio;
  } else if (spectrum == SPECTRUM_CONT) {
    float w[4];
    uniforms4(seed, STREAM_REFILL, (uint32_t)i, counter, 2u, w);
    xfreq = (xfreq_min + w[0] * xfreq_span) / ratio;
  }

  // lab-frame source -> comoving frequency; Jin at the lab frequency
  const float kdir[3] = {kx, ky, kz};
  const float u1 = clump.n ? clump_vel_dot(clump, ic, kdir, CLUMP_U_SCALE)
                           : vsx * kx + vsy * ky + vsz * kz;
  if (!comoving_source) xfreq = xfreq - u1;
  const float fx = floorf(((xfreq + u1) * ratio - xfreq_min) / dxfreq);
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
  // unpolarized, with the reference triad of the birth direction
  s.Q[i] = 0.0f;
  s.U[i] = 0.0f;
  s.V[i] = 0.0f;
  s.mx[i] = cost * cosp;
  s.my[i] = cost * sinp;
  s.mz[i] = -sint;
  s.nnx[i] = -sinp;
  s.nny[i] = cosp;
  s.nnz[i] = 0.0f;
  s.iband[i] = 1;  // the resonance line's band (engine.py:2888)
}

// record: the PeelRecord pointer table, or null with peel-off off; amr: the
// octree, or null on a Cartesian grid, with vfx/vfy/vfz its per-leaf
// velocities (null in a static medium; an extended source on a moving
// Cartesian grid: the cells' velocities); clump: the clumps, or null;
// source: the extended source, or null for the point source
LART_API int lart_refill_point(void* const* lanes, void* const* record, int B,
                               void* n_launched, int budget, unsigned seed,
                               unsigned counter, float xs, float ys, float zs, int ic,
                               int jc, int kc, float xfreq0, int spectrum, float sigma_x,
                               float a,
                               float vsx, float vsy, float vsz, int comoving_source,
                               float xfreq_min, float dxfreq, int nxfreq, void* Jin,
                               float xfreq_span, float Dfreq, const LineC* line,
                               const AmrGrid* amr, const ClumpGrid* clump,
                               const float* vfx, const float* vfy, const float* vfz,
                               const SourceC* source, void* stream) {
  if (B > 0) {
    const int threads = 256;
    refill_point_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        unpack_lanes(lanes), unpack_record(record), B, (int*)n_launched, budget, seed,
        counter, xs, ys, zs, ic, jc, kc, xfreq0, spectrum, sigma_x, a, vsx, vsy, vsz,
        comoving_source, xfreq_min, dxfreq, nxfreq, (float*)Jin, xfreq_span, Dfreq, *line,
        amr ? *amr : AmrGrid{}, clump ? *clump : ClumpGrid{}, vfx, vfy, vfz,
        source ? *source : SourceC{});
  }
  return (int)cudaGetLastError();
}

LART_API int lart_source_params_size() { return (int)sizeof(SourceC); }
