// Declarations shared by the lart_tpu_torch CUDA kernels.
//
// The batch state is a structure of arrays: one f32 or i32 array of B lanes
// per field.  The host passes the field pointers as one array of B-lane
// device pointers in the order of LANE_FIELDS in
// lart_tpu_torch/transport/state.py; unpack_lanes below must keep that order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LART_API extern "C" __attribute__((visibility("default")))

// lane phases (lart_tpu/transport/engine.py:47)
enum { DEAD = 0, FFS = 1, FLYING = 2, AT_SCATTER = 3 };

// Philox key word 1: one stream per kernel that draws random numbers
enum { STREAM_REFILL = 1, STREAM_SCATTER = 2 };

#define LART_PI 3.14159265358979323846f
#define LART_TWOPI 6.283185307179586f
#define LART_TINY 1e-30f
#define LART_BIG 3.0e38f

struct Lanes {
  int* phase;
  float* x;
  float* y;
  float* z;
  float* kx;
  float* ky;
  float* kz;
  int* ic;
  int* jc;
  int* kc;
  float* xfreq;
  float* wgt;
  float* tau_target;
  float* tau_run;
  float* bx;
  float* by;
  float* bz;
  int* bic;
  int* bjc;
  int* bkc;
  float* bxfreq;
  float* bkx;
  float* bky;
  float* bkz;
  // Stokes parameters (I == 1) and the reference triad (m, n) of k
  float* Q;
  float* U;
  float* V;
  float* mx;
  float* my;
  float* mz;
  float* nnx;
  float* nny;
  float* nnz;
  int* iband;  // 1 the resonance line, 2 the H-alpha band (line type 8)
  float* vfy_shear;  // the shearing box's shear-frame y-velocity offset
  // save_all_photons: the photon's id (-1 without one) and its gas and dust
  // scattering events
  int* pid;
  float* nsg;
  float* nsd;
};

#define LART_N_LANE_FIELDS 38

inline Lanes unpack_lanes(void* const* p) {
  Lanes s;
  s.phase = (int*)p[0];
  s.x = (float*)p[1];
  s.y = (float*)p[2];
  s.z = (float*)p[3];
  s.kx = (float*)p[4];
  s.ky = (float*)p[5];
  s.kz = (float*)p[6];
  s.ic = (int*)p[7];
  s.jc = (int*)p[8];
  s.kc = (int*)p[9];
  s.xfreq = (float*)p[10];
  s.wgt = (float*)p[11];
  s.tau_target = (float*)p[12];
  s.tau_run = (float*)p[13];
  s.bx = (float*)p[14];
  s.by = (float*)p[15];
  s.bz = (float*)p[16];
  s.bic = (int*)p[17];
  s.bjc = (int*)p[18];
  s.bkc = (int*)p[19];
  s.bxfreq = (float*)p[20];
  s.bkx = (float*)p[21];
  s.bky = (float*)p[22];
  s.bkz = (float*)p[23];
  s.Q = (float*)p[24];
  s.U = (float*)p[25];
  s.V = (float*)p[26];
  s.mx = (float*)p[27];
  s.my = (float*)p[28];
  s.mz = (float*)p[29];
  s.nnx = (float*)p[30];
  s.nny = (float*)p[31];
  s.nnz = (float*)p[32];
  s.iband = (int*)p[33];
  s.vfy_shear = (float*)p[34];
  s.pid = (int*)p[35];
  s.nsg = (float*)p[36];
  s.nsd = (float*)p[37];
  return s;
}

// The peel record of one cycle, written by K2 (flag: launched by this
// refill) and by K4 (flag: the kind of event, 1 a resonance, 2 a dust
// scattering and 4 a Ly-beta resonance that converts to H-alpha; the
// pre-scatter direction, and with Stokes its triad and
// Stokes vector, with a resonance's xfreq_atom and atom velocity, and its
// phase weights E1, E2, E3 where they differ from event to event: line
// types 2, 4, 5, 6), read by K7 right after.  The host passes the pointers in the
// order of PEEL_RECORD_FIELDS in lart_tpu_torch/instruments/peel.py;
// unpack_record keeps that order.
struct PeelRecord {
  int* flag;
  float* kx;
  float* ky;
  float* kz;
  float* mx;
  float* my;
  float* mz;
  float* nnx;
  float* nny;
  float* nnz;
  float* Q;
  float* U;
  float* V;
  float* xatom;
  float* ux;
  float* uy;
  float* uz;
  float* E1;
  float* E2;
  float* E3;
  // a stellar source's newborn (K2, with peel-off): its one limb-darkened
  // surface sample, cos theta and vphi, read by K7's PEEL_STELLAR pairs
  float* limb_cost;
  float* limb_vphi;
};

// A null table (peel-off off) gives a record of null pointers.
inline PeelRecord unpack_record(void* const* p) {
  PeelRecord r = {};
  if (!p) return r;
  r.flag = (int*)p[0];
  r.kx = (float*)p[1];
  r.ky = (float*)p[2];
  r.kz = (float*)p[3];
  r.mx = (float*)p[4];
  r.my = (float*)p[5];
  r.mz = (float*)p[6];
  r.nnx = (float*)p[7];
  r.nny = (float*)p[8];
  r.nnz = (float*)p[9];
  r.Q = (float*)p[10];
  r.U = (float*)p[11];
  r.V = (float*)p[12];
  r.xatom = (float*)p[13];
  r.ux = (float*)p[14];
  r.uy = (float*)p[15];
  r.uz = (float*)p[16];
  r.E1 = (float*)p[17];
  r.E2 = (float*)p[18];
  r.E3 = (float*)p[19];
  r.limb_cost = (float*)p[20];
  r.limb_vphi = (float*)p[21];
  return r;
}

#define FFS_TAU_CAP 25.0f

// the line's constants and device functions (LineC, which FlightParams
// embeds), and H2's (H2C); included here, below the definitions they use
#include "line.cuh"
#include "h2.cuh"
// the octree AMR grid (AmrGrid, which FlightParams embeds) and its lookups
#include "amr.cuh"
// the clump medium (ClumpGrid, which FlightParams embeds) and its lookups
#include "clump.cuh"
// the all-photons table (AllPh, which FlightParams embeds) and its rows
#include "allph.cuh"

// The CALCJ/CALCP/CALCPnew maps (engine.py:581-610): their tallies (null
// where the map is off), f64 sums of f32 deposits as the reference keeps
// them (define.f90:203-205), and the binning of jpa_bin.  FlightParams and
// ScatterParams embed it; lart_tpu_torch/transport/jpa.py JpaC mirrors it.
struct JpaBins {
  double* J1;    // (nxfreq, nbin): path length a frequency bin (K5)
  double* Pa;    // (nbin): resonance scatterings per atom (K4)
  double* Pnew;  // (nbin): the path-length estimate of Pa (K5)
  int geom;      // -1 the z cell, 1 radial by cell centre, 3 the flat cell
  int nbin;      // 0: no map
  int n[3];
  float amin[3], d[3];
  float dr, roff;
  float cross0;  // rhokap_phys = rhokap D / cross0
};

// jpa_bin (engine.py:581-603) of Cartesian cell (i, j, k): the centre's
// coordinates and radius as XLA contracts them, fma(i + 0.5, dx, xmin) and
// the fma chain of the sum of squares
__device__ inline int jpa_bin(const JpaBins& q, int i, int j, int k) {
  if (q.geom == -1) return min(max(k, 0), q.nbin - 1);
  if (q.geom == 1) {
    const float cx = fmaf((float)i + 0.5f, q.d[0], q.amin[0]);
    const float cy = fmaf((float)j + 0.5f, q.d[1], q.amin[1]);
    const float cz = fmaf((float)k + 0.5f, q.d[2], q.amin[2]);
    const float rr = sqrtf(fmaf(cz, cz, fmaf(cx, cx, cy * cy)));
    return (int)fminf(fmaxf(floorf((rr - q.roff) / q.dr), 0.0f), (float)(q.nbin - 1));
  }
  return min(max((i * q.n[1] + j) * q.n[2] + k, 0), q.nbin - 1);
}

// Constants and device pointers of the K5 (fly_cartesian), K6
// (fly_uniform_sphere), K8 (fly_amr) and K9/K10 (fly_clump) flights, passed by pointer from the host and by value
// to the kernel.  lart_tpu_torch/transport/flight.py FlightParams mirrors this
// layout field for field; lart_flight_params_size() lets it check the size.
struct FlightParams {
  const float* rhokap;  // (nx, ny, nz) f32, flat index (i*ny + j)*nz + k
  const float* rhokapD; // dust opacity, the same layout; null without dust
  const float* vfx;     // velocity in thermal units; null in a static medium
  const float* vfy;
  const float* vfz;
  const float* cell_a;  // per-cell damping and Doppler width, the layout of
  const float* cell_D;  //   rhokap, at non-uniform temperature; null else
  float* Jout;
  float* Jmu;
  float* W_oor;
  float* Jout_Ha;  // line type 8: the H-alpha band's escapes, and each
  float* W_esc1;   //   band's escaped weight; null otherwise
  float* W_esc2;
  float* Jabs2;    // an exoplanet atmosphere's destroyed weight, else null
  const unsigned char* mask;  // a spherical atmosphere's masked core cells
                              //   (the layout of rhokap), else null
  int n[3];        // nx, ny, nz
  int bc[3];       // BC_ESCAPE, BC_PERIODIC, BC_REFLECT per axis
  int cell0[3];    // i0, j0, k0: reflect restarts in cell0 - 1
  int walk[3];     // the axis' faces are walked (n > 1 or escape)
  int moving;      // velocities present (comoving frequency updates)
  int nxfreq;
  int save_jmu;
  int nmu;
  int mu_abs;      // xyz_symmetry bins |kz|
  int atmosphere;  // 1 a plane atmosphere (its bottom face destroys), 2 a
                   //   spherical one (its masked core destroys), else 0
  float amin[3];   // xmin, ymin, zmin
  float amax[3];   // amin + n d
  float neg_amin[3];
  float d[3];      // dx, dy, dz
  float a_ref;     // Voigt damping parameter (uniform temperature)
  float Dfreq;     // the reference Doppler width (every cell's at uniform T)
  float xfreq_min;
  float dxfreq;
  float mu_min;
  float dmu;
  float sphere_R2;
  float sphere_rho;
  float sphere_rhoD;
  float R_Ha;      // cext_dust_Ha / cext_dust: the H-alpha band's dust
  LineC line;      // the line: its opacity profile (line.cuh)
  H2C h2;          // H2 pumping (the instances with kH2 read it)
  AmrGrid amr;     // the octree (K7's AMR sightline, K8): rhokap, rhokapD
                   //   and the velocities are then per leaf; ncells 0 else
  ClumpGrid clump; // the clumps (K7's clump sightline, K9, K10); n 0 else
  JpaBins jpa;     // K5's J1 and Pnew deposits (nbin 0: none)
  float omega_shear;  // the shearing box's jump of vfy_shear at an x wrap
  AllPh allph;     // the death rows of K5, K8, K9, K10 (rp null: none)
};

enum { BC_ESCAPE = 0, BC_PERIODIC = 1, BC_REFLECT = 2 };

__device__ inline int clamp_floor(float v, int n) {
  return (int)fminf(fmaxf(floorf(v), 0.0f), (float)(n - 1));
}

// Escape tally at lab frequency xfreq_lab and direction cosine kz: adds w to
// the spectrum J (Jout, or Jout_Ha for the H-alpha band) and Jmu when the
// bin is on the frequency grid, else returns w, the weight the caller sums
// into W_oor.
__device__ inline float tally_out(const FlightParams& p, float* J, float xfreq_lab,
                                  float kz, float w) {
  const float fx = floorf((xfreq_lab - p.xfreq_min) / p.dxfreq);
  if (!(fx >= 0.0f && fx < (float)p.nxfreq)) return w;
  atomicAdd(&J[(int)fx], w);
  if (p.save_jmu) {
    const float mu = p.mu_abs ? fabsf(kz) : kz;
    atomicAdd(&p.Jmu[(int)fx * p.nmu + clamp_floor((mu - p.mu_min) / p.dmu, p.nmu)], w);
  }
  return 0.0f;
}

// Adds w to the spectrum J at lab frequency xfreq_lab when the bin is on
// the frequency grid, else returns w (the caller's W_oor share).
__device__ inline float tally_bin(const FlightParams& p, float* J, float xfreq_lab, float w) {
  const float fx = floorf((xfreq_lab - p.xfreq_min) / p.dxfreq);
  if (!(fx >= 0.0f && fx < (float)p.nxfreq)) return w;
  atomicAdd(&J[(int)fx], w);
  return 0.0f;
}

// Sum v over the block and add it to *dst with one atomic per block.
// Every thread of the block must call it.
__device__ inline void block_sum_atomic(float v, float* dst) {
  __shared__ float warp_part[32];
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(full, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? warp_part[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(full, v, off);
    if (lane == 0 && v != 0.0f) atomicAdd(dst, v);
  }
  __syncthreads();
}

// Aggregated map deposits (K4's Pa, K5's J1 and Pnew).  One
// atomic per deposit serializes in L2 where the lanes crowd into a few
// bins (the cells round a slab's source: 81x K4's bound, 40x K5's).  So at
// a point where the warp has converged every lane offers one (key, value),
// key < 0 for none: the lanes of one key find each other with
// __match_any_sync, sum over a tree of shuffles, and the lowest of them
// adds the sum, into the block's private copy of the map in dynamic shared
// memory where the launch gave it one (the wrapper's block plan: the map's
// slots, 0 where it does not fit), else into the map.  After the block's
// deposits each nonzero bin of the copy is added to the map once.  The
// sums are f64, as the maps are; only their order changes.

// the block's dynamic shared memory, 8-byte aligned; a kernel lays its
// block copies out in it (f64 first)
extern __shared__ double lart_block_copy[];

// The sum of v over the lanes `peers` (one key's lanes, from
// __match_any_sync), a tree over their ranks, at the lowest of them.  The
// whole warp calls it, converged.
template <typename T>
__device__ inline T peer_sum(unsigned peers, T v) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned up = peers & (0xfffffffeu << lane);  // the peers above this lane
  while (__any_sync(full, up != 0u)) {
    const int next = __ffs(up);  // the nearest peer above still summing
    const T t = __shfl_sync(full, v, next - 1);
    if (next) v += t;
    // the lanes of odd rank have been summed by the lane below them
    up &= ~__ballot_sync(full, rank & 1);
    rank >>= 1;
  }
  return v;
}

// The warp level: returns true at the one lane of each key >= 0 that adds
// `sum`, the key's lanes' values summed.  The whole warp calls it,
// converged; a warp without a deposit leaves at once.
template <typename T>
__device__ inline bool warp_aggregate(int key, T v, T& sum) {
  if (!__any_sync(0xffffffffu, key >= 0)) return false;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  sum = peer_sum(peers, v);
  return key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1;
}

// Zero a block copy of n slots.  Every thread of the block calls it; a
// __syncthreads() must follow before the first deposit into it.
template <typename T>
__device__ inline void block_copy_zero(T* copy, int n) {
  for (int b = threadIdx.x; b < n; b += blockDim.x) copy[b] = T(0);
}

// Add each nonzero bin b of a block copy of n slots into *at(b).  Every
// thread of the block calls it, after a __syncthreads() that follows the
// block's deposits.
template <typename T, typename At>
__device__ inline void block_copy_flush(const T* copy, int n, At at) {
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    const T v = copy[b];
    if (v != T(0)) atomicAdd(at(b), v);
  }
}

// One deposit a lane (key < 0: none) into the map whose bin b is *at(b),
// through the warp level and the block copy `copy` of n slots (n 0: the
// warp level alone, into the map; a block without a deposit skips the
// flush).  Every thread of the block calls it; the copy was zeroed before
// a __syncthreads().
template <typename T, typename At>
__device__ inline void deposit_aggregated(int key, T v, At at, T* copy, int n) {
  T sum;
  if (warp_aggregate(key, v, sum)) atomicAdd(n ? &copy[key] : at(key), sum);
  if (n && __syncthreads_or(key >= 0)) block_copy_flush(copy, n, at);
}
