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
};

#define LART_N_LANE_FIELDS 24

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
  return s;
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
