// Philox4x32-10 counter-based generator (Salmon et al. 2011, the Random123
// algorithm), used by the refill and scatter kernels in place of the JAX
// package's threefry keys (lart_tpu/physics/samplers.py:32 _u01).
//
// Key = (seed, stream id); counter = (lane, launch counter, draw block, 0).
// Each block yields four uniforms, so a lane's draws depend only on its
// lane index, the launch and the block number, never on control flow.  The
// plain PyTorch version (lart_tpu_torch/physics/rng.py) does the same
// integer math, so kernel and plain version see the same uniforms.
#pragma once

#include <stdint.h>

__device__ inline void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// uniform in (0, 1): the top 24 bits, floored at 1e-12 against log(0)
// (mirrors samplers._u01's max(u, 1e-12))
__device__ inline float u01_from_bits(uint32_t v) {
  return fmaxf((float)(v >> 8) * 5.9604644775390625e-8f, 1e-12f);
}

__device__ inline void uniforms4(uint32_t seed, uint32_t stream, uint32_t lane,
                                 uint32_t counter, uint32_t block, float u[4]) {
  uint32_t c[4] = {lane, counter, block, 0u};
  philox4x32_10(c, seed, stream);
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = u01_from_bits(c[i]);
}
