// K1 voigt_h: H(x, a) elementwise.
//
// Replaces lart_tpu/physics/voigt.py:23 _humlicek_w4_real / :104 voigt, an
// XLA elementwise fusion on the TPU.  On the card it is bound by device
// memory (12 bytes a point) and, in the wing regions, by the division and
// the exp/cos of region IV.  Each thread takes the branch of its own
// Humlicek region instead of evaluating all four; the same device function
// (voigt.cuh) is inlined into the flight kernel, so the main path never
// launches this kernel: it exists to test H(x, a) alone against its plain
// version.
#include "lart.cuh"
#include "voigt.cuh"

__global__ void voigt_h_kernel(const float* __restrict__ x, const float* __restrict__ a,
                               float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = voigt_h(x[i], a[i]);
}

LART_API int lart_voigt_h(const void* x, const void* a, void* out, int n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    voigt_h_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)a, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
