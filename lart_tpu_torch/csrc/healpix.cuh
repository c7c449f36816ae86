// HEALPix RING scheme on the device: the interior all-sky observer's pixel
// of a direction (K7's peel geometry) and the direction of a pixel's centre
// (K11's map rays).
//
// Replaces lart_tpu/instruments/healpix.py:30 vec2pix_ring and :69
// pix2vec_ring, 0-based ids.  The TPU evaluates every branch over the whole
// batch and selects with masks; a thread here takes its own branch first
// (equatorial or cap), with the same f32 operations as the plain versions
// in lart_tpu_torch/instruments/healpix.py: vec2pix_ring as lart_tpu's jitted
// peel computes it (the division by pi/2 a multiply by its f32 reciprocal,
// z 0.75 rounded before it meets 0.5 + tt), pix2vec_ring as its eager
// set-up does (each operation rounded on its own).  C's / and % truncate
// toward 0 where Python's floor: hp_floordiv and hp_floormod take the
// operands that can be negative.
// Bound: a few dozen flops and one atan2f or sincosf a call, inlined.
#pragma once

#define HP_TWOPI_F 6.2831854820251465f       // f32(2 pi)
#define HP_INV_HALFPI_F 0.6366197466850281f  // f32(1) / f32(pi / 2)
#define HP_TWOTHIRD_F 0.6666666865348816f    // f32(2 / 3)
#define HP_PI_F 3.1415927410125732f          // f32(pi)

__device__ inline int hp_floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ inline int hp_floormod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// RING-scheme pixel id (0-based) holding direction (vx, vy, vz)
__device__ inline int vec2pix_ring(int nside, float vx, float vy, float vz) {
  const float norm = sqrtf(vx * vx + vy * vy + vz * vz);
  const float z = vz / norm;
  float phi = atan2f(vy, vx);
  if (phi < 0.0f) phi = phi + HP_TWOPI_F;
  const float tt = phi * HP_INV_HALFPI_F;  // in [0, 4)
  const float za = fabsf(z);
  const float fn = (float)nside;
  int pix1;  // 1-based
  if (za <= HP_TWOTHIRD_F) {
    // equatorial region
    const float half_tt = 0.5f + tt, z34 = z * 0.75f;
    const int jp = (int)floorf(fn * (half_tt - z34));
    const int jm = (int)floorf(fn * (half_tt + z34));
    const int ir = nside + 1 + jp - jm;  // ring index from z = 2/3
    const int kshift = hp_floormod(ir, 2) == 0 ? 1 : 0;
    int ip = hp_floordiv(jp + jm - nside + kshift + 1, 2) + 1;
    if (ip > 4 * nside) ip -= 4 * nside;
    pix1 = 2 * nside * (nside - 1) + 4 * nside * (ir - 1) + ip;
  } else {
    // polar caps
    const float tp = tt - floorf(tt);
    const float tmp = fn * sqrtf(3.0f * (1.0f - za));
    const int jpc = (int)floorf(tp * tmp);
    const int jmc = (int)floorf((1.0f - tp) * tmp);
    const int irc = jpc + jmc + 1;
    int ipc = (int)floorf(tt * (float)irc) + 1;
    if (ipc > 4 * irc) ipc -= 4 * irc;
    pix1 = z > 0.0f ? 2 * irc * (irc - 1) + ipc : 12 * nside * nside - 2 * irc * (irc + 1) + ipc;
  }
  return pix1 - 1;
}

// the ring (1-based) of a polar-cap pixel from h = ipix1 / 2
__device__ inline int hp_cap_ring(float h) {
  return (int)floorf(sqrtf(fmaxf(h - sqrtf(floorf(h)), 0.0f))) + 1;
}

// unit vector of the centre of 0-based RING pixel ipix
__device__ inline void pix2vec_ring(int nside, int ipix, float v[3]) {
  const int ipix1 = ipix + 1;
  const int nl2 = 2 * nside, nl4 = 4 * nside, ncap = 2 * nside * (nside - 1);
  const float fact1 = 1.5f * (float)nside;
  const float fact2 = 3.0f * (float)nside * (float)nside;
  float z, phi;
  if (ipix1 <= ncap) {
    // north polar cap
    const int ir = hp_cap_ring((float)ipix1 / 2.0f);
    const int iphi = ipix1 - 2 * ir * (ir - 1);
    z = 1.0f - (float)(ir * ir) / fact2;
    phi = ((float)iphi - 0.5f) * HP_PI_F / (2.0f * (float)ir);
  } else if (ipix1 <= nl2 * (5 * nside + 1)) {
    // equatorial region
    const int ipe = ipix1 - ncap - 1;
    const int ir = hp_floordiv(ipe, nl4) + nside;
    const int iphi = hp_floormod(ipe, nl4) + 1;
    const float fodd = 0.5f * (float)(1 + hp_floormod(ir + nside, 2));
    z = (float)(nl2 - ir) / fact1;
    phi = ((float)iphi - fodd) * HP_PI_F / (2.0f * (float)nside);
  } else {
    // south polar cap
    const int ips = 12 * nside * nside - ipix1 + 1;
    const int ir = hp_cap_ring((float)ips / 2.0f);
    const int iphi = 4 * ir + 1 - (ips - 2 * ir * (ir - 1));
    z = -1.0f + (float)(ir * ir) / fact2;
    phi = ((float)iphi - 0.5f) * HP_PI_F / (2.0f * (float)ir);
  }
  const float sth = sqrtf(fmaxf((1.0f - z) * (1.0f + z), 0.0f));
  v[0] = sth * cosf(phi);
  v[1] = sth * sinf(phi);
  v[2] = z;
}
