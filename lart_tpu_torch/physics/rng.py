"""Philox4x32-10 counter-based uniforms, bit-identical to csrc/philox.cuh.

Key = (seed, stream id), counter = (lane, launch counter, draw block, 0).
Each block yields four uniforms, floored like lart_tpu's samplers._u01
(samplers.py:32-35): u = max(u24 * 2^-24, 1e-12) from the top 24 bits.

torch has no unsigned 32-bit arithmetic, so the words live in int64
tensors.  Philox's 32x32 -> 64 bit products would overflow int64, so one
operand is split into 16-bit halves and the partial products (< 2^48) are
recombined.
"""

from __future__ import annotations

import torch

STREAM_REFILL = 1
STREAM_SCATTER = 2

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) words of m * b for a 32-bit constant m and b < 2^32."""
    t_lo = m * (b & 0xFFFF)
    t_hi = m * (b >> 16)
    s = t_lo + ((t_hi & 0xFFFF) << 16)
    return (t_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox rounds on int64 tensors holding 32-bit words."""
    k0 &= _MASK32
    k1 &= _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(seed: int, stream: int, lane: torch.Tensor, counter: int,
             blocks) -> torch.Tensor:
    """f32 uniforms in [1e-12, 1) for int64 lane indices `lane` (B,):
    (4, B) for one block index, (nblocks, 4, B) for a range of them."""
    blk = torch.as_tensor(blocks, dtype=torch.int64, device=lane.device)
    c2 = (blk & _MASK32).reshape(-1, 1).expand(-1, lane.shape[0])
    c0 = lane.expand_as(c2)
    z = torch.zeros_like(c2)
    words = philox4x32(c0, z + (counter & _MASK32), c2, z, seed, stream)
    u = torch.stack(words, dim=1).bitwise_right_shift(8).to(torch.float32)
    u = torch.clamp_min(u * (2.0 ** -24), 1e-12)
    return u[0] if blk.dim() == 0 else u
