"""Photon budgets, ids, RNG streams and the drain's deal across ranks.

Counterpart of lart_tpu/parallel/mesh.py and of the parts of
lart_tpu/driver.py that place work on its ('data',) mesh.  lart_tpu runs
one program over the mesh's devices; the port runs one process a rank, one
GPU each (parallel/launch.py), and these pure functions give each rank its
share:

- shard_budget: the contiguous photon budget of each rank (mesh.py:32-38);
- pid_bases: each rank's first photon id, the cumsum of the budgets before
  it (driver.py:108-118), so the all-photons rows of every rank keep
  distinct ids and a sum of the ranks' tables is exact;
- rank_seed: each rank's own Philox key, where lart_tpu folds each
  device's key by its axis index (mesh.py:66).  One rank keeps the seed, as
  a one-device mesh skips the fold (mesh.py:51-62);
- deal_alive: _compact_shrink's order (driver.py:407-435): the lanes of
  all ranks, alive first, dealt round-robin over the ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import rng

# the Philox stream of the ranks' seeds; the kernels draw from 1 and 2
STREAM_RANK = 3


def shard_budget(nphotons: int, n: int) -> np.ndarray:
    """Contiguous photon budget of each of n ranks; sums to nphotons."""
    base, extra = divmod(int(nphotons), n)
    return np.array([base + (1 if r < extra else 0) for r in range(n)],
                    np.int64)


def pid_bases(budgets) -> np.ndarray:
    """Each rank's first photon id: the budgets before it, summed."""
    b = np.asarray(budgets, np.int64)
    return np.concatenate([[0], np.cumsum(b)[:-1]]).astype(np.int64)


def rank_seed(seed: int, rank: int, world: int) -> int:
    """The seed rank `rank` of `world` hands the kernels: `seed` itself on
    one rank, else the first 32-bit word of the Philox block (rank, 0, 0,
    0) under the key (seed, STREAM_RANK), for rank 0 too."""
    if world == 1:
        return int(seed)
    w = rng.words(int(seed), STREAM_RANK,
                  torch.tensor([rank], dtype=torch.int64), 0, 0)
    return int(w[0, 0])


def rank_seeds(seed: int, world: int) -> list:
    """Every rank's seed; raises unless they are distinct (each rank must
    draw its own stream)."""
    seeds = [rank_seed(seed, r, world) for r in range(world)]
    if len(set(seeds)) != world:
        raise RuntimeError(f'the rank seeds of seed {seed} collide: {seeds}')
    return seeds


def deal_alive(dead: torch.Tensor, n: int, B_new: int) -> torch.Tensor:
    """(n, B_new) int64 indices into the lanes of all n ranks, in
    rank-major order, given their dead flags: row r the lanes rank r keeps
    after the shrink.  The lanes are ordered alive first (stable), the
    first B_new * n taken and dealt round-robin, as _compact_shrink deals
    them (driver.py:421-423).  The caller knows that at most B_new * n are
    alive."""
    order = torch.argsort(dead.to(torch.int8), stable=True)[:B_new * n]
    if order.numel() < B_new * n:
        raise ValueError(f'{dead.numel()} lanes cannot fill {n} ranks of '
                         f'{B_new}')
    return order.reshape(B_new, n).T.contiguous()
