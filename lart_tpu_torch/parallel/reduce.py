"""The collectives of a run: the tally psum across ranks (PERF.md row 20),
the drain's shrink across ranks, and the run's end reduce.

Counterpart of the psum of every tally leaf, `alive` and `launched` in
lart_tpu/parallel/mesh.py sharded_chunk (:69-72).  lart_tpu's psum is
XLA's own collective over the ICI, in no kernel of its own; its GPU
counterpart is NCCL's all-reduce, as torch.distributed issues it.  One
all_reduce(SUM) a chunk of the flat f64 buffer that driver.chunk_to_host
builds: every tally, alive and launched.  NCCL reduces the buffer on the
device before its one host read; gloo reduces the host buffer after that
read, so neither adds a copy.  The backend fixes which.  Outside a process
group nothing is reduced.  LAUNCHES['all_reduce'] counts the per-chunk
all-reduces (kernels/build.py).

The peel cubes' f64 accumulators and the all-photons table stay on each
rank's device for the whole run and are summed onto rank 0 once at its
end (reduce_to_root).  Every photon id's birth row is written by the rank
that launches it and its death row by the rank where it dies (a lane
dealt to another rank in the drain takes its id along), and every other
rank holds zeros there, so the sum of the tables is exact.

The drain's shrink (`shrink`) is _compact_shrink's (lart_tpu/driver.py:
407-435) across ranks: each rank gathers from every rank its first
min(B, B_new * W) lanes in alive-first order, every lane field and the
photon id among them, and keeps the lanes parallel/mesh.deal_alive deals
it; each rank keeps its own n_launched, so no rank launches again.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import build as kbuild
from ..transport.state import DEAD, INT_FIELDS, LANE_FIELDS, BatchState
from .mesh import deal_alive


def _on_device() -> bool:
    return str(dist.get_backend()) == 'nccl'


def all_reduce_chunk(flat: torch.Tensor) -> np.ndarray:
    """A chunk's flat f64 buffer summed over the ranks, on the host."""
    if not dist.is_initialized():
        return flat.cpu().numpy()
    if not _on_device():
        flat = flat.cpu()
    dist.all_reduce(flat)
    kbuild.LAUNCHES['all_reduce'] += 1
    return flat.cpu().numpy()


def reduce_to_root(tensors: list) -> list:
    """The tensors summed over the ranks onto rank 0, on the host (the
    other ranks get theirs back unreduced)."""
    if not dist.is_initialized():
        return [t.cpu() for t in tensors]
    out = []
    for t in tensors:
        t = t if _on_device() else t.cpu()
        dist.reduce(t, dst=0)
        out.append(t.cpu())
    return out


def shrink(state: BatchState, B_new: int) -> BatchState:
    """The batch after the drain's shrink to B_new lanes a rank (the caller
    knows that at most B_new a rank are alive over all ranks): outside a
    process group the alive lanes first, truncated to B_new, on the
    device; in one, the lanes deal_alive deals this rank."""
    order = torch.argsort((state.phase == DEAD).to(torch.int8), stable=True)
    if not dist.is_initialized():
        return state.select(order[:B_new])
    world, rank = dist.get_world_size(), dist.get_rank()
    k = min(state.batch, B_new * world)
    # every field as f32 bits, one (fields, k) block a rank
    lanes = torch.stack([getattr(state, f).view(torch.float32)
                         for f in LANE_FIELDS]).index_select(1, order[:k])
    if not _on_device():
        lanes = lanes.cpu()
    parts = [torch.empty_like(lanes) for _ in range(world)]
    dist.all_gather(parts, lanes)
    every = torch.cat(parts, dim=1)
    dead = every[LANE_FIELDS.index('phase')].view(torch.int32) == DEAD
    mine = every.index_select(1, deal_alive(dead, world, B_new)[rank])
    mine = mine.to(state.device)
    return BatchState(**{f: (mine[i].view(torch.int32) if f in INT_FIELDS
                             else mine[i]).clone()
                         for i, f in enumerate(LANE_FIELDS)},
                      n_launched=state.n_launched.clone())
