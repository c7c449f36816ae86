"""Wiring the ranks of a run into one torch.distributed process group.

Counterpart of lart_tpu/parallel/distributed.py without its TPU-pod
detection (distributed.py:55): every rank is one process on one device,
runs the same driver, and the per-chunk all-reduce (parallel/reduce.py)
hands every rank the same tallies and liveness counts, so all take the
same decisions; only rank 0 reports progress, normalizes and writes.

One command a rank, the coordinator a free port on rank 0's host:

    LART_COORDINATOR=host:port LART_NUM_PROCS=2 LART_PROC_ID=0 \\
        python -m lart_tpu_torch input.in
    LART_COORDINATOR=host:port LART_NUM_PROCS=2 LART_PROC_ID=1 \\
        python -m lart_tpu_torch input.in

or parallel/launch.run_ranks, which spawns the ranks of one host itself
(the CLI does with n_devices > 1).  The backend is NCCL on GPUs, each rank
on a card of its own, and gloo on the CPU; several ranks that share one
card take gloo, asked for by argument (NCCL refuses two ranks on one
device).  Every collective waits at most TIMEOUT_S, so a rank that dies
cannot hang the others for ever.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

TIMEOUT_S = 600.0


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Join this process to the run's process group (idempotent).

    The coordinator ('host:port' or 'tcp://host:port'), the number of
    processes and this one's rank default to LART_COORDINATOR,
    LART_NUM_PROCS and LART_PROC_ID.  With none of the three, a single
    process needs no group: returns False.  backend None takes NCCL where
    `device` is a CUDA device, else gloo.  Returns True once the group
    stands."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get('LART_COORDINATOR')
    if num_processes is None and 'LART_NUM_PROCS' in os.environ:
        num_processes = int(os.environ['LART_NUM_PROCS'])
    if process_id is None and 'LART_PROC_ID' in os.environ:
        process_id = int(os.environ['LART_PROC_ID'])
    given = (coordinator, num_processes, process_id)
    if all(v is None for v in given):
        return False
    if any(v is None for v in given):
        raise ValueError('a process group needs the coordinator, the number '
                         'of processes and the process id (LART_COORDINATOR, '
                         f'LART_NUM_PROCS, LART_PROC_ID); got {given}')
    dev = None if device is None else resolve_device(device)
    if backend is None:
        backend = 'nccl' if dev is not None and dev.type == 'cuda' \
            else 'gloo'
    kw = {}
    if backend == 'nccl':
        if dev is None or dev.type != 'cuda':
            raise ValueError(f'backend nccl needs a CUDA device, not {dev}')
        torch.cuda.set_device(dev)
        kw['device_id'] = dev
    addr = coordinator if '://' in coordinator else 'tcp://' + coordinator
    dist.init_process_group(
        backend, init_method=addr, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    """'nccl', 'gloo', or None outside a process group."""
    return str(dist.get_backend()) if dist.is_initialized() else None
