"""Spawn the ranks of one host: one process a rank, each on its own device.

lart_tpu runs one program over every device of its mesh; one host process
cannot feed several GPUs (the chunk loop is already launch-bound on one),
so the port runs one process a rank, torch.distributed's idiom.  run_ranks
spawns n ranks with torch.multiprocessing in spawn mode (CUDA cannot
fork), wires them into one process group (parallel/distributed.py), runs
driver.run in each and hands back rank 0's RunResult.

Rank r takes cuda:r over NCCL, and raises when fewer than n cards are
visible (lart_tpu's make_mesh silently takes fewer devices, mesh.py:27-28;
the port does not).  With shared=True every rank takes the current card
and the ranks reduce through gloo (NCCL refuses two ranks on one device).
On the CPU the ranks use gloo, each pinned to its share of this process's
threads.  The kernel library is built once in the calling process before
the ranks start, so each rank loads it rather than racing to rebuild it.

If a rank raises or dies, the others are stopped and the call raises with
its traceback.  Each rank's kernel launch counts (kernels/build.LAUNCHES)
are added into the caller's.  Every rank has exited, its output flushed,
when the call returns.
"""

from __future__ import annotations

import queue
import socket
import sys
import traceback
from typing import Callable, Optional

import torch
import torch.multiprocessing as mp

from ..kernels import build as kbuild
from . import distributed

POLL_S = 0.5
JOIN_S = 30.0


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def rank_devices(device, n: int, shared: bool = False) -> list:
    """The device of each of n ranks: the CPU; cuda:r for rank r; or with
    shared the current card for all."""
    dev = torch.device(device)
    if dev.type == 'cpu':
        return [dev] * n
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    if not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but '
                           'torch.cuda.is_available() is False')
    if shared:
        return [torch.device('cuda', dev.index if dev.index is not None
                             else torch.cuda.current_device())] * n
    count = torch.cuda.device_count()
    if count < n:
        raise RuntimeError(f'{n} ranks need {n} CUDA devices, {count} '
                           'visible (several ranks on one card: '
                           'shared=True)')
    return [torch.device('cuda', r) for r in range(n)]


def _rank_main(fn, rank, n, coordinator, device, backend, threads, results,
               args, kwargs):
    """One rank: join the group, run fn, send back (rank, ok, its return
    value or traceback, its launch counts)."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        distributed.initialize(coordinator, n, rank, backend=backend,
                               device=dev)
        kbuild.reset_launch_counts()
        msg = (rank, True, fn(*args, device=dev, **kwargs),
               dict(kbuild.LAUNCHES))
    except Exception:
        msg = (rank, False, traceback.format_exc(), {})
    results.put(msg)
    sys.stdout.flush()
    distributed.shutdown()


def spawn_ranks(fn: Callable, n: int, *args, device='cuda',
                shared: bool = False, **kwargs) -> list:
    """fn(*args, device=<the rank's device>, **kwargs) in each of n spawned
    ranks of one process group (fn importable by name, its arguments and
    return value picklable); returns their return values in rank order.
    The ranks reduce over NCCL on cards of their own, else over gloo."""
    devices = rank_devices(device, n, shared)
    cuda = devices[0].type == 'cuda'
    backend = 'nccl' if cuda and not shared else 'gloo'
    threads = None if cuda else max(1, torch.get_num_threads() // n)
    if cuda:
        kbuild.build()
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    coordinator = f'127.0.0.1:{free_port()}'
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, n, coordinator, str(devices[r]), backend, threads, results,
        args, kwargs)) for r in range(n)]
    for p in procs:
        p.start()
    out, counts, failure = [None] * n, [], None
    try:
        got = 0
        while got < n and failure is None:
            try:
                rank, ok, value, launches = results.get(timeout=POLL_S)
            except queue.Empty:
                gone = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if gone:
                    failure = f'rank {gone[0][0]} died (exit code ' \
                              f'{gone[0][1]})'
                elif all(p.exitcode == 0 for p in procs) \
                        and results.empty():
                    failure = 'a rank exited without a result'
                continue
            got += 1
            if not ok:
                failure = f'rank {rank} raised:\n{value}'
            out[rank] = value
            counts.append(launches)
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f'run of {n} ranks failed: {failure}')
    for c in counts:
        for k, v in c.items():
            kbuild.LAUNCHES[k] = kbuild.LAUNCHES.get(k, 0) + v
    return out


def _run(par, device, **kwargs):
    from .. import driver
    return driver.run(par, device=device, **kwargs)


def run_ranks(par, n: int, device='cuda', seed: Optional[int] = None, *,
              shared: bool = False, **run_kw):
    """driver.run of par over n spawned ranks (n_devices 0 or n); rank 0's
    RunResult.  run_kw go to driver.run in each rank (progress, amr_data,
    clump_seed, ...)."""
    return spawn_ranks(_run, n, par, device=device, shared=shared, seed=seed,
                       **run_kw)[0]
