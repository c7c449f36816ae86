"""CLI: python -m lart_tpu_torch input.in [output] [--device cuda|cpu]

Same usage as python -m lart_tpu; the device is CUDA unless --device cpu
is given, and a CUDA request without a GPU raises.  par%n_devices > 1 runs
that many ranks, one process each (parallel/launch.run_ranks: cuda:r for
rank r over NCCL, or gloo ranks on the CPU with --device cpu); 0 runs one
rank a visible card when there are several, else the single-rank path.
With LART_COORDINATOR, LART_NUM_PROCS and LART_PROC_ID set, this process
is one rank of a run started one command a rank (parallel/distributed.py),
on card LART_PROC_ID mod the visible cards.  Rank 0 alone writes the
output.
"""

import argparse
import os
import sys

import torch

from . import driver
from .config import Params
from .io.iofile import default_extension
from .io.writer import write_output
from .parallel import distributed
from .parallel.launch import run_ranks
from .utils.device import resolve_device


def _run(par, device: str):
    """The run's RunResult on rank 0, None on the other ranks."""
    progress = driver.PrintProgress(10.0)
    if any(k in os.environ for k in ('LART_COORDINATOR', 'LART_NUM_PROCS',
                                     'LART_PROC_ID')):
        dev = resolve_device(device)
        if dev.type == 'cuda':
            dev = torch.device('cuda', int(os.environ.get('LART_PROC_ID', 0))
                               % torch.cuda.device_count())
        distributed.initialize(device=dev)
        try:
            return driver.run(par, device=dev, progress=progress)
        finally:
            distributed.shutdown()
    n = par.n_devices
    if n == 0 and device == 'cuda' and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
    if n > 1:
        return run_ranks(par, n, device, progress=progress)
    return driver.run(par, device=device, progress=progress)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python -m lart_tpu_torch')
    ap.add_argument('input', help='namelist file (&parameters ... /)')
    ap.add_argument('output', nargs='?', help='output file (default: '
                    'par%%out_file, else the input name)')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)

    par = Params.from_namelist(args.input)
    if args.output:
        par.out_file = args.output
    elif not par.out_file.strip():
        base = args.input
        for ext in ('.in', '.txt'):
            if base.endswith(ext):
                base = base[:-len(ext)]
        par.out_file = base + default_extension(par.file_format)

    res = _run(par, args.device)
    if res is None:
        return 0
    print(f"Average Number of scattering : {res.nscatt_tot:.4e}")
    print(f"Total Execution Time : {res.exetime_s/60.0:.3f} mins")
    fn = write_output(par.out_file, res)
    print(f"output written: {fn}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
