"""CLI: python -m lart_tpu_torch input.in [output] [--device cuda|cpu]

Same usage as python -m lart_tpu; the device is CUDA unless --device cpu
is given, and a CUDA request without a GPU raises.
"""

import argparse
import sys
import time

from lart_tpu.config import Params
from lart_tpu.io.iofile import default_extension

from . import driver
from .io.writer import write_output


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

    t_last = [time.time()]

    def progress(launched, nphotons, alive):
        now = time.time()
        if now - t_last[0] > 10.0:
            print(f"{launched:.5e} photons launched, {alive} lanes alive",
                  flush=True)
            t_last[0] = now

    res = driver.run(par, device=args.device, progress=progress)
    print(f"Average Number of scattering : {res.nscatt_tot:.4e}")
    print(f"Total Execution Time : {res.exetime_s/60.0:.3f} mins")
    fn = write_output(par.out_file, res)
    print(f"output written: {fn}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
