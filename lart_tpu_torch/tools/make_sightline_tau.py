"""Standalone sight-line tau / column-density map calculator.

Port of lart_tpu/tools/make_sightline_tau.py (the reference
make_sightline_tau.x, src/make_sightline_tau.f90:1-77): builds the
Cartesian grid and the observers of a namelist, forcing save_peeloff and
save_sightline_tau, and writes only the _tau maps (kernel K11 on the card,
instruments/sightline.py), without running any transport.

usage: python -m lart_tpu_torch.tools.make_sightline_tau input.in
           [out_tau.h5] [--device cuda|cpu]

The device is CUDA unless --device cpu is given; a CUDA request without a
GPU raises.  The file's format follows par%file_format (the default name
ends in its extension).
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m lart_tpu_torch.tools.make_sightline_tau')
    ap.add_argument('input', help='namelist file (&parameters ... /)')
    ap.add_argument('output', nargs='?', help='output file (default: the '
                    'input name + _tau)')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from ..config import Params
    from ..grid.cartesian import build_cartesian
    from ..instruments.sightline import (Sightline, maps, sightline,
                                         write_sightline_tau)
    from ..io.iofile import default_extension
    from ..utils.device import resolve_device

    par = Params.from_namelist(args.input)
    par.save_peeloff = True            # the observers give the geometry
    par.save_sightline_tau = True
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=resolve_device(args.device))
    sl = Sightline.from_config(cfg, meta, grid)
    cube = sightline(sl)

    base = args.input
    for ext in ('.in', '.txt'):
        if base.endswith(ext):
            base = base[:-len(ext)]
    out = args.output or base + '_tau' + default_extension(par.file_format)
    root, ext = os.path.splitext(out)
    for i in range(sl.nobs):
        suffix = '' if sl.nobs == 1 else f'_{i + 1:03d}'
        fn = write_sightline_tau(f'{root}{suffix}{ext}', maps(sl, cube, i),
                                 cfg, meta)
        print(f'wrote {fn}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
