"""Tabulated Mueller-matrix dust tables, read on the host with numpy.

The parse of lart_tpu/physics/mueller.py (load_mueller, :46-66, and
default_mueller_file, :113-137) without its device arrays, which need jax:
config.resolve() reads a table's albedo, g and extinction from it.  The
tables themselves are data, not code, and stay where lart_tpu bundles them
(lart_tpu/data/mueller_*.dat).  The dust slice of the port builds its
sampler from the normalized table returned here.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                        '..', 'lart_tpu', 'data')


@dataclasses.dataclass(frozen=True)
class MuellerMeta:
    n: int
    wavelength_um: float
    cext: float
    albedo: float
    hgg: float
    dcos: float


def load_mueller(path: str):
    """Parse a mueller_*.dat table -> (MuellerMeta, dict of the normalized
    f64 columns coss, S11, S12, S33, S34; Integral S11 dcos = 1)."""
    if not os.path.exists(path):
        cand = os.path.join(DATA_DIR, path)
        if os.path.exists(cand):
            path = cand
    with open(path) as fh:
        fh.readline()
        wl, cext, albedo, hgg, n = fh.readline().split()
        n = int(n)
        fh.readline()
        rows = np.loadtxt(fh, max_rows=n)
    coss = rows[:, 0]
    norm = np.trapezoid(rows[:, 1], coss)
    table = {'coss': coss}
    table.update({k: rows[:, j] / norm
                  for j, k in enumerate(('S11', 'S12', 'S33', 'S34'), 1)})
    meta = MuellerMeta(n=n, wavelength_um=float(wl), cext=float(cext),
                       albedo=float(albedo), hgg=float(hgg),
                       dcos=float(coss[1] - coss[0]))
    return meta, table


def default_mueller_file(wavelength_um: float, dust_type: str = 'MW') -> str:
    """The bundled table closest in wavelength (data/mueller_*.dat)."""
    suffix = '' if dust_type.upper() == 'MW' else f'_{dust_type.upper()}'
    best, best_d = None, 1e99
    for f in glob.glob(os.path.join(DATA_DIR, f'mueller_*{suffix}.dat')):
        m = re.search(r'mueller_([A-Za-z0-9]+?)(_LMC|_SMC)?\.dat$',
                      os.path.basename(f))
        if not m:
            continue
        if suffix == '' and m.group(2):
            continue
        tag = m.group(1)
        if tag == 'Lyalpha':
            wl = 0.12160
        else:
            try:
                wl = float(tag) * 1e-4
            except ValueError:
                continue
        d = abs(wl - wavelength_um)
        if d < best_d:
            best, best_d = f, d
    return best
