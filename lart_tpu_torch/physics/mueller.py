"""Tabulated Mueller-matrix dust scattering: the host parse of the tables,
their device copy, and the two functions of the dust's Stokes transfer.

The parse is lart_tpu/physics/mueller.py's (load_mueller, :46-66, and
default_mueller_file, :113-137); config.resolve() reads a table's albedo,
g and extinction from it.  The tables are data, not code, and stay where
lart_tpu bundles them (lart_tpu/data/mueller_*.dat).

`MuellerTable` holds what lart_tpu's MuellerDevice holds (:26-33): the
normalized columns (cos, S11, S12, S33, S34) in f32 and the Vose alias
table of the per-bin probabilities, on the device.  `sample_cost` (:80,
row 11 of PERF.md's kernel table) draws cos(theta) from S11: the alias
method over the bins, then the inversion of the linear pdf inside the
chosen bin; `interp_S` (:101) interpolates the four elements on the uniform
cos grid.  Both take their uniforms from the caller.  These are the plain
versions; csrc/mueller.cuh holds their per-lane twins, inlined into the
scatter (K4) and the peel (K7) kernels, which read the table through the
pointers of `c_struct`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import os
import re

import numpy as np
import torch

from .samplers import alias_sample, build_alias_table

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                        '..', 'lart_tpu', 'data')
TABLE_FIELDS = ('coss', 'S11', 'S12', 'S33', 'S34', 'prob', 'alias')


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


class MuellerC(ctypes.Structure):
    """csrc/mueller.cuh struct MuellerTable, field for field."""
    _fields_ = [(f, ctypes.c_void_p) for f in TABLE_FIELDS] + [
        ('n', ctypes.c_int), ('dcos', ctypes.c_float)]


@dataclasses.dataclass(frozen=True, eq=False)
class MuellerTable:
    """A table on the device: the f32 columns, the alias table of its n - 1
    bins (prob f32, alias int32), n and the cos step dcos."""
    coss: torch.Tensor
    S11: torch.Tensor
    S12: torch.Tensor
    S33: torch.Tensor
    S34: torch.Tensor
    prob: torch.Tensor
    alias: torch.Tensor
    n: int
    dcos: float

    @classmethod
    def load(cls, path: str, device='cpu') -> 'MuellerTable':
        """The table of `path` as lart_tpu's load_mueller builds it: the
        per-bin pdf is the mean of S11 at the bin's two ends."""
        meta, t = load_mueller(path)
        pdf = 0.5 * (t['S11'][:-1] + t['S11'][1:])
        prob, alias = build_alias_table(pdf / pdf.sum())

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)
        return cls(**{k: f32(t[k]) for k in ('coss', 'S11', 'S12', 'S33',
                                             'S34')},
                   prob=f32(prob),
                   alias=torch.as_tensor(np.asarray(alias, np.int32),
                                         device=device),
                   n=meta.n, dcos=meta.dcos)

    @classmethod
    def for_config(cls, cfg, device='cpu'):
        """The table of a config's Stokes dust (use_stokes with DGR > 0),
        else None; raises where no table is named or bundled, as
        lart_tpu's make_scatter does (engine.py:1845-1851)."""
        par = cfg.par
        if not (par.use_stokes and par.DGR > 0.0):
            return None
        path = par.scatt_mat_file.strip() or \
            default_mueller_file(cfg.line.wavelength0)
        if path is None:
            raise RuntimeError('Stokes dust scattering requires a Mueller '
                               'table (scatt_mat_file)')
        return cls.load(path, device)

    @functools.cached_property
    def c_struct(self) -> MuellerC:
        c = MuellerC()
        for f in TABLE_FIELDS:
            setattr(c, f, getattr(self, f).data_ptr())
        c.n, c.dcos = self.n, self.dcos
        return c

    def tensors(self):
        return tuple(getattr(self, f) for f in TABLE_FIELDS)


def sample_cost(t: MuellerTable, u_bin: torch.Tensor, u_alias: torch.Tensor,
                u_lin: torch.Tensor) -> torch.Tensor:
    """cos(theta) from the tabulated S11: alias over the bins, then the
    inversion of the linear pdf between (c0, f0) and (c1, f1) in the bin
    (mueller.py:80-98)."""
    ib = alias_sample(t.prob, t.alias, u_bin, u_alias)
    c0, c1 = t.coss[ib], t.coss[ib + 1]
    f0, f1 = t.S11[ib], t.S11[ib + 1]
    df = f1 - f0
    flat = torch.abs(df) < 1e-12 * torch.clamp_min(f0, 1e-30)
    disc = torch.clamp_min(f0 * f0 + u_lin * (f1 * f1 - f0 * f0), 0.0)
    # sqrt(disc) - f0 cancels where the pdf is flat across the bin, so the
    # root must be correctly rounded, as XLA's and the kernel's are: the
    # f64 root rounded to f32 is (torch's f32 root on the CPU may be an
    # ulp off)
    root = torch.sqrt(disc.double()).float()
    t_slope = (root - f0) / torch.where(flat, torch.ones_like(df), df)
    tt = torch.where(flat, u_lin, t_slope)
    return torch.clamp(c0 + (c1 - c0) * tt, -1.0, 1.0)


def interp_S(t: MuellerTable, cost: torch.Tensor):
    """(S11, S12, S33, S34) at cost, linear on the uniform cos grid
    (mueller.py:101-110); dcos is divided by exactly, as the kernels do."""
    f = (cost - t.coss[0]) / torch.full((), t.dcos, dtype=cost.dtype,
                                        device=cost.device)
    i = torch.clamp(torch.floor(f).to(torch.int64), 0, t.n - 2)
    w = torch.clamp(f - i.to(torch.float32), 0.0, 1.0)
    return tuple(arr[i] * (1.0 - w) + arr[i + 1] * w
                 for arr in (t.S11, t.S12, t.S33, t.S34))
