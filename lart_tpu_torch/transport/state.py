"""Photon batch state and per-chunk tallies as structure-of-arrays tensors.

Counterparts of BatchState / Tallies / init_state / zero_tallies
(lart_tpu/transport/engine.py:47-146, :222-264), cut to the fields the
ported paths read and write: the lane's position, direction, cell,
frequency, weight and optical depths, the forced-first-scattering birth
snapshot, the Stokes parameters with the reference triad (m, n, k)
that polarized peel-off carries (engine.py:80-90), and the photon's band
(engine.py:98-99: 1 the resonance line, 2 the H-alpha photon a Ly-beta
scattering converts to, line type 8), and the shearing box's
shear-frame y-velocity vfy_shear (engine.py:91-93), which a periodic x
wrap moves by -+ omega_shear and a birth or a completed forced first
scattering sets to 0, and the all-photons bookkeeping of save_all_photons
(engine.py:94-98): the photon's id, -1 until a birth with the table on
gives it one, and its counts of gas and dust scattering events (nsg, nsd),
0 at that birth.  The Ly-beta tallies (Jout_Ha, Jabs_Ha and the band budgets)
exist only for line type 8, the H2 tallies only with H2 pumping on, Jabs2
only in an exoplanet atmosphere, the flux factor and rejected draws only
for a stellar or point illumination, and the CALCJ/CALCP/CALCPnew maps
J1 (nxfreq x nbin, frequency-major), Pa and Pnew (nbin; f64 on the
device, unlike lart_tpu's f32) only with their flag on a grid that bins
them (nbin_JPa > 0), so a run without them carries and reads what it did
before.

Unlike the JAX pytrees these are mutable: refill, fly and scatter update
the tensors in place (kernels and plain versions alike), so one batch
lives in one set of buffers for the whole run.  Never rebind a field of a
live state: the kernels' pointer table is taken once per state.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

# lane phases
DEAD, FFS, FLYING, AT_SCATTER = 0, 1, 2, 3

# order of the lane pointer table that csrc/lart.cuh unpack_lanes reads
LANE_FIELDS = ('phase', 'x', 'y', 'z', 'kx', 'ky', 'kz', 'ic', 'jc', 'kc',
               'xfreq', 'wgt', 'tau_target', 'tau_run',
               'bx', 'by', 'bz', 'bic', 'bjc', 'bkc',
               'bxfreq', 'bkx', 'bky', 'bkz',
               'Q', 'U', 'V', 'mx', 'my', 'mz', 'nnx', 'nny', 'nnz',
               'iband', 'vfy_shear', 'pid', 'nsg', 'nsd')
INT_FIELDS = frozenset({'phase', 'ic', 'jc', 'kc', 'bic', 'bjc', 'bkc',
                        'iband', 'pid'})
LYB_SCALARS = ('W_conv', 'W_esc1', 'W_abs1', 'W_esc2', 'W_abs2')
H2_SCALARS = ('W_H2abs', 'W_H2scat')
ILLUM_SCALARS = ('flux_factor', 'nrejected')
JPA_TALLIES = ('J1', 'Pa', 'Pnew')


@dataclasses.dataclass(eq=False)
class BatchState:
    phase: torch.Tensor          # int32 (B,)
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    kx: torch.Tensor
    ky: torch.Tensor
    kz: torch.Tensor
    ic: torch.Tensor             # int32 cell indices (0-based)
    jc: torch.Tensor
    kc: torch.Tensor
    xfreq: torch.Tensor
    wgt: torch.Tensor
    tau_target: torch.Tensor
    tau_run: torch.Tensor
    # forced-first-scattering birth snapshot
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor
    bic: torch.Tensor
    bjc: torch.Tensor
    bkc: torch.Tensor
    bxfreq: torch.Tensor
    bkx: torch.Tensor
    bky: torch.Tensor
    bkz: torch.Tensor
    # Stokes parameters (normalized: I == 1) and the reference triad (m, n)
    # of the direction k (engine.py:80-90)
    Q: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    mz: torch.Tensor
    nnx: torch.Tensor
    nny: torch.Tensor
    nnz: torch.Tensor
    iband: torch.Tensor          # int32: 1 the line, 2 H-alpha (type 8)
    vfy_shear: torch.Tensor      # the shearing box's y-velocity offset
    # save_all_photons: the photon's id (int32, -1 without one) and its gas
    # and dust scattering events (f32 counts)
    pid: torch.Tensor
    nsg: torch.Tensor
    nsd: torch.Tensor
    n_launched: torch.Tensor     # int32 (1,)

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @functools.cached_property
    def lane_pointers(self):
        """ctypes table of the lane fields' device pointers (LANE_FIELDS)."""
        ptrs = [getattr(self, f).data_ptr() for f in LANE_FIELDS]
        return (ctypes.c_void_p * len(ptrs))(*ptrs)

    def select(self, idx: torch.Tensor) -> 'BatchState':
        """New state of the lanes `idx` (index_select on the device)."""
        return BatchState(**{f: getattr(self, f).index_select(0, idx)
                             for f in LANE_FIELDS},
                          n_launched=self.n_launched.clone())


@dataclasses.dataclass(eq=False)
class Tallies:
    Jin: torch.Tensor            # (nxfreq,) f32
    Jout: torch.Tensor
    Jmu: torch.Tensor            # (nxfreq*nmu,) f32; (0,) without save_Jmu
    nscatt_gas: torch.Tensor     # () f32: scattered weight
    nscatt_events: torch.Tensor  # () f32: unweighted scatter events
    W_oor: torch.Tensor          # () f32: escaped weight outside the grid
    Jabs: torch.Tensor           # (nxfreq,) f32: dust-absorbed weight
    nscatt_dust: torch.Tensor    # () f32: weight of the dust events
    peel: Optional[object] = None  # instruments.peel.PeelCubes (peel-off)
    # line type 8: the H-alpha band's escaped and dust-absorbed spectra,
    # the 3p -> 2s conversion weight, and each band's escaped and absorbed
    # weight (() f32 each; W_esc1 counts the forced first scatterings'
    # escaped fractions)
    Jout_Ha: Optional[torch.Tensor] = None
    Jabs_Ha: Optional[torch.Tensor] = None
    W_conv: Optional[torch.Tensor] = None
    W_esc1: Optional[torch.Tensor] = None
    W_abs1: Optional[torch.Tensor] = None
    W_esc2: Optional[torch.Tensor] = None
    W_abs2: Optional[torch.Tensor] = None
    # H2 pumping: the weight destroyed, scattered back to Ly-alpha, and
    # pumped in each of the two lines ((2,) f32)
    W_H2abs: Optional[torch.Tensor] = None
    W_H2scat: Optional[torch.Tensor] = None
    W_H2pump: Optional[torch.Tensor] = None
    # an exoplanet atmosphere: the weight destroyed at its bottom face or
    # in its masked core, by lab frequency (engine.py:121-124)
    Jabs2: Optional[torch.Tensor] = None
    # a stellar or point illumination: the births' summed flux factors
    # and rejected draws (() f32 each; engine.py:119-120)
    flux_factor: Optional[torch.Tensor] = None
    nrejected: Optional[torch.Tensor] = None
    # CALCJ/CALCP/CALCPnew (engine.py:1199-1219, :2541-2547): the path
    # length a bin and frequency (J1, index ixfreq * nbin + bin), the
    # resonance scatterings per atom (Pa) and the path-length estimate of
    # the same rate (Pnew); f64 sums of f32 deposits, as the reference
    # keeps them (define.f90:203-205): in f32 a chunk's equal deposits
    # into one hot bin round alike, 1.05e-3 of the sum of 2^17 of them
    # (tests/test_torch_precision.py)
    J1: Optional[torch.Tensor] = None
    Pa: Optional[torch.Tensor] = None
    Pnew: Optional[torch.Tensor] = None
    # save_all_photons: the run's per-photon table (transport/allph.py
    # AllPhotons), one for the whole run, written in place at each birth
    # and death
    allph: Optional[object] = None


def init_state(batch: int, device) -> BatchState:
    def zf(v=0.0):
        return torch.full((batch,), v, dtype=torch.float32, device=device)

    def zi():
        return torch.zeros((batch,), dtype=torch.int32, device=device)

    fields = {f: (zi() if f in INT_FIELDS else zf()) for f in LANE_FIELDS}
    for f in ('kz', 'bkz', 'mx', 'nny'):
        fields[f] = zf(1.0)
    fields['iband'] = zi() + 1
    fields['pid'] = zi() - 1
    return BatchState(**fields,
                      n_launched=torch.zeros((1,), dtype=torch.int32,
                                             device=device))


def zero_tallies(nxfreq: int, nmu: int, device, lyb: bool = False,
                 h2: bool = False, atmosphere: bool = False,
                 illumination: bool = False, jpa: tuple = (0, 0, 0)
                 ) -> Tallies:
    """Zero tallies; `lyb` adds line type 8's, `h2` H2 pumping's,
    `atmosphere` Jabs2, `illumination` flux_factor and nrejected
    (engine.py:240-246); `jpa`, the sizes of J1, Pa and Pnew, each map
    whose size is not 0 (engine.py:256-263)."""
    def z(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def s():
        return torch.zeros((), dtype=torch.float32, device=device)

    extra = {}
    if lyb:
        extra.update(Jout_Ha=z(nxfreq), Jabs_Ha=z(nxfreq),
                     **{k: s() for k in LYB_SCALARS})
    if h2:
        extra.update(W_H2pump=z(2), **{k: s() for k in H2_SCALARS})
    if atmosphere:
        extra.update(Jabs2=z(nxfreq))
    if illumination:
        extra.update({k: s() for k in ILLUM_SCALARS})
    extra.update({k: torch.zeros((n,), dtype=torch.float64, device=device)
                  for k, n in zip(JPA_TALLIES, jpa) if n})
    return Tallies(Jin=z(nxfreq), Jout=z(nxfreq), Jmu=z(nxfreq * nmu),
                   nscatt_gas=s(), nscatt_events=s(), W_oor=s(),
                   Jabs=z(nxfreq), nscatt_dust=s(), **extra)
