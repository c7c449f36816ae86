"""Photon batch state and per-chunk tallies as structure-of-arrays tensors.

Counterparts of BatchState / Tallies / init_state / zero_tallies
(lart_tpu/transport/engine.py:47-146, :222-264), cut to the fields the
Neufeld-slab path reads and writes.  The Stokes, triad, shear, all-photons
and band fields come with the features that use them.

Unlike the JAX pytrees these are mutable: refill, fly and scatter update
the tensors in place (kernels and plain versions alike), so one batch
lives in one set of buffers for the whole run.  Never rebind a field of a
live state: the kernels' pointer table is taken once per state.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

# lane phases
DEAD, FFS, FLYING, AT_SCATTER = 0, 1, 2, 3

# order of the lane pointer table that csrc/lart.cuh unpack_lanes reads
LANE_FIELDS = ('phase', 'x', 'y', 'z', 'kx', 'ky', 'kz', 'ic', 'jc', 'kc',
               'xfreq', 'wgt', 'tau_target', 'tau_run',
               'bx', 'by', 'bz', 'bic', 'bjc', 'bkc',
               'bxfreq', 'bkx', 'bky', 'bkz')
INT_FIELDS = frozenset({'phase', 'ic', 'jc', 'kc', 'bic', 'bjc', 'bkc'})


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


def init_state(batch: int, device) -> BatchState:
    def zf(v=0.0):
        return torch.full((batch,), v, dtype=torch.float32, device=device)

    def zi():
        return torch.zeros((batch,), dtype=torch.int32, device=device)

    fields = {f: (zi() if f in INT_FIELDS else zf()) for f in LANE_FIELDS}
    fields['kz'] = zf(1.0)
    fields['bkz'] = zf(1.0)
    return BatchState(**fields,
                      n_launched=torch.zeros((1,), dtype=torch.int32,
                                             device=device))


def zero_tallies(nxfreq: int, nmu: int, device) -> Tallies:
    def z(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def s():
        return torch.zeros((), dtype=torch.float32, device=device)

    return Tallies(Jin=z(nxfreq), Jout=z(nxfreq), Jmu=z(nxfreq * nmu),
                   nscatt_gas=s(), nscatt_events=s(), W_oor=s())
