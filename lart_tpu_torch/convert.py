"""Carry lart_tpu's grid, batch state and tallies into the port.

`*_from_jax` take lart_tpu's objects, read every leaf through numpy, and
return the port's, so this module never imports jax.  The way back, which
needs jax, lives with the tests (tests/_torch_jax_bridge.py); together
they feed lart_tpu and lart_tpu_torch the identical grid and state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grid.cartesian import GridDevice, GridMeta
from .transport.state import LANE_FIELDS, BatchState, Tallies

TALLY_FIELDS = ('Jin', 'Jout', 'Jmu', 'nscatt_gas', 'nscatt_events',
                'W_oor')


def _tensor(leaf, device):
    return None if leaf is None else \
        torch.as_tensor(np.array(leaf), device=device)


def grid_from_jax(meta, grid, device='cpu'):
    """lart_tpu (GridMeta, GridDevice) -> the port's."""
    m = GridMeta(**dataclasses.asdict(meta))
    return m, GridDevice(**{f.name: _tensor(getattr(grid, f.name), device)
                            for f in dataclasses.fields(GridDevice)})


def state_from_jax(state, device='cpu') -> BatchState:
    """lart_tpu BatchState (one device) -> the port's lane fields."""
    return BatchState(**{f: _tensor(getattr(state, f), device)
                         for f in LANE_FIELDS},
                      n_launched=_tensor(np.asarray(state.n_launched,
                                                    np.int32).reshape(1),
                                         device))


def tallies_from_jax(tallies, device='cpu') -> Tallies:
    out = {k: _tensor(getattr(tallies, k), device) for k in TALLY_FIELDS}
    if out['Jmu'] is None:
        out['Jmu'] = torch.zeros((0,), dtype=torch.float32, device=device)
    return Tallies(**out)
