"""The port's grid, state and tallies as lart_tpu's jax objects.

The inverse of lart_tpu_torch.convert's `*_from_jax`.  It lives with the
tests, the only code that runs both packages in one process, so that
lart_tpu_torch itself never imports jax.
"""

import dataclasses

import jax.numpy as jnp

from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine
from lart_tpu_torch.convert import TALLY_FIELDS
from lart_tpu_torch.grid.cartesian import GridDevice, GridMeta
from lart_tpu_torch.transport.state import LANE_FIELDS, BatchState, Tallies


def grid_to_jax(meta: GridMeta, grid: GridDevice):
    leaves = {f.name: getattr(grid, f.name)
              for f in dataclasses.fields(GridDevice)}
    return (jcart.GridMeta(**dataclasses.asdict(meta)),
            jcart.GridDevice(**{k: None if v is None
                                else jnp.asarray(v.cpu().numpy())
                                for k, v in leaves.items()}))


def state_to_jax(state: BatchState):
    """The port's state -> lart_tpu BatchState; the fields the port does
    not carry take lart_tpu's init_state values."""
    base = engine.init_state(state.batch)
    return base._replace(
        n_launched=jnp.asarray(state.n_launched.cpu().numpy()),
        **{f: jnp.asarray(getattr(state, f).cpu().numpy())
           for f in LANE_FIELDS})


def tallies_to_jax(tallies: Tallies):
    nxfreq = tallies.Jout.numel()
    nmu = tallies.Jmu.numel() // max(nxfreq, 1)
    base = engine.zero_tallies(nxfreq, nmu=nmu)
    return base._replace(**{
        k: jnp.asarray(getattr(tallies, k).cpu().numpy())
        for k in TALLY_FIELDS if k != 'Jmu' or nmu > 0})
