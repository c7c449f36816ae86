"""lart_tpu_torch build_cartesian against lart_tpu's, and the convert.py
round trips of grid, state and tallies.

Both builders run the same numpy float64 body, so every GridMeta field is
equal exactly and the device arrays, cast to f32 by each, are equal
bit for bit (tolerance 0)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.config import Params
from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.grid import cartesian as tcart
from lart_tpu_torch.transport.state import LANE_FIELDS, zero_tallies

import _torch_jax_bridge as bridge

CASES = {
    'slab': dict(temperature=1e4, taumax=100.0, xy_periodic=True, nx=1,
                 ny=1, nz=101, spectral_type='voigt',
                 source_geometry='point', save_Jmu=True, nmu=8),
    'sphere17': dict(temperature=1e4, taumax=50.0, geometry='sphere',
                     rmax=1.0, nx=17, ny=17, nz=17, spectral_type='voigt',
                     source_geometry='point'),
    'sphere17_hubble_dust': dict(temperature=1e4, taumax=20.0,
                                 geometry='sphere', rmax=1.0, nx=17, ny=17,
                                 nz=17, velocity_type='hubble', Vexp=100.0,
                                 DGR=1.0, source_geometry='point'),
}


def _arrays_equal(tgrid, jgrid):
    for f in dataclasses.fields(tcart.GridDevice):
        t, j = getattr(tgrid, f.name), getattr(jgrid, f.name)
        assert (t is None) == (j is None), f.name
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f.name)


@pytest.mark.parametrize('case', sorted(CASES))
def test_build_cartesian_matches_jax(case):
    cfg = Params(nphotons=1000, **CASES[case]).resolve()
    tmeta, tgrid = tcart.build_cartesian(cfg, device='cpu')
    jmeta, jgrid = jcart.build_cartesian(cfg)
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    _arrays_equal(tgrid, jgrid)
    assert tgrid.rhokap.dtype == torch.float32
    if case == 'slab':
        assert tmeta.rho_uniform > 0.0
    if case == 'sphere17':
        assert tmeta.sphere_R == 1.0


def test_grid_round_trip():
    cfg = Params(nphotons=1000, **CASES['sphere17_hubble_dust']).resolve()
    jmeta, jgrid = jcart.build_cartesian(cfg)
    tmeta, tgrid = convert.grid_from_jax(jmeta, jgrid)
    assert tmeta == tcart.build_cartesian(cfg)[0]
    _arrays_equal(tgrid, jgrid)
    jmeta2, jgrid2 = bridge.grid_to_jax(tmeta, tgrid)
    assert jmeta2 == jmeta
    for a, b in zip(jgrid2, jgrid):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_and_tallies_round_trip():
    cfg = testing.slab_params().resolve()
    meta, _ = tcart.build_cartesian(cfg)
    st = testing.mixed_state(meta, 1000, seed=1)
    st.n_launched.fill_(321)
    js = bridge.state_to_jax(st)
    assert isinstance(js, jeng.BatchState)
    back = convert.state_from_jax(js)
    for f in LANE_FIELDS + ('n_launched',):
        a, b = getattr(st, f), getattr(back, f)
        assert a.dtype == b.dtype, f
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    # the fields the port does not carry keep lart_tpu's initial values
    np.testing.assert_array_equal(np.asarray(js.pid), -1)

    tl = zero_tallies(meta.nxfreq, 8, 'cpu')
    tl.Jout.copy_(torch.arange(meta.nxfreq, dtype=torch.float32))
    tl.Jmu.fill_(0.5)
    tl.nscatt_gas.fill_(7.0)
    jt = bridge.tallies_to_jax(tl)
    assert jt.Jmu.shape == (meta.nxfreq * 8,)
    assert float(jt.nscatt_gas) == 7.0
    tb = convert.tallies_from_jax(jt)
    for f in ('Jin', 'Jout', 'Jmu', 'nscatt_gas', 'nscatt_events', 'W_oor'):
        torch.testing.assert_close(getattr(tb, f), getattr(tl, f), rtol=0,
                                   atol=0, msg=f)
    # without save_Jmu the JAX tallies carry Jmu = None
    tb0 = convert.tallies_from_jax(jeng.zero_tallies(meta.nxfreq))
    assert tb0.Jmu.shape == (0,) and tb0.Jout.shape == (meta.nxfreq,)
    assert bridge.tallies_to_jax(tb0).Jmu is None
    assert isinstance(jt.Jout, jnp.ndarray)
