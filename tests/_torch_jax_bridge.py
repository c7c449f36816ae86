"""The port's grid, state and tallies as lart_tpu's jax objects.

The inverse of lart_tpu_torch.convert's `*_from_jax`.  It lives with the
tests, the only code that runs both packages in one process, so that
lart_tpu_torch itself never imports jax.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lart_tpu import config as jconfig
from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine
from lart_tpu_torch import convert, testing
from lart_tpu_torch.convert import TALLY_FIELDS
from lart_tpu_torch.grid.cartesian import GridDevice, GridMeta
from lart_tpu_torch.transport.state import (LANE_FIELDS, BatchState, Tallies,
                                            zero_tallies)


def jax_params(par):
    """The port's Params as lart_tpu's Params: the same namelist values,
    so each package resolves the one namelist on its own."""
    return jconfig.Params(**{f.name: copy.deepcopy(getattr(par, f.name))
                             for f in dataclasses.fields(par)})


def resolve_both(par):
    """(the port's ResolvedConfig, lart_tpu's) of one namelist."""
    return par.resolve(), jax_params(par).resolve()


def grid_to_jax(meta: GridMeta, grid: GridDevice):
    leaves = {f.name: getattr(grid, f.name)
              for f in dataclasses.fields(GridDevice)}
    return (jcart.GridMeta(**dataclasses.asdict(meta)),
            jcart.GridDevice(**{k: None if v is None
                                else jnp.asarray(v.cpu().numpy())
                                for k, v in leaves.items()}))


def amr_to_jax(meta: GridMeta, dev):
    """The port's AMR grid (GridMeta, AmrDevice) -> lart_tpu's."""
    from lart_tpu.grid.octree import AmrDevice as JAmrDevice
    return (jcart.GridMeta(**dataclasses.asdict(meta)),
            JAmrDevice(**{f: None if getattr(dev, f) is None
                          else jnp.asarray(getattr(dev, f).cpu().numpy())
                          for f in JAmrDevice._fields}))


def clump_to_jax(meta: GridMeta, cmeta, dev):
    """The port's clump medium (GridMeta, ClumpMeta, ClumpDevice) ->
    lart_tpu's."""
    from lart_tpu.grid import clump as jclump
    return (jcart.GridMeta(**dataclasses.asdict(meta)),
            jclump.ClumpMeta(**dataclasses.asdict(cmeta)),
            jclump.ClumpDevice(**{
                f: None if getattr(dev, f) is None
                else jnp.asarray(getattr(dev, f).cpu().numpy())
                for f in jclump.ClumpDevice._fields}))


def observers_to_jax(meta, pos, rmat):
    """The port's observer set (ObserverSetMeta and the f32 positions and
    rotation matrices) -> lart_tpu's (ObserverSetMeta, ObserverDevice),
    through numpy, so both packages peel to the same observers."""
    from lart_tpu.instruments import observer as jobs
    return (jobs.ObserverSetMeta(**dataclasses.asdict(meta)),
            jobs.ObserverDevice(pos=jnp.asarray(pos.cpu().numpy()),
                                rmat=jnp.asarray(rmat.cpu().numpy())))


def sources_to_jax(table):
    """The port's radial source table (physics/sources.py RadialTable) ->
    lart_tpu's SourceTables with its f32 knots r_p, r_r."""
    from lart_tpu.physics.sources import SourceTables
    return SourceTables(r_p=jnp.asarray(table.p.cpu().numpy()),
                        r_r=jnp.asarray(table.r.cpu().numpy()))


def state_to_jax(state: BatchState):
    """The port's state -> lart_tpu BatchState (the all-photons id and
    counts among its lane fields); the fields the port does not carry take
    lart_tpu's init_state values."""
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


def fly_both(jax_fly, jgrid, port_fly, nxfreq, s0, max_steps, nmu=8):
    """One call of lart_tpu's flight closure `jax_fly` (jitted here) and of
    the port's `port_fly(state, tallies, max_steps)` from the same state
    s0.  Returns (port state, port tallies, lart_tpu state, lart_tpu
    tallies), all in the port's types; s0 is left as it was."""
    js, jt = jax.jit(jax_fly, static_argnums=3)(
        state_to_jax(s0), jgrid, engine.zero_tallies(nxfreq, nmu=nmu),
        max_steps)
    st = testing.clone_state(s0)
    tl = zero_tallies(nxfreq, nmu, 'cpu')
    port_fly(st, tl, max_steps)
    return st, tl, convert.state_from_jax(js), convert.tallies_from_jax(jt)


def allph_to_jax(table):
    """The port's all-photons table (transport/allph.py AllPhotons) as
    lart_tpu's AllPhotons."""
    return engine.AllPhotons(**{f: jnp.asarray(getattr(table, f).numpy())
                                for f in table.fields})


def allph_from_jax(ap) -> dict:
    """lart_tpu's AllPhotons as {column: (n,) f64 numpy}."""
    return {f: np.asarray(getattr(ap, f), np.float64) for f in ap._fields
            if getattr(ap, f) is not None}


def fly_both_allph(jax_fly, jgrid, port_fly, nxfreq, s0, max_steps,
                   stokes, rmax, nmu=8, **flags):
    """fly_both with the all-photons table: one zero table of s0.batch rows
    (mixed_state's ids) in each package, and the tallies of `flags` (lyb,
    atmosphere) in both.  Returns (port state, port table, lart_tpu state,
    lart_tpu table), the tables as {column: (n,) f64}."""
    from lart_tpu_torch.transport.allph import zero_allph
    table = zero_allph(s0.batch, stokes, rmax, 'cpu')
    js, jt = jax.jit(jax_fly, static_argnums=3)(
        state_to_jax(s0), jgrid,
        engine.zero_tallies(nxfreq, nmu=nmu, allph=allph_to_jax(table),
                            **flags), max_steps)
    st = testing.clone_state(s0)
    tl = zero_tallies(nxfreq, nmu, 'cpu', **flags)
    tl.allph = table
    port_fly(st, tl, max_steps)
    return (st, table.to_host(), convert.state_from_jax(js),
            allph_from_jax(jt.allph))


def assert_tallies_close(tl: Tallies, ref: Tallies, rel=1e-5):
    """Jout, Jmu and W_oor to `rel` of their sum (f32 sums in another
    order)."""
    for f in ('Jout', 'Jmu', 'W_oor'):
        a, b = getattr(tl, f), getattr(ref, f)
        atol = rel * max(float(b.abs().sum()), 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=f)


def run_jax_chunks(par, seed, max_chunks=2000):
    """lart_tpu's make_chunk from an empty batch until every photon of
    par.nphotons has launched and died: (Jout, Jmu, <N_scatt>) in f64."""
    cfg = jax_params(par).resolve()
    meta, grid = jcart.build_cartesian(cfg)
    chunk = jax.jit(engine.make_chunk(cfg, meta))
    state = jax.tree.map(jnp.asarray, engine.init_state(par.batch_size))
    state = state._replace(n_launched=jnp.zeros((1,), jnp.int32))
    n_shard = jnp.asarray([[par.nphotons, 0]], jnp.int32)
    key0 = jax.random.PRNGKey(seed)
    J = np.zeros(meta.nxfreq)
    Jmu = np.zeros(meta.nxfreq * par.nmu)
    ns = 0.0
    for i in range(max_chunks):
        state, tl, alive, launched = chunk(
            state, grid, jax.random.fold_in(key0, i), n_shard, None, None)
        J += np.asarray(tl.Jout, np.float64)
        Jmu += np.asarray(tl.Jmu, np.float64)
        ns += float(tl.nscatt_gas)
        if int(alive) == 0 and int(launched) >= par.nphotons:
            return J, Jmu, ns / par.nphotons
    raise AssertionError(f'lart_tpu batch did not drain in {max_chunks} '
                         f'chunks')


def run_port_cpu(par, seed):
    """lart_tpu_torch.driver.run on the CPU in one thread (B = 4096 gains
    nothing from more): the RunResult."""
    from lart_tpu_torch import driver
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return driver.run(par, device='cpu', seed=seed)
    finally:
        torch.set_num_threads(nthreads)


# --------------------------------------------------------------------------
# the atmospheres end to end (tests/test_torch_atmosphere*.py)
# --------------------------------------------------------------------------

def _ff_sigma(par, n):
    """The sigma of the normalized flux factor sum(ff) / (n + sum(nrej))
    of n photons, by the delta method from 2^16 births of the port's plain
    sampler (each birth's flux factor and rejected rounds)."""
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.physics import sources as tsrc
    cfg = par.resolve()
    meta = build_cartesian(cfg)[0] if not par.use_amr_grid else None
    il = tsrc.Illumination.from_config(cfg, meta)
    m = 1 << 16
    xi = torch.from_numpy(np.random.default_rng(7).random(
        (tsrc.N_ROUNDS, il.n_uniforms, m)).astype(np.float32))
    sampler = tsrc.sample_stellar_illumination if il.kind == 'stellar' \
        else tsrc.sample_point_illumination
    out = sampler(il, xi)
    ff, nrej = out[7].double().numpy(), out[8].double().numpy()
    r = ff.sum() / (m + nrej.sum())
    z = ff - r * (1.0 + nrej)
    return float(z.std() / (1.0 + nrej.mean()) / np.sqrt(n))


def atmosphere_against_lart_tpu(name, par, data=None, destroys=True,
                                illum=True, stellar=False, n_runs=4):
    """The port's driver.run on the CPU (par's photons in n_runs runs from
    seeds 3, 4, ...; AMR leaves `data` in memory) against lart_tpu's
    driver.run at B = 2560 (the leaves written to a generic AMR file): each
    run's budget W_esc + W_abs2 + W_oor against its birth weights in the
    band (Jin) to 1e-3; <N_scatt>, the Jabs2 share and the normalized flux
    factor within 5% or 3 sigma (the runs' spread for <N_scatt>, binomial
    for the share, _ff_sigma for the flux factor); with a stellar peel,
    Direct <= Direct0 (1 + 1e-6) in every bin and the transit depth within
    3 sigma (testing.transit)."""
    import dataclasses
    import math
    import os
    import tempfile
    from lart_tpu import driver as jdriver
    from lart_tpu_torch import driver
    sub = dataclasses.replace(par, nphotons=par.nphotons // n_runs)
    runs = [driver.run(sub, device='cpu', seed=3 + i, amr_data=data)
            for i in range(n_runs)]
    budgets = [testing.atmosphere_budget(r) for r in runs]
    jpar = jax_params(par)
    jpar.batch_size = 2560
    if data is not None:
        from lart_tpu.grid.amr import write_generic_amr
        with tempfile.TemporaryDirectory() as td:
            jpar.amr_file = os.path.join(td, 's.h5')
            write_generic_amr(jpar.amr_file, data)
            jres = jdriver.run(jpar, seed=5)
    else:
        jres = jdriver.run(jpar, seed=5)
    jb = testing.atmosphere_budget(jres)
    n_port = sum(r.nphotons for r in runs)
    for b in budgets:
        assert abs(b['total'] - b['birth']) < 1e-3, (name, b)
    assert abs(jb['total'] - jb['birth']) < 1e-3, (name, jb)
    if destroys:
        assert min(b['W_abs2'] for b in budgets) > 0.0
    for key in ('N', 'share', 'ff'):
        v = np.array([b[key] for b in budgets])
        got, want = float(v.mean()), jb[key]
        if key == 'share':
            sig = math.sqrt(want * (1 - want) / jres.nphotons
                            + got * (1 - got) / n_port)
        elif key == 'ff':
            if not illum:
                continue
            sig = math.hypot(_ff_sigma(par, n_port),
                             _ff_sigma(par, jres.nphotons))
        else:
            spread = float(v.std(ddof=1)) * math.sqrt(n_port / n_runs)
            sig = spread * math.sqrt(1.0 / n_port + 1.0 / jres.nphotons)
        assert abs(got - want) <= max(0.05 * abs(want), 3.0 * sig), \
            (name, key, got, want, sig)
    if illum:
        assert all(r.flux_factor > 0.0 and r.nrejected >= 0.0 for r in runs)
    if stellar:
        depths = []
        for r in runs:
            d0, d1 = r.peel['direc0'][0], r.peel['direc'][0]
            assert float(d0.sum()) > 0.0
            assert np.all(d1 <= d0 * (1 + 1e-6))
            depths.append(testing.transit(r))
        depth = float(np.mean([d[0] for d in depths]))
        sig = math.sqrt(sum(d[1] ** 2 for d in depths)) / len(depths)
        jdepth, jsig, _ = testing.transit(jres)
        assert jdepth > 0.02 and depth > 0.02
        assert abs(depth - jdepth) <= 3.0 * math.hypot(sig, jsig), \
            (name, depth, sig, jdepth, jsig)
