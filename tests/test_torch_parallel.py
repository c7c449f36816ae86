"""Several ranks (lart_tpu_torch/parallel/) on the CPU, over gloo, against
lart_tpu's multi-device run (lart_tpu/parallel/mesh.py, driver.py:99-118,
:407-435): the budgets and photon-id offsets, the ranks' seeds, the
drain's deal against _compact_shrink lane for lane, the shrink across two
spawned ranks, run_ranks at one rank bit for bit against driver.run, two
ranks against lart_tpu's n_devices = 2 run with the all-photons table,
and the CLI with n_devices 2, metrics_file and profile_dir.  Each spawned
rank pins torch to one thread."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu import driver as jdriver
from lart_tpu.config import Params as JParams
from lart_tpu.io.iofile import open_read
from lart_tpu.parallel import mesh as jmesh
from lart_tpu.transport import engine as jeng

from lart_tpu_torch import __main__ as tmain
from lart_tpu_torch import driver, testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.kernels import build as kb
from lart_tpu_torch.parallel import mesh
from lart_tpu_torch.parallel.launch import run_ranks, spawn_ranks
from lart_tpu_torch.tally import RunResult

# tests/test_multiprocess.py's sphere (and tools/mp_worker.py's)
MP_SPHERE = dict(nphotons=600, temperature=1e4, taumax=30.0,
                 geometry='sphere', rmax=1.0, nx=17, ny=17, nz=17,
                 spectral_type='voigt', source_geometry='point',
                 batch_size=128, fly_substeps=8, scatter_rounds=4,
                 chunk_cycles=8, refill_every=2)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('nphotons,n', [(600, 2), (601, 2), (7, 4),
                                        (1_000_003, 8), (5, 8), (10, 1)])
def test_budgets_and_ids_match_lart_tpu(nphotons, n):
    got = mesh.shard_budget(nphotons, n)
    want = jmesh.shard_budget(nphotons, n)
    np.testing.assert_array_equal(got, want)
    # lart_tpu/driver.py:113
    np.testing.assert_array_equal(
        mesh.pid_bases(got), np.concatenate([[0], np.cumsum(want)[:-1]]))
    assert got.sum() == nphotons


def test_rank_seeds_are_distinct_and_one_rank_keeps_its_seed():
    assert mesh.rank_seed(42, 0, 1) == 42
    seeds = mesh.rank_seeds(42, 8)
    assert len(set(seeds)) == 8 and 42 not in seeds
    assert seeds == mesh.rank_seeds(42, 8)
    assert all(0 <= s < 2 ** 32 for s in seeds)
    assert seeds[:2] != mesh.rank_seeds(43, 2)


@pytest.mark.parametrize('n,alive_share', [(2, 0.05), (2, 0.45),
                                           (4, 0.2)])
def test_deal_alive_matches_compact_shrink(n, alive_share):
    """The lanes each rank keeps are the lanes lart_tpu's _compact_shrink
    leaves on each device of a CPU mesh, lane for lane."""
    B, B_new = 1024, 512
    rng = np.random.default_rng(n)
    dead = rng.random(B * n) >= alive_share
    m = jmesh.make_mesh(n)
    st = jeng.init_state(B * n)._replace(
        phase=jnp.asarray(np.where(dead, 0, 2), jnp.int32),
        x=jnp.arange(B * n, dtype=jnp.float32),
        n_launched=jnp.zeros((n,), jnp.int32))
    st = jmesh.device_put_sharded_state(st, m)
    want = np.asarray(jax.device_get(
        jdriver._compact_shrink(st, n, B_new, m).x)).astype(np.int64)
    got = mesh.deal_alive(torch.from_numpy(dead), n, B_new)
    assert got.shape == (n, B_new)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)


def test_shrink_across_two_gloo_ranks():
    """After the gather and the deal every alive lane of either rank is on
    exactly one rank, with its photon id and its fields, dealt as
    deal_alive deals the lanes of both; each rank keeps its n_launched."""
    n_lanes, B_new = 4096, 512
    out = spawn_ranks(testing.shrink_rank, 2, n_lanes, 0.1, B_new, 7,
                      device='cpu')
    before = {k: np.concatenate([o['before'][k] for o in out])
              for k in ('alive', 'pid')}
    assert 0 < before['alive'].sum() <= 2 * B_new
    deal = mesh.deal_alive(torch.from_numpy(~before['alive']), 2,
                           B_new).numpy()
    kept = []
    for r, o in enumerate(out):
        a = o['after']
        assert a['pid'].size == B_new and o['n_launched'] == n_lanes + r
        np.testing.assert_array_equal(a['x'][a['alive']],
                                      a['pid'][a['alive']])
        want = before['pid'][deal[r]][before['alive'][deal[r]]]
        np.testing.assert_array_equal(a['pid'][a['alive']], want)
        kept.append(a['pid'][a['alive']])
    kept = np.concatenate(kept)
    assert np.unique(kept).size == kept.size
    np.testing.assert_array_equal(np.sort(kept),
                                  np.sort(before['pid'][before['alive']]))


def _same(a: RunResult, b: RunResult):
    """Every tally, cube and table of two runs identical."""
    for f in dataclasses.fields(RunResult):
        if f.name in ('cfg', 'meta', 'obs_meta', 'exetime_s'):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys(), f.name
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_run_ranks_at_one_rank_is_driver_run_bit_for_bit():
    """One rank keeps the seed, the budget and the ids; its all-reduce is
    a copy and its shrink (B 1024 -> 512) keeps the lanes the single-rank
    path keeps: every tally, peel cube and table row equal."""
    par = testing.sphere_params(
        tau0=10.0, n=9, nphotons=300, batch=1024, save_all_photons=True,
        save_peeloff=True, nobs=1, distance=1e3, alpha=(0.0,), beta=(0.0,),
        gamma=(0.0,), nxim=9, nyim=9)
    want = driver.run(par, device='cpu', seed=3)
    kb.reset_launch_counts()
    got = run_ranks(par, 1, 'cpu', seed=3)
    assert kb.LAUNCHES['all_reduce'] > 0 and got.nprocs == 1
    _same(got, want)


def test_two_ranks_agree_with_lart_tpu_on_two_devices(tmp_path):
    """Two gloo ranks against lart_tpu's driver.run with n_devices = 2 on
    tests/test_multiprocess.py's sphere with save_all_photons, the port at
    B = 1024 a rank so that the drain crosses the 512 rung across ranks:
    <N> within 5% or 3 sigma, Jout chi2/dof < 3, the weight to 1e-3,
    every photon launched, every table id written by one rank."""
    kw = dict(MP_SPHERE, save_all_photons=True, n_devices=2)
    jres = jdriver.run(JParams(**kw), seed=42)
    metrics = tmp_path / 'm.jsonl'
    par = Params(**dict(kw, batch_size=1024), metrics_file=str(metrics))
    res = run_ranks(par, 2, 'cpu', seed=42)
    assert res.nprocs == 2
    rows = [json.loads(s) for s in metrics.read_text().splitlines()]
    # the rung: 512 a rank with lanes alive
    assert any(r['batch'] == 1024 and r['alive'] >= 2 for r in rows[1:]), \
        rows
    for name, (v, lim) in testing.rank_table_closures(
            res, rows[-1]['launched']).items():
        assert v <= lim, (name, v, lim)
    n = par.nphotons
    for r in (res, jres):
        assert abs(r.W_escape + r.W_oor - 1.0) < 1e-3
    sig = np.hypot(res.allph['nscatt_gas'].std(),
                   jres.allph['nscatt_gas'].std()) / np.sqrt(n)
    d = abs(res.nscatt_gas - jres.nscatt_gas)
    assert d < 0.05 * jres.nscatt_gas or d < 3.0 * sig, (
        res.nscatt_gas, jres.nscatt_gas, sig)
    chi2, bins = testing.spectra_chi2(res.Jout, np.asarray(jres.Jout),
                                      n * res.W_escape, n * jres.W_escape)
    assert chi2 < 3.0 and bins > 5, (chi2, bins)


def test_n_devices_needs_as_many_ranks():
    """n_devices 2 in one process, or 3 in two ranks, raises: driver.run
    spawns nothing itself, and a rank that raises stops the run."""
    par = testing.sphere_params(tau0=10.0, n=9, nphotons=100, batch=256,
                                n_devices=2)
    with pytest.raises(ValueError, match='n_devices'):
        driver.prepare(par, device='cpu')
    par.n_devices = 3
    with pytest.raises(RuntimeError, match='n_devices 3'):
        run_ranks(par, 2, 'cpu')


NAMELIST = """&parameters
 par%nphotons = 300
 par%temperature = 1e4
 par%geometry = 'sphere'
 par%rmax = 1.0
 par%taumax = 10.0
 par%nx = 9
 par%ny = 9
 par%nz = 9
 par%xmax = 1.0
 par%ymax = 1.0
 par%zmax = 1.0
 par%spectral_type = 'voigt'
 par%batch_size = 256
 par%file_format = 'hdf5'
 par%n_devices = 2
 par%metrics_file = '{metrics}'
 par%profile_dir = '{prof}'
 par%profile_chunks = 1
/
"""


def test_cli_runs_two_gloo_ranks(tmp_path):
    """python -m lart_tpu_torch with n_devices 2 and --device cpu: two
    gloo ranks, one output file (rank 0's) with Nprocs 2, a metrics_file
    row a chunk, a profiler trace a rank."""
    metrics, prof = tmp_path / 'm.jsonl', tmp_path / 'prof'
    nml = tmp_path / 't.in'
    nml.write_text(NAMELIST.format(metrics=metrics, prof=prof))
    kb.reset_launch_counts()
    assert tmain.main([str(nml), '--device', 'cpu']) == 0
    outs = sorted(p.name for p in tmp_path.iterdir() if p.suffix == '.h5')
    assert outs == ['t.h5']
    with open_read(str(tmp_path / 't.h5')) as f:
        attrs = dict(f['Spectrum'].attrs)
    assert int(attrs['Nprocs']) == 2
    assert abs(float(attrs['W_esc']) - 1.0) < 1e-3
    rows = [json.loads(s) for s in metrics.read_text().splitlines()]
    # each of the two ranks counts its chunks' all-reduces
    assert len(rows) == kb.LAUNCHES['all_reduce'] // 2 > 0
    assert [r['chunk'] for r in rows] == list(range(len(rows)))
    assert set(rows[0]) == {'chunk', 'wall_s', 'nscatt_gas', 'scatt_per_s',
                            'alive', 'launched', 'batch'}
    assert rows[0]['batch'] == 512 and rows[-1]['launched'] == 300
    assert sorted(p.name for p in prof.iterdir()) == [
        'trace_rank0.json', 'trace_rank1.json']
