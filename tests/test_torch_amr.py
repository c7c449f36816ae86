"""The port's octree AMR backend against lart_tpu's, on the CPU.

The grids: make_amr_sphere(16, 1) (a uniform static sphere, levels 4-5,
a 32^3 fine map), the same sphere in a Hubble flow (velocity_type
overrides the file's velocities), the jellyfish leaves of
testing.jellyfish_amr (examples/jellyfish_rmhd/mk_amr.py: levels 4-6,
8e3 / 3e5 K, vy, dust from its ndust column), and the tracked
examples/amr_sphere/amr_sphere.h5 (48000 leaves, a 64^3 fine map).

The host build (the octree, its neighbor table, the fine map) and the
device arrays of build_amr must equal lart_tpu's exactly, meta field for
field.  The lookups (amr_find_cell, amr_descend_from_face, both with the
fine map and by the octant descent) must give lart_tpu's nodes on random
points and on points on node faces.  K8's plain walk must match
make_fly_amr lane by lane after one call of 8 steps: integer fields
(phase, cell) equal on every lane, float fields to rtol 1e-5 (atol 1e-6)
on all but FRAC of the lanes (3e-4: in a moving medium the comoving
update x' = (x + u1) D1 / D2 - u2 cancels terms of ~10 to ~1e-2, so a
last-ulp difference of the velocity dot product, which XLA may fuse,
grows to ~1e-4 relative on a few lanes), tallies to 1e-5 of their sum.
K4's AMR local_xcrit must match make_scatter's closure and K7's AMR
sightline tau make_peel's tau_to_edge closure to rtol 1e-5 (atol 1e-6),
on all but 1e-3 of the pairs (a near tie of two faces).  The births of
K2's plain version sit in lart_tpu's source node.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lart_tpu.grid import amr as jamr
from lart_tpu.grid import octree as joct
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import peel as jpeel
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.grid import amr as tamr
from lart_tpu_torch.grid import octree as toct
from lart_tpu_torch.instruments import peel as tpeel
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import refill as trefill
from lart_tpu_torch.transport import scatter as tscatter
from lart_tpu_torch.transport.fly_amr import AmrFlight
from lart_tpu_torch.transport.state import (AT_SCATTER, DEAD, FFS, FLYING,
                                            INT_FIELDS, init_state,
                                            zero_tallies)

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]
B = 20_000
FRAC = 3e-4


def _jelly_par(**kw):
    par = Params.from_namelist(
        str(ROOT / 'examples/jellyfish_rmhd/jellyfish_pt.in'))
    par.taumax = 100.0
    for k, v in kw.items():
        setattr(par, k, v)
    return par


GRIDS = {
    'sphere16': (lambda: testing.amr_params(16, 1, tau0=100.0),
                 lambda: tamr.make_amr_sphere(16, 1)),
    'hubble16': (lambda: testing.amr_params(
        16, 1, tau0=100.0, velocity_type='hubble', Vexp=200.0,
        comoving_source=False), lambda: tamr.make_amr_sphere(16, 1)),
    'sphere16_dust': (lambda: testing.amr_params(16, 1, tau0=100.0,
                                                 DGR=3e5),
                      lambda: tamr.make_amr_sphere(16, 1)),
    'jellyfish': (_jelly_par, testing.jellyfish_amr),
    # 5% of the finest leaves dropped: gap cells of no gas
    'sphere16_gaps': (lambda: testing.amr_params(16, 1, tau0=100.0),
                      lambda: testing.amr_gaps(tamr.make_amr_sphere(16, 1))),
}


def _build(name, descent=False, **over):
    """(port cfg, lart_tpu cfg, lart_tpu build, port meta, port AmrDevice)
    of GRIDS[name]: lart_tpu builds it, convert.amr_from_jax carries it
    over, so both packages walk one grid."""
    make_par, make_data = GRIDS[name]
    par = make_par()
    for k, v in over.items():
        setattr(par, k, v)
    if descent:
        par.amr_fine_lookup_max = 0
    cfg, jcfg = bridge.resolve_both(par)
    jr = jamr.build_amr(jcfg, data=make_data())
    meta, dev = convert.amr_from_jax(jr.meta, jr.dev)
    assert (dev.fine_map is None) == descent
    return cfg, jcfg, jr, meta, dev


def _h5_leaves():
    pytest.importorskip('h5py')
    return tamr.read_generic_amr(
        str(ROOT / 'examples/amr_sphere/amr_sphere.h5'))


LEAVES = {'sphere16': lambda: tamr.make_amr_sphere(16, 1),
          'jellyfish': testing.jellyfish_amr,
          'amr_sphere_h5': _h5_leaves}


@pytest.mark.parametrize('case', sorted(LEAVES))
def test_octree_and_fine_map_equal_lart_tpu(case):
    d = LEAVES[case]()
    box = [d['origin'][0], d['origin'][0] + d['boxlen'],
           d['origin'][1], d['origin'][1] + d['boxlen'],
           d['origin'][2], d['origin'][2] + d['boxlen']]
    args = (d['x'], d['y'], d['z'], d['level'], box)
    t = toct.build_octree(*args)
    j = joct.build_octree(*args)
    assert t.builder == 'native'
    for f in dataclasses.fields(j):
        assert np.array_equal(np.asarray(getattr(t, f.name)),
                              np.asarray(getattr(j, f.name))), f.name
    assert np.array_equal(toct.build_fine_map(t), joct.build_fine_map(j))
    if case == 'sphere16':
        # the NumPy builder gives the C++ builder's tree
        n = toct._build_octree_numpy(*(np.asarray(a) for a in args[:3]),
                                     np.asarray(d['level'], np.int32),
                                     np.asarray(box))
        assert n.builder == 'numpy'
        for f in dataclasses.fields(j):
            assert np.array_equal(np.asarray(getattr(n, f.name)),
                                  np.asarray(getattr(j, f.name))), f.name


@pytest.mark.parametrize('name', sorted(GRIDS))
def test_build_amr_equals_lart_tpu(name):
    """Device arrays and meta of the port's own build_amr against
    lart_tpu's on the same leaves and namelist."""
    make_par, make_data = GRIDS[name]
    cfg, jcfg = bridge.resolve_both(make_par())
    r = tamr.build_amr(cfg, data=make_data())
    j = jamr.build_amr(jcfg, data=make_data())
    assert dataclasses.asdict(r.meta) == dataclasses.asdict(j.meta)
    for f in dataclasses.fields(r.dev):
        a, b = getattr(r.dev, f.name), getattr(j.dev, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), f.name
    assert cfg.par.rmax == jcfg.par.rmax and cfg.par.zmax == jcfg.par.zmax
    m = r.meta
    assert m.grid_type == 'amr' and m.levelmax == r.tree.levelmax
    if name == 'jellyfish':
        assert not m.uniform_temperature and not m.static_medium \
            and m.has_dust
        assert r.emissivity is not None


def test_jellyfish_amr_equals_mk_amr(tmp_path):
    """testing.jellyfish_amr() is examples/jellyfish_rmhd/mk_amr.py's file,
    column for column (the script writes into tmp_path)."""
    pytest.importorskip('h5py')
    spec = importlib.util.spec_from_file_location(
        'mk_amr', ROOT / 'examples/jellyfish_rmhd/mk_amr.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.HERE = str(tmp_path)
    mod.main()
    got = tamr.read_generic_amr(str(tmp_path / 'jellyfish_galaxy.h5'))
    want = testing.jellyfish_amr()
    for k in ('x', 'y', 'z', 'level', 'nH', 'T', 'vx', 'vy', 'vz', 'xHI',
              'n_e', 'ndust', 'emissivity'):
        assert np.array_equal(got[k], want[k]), k
    assert got['boxlen'] == want['boxlen']
    assert tuple(got['origin']) == tuple(want['origin'])


@pytest.mark.parametrize('descent', [False, True])
@pytest.mark.parametrize('name', ['sphere16_gaps', 'jellyfish'])
def test_lookups_match_lart_tpu(name, descent):
    cfg, jcfg, jr, meta, dev = _build(name, descent)
    amr = AmrFlight.from_amr(cfg, meta, dev).amr
    rng = np.random.default_rng(5)
    n = 4000
    lo, hi = meta.xmin, meta.xmax
    p = rng.uniform(lo, hi, (3, n)).astype(np.float32)
    # a quarter of the points on a face of the node that holds them
    tp = [torch.as_tensor(v) for v in p]
    ic = amr.find_cell(*tp)
    jic = jeng.amr_find_cell(jr.dev, jr.meta, *(jnp.asarray(v) for v in p))
    assert np.array_equal(ic.numpy(), np.asarray(jic))
    c = ic.long()
    face = torch.as_tensor(rng.integers(0, 6, n))
    axis = face // 2
    sgn = torch.where(face % 2 == 0, 1.0, -1.0)
    cen = (dev.node_cx[c], dev.node_cy[c], dev.node_cz[c])
    q = [torch.where(axis == a, cen[a] + sgn * dev.node_ch[c], tp[a])
         for a in range(3)]
    nb = dev.neighbor.reshape(-1)[c * 6 + face]
    ok = nb >= 0
    got = amr.descend_from_face(nb[ok], face[ok], *(v[ok] for v in q))
    want = jeng.amr_descend_from_face(
        jr.dev, jr.meta, jnp.asarray(nb[ok].numpy()),
        jnp.asarray(face[ok].numpy(), jnp.int32),
        *(jnp.asarray(v[ok].numpy()) for v in q))
    assert int(ok.sum()) > n // 2
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the face points too
    assert np.array_equal(
        amr.find_cell(*q).numpy(),
        np.asarray(jeng.amr_find_cell(jr.dev, jr.meta,
                                      *(jnp.asarray(v.numpy()) for v in q))))


FLY_CASES = {
    'sphere16': ('sphere16', False),
    'sphere16_descent': ('sphere16', True),
    'hubble16': ('hubble16', False),
    'sphere16_dust': ('sphere16_dust', False),
    'sphere16_gaps': ('sphere16_gaps', False),
    'sphere16_gaps_descent': ('sphere16_gaps', True),
    'jellyfish': ('jellyfish', False),
    'jellyfish_descent': ('jellyfish', True),
}


@pytest.mark.parametrize('case', sorted(FLY_CASES))
def test_fly_amr_matches_make_fly_amr(case):
    name, descent = FLY_CASES[case]
    cfg, jcfg, jr, meta, dev = _build(name, descent)
    flight = teng.make_fly(cfg, meta, dev)
    assert isinstance(flight, AmrFlight)
    s0 = testing.amr_state(meta, flight.amr, B, seed=31)
    st, tl, ref, ref_t = bridge.fly_both(
        jeng.make_fly_amr(jcfg, jr.meta), jr.dev, flight, meta.nxfreq, s0,
        cfg.par.fly_substeps)
    for f in INT_FIELDS:
        assert torch.equal(getattr(st, f), getattr(ref, f)), f
    frac, err = testing.compare_states(st, ref, rtol=1e-5, atol=1e-6)
    assert frac <= FRAC, frac
    bridge.assert_tallies_close(tl, ref_t)
    # every branch took part: escapes, FFS restarts, scatterings, and node
    # changes
    assert int((st.phase == DEAD).sum()) > int((s0.phase == DEAD).sum())
    assert int((st.phase == AT_SCATTER).sum()) > \
        int((s0.phase == AT_SCATTER).sum())
    restarted = (s0.phase == FFS) & (st.phase != FFS) & (st.wgt != s0.wgt)
    assert int(restarted.sum()) > 0
    kept = (s0.phase == FLYING) & (st.phase != DEAD)
    assert int((st.ic[kept] != s0.ic[kept]).sum()) > 0
    if 'gaps' in case:
        # lanes started in gap cells, and lanes walked into them
        gap = flight.amr.leaf(s0.ic) < 0
        assert int(gap.sum()) > 20
        assert int((flight.amr.leaf(st.ic) < 0).sum()) > 20
    if meta.static_medium and meta.uniform_temperature:
        assert torch.equal(st.xfreq[kept], s0.xfreq[kept])
    else:
        assert not torch.equal(st.xfreq[kept], s0.xfreq[kept])
    assert float(tl.Jout.sum()) > 0.0


def _closure(fn, name):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))[name]


@pytest.mark.parametrize('name', ['sphere16', 'jellyfish'])
def test_local_xcrit_matches_make_scatter(name):
    """The cell-local core-skip threshold on AMR nodes (engine.py:
    1880-1905), at tau0 1e7, where a tau dl > 1 in the dense leaves."""
    cfg, jcfg, jr, meta, dev = _build(name, core_skip=True, taumax=1e7)
    p = tscatter.ScatterParams.from_config(cfg, meta, dev)
    assert p.core_skip == tscatter.CORE_SKIP_LOCAL and p.amr is not None
    s = testing.amr_state(meta, p.amr, 8192, seed=41, face_frac=0.0)
    xc, xc2 = tscatter.local_xcrit(s, p)
    jl = _closure(jeng.make_scatter(jcfg, jr.meta), 'local_xcrit')
    jxc, jxc2 = jax.jit(jl)(jr.dev, bridge.state_to_jax(s))
    torch.testing.assert_close(xc, torch.as_tensor(np.asarray(jxc)),
                               rtol=1e-6, atol=0.0)
    torch.testing.assert_close(xc2, torch.as_tensor(np.asarray(jxc2)),
                               rtol=1e-6, atol=0.0)
    assert int((xc > 0).sum()) > 20


@pytest.mark.parametrize('name', ['sphere16_gaps', 'hubble16',
                                  'jellyfish'])
def test_peel_tau_matches_make_peel(name):
    """K7's AMR sightline (peel.py:242-290), pair by pair, from lanes in
    leaves, gaps and on faces to two observers."""
    cfg, jcfg, jr, meta, dev = _build(
        name, save_peeloff=True, nobs=2, nxim=17, nyim=17, dxim=0.15,
        dyim=0.15, distance=1e2, alpha=(0.0, 40.0), beta=(0.0, 30.0))
    p = teng.make_chunk(cfg, meta, dev).peel
    assert p.grid.amr is not None and not p.chord
    jobs_meta, _ = jobs.build_observers(jcfg)
    pd = jpeel.make_peel(jcfg, jr.meta, jobs_meta)[0]
    jtau = jax.jit(_closure(pd, 'tau_to_edge'), static_argnums=12)
    max_steps = _closure(pd, 'max_steps')
    assert max_steps == p.max_steps
    s = testing.amr_state(meta, p.grid.amr, 4096, seed=43)
    n_off = n = 0
    for o in range(p.nobs):
        pk, _, _, in_img = tpeel.obs_geometry(p, o, s.x, s.y, s.z)
        t = tpeel.tau_to_edge(p, (s.x, s.y, s.z), (s.ic, s.jc, s.kc), pk,
                              s.xfreq, in_img)
        j = jtau(jr.dev, *(jnp.asarray(v.numpy()) for v in (
            s.x, s.y, s.z, s.ic, s.jc, s.kc, *pk, s.xfreq, in_img)),
            max_steps)
        t = torch.clamp_max(t, tpeel.TAU_STOP)
        j = torch.clamp_max(torch.as_tensor(np.array(j)), tpeel.TAU_STOP)
        n_off += int((in_img & ((t - j).abs() > 1e-6 + 1e-5 * j.abs()))
                     .sum())
        n += int(in_img.sum())
        assert float(t[in_img].max()) > 1.0
    assert n > 0.3 * p.nobs * s.batch
    assert n_off <= 1e-3 * n, (n_off, n)


def test_refill_births_in_the_source_node():
    """K2's plain version on the AMR grid: each launched lane in lart_tpu's
    node of the source (amr_find_cell), launched FFS with unit weight."""
    for descent in (False, True):
        cfg, jcfg, jr, meta, dev = _build('jellyfish', descent)
        p = trefill.RefillParams.from_config(cfg, meta, dev)
        assert p.amr is not None and p.vel is not None
        s = init_state(512, 'cpu')
        tl = zero_tallies(meta.nxfreq, 0, 'cpu')
        trefill.refill(s, tl, p, seed=3, counter=1, budget=300)
        want = int(jeng.amr_find_cell(jr.dev, jr.meta, *(
            jnp.full((1,), v, jnp.float32) for v in (
                p.xs, p.ys, p.zs)))[0])
        launched = s.phase == FFS
        assert int(launched.sum()) == 300
        assert bool((s.ic[launched] == want).all())
        assert bool((s.bic[launched] == want).all())
        assert float(tl.Jin.sum()) > 0.0


def test_check_supported_on_amr():
    """AMR runs through the port; what it does not port is named."""
    teng.check_supported(testing.amr_params().resolve())
    teng.check_supported(_jelly_par().resolve())
    # the solar-CIE ion model is ported (grid/ion_data.py)
    teng.check_supported(testing.amr_params(ion_model='solar_cie').resolve())
    for over, what in ((dict(amr_type='ramses'), 'ramses'),
                       # lart_tpu would read a 3-D cube as the leaves'
                       (dict(source_geometry='diffuse_emissivity',
                             emiss_file='emiss.fits'), '3-D FITS/HDF5'),
                       # lart_tpu hands build_sources no rhokap on AMR
                       (dict(source_geometry='diffuse_emissivity',
                             emiss_file='density1'), 'density1')):
        par = testing.amr_params(**over)
        with pytest.raises(NotImplementedError, match=what):
            teng.check_supported(par.resolve())
    # the leaves' own temperature with a metal line or H2 is ported
    for over in (dict(line_id='MgII_2796'), dict(h2_model='neufeld')):
        cfg, _, _, meta, dev = _build('jellyfish', **over)
        assert not meta.uniform_temperature
        teng.check_supported(cfg, meta)


def test_reading_an_amr_file_without_h5py_names_it(monkeypatch):
    """Where h5py is missing (as on the card's machine) reading a
    generic-AMR file raises an error that names h5py and the way round it
    (the leaves in memory)."""
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError, match='h5py.*amr_data'):
        tamr.read_generic_amr(str(ROOT / 'examples/amr_sphere/amr_sphere.h5'))
