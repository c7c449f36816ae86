"""The Stokes branch of lart_tpu_torch's scatter (K4) and the polarized
birth of its refill (K2) against lart_tpu, on the CPU.

The two packages draw from different generators, so the scattered lanes
are held to two-sample Kolmogorov-Smirnov tests (p > 1e-3) and accepted
fractions within 0.01, as tests/test_torch_transport.py holds the
unpolarized scatter; the birth triad, the peel record and the triad's
orthonormality are exact rules, checked to 1e-5 (f32)."""

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from lart_tpu.grid import cartesian as jcart
from lart_tpu.transport import engine as jeng
from lart_tpu_torch import convert, testing
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.instruments.peel import PeelRecord
from lart_tpu_torch.transport import engine as teng
from lart_tpu_torch.transport import refill, scatter
from lart_tpu_torch.transport.state import (AT_SCATTER, DEAD, FLYING,
                                            LANE_FIELDS, zero_tallies)

import _torch_jax_bridge as bridge


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The plain versions in one torch thread: under Tier-1's six workers
    torch's default pool oversubscribes the cores (in a whole run
    test_triad_stays_orthonormal_after_many_scatterings took 470 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

P_MIN = 1e-3
TRIAD = ('kx', 'ky', 'kz', 'mx', 'my', 'mz', 'nnx', 'nny', 'nnz')


def _setup(**kw):
    cfg, jcfg = bridge.resolve_both(testing.slab_params(use_stokes=True,
                                                        **kw))
    meta, grid = build_cartesian(cfg)
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    ch = teng.make_chunk(cfg, meta, grid)
    assert ch.scatter_params.stokes
    return cfg, jcfg, meta, jmeta, jgrid, ch


def _triad_error(s, sel):
    """Largest deviation of (k, m, n) from a right-handed orthonormal
    triad on the lanes `sel`."""
    k = torch.stack([s.kx, s.ky, s.kz])[:, sel].double()
    m = torch.stack([s.mx, s.my, s.mz])[:, sel].double()
    n = torch.stack([s.nnx, s.nny, s.nnz])[:, sel].double()
    errs = [(k * k).sum(0) - 1.0, (m * m).sum(0) - 1.0, (k * m).sum(0),
            *(n - torch.linalg.cross(k, m, dim=0))]
    return max(float(e.abs().max()) for e in errs)


@pytest.mark.parametrize('x', [0.0, 3.0])
def test_scatter_stokes_matches_jax(x):
    cfg, jcfg, meta, jmeta, jgrid, ch = _setup()
    B = 50_000
    s0 = testing.mixed_state(meta, B, seed=int(x) + 17)
    rng = np.random.default_rng(int(x) + 5)
    at = torch.from_numpy(rng.random(B) < 0.95)
    s0.phase.copy_(torch.where(at, AT_SCATTER, s0.phase))
    s0.xfreq.copy_(torch.from_numpy(np.float32(x) * np.where(
        rng.random(B) < 0.5, -1.0, 1.0).astype(np.float32)))
    at = s0.phase == AT_SCATTER

    st = testing.clone_state(s0)
    tl = zero_tallies(meta.nxfreq, 8, 'cpu')
    rec = PeelRecord.zeros(B, 'cpu')
    scatter.scatter(st, tl, ch.scatter_params, seed=5, counter=3,
                    record=rec)
    js, _ = jax.jit(jeng.make_scatter(jcfg, jmeta))(
        bridge.state_to_jax(s0), jgrid, jeng.zero_tallies(meta.nxfreq, nmu=8),
        jax.random.PRNGKey(int(x) + 2))
    ref = convert.state_from_jax(js)

    for f in LANE_FIELDS:
        for out in (st, ref):
            assert torch.equal(getattr(out, f)[~at], getattr(s0, f)[~at])
    acc_t = at & (st.phase == FLYING)
    acc_j = at & (ref.phase == FLYING)
    frac_t = float(acc_t.sum()) / float(at.sum())
    frac_j = float(acc_j.sum()) / float(at.sum())
    assert abs(frac_t - frac_j) < 0.01, (frac_t, frac_j)
    # a lane that fails the azimuth rounds keeps its whole state
    for f in LANE_FIELDS:
        assert torch.equal(getattr(st, f)[at & ~acc_t],
                           getattr(s0, f)[at & ~acc_t])

    def cos_turn(out, acc):
        return (out.kx * s0.kx + out.ky * s0.ky + out.kz * s0.kz)[acc]

    def azimuth(out, acc):
        """The turn's azimuth about the old k, from the old (m, n)."""
        return torch.atan2(out.kx * s0.nnx + out.ky * s0.nny
                           + out.kz * s0.nnz,
                           out.kx * s0.mx + out.ky * s0.my
                           + out.kz * s0.mz)[acc]

    for name, a, b in (
            ('|xfreq|', st.xfreq[acc_t].abs(), ref.xfreq[acc_j].abs()),
            ("cos(k, k')", cos_turn(st, acc_t), cos_turn(ref, acc_j)),
            ('azimuth', azimuth(st, acc_t), azimuth(ref, acc_j)),
            ('Q', st.Q[acc_t], ref.Q[acc_j]),
            ('U', st.U[acc_t], ref.U[acc_j]),
            ('V', st.V[acc_t], ref.V[acc_j])):
        p = ks_2samp(a.numpy(), b.numpy()).pvalue
        assert p > P_MIN, (name, x, p)
    assert _triad_error(st, acc_t) < 1e-5
    assert _triad_error(ref, acc_j) < 1e-5

    # the peel record: the scattered lanes, before their turn
    assert torch.equal(rec.flag.bool(), acc_t)
    for f in TRIAD + ('Q', 'U', 'V'):
        assert torch.equal(getattr(rec, f)[acc_t], getattr(s0, f)[acc_t]), f
    # xfreq_atom = x - u_par, with u_par the record's uz
    upar = (s0.xfreq - rec.xatom)[acc_t]
    torch.testing.assert_close(upar, rec.uz[acc_t], rtol=0, atol=1e-5)


def test_refill_births_unpolarized_with_the_triad():
    """A launched lane is unpolarized with the reference triad
    m = (cos t cos p, cos t sin p, -sin t), n = (-sin p, cos p, 0) of its
    direction k = (sin t cos p, sin t sin p, cos t) (engine.py:2863-2873);
    the record flags exactly the launched lanes."""
    cfg, _, meta, _, _, ch = _setup()
    B = 20_000
    s0 = testing.mixed_state(meta, B, seed=19)
    st = testing.clone_state(s0)
    rec = PeelRecord.zeros(B, 'cpu')
    rec.flag.fill_(7)
    budget = int((s0.phase == DEAD).sum()) // 2
    refill.refill(st, zero_tallies(meta.nxfreq, 8, 'cpu'), ch.refill_params,
                  seed=3, counter=4, budget=budget, record=rec)
    new = s0.phase == DEAD
    new &= st.phase != DEAD
    assert int(new.sum()) == budget
    assert torch.equal(rec.flag.bool(), new)
    for f in LANE_FIELDS:
        assert torch.equal(getattr(st, f)[~new], getattr(s0, f)[~new]), f
    for f in ('Q', 'U', 'V', 'nnz'):
        assert bool((getattr(st, f)[new] == 0.0).all()), f
    kx, ky, kz = st.kx[new].double(), st.ky[new].double(), st.kz[new].double()
    sint = torch.sqrt(1.0 - kz * kz)
    cosp, sinp = kx / sint, ky / sint
    for f, want in (('mx', kz * cosp), ('my', kz * sinp), ('mz', -sint),
                    ('nnx', -sinp), ('nny', cosp)):
        torch.testing.assert_close(getattr(st, f)[new].double(), want,
                                   rtol=0, atol=1e-4, msg=f)
    assert _triad_error(st, new) < 1e-5


def test_triad_stays_orthonormal_after_many_scatterings():
    """The re-orthonormalization after each turn keeps (k, m, n) a
    right-handed orthonormal triad to 1e-5 over 400 scatterings of every
    lane, and the Stokes vector inside the unit ball."""
    cfg, _, meta, _, _, ch = _setup()
    B = 2048
    st = testing.mixed_state(meta, B, seed=23)
    tl = zero_tallies(meta.nxfreq, 8, 'cpu')
    n_sc = torch.zeros(B, dtype=torch.int32)
    for i in range(400):
        st.phase.fill_(AT_SCATTER)
        st.xfreq.fill_(0.5)
        scatter.scatter(st, tl, ch.scatter_params, seed=9, counter=i)
        n_sc += (st.phase == FLYING).to(torch.int32)
    assert int(n_sc.min()) >= 300, int(n_sc.min())
    assert _triad_error(st, torch.ones(B, dtype=torch.bool)) < 1e-5
    pol = st.Q.double() ** 2 + st.U.double() ** 2 + st.V.double() ** 2
    assert float(pol.max()) <= 1.0 + 1e-5
    assert float(pol.mean()) > 1e-4     # the scatterings polarize
