"""The volume and table sources of the port end to end against lart_tpu on
the CPU.

- examples/HeI_sphere_cont/t4tau2.in (He I 10833, a uniform_sphere source
  with a flat continuum in a sphere at tau 100) cut to a 17^3 grid and
  2e4 photons through both packages' drivers: <N_scatt> within 5% and the
  escaped spectra's shapes by chi2/dof < 3.
- examples/jellyfish_rmhd/jellyfish_emiss.in's diffuse_emissivity over
  the AMR leaves of testing.jellyfish_amr: the histogram of 2^17 births'
  leaves, weighted by their birth weights, against the leaves' share of
  the emissivity, by chi-square over the leaves that hold at least 20
  expected births.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

from lart_tpu_torch import testing
from lart_tpu_torch.grid import amr as tamr
from lart_tpu_torch.transport import refill as trefill
from lart_tpu_torch.transport.state import FFS, init_state, zero_tallies

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The plain versions in one thread: their ops are small, and the
    other test workers share the cores (torch's thread pool would spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_t4tau2_matches_lart_tpu():
    n = 20_000
    par = testing.source_params('t4tau2', ROOT, nx=17, ny=17, nz=17,
                                nphotons=n, batch_size=4096)
    res = bridge.run_port_cpu(par, seed=5)
    J_j, _, N_j = bridge.run_jax_chunks(par, seed=9)
    J_t, _, N_t = testing.run_tallies(res)
    assert abs(N_t / N_j - 1.0) < 0.05, (N_t, N_j)
    chi2, bins = testing.spectra_chi2(J_t, J_j, n * res.W_escape,
                                      float(J_j.sum()))
    assert bins > 20 and chi2 < 3.0, (chi2, bins)
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-3


def test_amr_emissivity_births_follow_the_leaves():
    n = 1 << 17
    par = testing.source_params('jellyfish_emiss', ROOT, taumax=10.0,
                                batch_size=n)
    cfg = par.resolve()
    built = tamr.build_amr(cfg, data=testing.jellyfish_amr(), device='cpu')
    meta, grid = built.meta, built.dev
    rp = trefill.RefillParams.from_config(
        cfg, meta, grid, host_data={'emissivity': built.emissivity})
    assert rp.kernel == 'refill_alias'
    s = init_state(n, 'cpu')
    tl = zero_tallies(meta.nxfreq, 0, 'cpu')
    trefill.refill(s, tl, rp, seed=8, counter=1, budget=n)
    assert bool((s.phase == FFS).all())
    leaf = rp.amr.leaf(s.ic).numpy()
    nleaf = built.emissivity.size
    # the weighted histogram of the birth leaves estimates n times each
    # leaf's share of the emissivity
    share = built.emissivity / built.emissivity.sum()
    hist = np.bincount(leaf, weights=s.wgt.double().numpy(),
                       minlength=nleaf)
    hits = np.bincount(leaf, minlength=nleaf)
    sel = share * n >= 20.0
    # each leaf's variance: its births' count times their weight squared
    w = np.where(hits > 0, hist / np.maximum(hits, 1), 0.0)
    var = np.maximum(hits, 1) * w ** 2
    chi2 = float(np.sum((hist[sel] - n * share[sel]) ** 2 / var[sel]))
    dof = int(sel.sum())
    assert dof > 100 and stats.chi2.sf(chi2, dof) > 1e-3, (chi2, dof)
    assert abs(hist.sum() / n - 1.0) < 5.0 * math.sqrt(
        float(s.wgt.double().var()) / n)
