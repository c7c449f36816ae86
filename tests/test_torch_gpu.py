"""The CUDA kernels on the card: each against its plain PyTorch version,
and the slab and sphere paths through the driver with every kernel of the
path launched.

These tests need a CUDA device and nvcc; without them they skip.  The
card's machine has no jax, so run them there without the repository's
conftest (which selects jax's CPU backend):

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances are those of chip_smoke.py phase 2 and 3: lane fields to rtol
1e-5, at most 1e-4 of the lanes differing where an f32 decision flips,
tallies to 1e-5 of their sum (atomics add in no fixed order)."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU and nvcc')
    return torch.device('cuda')


def test_kernels_match_plain_versions(cuda):
    import chip_smoke
    chip_smoke.B_MAIN = 8192
    res = chip_smoke.phase2(cuda)
    assert set(res) == {'voigt_h', 'refill_point', 'fly_uniform_slab',
                        'fly_cartesian', 'fly_uniform_sphere',
                        'scatter_lya'}


def test_driver_runs_the_kernels(cuda):
    import numpy as np

    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = testing.slab_params(tau0=10.0, nz=33, nphotons=2000, batch=1024)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=1)
    assert all(kb.LAUNCHES[k] > 0 for k in ('refill_point',
                                            'fly_uniform_slab',
                                            'scatter_lya'))
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-5
    assert np.all(np.isfinite(res.Jout))


FLIGHTS = {    # case: (testing helper, overrides, kernel)
    'cartesian_hubble': ('hubble_params', {}, 'fly_cartesian'),
    'cartesian_sphere': ('sphere_params', {'force_generic_kernel': True},
                         'fly_cartesian'),
    'uniform_sphere': ('sphere_params', {}, 'fly_uniform_sphere'),
}


@pytest.mark.parametrize('case', sorted(FLIGHTS))
def test_flight_kernel_matches_plain(cuda, case):
    """K5 (reflect + Hubble flow; escape) and K6 on 33^3 grids."""
    import sys

    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.kernels import build as kb
    from lart_tpu_torch.transport.engine import make_fly
    from lart_tpu_torch.transport.state import zero_tallies
    helper, over, kernel = FLIGHTS[case]
    cfg = getattr(testing, helper)(tau0=1e4, n=33, **over).resolve()
    meta, grid = build_cartesian(cfg, device=cuda)
    flight = make_fly(cfg, meta, grid)
    mod = sys.modules[type(flight).__module__]
    s0 = testing.mixed_state(meta, 65536, seed=8, device=cuda)
    sk, sp = testing.clone_state(s0), testing.clone_state(s0)
    tk = zero_tallies(meta.nxfreq, 8, cuda)
    tp = zero_tallies(meta.nxfreq, 8, cuda)
    n0 = kb.LAUNCHES[kernel]
    mod.fly(sk, tk, flight, 8)
    mod.fly_plain(sp, tp, flight, 8)
    torch.cuda.synchronize()
    assert kb.LAUNCHES[kernel] == n0 + 1
    frac, _ = testing.compare_states(sk, sp, 1e-5, 1e-6)
    assert frac <= 1e-4, frac
    for f in ('Jout', 'Jmu', 'W_oor'):
        u, v = getattr(tk, f), getattr(tp, f)
        assert float((u - v).abs().max()) <= 1e-5 * max(
            float(v.abs().sum()), 1.0), f


@pytest.mark.parametrize('helper,fly', [('sphere_params', 'fly_uniform_sphere'),
                                        ('hubble_params', 'fly_cartesian')])
def test_driver_runs_the_sphere_kernels(cuda, helper, fly):
    import numpy as np

    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = getattr(testing, helper)(tau0=10.0, n=17, nphotons=2000,
                                   batch=1024)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=1)
    assert all(kb.LAUNCHES[k] > 0 for k in ('refill_point', fly,
                                            'scatter_lya'))
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-5
    assert np.all(np.isfinite(res.Jout))
