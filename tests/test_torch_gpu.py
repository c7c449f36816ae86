"""The CUDA kernels on the card: each against its plain PyTorch version,
and the slab through the driver with every kernel of the path launched.

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
