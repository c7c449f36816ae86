"""CPU runs behind the interior-observer slice's phase-4 comparison.

    python tools/civ_cpu_runs.py PACKAGE NPHOTONS SEED
        driver.run on the CPU of examples/healpix_CIV/CIV_test.in as written
        (no peel-off: the scatterings do not depend on it) with NPHOTONS
        photons at B = 4096 and SEED, through lart_tpu (PACKAGE jax) or the
        port's plain versions (PACKAGE torch): <N_scatt> and W_esc + W_oor,
        to hold beside the port's run on the card (chip_smoke.py phase 4)
        and examples/RUNLOG.md's 2000-photon row.

Run from the repository root with JAX_PLATFORMS=cpu.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))


def main(package, nphotons, seed):
    from lart_tpu_torch.config import Params
    par = Params.from_namelist(os.path.join(
        ROOT, 'examples/healpix_CIV/CIV_test.in'))
    par.nphotons, par.batch_size = int(nphotons), 4096
    t0 = time.time()
    if package == 'jax':
        import _torch_jax_bridge as bridge
        from lart_tpu import driver
        res = driver.run(bridge.jax_params(par), seed=int(seed))
    else:
        from lart_tpu_torch import driver
        res = driver.run(par, device='cpu', seed=int(seed))
    print(f'{package} {nphotons} photons seed {seed}: <N_scatt> '
          f'{res.nscatt_gas:.4f}, W_esc + W_oor '
          f'{res.W_escape + res.W_oor:.6f}, {time.time() - t0:.1f} s')


if __name__ == '__main__':
    main(*sys.argv[1:4])
