"""CPU runs behind the dust slice's statistics and its phase-4 comparison.

    python tools/dust_cpu_runs.py spread [n_runs] [nphotons]
        lart_tpu_torch on the CPU, the dusty shell of testing.dust_params
        with Stokes and one observer on +z, seeds 11, 12, ...: the spread of
        the peeled Stokes I, of the flux closure and of the scatterings per
        photon, whence testing.PEEL_V_DUST, DUST_V_NSCATT and DUST_V_NDUST
        (variance per photon in units of the mean squared).
    python tools/dust_cpu_runs.py dl2008 NAME [nphotons]
        lart_tpu's driver.run on the CPU of examples/DL2008/NAME.in cut as
        chip_smoke.py's phase 4 cuts it (N_HI 1e18, DGR times 100, which
        keeps the dust's optical depth), B = 2048, seed 7: W_esc, W_abs,
        the red share of the escaped weight and <N_scatt>, to hold beside
        the port's run on the card.

Run from the repository root with JAX_PLATFORMS=cpu.
"""

import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def spread(n_runs=8, nphotons=2000):
    import torch
    from lart_tpu_torch import driver, testing
    torch.set_num_threads(1)
    rows = []
    for seed in range(11, 11 + n_runs):
        par = dataclasses.replace(
            testing.peel_params(testing.dust_params(nphotons=nphotons),
                                nim=17), alpha=(0.0,), beta=(0.0,))
        r = driver.run(par, device='cpu', seed=seed)
        rows.append((float(r.peel['I'].sum()), testing.peel_closure(r)[0],
                     r.nscatt_gas, r.nscatt_dust))
        print(seed, *rows[-1], flush=True)
    a = np.asarray(rows)
    mean, std = a.mean(0), a.std(0, ddof=1)
    for name, m, s in zip(('Stokes I', 'closure', 'N gas', 'N dust'), mean,
                          std):
        print(f'{name}: {m:.4f} +- {s:.4f}, variance per photon / mean^2 '
              f'{(s / m) ** 2 * nphotons:.2f}')


def dl2008(name, nphotons=2000):
    from lart_tpu import driver
    from lart_tpu.config import Params
    par = Params.from_namelist(os.path.join(ROOT, 'examples', 'DL2008',
                                            name + '.in'))
    par = dataclasses.replace(par, nphotons=nphotons, out_file='',
                              batch_size=2048, N_HI=1e18,
                              DGR=par.DGR * 100.0)
    t0 = time.time()
    r = driver.run(par, seed=7)
    red = float(r.Jout[r.xfreq < 0].sum() / r.Jout.sum())
    print(f'{name} {nphotons} photons: W_esc {r.W_escape:.6f} W_abs '
          f'{r.W_absorb:.6f} W_oor {r.W_oor:.6f}, red share {red:.4f}, '
          f'<N_scatt> {r.nscatt_gas:.2f}, dust events {r.nscatt_dust:.4f}, '
          f'{time.time() - t0:.0f} s')


if __name__ == '__main__':
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == 'spread':
        spread(*(int(a) for a in args))
    else:
        dl2008(args[0], *(int(a) for a in args[1:]))
