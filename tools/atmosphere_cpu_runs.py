"""CPU runs behind the atmospheres' phase-4 comparison.

    python tools/atmosphere_cpu_runs.py NAME NPHOTONS SEED [NBATCH]
        lart_tpu's driver.run on the CPU of
        lart_tpu_torch.testing.SOURCE_CASES[NAME] (a090:
        star_planet_a090.in as written, a090_transit: the same with its
        observer on +z and Direct0, wasp52b: wasp52b_like.in as written)
        or of the plane atmosphere lit by plane_illumination (plane:
        testing.plane_atmosphere_params), NPHOTONS photons in NBATCH runs
        (1 by default) from seeds SEED, SEED + 1, ..., at B = 4096, without
        peel-off but for a090_transit.  It prints <N_scatt>, W_esc + W_abs2
        + W_oor against the birth weights in the band (Jin's sum), the
        Jabs2 share, the normalized flux factor and nrejected, and for
        a090_transit the transit depth 1 - Direct / Direct0; each as the
        mean over the runs and, with NBATCH > 1, the spread of one photon
        (the runs' standard error times sqrt(NPHOTONS)), to hold beside the
        port's run on the card (chip_smoke.py phase 4, atmosphere_cli).

Run from the repository root with JAX_PLATFORMS=cpu.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))


def one(name, nphotons, seed):
    import _torch_jax_bridge as bridge
    from lart_tpu import driver
    from lart_tpu_torch import testing
    over = dict(nphotons=int(nphotons), batch_size=4096)
    if name == 'plane':
        par = testing.plane_atmosphere_params(**over)
    else:
        par = testing.source_params(
            name, ROOT, **over,
            **({} if name == 'a090_transit' else {'save_peeloff': False}))
    res = driver.run(bridge.jax_params(par), seed=int(seed))
    b = testing.atmosphere_budget(res)
    b['nrej'] = res.nrejected
    if name == 'a090_transit':
        b['depth'] = testing.transit(res)[0]
    return b


def main(name, nphotons, seed, nbatch=1):
    n, nb = int(nphotons), int(nbatch)
    t0 = time.time()
    runs = [one(name, n // nb, int(seed) + i) for i in range(nb)]
    keys = ('N', 'share', 'ff', 'total', 'birth', 'W_oor', 'nrej') + (
        ('depth',) if name == 'a090_transit' else ())
    parts = []
    for k in keys:
        v = np.array([r[k] for r in runs], np.float64)
        msg = f'{k} {v.mean():.6e}'
        if nb > 1:
            msg += f' (one photon\'s spread {v.std(ddof=1) * np.sqrt(n / nb):.6e})'
        parts.append(msg)
    print(f'{name} {n} photons in {nb} runs from seed {seed}: '
          + ', '.join(parts) + f'; {time.time() - t0:.1f} s', flush=True)


if __name__ == '__main__':
    main(*sys.argv[1:5])
