"""CPU runs behind the phase-4 comparisons of the shearing box and of the
CALCJ/CALCP/CALCPnew maps.

    python tools/shear_cpu_runs.py shear NPHOTONS SEED
        lart_tpu's driver.run on the CPU of examples/tigress_shear/shear.in
        as written (B = 4096), with its all-photons table on: <N_scatt>,
        the rms of the escaped spectrum Jout about its mean, W_esc + W_oor,
        and each one's spread over the photons (N from the table's
        scatterings of each photon, the rms from its escape frequencies in
        the spectrum's band).
    python tools/shear_cpu_runs.py slab|sphere NPHOTONS SEED NBATCH
        lart_tpu's driver.run of chip_smoke.py phase 4's cut with calcJ,
        calcP and calcPnew on (slab: examples/slab/t1tau6.in at tauhomo
        1e4; sphere: examples/sphere/t4tau7.in at taumax 1e3), NPHOTONS
        photons in NBATCH runs from seeds SEED, SEED + 1, ...: each run's
        normalized Pa, Pnew and J1 (summed over frequency and over bins).

Each prints one line, and merges its figures into tools/shear_cpu_runs.json
(the file chip_smoke.py phase 4 holds the card's runs against).  Run from
the repository root with JAX_PLATFORMS=cpu.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))
OUT = os.path.join(ROOT, 'tools', 'shear_cpu_runs.json')

# chip_smoke.py phase 4's cuts of the maps' examples
CUTS = {'slab': ('slab/t1tau6.in', dict(tauhomo=1e4)),
        'sphere': ('sphere/t4tau7.in', dict(taumax=1e3))}
MAPS = dict(calcJ=True, calcP=True, calcPnew=True)


def cut_params(name, **over):
    """The Params of a CUTS entry with the maps on (the port's Params)."""
    from lart_tpu_torch.config import Params
    rel, cut = CUTS[name]
    par = Params.from_namelist(os.path.join(ROOT, 'examples', rel))
    for k, v in dict(cut, **MAPS, **over).items():
        setattr(par, k, v)
    return par


def shear(nphotons, seed):
    import _torch_jax_bridge as bridge
    from lart_tpu import driver
    from lart_tpu_torch import testing
    from lart_tpu_torch.config import Params
    par = Params.from_namelist(os.path.join(
        ROOT, 'examples', 'tigress_shear', 'shear.in'))
    par.nphotons, par.batch_size = int(nphotons), 4096
    par.save_all_photons = True
    res = driver.run(bridge.jax_params(par), seed=int(seed))
    ap = res.allph
    ns = np.asarray(ap['nscatt_gas'], np.float64)
    # the escapes inside the spectrum's band, which Jout holds
    xf = np.asarray(ap['xfreq2'], np.float64)
    xf = xf[(xf >= res.meta.xfreq_min) & (xf < res.meta.xfreq_max)]
    mu, var = xf.mean(), xf.var()
    m4 = ((xf - mu) ** 4).mean()
    return {'photons': int(nphotons), 'N': float(res.nscatt_gas),
            'N_spread': float(ns.std()),
            'rms': testing.spectrum_rms(res.xfreq, res.Jout),
            # the rms of n escapes has the standard error
            # sqrt((m4 - var^2) / (4 var n)): one photon's spread below
            'rms_spread': float(np.sqrt((m4 - var * var) / (4.0 * var))),
            'W': float(res.W_escape + res.W_oor),
            'omega_shear': float(res.meta.omega_shear)}


def maps(name, nphotons, seed, nbatch):
    import _torch_jax_bridge as bridge
    from lart_tpu import driver
    from lart_tpu_torch import testing
    n = int(nphotons) // int(nbatch)
    runs = []
    for i in range(int(nbatch)):
        par = cut_params(name, nphotons=n, batch_size=4096)
        res = driver.run(bridge.jax_params(par), seed=int(seed) + i)
        maps = testing.run_maps(res)
        runs.append(dict({k: np.asarray(v, np.float64).tolist()
                          for k, v in maps.items()},
                         N=float(res.nscatt_gas)))
    return {'photons_per_run': n, 'runs': runs,
            'geometry_JPa': int(res.meta.geometry_JPa)}


def main(name, nphotons, seed, nbatch=1):
    t0 = time.time()
    out = shear(nphotons, seed) if name == 'shear' \
        else maps(name, nphotons, seed, nbatch)
    out['seconds'] = time.time() - t0
    data = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            data = json.load(f)
    data[name] = out
    with open(OUT, 'w') as f:
        json.dump(data, f, indent=1, sort_keys=True)
    if name == 'shear':
        print(f'shear.in as written, {nphotons} photons from seed {seed}: '
              f'<N_scatt> {out["N"]:.6e} (one photon\'s spread '
              f'{out["N_spread"]:.6e}), Jout rms {out["rms"]:.6e} (one '
              f'photon\'s spread {out["rms_spread"]:.6e}), W_esc + W_oor '
              f'{out["W"]:.6f}, omega_shear {out["omega_shear"]:.6f}; '
              f'{out["seconds"]:.1f} s', flush=True)
    else:
        r = out['runs']
        print(f'{name} with the maps, {nphotons} photons in {nbatch} runs '
              f'from seed {seed}: <N_scatt> '
              f'{np.mean([x["N"] for x in r]):.6e}, sum Pa '
              f'{np.mean([np.sum(x["Pa"]) for x in r]):.6e}, sum Pnew '
              f'{np.mean([np.sum(x["Pnew"]) for x in r]):.6e}; '
              f'{out["seconds"]:.1f} s', flush=True)


if __name__ == '__main__':
    main(*sys.argv[1:5])
