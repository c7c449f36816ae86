"""CPU runs behind the per-cell temperature's phase-4 comparison.

    python tools/temperature_cpu_runs.py NAME NPHOTONS SEED
        lart_tpu's driver.run on the CPU of
        lart_tpu_torch.testing.SOURCE_CASES[NAME] (AlII: AlII_ex.in as
        written, with its temp_file) with NPHOTONS photons at B = 4096 and
        SEED, without peel-off and sight-line maps (the scatterings do not
        depend on them): <N_scatt>, W_esc + W_abs + W_oor and the birth
        weights in the band (Jin's sum), to hold beside the port's run on
        the card (chip_smoke.py phase 4, temperature_cli).

Run from the repository root with JAX_PLATFORMS=cpu.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))


def main(name, nphotons, seed):
    import _torch_jax_bridge as bridge
    from lart_tpu import driver
    from lart_tpu_torch import testing
    par = testing.source_params(name, ROOT, nphotons=int(nphotons),
                                batch_size=4096, save_peeloff=False,
                                save_sightline_tau=False)
    t0 = time.time()
    res = driver.run(bridge.jax_params(par), seed=int(seed))
    w = res.W_escape + (res.W_absorb or 0.0) + res.W_oor
    print(f'{name} {nphotons} photons seed {seed}: <N_scatt> '
          f'{res.nscatt_gas:.4f}, W_esc + W_abs + W_oor {w:.6f}, birth '
          f'weights in the band {testing.birth_weight(res):.6f}, '
          f'{time.time() - t0:.1f} s', flush=True)


if __name__ == '__main__':
    main(*sys.argv[1:4])
