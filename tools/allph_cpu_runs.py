"""CPU runs behind the all-photons table's phase-4 comparison.

    python tools/allph_cpu_runs.py NAME NPHOTONS SEED
        lart_tpu's driver.run on the CPU of
        lart_tpu_torch.testing.SOURCE_CASES[NAME + '_allph'] (the cuts
        chip_smoke.py phase 4 runs on the card with save_all_photons:
        t4tau7, DL20e_dust, amr_sphere, clumps_overlap) with NPHOTONS
        photons at B = 4096 and SEED (a clump medium: its population from
        the default seed, iseed + 77, as the card's CLI run builds it;
        the photons from SEED): the table's summary
        (lart_tpu_torch.testing.allph_summary: <nscatt_gas> and one photon's
        spread, the quantiles and the histograms of xfreq1, xfreq2 and rp),
        its closures (testing.allph_closures), <N_scatt> and the weight
        budget.  amr_sphere takes its leaves from
        lart_tpu.grid.amr.make_amr_sphere(32, 1), which
        examples/amr_sphere/amr_sphere.h5 holds column for column, as the
        card's run does.

Merges the summary into tools/allph_cpu_runs.json under NAME, one line a
case (the file chip_smoke.py phase 4 holds the card's tables against) and
prints one line.  Run from the repository root with JAX_PLATFORMS=cpu.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))
OUT = os.path.join(ROOT, 'tools', 'allph_cpu_runs.json')


def run(name, nphotons, seed):
    import _torch_jax_bridge as bridge
    from lart_tpu import driver
    from lart_tpu_torch import testing
    par = testing.source_params(name + '_allph', ROOT, nphotons=int(nphotons),
                                batch_size=4096)
    jpar = bridge.jax_params(par)
    with tempfile.TemporaryDirectory() as td:
        if par.use_amr_grid:
            from lart_tpu.grid.amr import make_amr_sphere, write_generic_amr
            jpar.amr_file = os.path.join(td, 'amr_sphere.h5')
            write_generic_amr(jpar.amr_file, make_amr_sphere(32, 1))
        if par.use_clump_medium:
            # the population from iseed + 77, as the CLI's (seed None)
            from lart_tpu.grid import clump as jclump
            build = jclump.build_clumps
            jclump.build_clumps = lambda cfg, seed=None, **kw: build(
                cfg, seed=jpar.iseed + 77, **kw)
        res = driver.run(jpar, seed=int(seed))
    meta = res.meta
    summary = testing.allph_summary(res.allph, testing.allph_edges(
        meta.xfreq_min, meta.xfreq_max, res.cfg.par.rmax))
    summary.update(
        photons=int(nphotons), seed=int(seed),
        xfreq=[float(meta.xfreq_min), float(meta.xfreq_max)],
        rmax=float(res.cfg.par.rmax),
        nscatt_gas=float(res.nscatt_gas),
        W=float(res.W_escape + (res.W_absorb or 0.0) + res.W_oor),
        closures={k: list(v) for k, v in
                  testing.allph_closures(res, summary).items()})
    return summary


def main(name, nphotons, seed):
    t0 = time.time()
    out = run(name, nphotons, seed)
    out['seconds'] = time.time() - t0
    data = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            data = json.load(f)
    data[name] = out
    with open(OUT, 'w') as f:
        f.write('{\n' + ',\n'.join(
            f' {json.dumps(k)}: {json.dumps(v, sort_keys=True)}'
            for k, v in sorted(data.items())) + '\n}\n')
    print(f'{name} with save_all_photons, {nphotons} photons from seed '
          f'{seed}: table <nscatt_gas> {out["N"]:.6e} (one photon\'s spread '
          f'{out["N_spread"]:.6e}), <N_scatt> {out["nscatt_gas"]:.6e}, '
          f'W {out["W"]:.6f}, rp q95 {out["rp_q95"]:.4f}, closures '
          f'{out["closures"]}; {out["seconds"]:.1f} s', flush=True)


if __name__ == '__main__':
    main(*sys.argv[1:4])
