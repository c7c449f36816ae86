#!/usr/bin/env python3
"""Smoke test of lart_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, runs the slab, the uniform
sphere and the expanding Hubble sphere end to end through the driver and
the CLI, and measures their steady-state rates.

    python3 chip_smoke.py            # every phase, needs one CUDA device
    python3 chip_smoke.py --phases 0,1,2

Phases (one line each, or more):
  0  card name and power limit (nvidia-smi), torch / CUDA / nvcc versions
  1  build K1-K6 from lart_tpu_torch/csrc with nvcc (one per source, in
     parallel)
  2  each kernel and branch against its plain version on the card at
     B = 131072: K1-K4 on the flagship slab; K5 on the 201^3 Hubble grid of
     examples/vel_effect/t4NHI2_20_V0200.in (reflect, moving) and on the
     slab with force_generic_kernel (periodic); K6 on the 129^3 sphere of
     examples/sphere/t4tau7.in; K4 core-skip, local and global, on that
     sphere, and local on the Hubble grid; K2 in the moving medium
  3  driver.run on cuda and on cpu, statistics agree: the tau0 = 100 slab,
     a 33^3 tau0 = 100 uniform sphere, a 33^3 xyz-symmetric Hubble sphere
     (Vexp 200 km/s, tau0 = 100)
  4  the main paths through the CLI (lart_tpu_torch.__main__.main), FITS
     output, launch counts read around each run: examples/slab/t1tau6.in
     (tauhomo 1e4, B = 131072); examples/sphere/t4tau7.in cut to the
     Dijkstra acceptance case (taumax 1e5, 2e4 photons; shape chi2/dof,
     peak position, W_esc); examples/vel_effect/t4NHI2_20_V0200.in at its
     201^3 grid cut to N_HI 2e18 and 1e4 photons (W_esc + W_oor)
  5  steady-state rates, B = 131072, budget 1e9 so the batch never drains:
     the flagship slab (tau0 = 1e6, nz = 201, chunk_cycles 32; 800 chunks),
     then one window of >= 1 s each of t4tau7 as written, vel_effect V0200
     as written, and the flagship slab through K5 (force_generic_kernel);
     a torch.profiler breakdown of each; each kernel's device time against
     its plain version's at the steady-state shapes
Any failure raises and exits non-zero.  Before the last line it prints one
JSON object with the kernels of the main paths, and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
It imports neither jax nor h5py.
"""

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B_MAIN = 131072
SLEEP_CYCLES = 20_000_000     # ~10 ms of GPU clock: covers 20 launches
FLAGSHIP_CHUNKS = 800         # one timed window of 1-2 s at 40-80 us a cycle
SPREAD_CHUNKS = 80
WINDOW_S = 1.0                # the shortest timed window of the other cells
LANE_RTOL, LANE_ATOL, MAX_FRAC = 1e-5, 1e-6, 1e-4


def log(phase, msg):
    print(f'[phase {phase}] {msg}', flush=True)


def smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time(fn, reps, before=None):
    """Mean ms of fn() over reps calls, CUDA events around each call (the
    host's launch time included); before() runs untimed ahead of each."""
    total = 0.0
    for _ in range(reps):
        if before is not None:
            before()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def turns(kernel, plain, reps, before=None):
    """(kernel ms, plain ms) measured in turns plain, kernel, kernel, plain."""
    p1 = cuda_time(plain, reps, before)
    k1 = cuda_time(kernel, reps, before)
    k2 = cuda_time(kernel, reps, before)
    p2 = cuda_time(plain, reps, before)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def example_params(rel, **over):
    """examples/<rel> as Params, with the keys of `over` replaced."""
    from lart_tpu.config import Params
    par = Params.from_namelist(str(ROOT / 'examples' / rel))
    for k, v in over.items():
        setattr(par, k, v)
    return par


def namelist_variant(rel, out_dir, **over):
    """examples/<rel> rewritten into out_dir with `over` set (one
    par%key = value per line) and FITS output."""
    text = (ROOT / 'examples' / rel).read_text()
    text = re.sub(r"(?m)^\s*par%out_file\s*=.*\n", '', text)
    over = dict(over, file_format="'fits'")
    for k, v in over.items():
        line = f' par%{k} = {v}'
        text, n = re.subn(rf'(?m)^\s*par%{k}\s*=.*$', line, text)
        if not n:
            text = text.rstrip()
            assert text.endswith('/'), 'namelist must end with /'
            text = text[:-1].rstrip() + f'\n{line}\n/\n'
    path = Path(out_dir) / Path(rel).name
    path.write_text(text)
    return path


def phase0():
    from lart_tpu_torch.kernels.build import find_nvcc
    nvcc = subprocess.run([find_nvcc(), '--version'], capture_output=True,
                          text=True, check=True).stdout
    m = re.search(r'release ([0-9.]+)', nvcc)
    log(0, f'{smi()} | torch {torch.__version__} cuda {torch.version.cuda} '
           f'nvcc {m.group(1) if m else "?"} | {torch.cuda.get_device_name(0)}'
           f' x{torch.cuda.device_count()}')


def phase1():
    from lart_tpu_torch.kernels import build as kb
    t0 = time.time()
    kb.library()
    regs = re.findall(r"Compiling entry function '_Z(\d+)(\w+)'|Used (\d+) "
                      r"registers", kb.BUILD_INFO.get('ptxas', ''))
    per = {}
    name = None
    for n, fn, used in regs:
        if fn:
            name = fn[:int(n)]
        elif name:
            per[name] = int(used)
    log(1, f'built {Path(kb.BUILD_INFO["path"]).name} from '
           f'{len(kb.SOURCES)} sources in {kb.BUILD_INFO["seconds"]:.1f} s '
           f'(load {time.time() - t0:.1f} s); ptxas registers: {per}')


def both(meta, state_seed, step, check_tallies, dev, r_max=None, nmu=8):
    """step(state, tallies, kernel) through the kernel and through the
    plain version from one mixed state; returns (s0, kernel state, fraction
    of lanes differing, max abs error of the others, tallies' max |d|)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.transport.state import zero_tallies
    s0 = testing.mixed_state(meta, B_MAIN, state_seed, dev, r_max=r_max)
    sk, sp = testing.clone_state(s0), testing.clone_state(s0)
    tk = zero_tallies(meta.nxfreq, nmu, dev)
    tp = zero_tallies(meta.nxfreq, nmu, dev)
    step(sk, tk, True)
    step(sp, tp, False)
    torch.cuda.synchronize()
    frac, err = testing.compare_states(sk, sp, LANE_RTOL, LANE_ATOL)
    tal = {}
    for f in check_tallies:
        u, v = getattr(tk, f), getattr(tp, f)
        if u.numel() == 0:      # Jmu without save_Jmu
            continue
        atol = 1e-5 * max(float(v.abs().sum()), 1.0)
        d = float((u - v).abs().max())
        assert d <= atol, (f, d, atol)
        tal[f] = d
    assert frac <= MAX_FRAC, frac
    return s0, sk, frac, err, tal


def _max_err(res, name, err):
    res.setdefault(name, {'max_abs_err': 0.0})
    res[name]['max_abs_err'] = max(res[name]['max_abs_err'], err)


def phase2(dev):
    """Kernel vs plain version on the card, lane by lane."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.physics.voigt import voigt, voigt_plain
    from lart_tpu_torch.transport import fly_slab, refill, scatter
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.state import DEAD, zero_tallies
    res = {}

    # K1 over all four Humlicek regions
    rng = np.random.default_rng(11)
    n = 1 << 20
    x = np.concatenate([rng.uniform(-3e3, 3e3, n // 4),
                        rng.uniform(-20.0, 20.0, n // 4),
                        rng.uniform(-6.0, 6.0, n // 4),
                        np.sign(rng.uniform(-1, 1, n // 4))
                        * np.exp(rng.uniform(-7.0, 8.0, n // 4))])
    a = np.exp(rng.uniform(np.log(1e-6), np.log(0.1), n))
    s = np.abs(x) + a
    region = np.where(s >= 15, 1, np.where(s >= 5.5, 2, np.where(
        a >= 0.195 * np.abs(x) - 0.176, 3, 4)))
    counts = np.bincount(region, minlength=5)[1:]
    assert (counts > 1000).all(), counts
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    at = torch.as_tensor(a, dtype=torch.float32, device=dev)
    hk, hp = voigt(xt, at), voigt_plain(xt, at)
    torch.cuda.synchronize()
    rel = ((hk - hp).abs() / hp.abs()).max().item()
    assert torch.isfinite(hk).all() and rel <= 2e-5, rel
    res['voigt_h'] = {'max_abs_err': (hk - hp).abs().max().item()}
    log(2, f'K1 voigt_h: {n} points, regions I-IV {counts.tolist()}, max rel '
           f'err {rel:.3e} (rtol 2e-5)')

    # flagship slab at the main path's batch
    par = testing.slab_params(tau0=1e6, nz=201, nphotons=10 ** 9,
                              batch=B_MAIN, chunk_cycles=32)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    nx = meta.nxfreq

    def fly_step(chunk):
        def step(s, t, kernel):
            mod = sys.modules[type(chunk.flight).__module__]
            (mod.fly if kernel else mod.fly_plain)(
                s, t, chunk.flight, chunk.fly_substeps)
        return step

    _, _, frac, err, tal = both(meta, 21, fly_step(ch),
                                ('Jout', 'Jmu', 'W_oor'), dev)
    _max_err(res, 'fly_uniform_slab', err)
    log(2, f'K3 fly_uniform_slab: B={B_MAIN} mixed phases, lanes differing '
           f'{frac:.2e} (rtol {LANE_RTOL}, atol {LANE_ATOL}, max {MAX_FRAC}),'
           f' max abs err {err:.3e}; tallies max |d| {tal} (atol 1e-5 x sum)')

    def refill_step(chunk):
        def step(s, t, kernel):
            (refill.refill if kernel else refill.refill_plain)(
                s, t, chunk.refill_params, 7, 12345, 10 ** 9)
        return step

    s0, sk, frac, err, tal = both(meta, 22, refill_step(ch), ('Jin',), dev)
    n_dead = int((s0.phase == DEAD).sum())
    assert int(sk.n_launched[0]) == n_dead
    _max_err(res, 'refill_point', err)
    # budget-limited: exactly min(#dead, remaining) launch
    for kernel in (True, False):
        st = testing.clone_state(s0)
        rem = n_dead // 3
        (refill.refill if kernel else refill.refill_plain)(
            st, zero_tallies(nx, 8, dev), ch.refill_params, 7, 12345, rem)
        n_l = int((st.phase != s0.phase).sum())
        assert int(st.n_launched[0]) == rem and n_l == rem, (kernel, n_l, rem)
    log(2, f'K2 refill_point: {n_dead} dead lanes all launched, lanes '
           f'differing {frac:.2e}, max abs err {err:.3e}, Jin max |d| '
           f'{tal["Jin"]:.3e}; budget-limited launch count exact')

    def scatter_step(chunk):
        def step(s, t, kernel):
            (scatter.scatter if kernel else scatter.scatter_plain)(
                s, t, chunk.scatter_params, 7, 99)
        return step

    _, _, frac, err, tal = both(meta, 23, scatter_step(ch),
                                ('nscatt_gas', 'nscatt_events'), dev)
    _max_err(res, 'scatter_lya', err)
    log(2, f'K4 scatter_lya: B={B_MAIN} mixed phases, lanes differing '
           f'{frac:.2e}, max abs err {err:.3e}; nscatt max |d| {tal}')

    # K5 on the slab with force_generic_kernel: periodic x/y
    par = testing.slab_params(tau0=1e6, nz=201, batch=B_MAIN,
                              force_generic_kernel=True)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    _, _, frac, err, tal = both(meta, 24, fly_step(ch),
                                ('Jout', 'Jmu', 'W_oor'), dev, nmu=ch.nmu)
    _max_err(res, 'fly_cartesian', err)
    log(2, f'K5 fly_cartesian, slab 1x1x201 periodic (force_generic_kernel):'
           f' lanes differing {frac:.2e}, max abs err {err:.3e}; tallies '
           f'max |d| {tal}')

    # K5 and K2 on the full vel_effect grid: 201^3, reflect, Hubble flow;
    # the source moved off the centre cell, whose velocity is 0
    t0 = time.time()
    par = example_params('vel_effect/t4NHI2_20_V0200.in', batch_size=B_MAIN,
                         xs_point=0.31, ys_point=0.17, zs_point=0.05)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    t_grid = time.time() - t0
    _, _, frac, err, tal = both(meta, 25, fly_step(ch),
                                ('Jout', 'Jmu', 'W_oor'), dev, nmu=ch.nmu)
    _max_err(res, 'fly_cartesian', err)
    log(2, f'K5 fly_cartesian, vel_effect V0200 201^3 reflect + Hubble flow '
           f'(grid built in {t_grid:.1f} s): lanes differing {frac:.2e}, '
           f'max abs err {err:.3e}; tallies max |d| {tal}')
    v = ch.refill_params.v_src
    assert any(c != 0.0 for c in v), v
    s0, sk, frac, err, tal = both(meta, 26, refill_step(ch), ('Jin',), dev)
    _max_err(res, 'refill_point', err)
    log(2, f'K2 refill_point, moving medium (comoving_source false, source '
           f'cell velocity {tuple(round(c, 4) for c in v)}): lanes differing '
           f'{frac:.2e}, max abs err {err:.3e}, Jin max |d| {tal["Jin"]:.3e}')
    # K4 local core-skip with the rhokap gather (DDA path)
    cfg = example_params('vel_effect/t4NHI2_20_V0200.in', batch_size=B_MAIN,
                         core_skip=True).resolve()
    ch = make_chunk(cfg, meta, grid)
    assert ch.scatter_params.rhokap is not None
    _, _, frac, err, tal = both(meta, 27, scatter_step(ch),
                                ('nscatt_gas', 'nscatt_events'), dev,
                                r_max=1.0)
    _max_err(res, 'scatter_lya', err)
    log(2, f'K4 scatter_lya, local core-skip with the rhokap gather '
           f'(vel_effect grid): lanes differing {frac:.2e}, max abs err '
           f'{err:.3e}')
    del grid, ch

    # K6 and K4 core-skip on the t4tau7 sphere
    for glob in (False, True):
        par = example_params('sphere/t4tau7.in', batch_size=B_MAIN,
                             core_skip_global=glob)
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        if not glob:
            _, _, frac, err, tal = both(meta, 28, fly_step(ch),
                                        ('Jout', 'Jmu', 'W_oor'), dev,
                                        nmu=ch.nmu)
            _max_err(res, 'fly_uniform_sphere', err)
            log(2, f'K6 fly_uniform_sphere, t4tau7 129^3 tau 1e7: lanes '
                   f'differing {frac:.2e}, max abs err {err:.3e}; tallies '
                   f'max |d| {tal}')
        s0, sk, frac, err, tal = both(meta, 29, scatter_step(ch),
                                      ('nscatt_gas', 'nscatt_events'), dev,
                                      r_max=1.0)
        _max_err(res, 'scatter_lya', err)
        p = ch.scatter_params
        boosted = _in_core_fraction(s0, p)
        log(2, f'K4 scatter_lya, {"global" if glob else "local"} core-skip '
               f'on t4tau7 (xcrit {p.xcrit:.4f} global, rk_const '
               f'{p.rk_const:.4e}): {boosted:.3f} of the lanes in the core, '
               f'lanes differing {frac:.2e}, max abs err {err:.3e}')
    return res


def _in_core_fraction(s0, p):
    from lart_tpu_torch.transport.scatter import local_xcrit
    xc, _ = local_xcrit(s0, p)
    frac = float((s0.xfreq.abs() < xc).float().mean())
    assert frac > 0.0, 'no lane in the core: core-skip not exercised'
    return frac


def spectra_run(label, par, dev):
    """driver.run on cuda and on cpu; the statistics of the two agree."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    kb.reset_launch_counts()
    t0 = time.time()
    rg = driver.run(par, device=dev, seed=5)
    tg = time.time() - t0
    counts = {k: v for k, v in kb.LAUNCHES.items() if v}
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.time()
        rc = driver.run(par, device='cpu', seed=6)
        tc = time.time() - t0
    finally:
        torch.set_num_threads(nthreads)
    chi2, dmu = testing.spectra_agree(
        *testing.run_tallies(rg), *testing.run_tallies(rc), par.nphotons,
        par.nmu)
    log(3, f'{label}: <N> cuda {rg.nscatt_gas:.2f} ({tg:.1f} s) cpu '
           f'{rc.nscatt_gas:.2f} ({tc:.1f} s), chi2/dof {chi2:.2f}, Jmu max '
           f'|d| {dmu:.4f}, W_esc + W_oor {rg.W_escape + rg.W_oor:.6f} / '
           f'{rc.W_escape + rc.W_oor:.6f}; launches {counts}')
    return counts


def phase3(dev):
    from lart_tpu_torch import testing
    c = spectra_run('slab tau0=100 1e4 photons', testing.slab_params(
        tau0=100.0, nz=101, nphotons=10_000, batch=4096), dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_uniform_slab',
                                  'scatter_lya')), c
    c = spectra_run('sphere 33^3 tau0=100 1e4 photons', testing.sphere_params(
        tau0=100.0, n=33, nphotons=10_000, batch=4096), dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_uniform_sphere',
                                  'scatter_lya')), c
    c = spectra_run('Hubble sphere 33^3 xyz_symmetry Vexp 200 tau0=100 '
                    '1e4 photons', testing.hubble_params(
                        tau0=100.0, n=33, nphotons=10_000, batch=4096), dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_cartesian',
                                  'scatter_lya')), c


def run_cli(nml, out, device='cuda'):
    """(rc, RunResult, wall s, launch counts) of the CLI on nml; the
    RunResult is caught on its way from driver.run to the writer."""
    from lart_tpu_torch import __main__ as cli
    from lart_tpu_torch import driver
    from lart_tpu_torch.kernels import build as kb
    caught = []
    run = driver.run

    def keep(*a, **k):
        caught.append(run(*a, **k))
        return caught[-1]

    driver.run = keep
    try:
        kb.reset_launch_counts()
        t0 = time.time()
        rc = cli.main([str(nml), str(out), '--device', device])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kb.LAUNCHES)
    finally:
        driver.run = run
    return rc, caught[0], wall, launches


def phase4(tauhomo=1e4, device='cuda'):
    """The main paths, through the CLI's entry point, with launch counts."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.io.writer import read_spectrum
    total = {}

    def add(launches, need):
        for k in need:
            assert launches[k] > 0, (k, launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        # the Neufeld slab
        nml = namelist_variant('slab/t1tau6.in', tmp, tauhomo=f'{tauhomo:g}',
                               batch_size=B_MAIN)
        out = Path(tmp) / 't1tau4.fits'
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        nph, w_esc, nsc = (float(spec[k]) for k in ('nphotons', 'W_esc',
                                                     'Nsc_gas'))
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and jout.shape == spec['Xfreq'].shape
        assert abs(w_esc - 1.0) < 1e-3, w_esc
        add(launches, ('refill_point', 'fly_uniform_slab', 'scatter_lya'))
        log(4, f'CLI t1tau6.in (tauhomo {tauhomo:g}, {nph:.0f} photons, '
               f'B={B_MAIN}, FITS): W_esc {w_esc:.6f}, <N_scatt> {nsc:.2f}, '
               f'wall {wall:.1f} s; launches {launches}')

        # the Dijkstra sphere acceptance case dijkstra_tau1e5_T1e4
        nml = namelist_variant('sphere/t4tau7.in', tmp, taumax='1e5',
                               nphotons=20000)
        out = Path(tmp) / 'dijkstra.fits'
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        x = np.asarray(spec['Xfreq'], np.float64)
        jout = np.asarray(spec['Jout'], np.float64)
        w_esc, nph = float(spec['W_esc']), float(spec['nphotons'])
        atau0 = float(spec['voigta']) * float(spec['taumax'])
        chi2, chi2_raw, ndof, pm, _ = testing.shape_chi2(
            x, jout, testing.dijkstra_J(x, atau0), nph, atau0=atau0)
        xp_model = abs(x[np.argmax(pm)])
        xp_exact = 0.92 * atau0 ** (1.0 / 3.0)
        xp_tol = testing.XPEAK_RTOL + 0.5 * testing.SYS_COEF \
            * atau0 ** (-1.0 / 3.0)
        assert np.all(np.isfinite(jout)) and jout.shape == x.shape
        assert abs(w_esc - 1.0) < 1e-3, w_esc
        assert chi2 / ndof < testing.CHI2_DOF_MAX, chi2 / ndof
        assert abs(xp_model / xp_exact - 1.0) < xp_tol, (xp_model, xp_exact)
        add(launches, ('refill_point', 'fly_uniform_sphere', 'scatter_lya'))
        log(4, f'CLI t4tau7.in as dijkstra_tau1e5_T1e4 (taumax 1e5, {nph:.0f}'
               f' photons, 129^3, core-skip, FITS): W_esc {w_esc:.6f}, '
               f'<N_scatt> {float(spec["Nsc_gas"]):.2f}, a tau0 {atau0:.2f},'
               f' shape chi2/dof {chi2 / ndof:.3f} (raw {chi2_raw / ndof:.3f}'
               f', {ndof} bins, limit {testing.CHI2_DOF_MAX}), peak '
               f'{xp_model:.3f} vs {xp_exact:.3f} (rel {xp_model / xp_exact - 1:+.4f},'
               f' tol {xp_tol:.4f}), wall {wall:.1f} s; launches {launches}')

        # the expanding Hubble sphere at its full 201^3 grid
        nml = namelist_variant('vel_effect/t4NHI2_20_V0200.in', tmp,
                               N_HI='2.0e18', no_photons='1e4')
        out = Path(tmp) / 'vel_effect.fits'
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        x = np.asarray(spec['Xfreq'], np.float64)
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and jout.shape == x.shape
        assert float(spec['W_esc']) == res.W_escape
        w = res.W_escape + res.W_oor
        assert abs(w - 1.0) < 1e-3, (res.W_escape, res.W_oor)
        red = float(jout[x < 0].sum() / jout.sum())
        add(launches, ('refill_point', 'fly_cartesian', 'scatter_lya'))
        log(4, f'CLI t4NHI2_20_V0200.in (N_HI 2e18, {res.nphotons} photons, '
               f'201^3 reflect, Hubble Vexp 200, FITS): W_esc {res.W_escape:.6f}'
               f' + W_oor {res.W_oor:.6f} = {w:.6f}, share of escaped weight '
               f'at x < 0 (red) {red:.4f}, <N_scatt> {res.nscatt_gas:.2f}, '
               f'wall {wall:.1f} s; launches {launches}')
    return total


def device_ms(calls):
    """Device ms per launch of calls[i](): a sleep holds the stream while
    the host enqueues every call, so the launches run back to back and the
    host's launch time stays outside the events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for c in calls:
        c()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(calls)


def profile_chunks(p, card, label, n_chunks=4):
    """Where a chunk's device time goes: torch.profiler (CUPTI) over
    n_chunks chunks of the prepared run, each device op's time and its
    share, and the device's busy share of the profiled wall time.  The
    profiler lengthens the host's side of a cycle, so the busy share is a
    lower bound on the unprofiled one."""
    from torch.profiler import ProfilerActivity, profile
    from lart_tpu_torch import driver
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            driver.chunk_to_host(*p.run_chunk())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = sorted(((getattr(e, 'self_device_time_total', 0.0), e.count, e.key)
                  for e in prof.key_averages()), reverse=True)
    ops = [o for o in ops if o[0] > 0]
    busy = sum(o[0] for o in ops)
    cycles = n_chunks * p.chunk.n_cycles
    if busy == 0:
        log(5, f'{label} profile of {cycles} cycles: the profiler saw no '
               f'device time; device busy share not measured [{card}]')
        return
    for us, count, key in ops[:6]:
        log(5, f'{label} profile: {key[:40]}: {us / count:.3f} us a launch x '
               f'{count} = {100 * us / busy:.2f}% of device time [{card}]')
    log(5, f'{label} profile of {cycles} cycles: device busy {busy:.1f} us '
           f'of {wall_us:.1f} us wall = {100 * busy / wall_us:.2f}% under the '
           f'profiler [{card}]')


def kernel_times(p, card, label, res, names, record=(), reps=20):
    """Each kernel of the prepared run's cycle against its plain version,
    on one cycle's inputs at the steady-state shapes; the times of the
    kernels named in `record` go into res."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.physics.voigt import voigt, voigt_plain
    from lart_tpu_torch.transport import refill, scatter
    from lart_tpu_torch.transport.state import zero_tallies
    ch, st = p.chunk, p.state
    fmod = sys.modules[type(ch.flight).__module__]
    tl = zero_tallies(p.meta.nxfreq, 0, st.device)
    pre_refill = testing.clone_state(st)
    refill.refill(st, tl, ch.refill_params, p.seed, p.cycle, p.budget)
    pre_fly = testing.clone_state(st)
    ch.flight(st, tl, ch.fly_substeps)
    pre_scatter = testing.clone_state(st)
    work = testing.clone_state(st)
    torch.cuda.synchronize()
    c = p.cycle
    fly_name = {'fly_slab': 'fly_uniform_slab', 'fly_sphere':
                'fly_uniform_sphere'}.get(fmod.__name__.rsplit('.', 1)[-1],
                                          'fly_cartesian')
    steps = {
        'refill_point': (
            pre_refill,
            lambda s: refill.refill(s, tl, ch.refill_params, 1, c, p.budget),
            lambda s: refill.refill_plain(s, tl, ch.refill_params, 1, c,
                                          p.budget)),
        fly_name: (
            pre_fly,
            lambda s: fmod.fly(s, tl, ch.flight, ch.fly_substeps),
            lambda s: fmod.fly_plain(s, tl, ch.flight, ch.fly_substeps)),
        'scatter_lya': (
            pre_scatter,
            lambda s: scatter.scatter(s, tl, ch.scatter_params, 1, c),
            lambda s: scatter.scatter_plain(s, tl, ch.scatter_params, 1, c)),
    }
    out = {}
    for k in names:
        if k == 'voigt_h':
            xs = pre_fly.xfreq.clone()
            a_ref = ch.scatter_params.a
            out[k] = (device_ms([lambda: voigt(xs, a_ref)] * reps),
                      *turns(lambda: voigt(xs, a_ref),
                             lambda: voigt_plain(xs, a_ref), reps))
            continue
        pre, kern, plain = steps[k]
        copies = [testing.clone_state(pre) for _ in range(reps)]
        dev_ms = device_ms([lambda s=s: kern(s) for s in copies])
        del copies
        call_ms, plain_ms = turns(
            lambda: kern(work), lambda: plain(work), reps,
            lambda: testing.copy_state_(work, pre))
        out[k] = dev_ms, call_ms, plain_ms
    for k, (dev_ms, call_ms, plain_ms) in out.items():
        if k in record:
            res.setdefault(k, {}).update(ms=dev_ms, plain_ms=plain_ms)
        log(5, f'{label} {k} at B={st.batch}: kernel {dev_ms:.6f} ms on the '
               f'device (back to back), {call_ms:.6f} ms a call with its '
               f'launch; plain {plain_ms:.6f} ms a call [{card}]')


def rate_window(label, par, dev, min_s=WINDOW_S):
    """Steady-state rate: 3 warm-up chunks, then whole chunks until at least
    min_s seconds have passed (host clock between two synchronisations);
    all gas scatterings over all the window's time.  Returns the prepared
    run and the rate."""
    from lart_tpu_torch import driver
    t0 = time.time()
    p = driver.prepare(par, seed=12345, device=dev)
    t_prep = time.time() - t0
    for _ in range(3):
        driver.chunk_to_host(*p.run_chunk())
    card = smi()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nsc, n = 0.0, 0
    while True:
        nsc += driver.chunk_to_host(*p.run_chunk())['nscatt_gas']
        n += 1
        if time.perf_counter() - t0 >= min_s:
            break
    dt = time.perf_counter() - t0
    cycles = n * par.chunk_cycles
    rate = nsc / dt
    log(5, f'{label} B={par.batch_size} fly_substeps {par.fly_substeps} '
           f'(set-up {t_prep:.1f} s): {nsc:.6e} gas scatterings in '
           f'{dt:.6f} s over {n} chunks x {par.chunk_cycles} cycles = '
           f'{rate:.6e} scatterings/s, {dt / cycles * 1e6:.3f} us a cycle '
           f'[{card}]')
    return p, rate


def phase5(dev, res):
    from lart_tpu_torch import driver, testing
    par = testing.slab_params(tau0=1e6, nz=201, nphotons=10 ** 9,
                              batch=B_MAIN, chunk_cycles=32, refill_every=4,
                              scatter_rounds=4, save_Jmu=False)
    p = driver.prepare(par, seed=12345, device=dev)
    for _ in range(3):
        driver.chunk_to_host(*p.run_chunk())
    card = smi()
    # one window of FLAGSHIP_CHUNKS chunks (over a second), all scatterings
    # over all its time; the rates of its parts are printed as the spread.
    # chunk_to_host reads the device, so each mark follows a sync.
    torch.cuda.synchronize()
    marks, parts, part = [time.perf_counter()], [], 0.0
    for i in range(FLAGSHIP_CHUNKS):
        part += driver.chunk_to_host(*p.run_chunk())['nscatt_gas']
        if (i + 1) % SPREAD_CHUNKS == 0:
            marks.append(time.perf_counter())
            parts.append(part)
            part = 0.0
    torch.cuda.synchronize()
    dt = time.perf_counter() - marks[0]
    nsc = sum(parts) + part
    rate = nsc / dt
    spread = [n / (t1 - t0) for n, t0, t1 in zip(parts, marks, marks[1:])]
    assert dt >= 1.0, dt
    log(5, f'flagship tau0=1e6 nz=201 B={B_MAIN}: {nsc:.6e} gas scatterings'
           f' in {dt:.6f} s over {FLAGSHIP_CHUNKS} chunks x '
           f'{par.chunk_cycles} cycles = {rate:.6e} scatterings/s, '
           f'{dt / (FLAGSHIP_CHUNKS * par.chunk_cycles) * 1e6:.3f} us a '
           f'cycle; parts of {SPREAD_CHUNKS} chunks: min {min(spread):.6e} '
           f'max {max(spread):.6e} [{card}]')
    profile_chunks(p, card, 'flagship')
    names = ('refill_point', 'fly_uniform_slab', 'scatter_lya', 'voigt_h')
    kernel_times(p, card, 'flagship', res, names, record=names)
    del p

    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    cells = (
        ('t4tau7 (tau 1e7, 129^3, core-skip)',
         example_params('sphere/t4tau7.in', **over), 'fly_uniform_sphere'),
        ('vel_effect V0200 (N_HI 2e20, 201^3, Hubble)',
         example_params('vel_effect/t4NHI2_20_V0200.in', **over),
         'fly_cartesian'),
        ('flagship slab through K5 (force_generic_kernel)',
         testing.slab_params(tau0=1e6, nz=201, nphotons=10 ** 9,
                             batch=B_MAIN, chunk_cycles=32, save_Jmu=False,
                             force_generic_kernel=True), None),
    )
    for label, cpar, fly_name in cells:
        p, _ = rate_window(label, cpar, dev)
        card = smi()
        profile_chunks(p, card, label.split(' ')[0])
        names = ('refill_point', fly_name or 'fly_cartesian', 'scatter_lya')
        kernel_times(p, card, label.split(' ')[0], res, names,
                     record=(fly_name,))
        del p


KERNELS = {
    'refill_point': ('lart_tpu_torch/csrc/refill.cu',
                     'lart_tpu/transport/engine.py:2557'),
    'fly_uniform_slab': ('lart_tpu_torch/csrc/fly_slab.cu',
                         'lart_tpu/transport/engine.py:671'),
    'fly_cartesian': ('lart_tpu_torch/csrc/fly_cartesian.cu',
                      'lart_tpu/transport/engine.py:1057'),
    'fly_uniform_sphere': ('lart_tpu_torch/csrc/fly_sphere.cu',
                           'lart_tpu/transport/engine.py:887'),
    'scatter_lya': ('lart_tpu_torch/csrc/scatter_lya.cu',
                    'lart_tpu/transport/engine.py:1838'),
}
INLINES_VOIGT = ('fly_uniform_slab', 'fly_cartesian', 'fly_uniform_sphere')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--phases', default='0,1,2,3,4,5')
    phases = {int(v) for v in ap.parse_args(argv).phases.split(',')}
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 2
    from lart_tpu_torch.utils.device import resolve_device
    dev = resolve_device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    phase0()
    if 1 in phases:
        phase1()
    res = phase2(dev) if 2 in phases else {}
    if 3 in phases:
        phase3(dev)
    launches = phase4() if 4 in phases else {}
    if 5 in phases:
        phase5(dev, res)
    if phases >= {2, 4, 5}:
        line = {'kernels': [dict(
            name=k, route='cuda', source=src, replaces=rep,
            launches=launches[k], max_abs_err=res[k]['max_abs_err'],
            ms=res[k]['ms'], plain_ms=res[k]['plain_ms'],
            **({'inlines': 'voigt_h (lart_tpu_torch/csrc/voigt.cuh, '
                           'replaces lart_tpu/physics/voigt.py:23)'}
               if k in INLINES_VOIGT else {}))
            for k, (src, rep) in KERNELS.items()]}
        print(json.dumps(line))
    assert not any(m.split('.')[0] in ('jax', 'jaxlib') for m in sys.modules)
    log('-', f'wall {time.time() - t_start:.1f} s')
    print(smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
