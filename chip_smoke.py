#!/usr/bin/env python3
"""Smoke test of lart_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, runs the Neufeld slab end to
end through the driver and the CLI, and measures the flagship rate.

    python3 chip_smoke.py            # every phase, needs one CUDA device
    python3 chip_smoke.py --phases 0,1,2

Phases (one line each):
  0  card name and power limit (nvidia-smi), torch / CUDA / nvcc versions
  1  build K1-K4 from lart_tpu_torch/csrc with nvcc
  2  each kernel against its plain version on the card at B = 131072
  3  driver.run on cuda and on cpu, tau0 = 100 slab: statistics agree
  4  the main path: the CLI (lart_tpu_torch.__main__.main) on
     examples/slab/t1tau6.in with tauhomo 1e4, FITS output, batch 131072;
     the kernels' launch counts are read around this run
  5  flagship rate: tau0 = 1e6, nz = 201, B = 131072, chunk_cycles 32,
     refill_every 4, scatter_rounds 4; 3 warm-up chunks, then one window
     of 800 chunks; a torch.profiler breakdown of 4 chunks; each kernel's
     time against its plain version's at the steady-state shapes
Any failure raises and exits non-zero.  Before the last line it prints one
JSON object with the kernels of the main path, and the card's name and
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
    regs = re.findall(r"Function properties for (\w+)|Used (\d+) registers",
                      kb.BUILD_INFO.get('ptxas', ''))
    used = [int(r[1]) for r in regs if r[1]]
    log(1, f'built {Path(kb.BUILD_INFO["path"]).name} in '
           f'{kb.BUILD_INFO["seconds"]:.1f} s (load {time.time() - t0:.1f} s);'
           f' ptxas registers per kernel: {used}')


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
    meta, _ = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta)
    nx = meta.nxfreq
    LANE_RTOL, LANE_ATOL, MAX_FRAC = 1e-5, 1e-6, 1e-4

    def both(step, state_seed, check_tallies):
        s0 = testing.mixed_state(meta, B_MAIN, state_seed, dev)
        sk, sp = testing.clone_state(s0), testing.clone_state(s0)
        tk, tp = zero_tallies(nx, 8, dev), zero_tallies(nx, 8, dev)
        step(sk, tk, kernel=True)
        step(sp, tp, kernel=False)
        torch.cuda.synchronize()
        frac, err = testing.compare_states(sk, sp, LANE_RTOL, LANE_ATOL)
        tal = {}
        for f in check_tallies:
            u, v = getattr(tk, f), getattr(tp, f)
            atol = 1e-5 * max(float(v.abs().sum()), 1.0)
            d = float((u - v).abs().max())
            assert d <= atol, (f, d, atol)
            tal[f] = d
        assert frac <= MAX_FRAC, frac
        return s0, sk, frac, err, tal

    def fly_step(s, t, kernel):
        (fly_slab.fly if kernel else fly_slab.fly_plain)(
            s, t, ch.slab_params, ch.fly_substeps)

    _, sk, frac, err, tal = both(fly_step, 21, ('Jout', 'Jmu', 'W_oor'))
    res['fly_uniform_slab'] = {'max_abs_err': err}
    log(2, f'K3 fly_uniform_slab: B={B_MAIN} mixed phases, lanes differing '
           f'{frac:.2e} (rtol {LANE_RTOL}, atol {LANE_ATOL}, max {MAX_FRAC}),'
           f' max abs err {err:.3e}; tallies max |d| {tal} (atol 1e-5 x sum)')

    def refill_step(s, t, kernel):
        (refill.refill if kernel else refill.refill_plain)(
            s, t, ch.refill_params, 7, 12345, 10 ** 9)

    s0, sk, frac, err, tal = both(refill_step, 22, ('Jin',))
    n_dead = int((s0.phase == DEAD).sum())
    assert int(sk.n_launched[0]) == n_dead
    res['refill_point'] = {'max_abs_err': err}
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

    def scatter_step(s, t, kernel):
        (scatter.scatter if kernel else scatter.scatter_plain)(
            s, t, ch.scatter_params, 7, 99)

    _, sk, frac, err, tal = both(scatter_step, 23,
                                 ('nscatt_gas', 'nscatt_events'))
    res['scatter_lya'] = {'max_abs_err': err}
    log(2, f'K4 scatter_lya: B={B_MAIN} mixed phases, lanes differing '
           f'{frac:.2e}, max abs err {err:.3e}; nscatt max |d| {tal}')
    return res


def phase3(dev):
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = testing.slab_params(tau0=100.0, nz=101, nphotons=10_000,
                              batch=4096)
    kb.reset_launch_counts()
    t0 = time.time()
    rg = driver.run(par, device=dev, seed=5)
    tg = time.time() - t0
    counts = dict(kb.LAUNCHES)
    assert all(counts[k] > 0 for k in ('refill_point', 'fly_uniform_slab',
                                       'scatter_lya')), counts
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.time()
        rc = driver.run(par, device='cpu', seed=6)
        tc = time.time() - t0
    finally:
        torch.set_num_threads(nthreads)
    chi2, dmu = testing.spectra_agree(*testing.run_tallies(rg),
                                      *testing.run_tallies(rc),
                                      par.nphotons, par.nmu)
    log(3, f'slab tau0=100 1e4 photons: <N> cuda {rg.nscatt_gas:.2f} '
           f'({tg:.1f} s) cpu {rc.nscatt_gas:.2f} ({tc:.1f} s), chi2/dof '
           f'{chi2:.2f}, Jmu max |d| {dmu:.4f}, W_esc {rg.W_escape:.6f} / '
           f'{rc.W_escape:.6f}; launches {counts}')


def phase4(tauhomo=1e4, device='cuda'):
    """The main path, through the CLI's entry point, with launch counts."""
    from lart_tpu_torch import __main__ as cli
    from lart_tpu_torch.io.writer import read_spectrum
    from lart_tpu_torch.kernels import build as kb
    text = (ROOT / 'examples' / 'slab' / 't1tau6.in').read_text()
    text = re.sub(r'par%tauhomo\s*=.*', f'par%tauhomo = {tauhomo:g}', text)
    text = re.sub(r"par%out_file\s*=.*", "par%file_format = 'fits'", text)
    text = text.rstrip()
    assert text.endswith('/'), 'namelist must end with /'
    text = text[:-1] + f' par%batch_size = {B_MAIN}\n/\n'
    with tempfile.TemporaryDirectory() as tmp:
        nml = Path(tmp) / 't1tau4.in'
        nml.write_text(text)
        out = Path(tmp) / 't1tau4.fits'
        kb.reset_launch_counts()
        t0 = time.time()
        rc = cli.main([str(nml), str(out), '--device', device])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kb.LAUNCHES)
        assert rc == 0
        spec = read_spectrum(str(out))
    nph, w_esc, nsc = (float(spec[k]) for k in ('nphotons', 'W_esc',
                                                 'Nsc_gas'))
    jout = np.asarray(spec['Jout'], np.float64)
    assert np.all(np.isfinite(jout)) and jout.shape == spec['Xfreq'].shape
    assert abs(w_esc - 1.0) < 1e-3, w_esc
    for k in ('refill_point', 'fly_uniform_slab', 'scatter_lya'):
        assert launches[k] > 0, launches
    log(4, f'CLI t1tau6.in (tauhomo {tauhomo:g}, {nph:.0f} photons, B={B_MAIN}, '
           f'FITS): W_esc {w_esc:.6f}, <N_scatt> {nsc:.2f}, wall {wall:.1f} s;'
           f' launches {launches}')
    return launches


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


def profile_chunks(p, card, n_chunks=4):
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
        log(5, f'profile of {cycles} cycles: the profiler saw no device '
               f'time; device busy share not measured [{card}]')
        return
    for us, count, key in ops[:6]:
        log(5, f'profile: {key[:40]}: {us / count:.3f} us a launch x {count}'
               f' = {100 * us / busy:.2f}% of device time [{card}]')
    log(5, f'profile of {cycles} cycles: device busy {busy:.1f} us of '
           f'{wall_us:.1f} us wall = {100 * busy / wall_us:.2f}% under the '
           f'profiler [{card}]')


def phase5(dev, res):
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.physics.voigt import voigt, voigt_plain
    from lart_tpu_torch.transport import fly_slab, refill, scatter
    from lart_tpu_torch.transport.state import zero_tallies
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
    profile_chunks(p, card)

    # per-kernel time at the steady-state shapes: one cycle's inputs
    ch, st = p.chunk, p.state
    tl = zero_tallies(p.meta.nxfreq, 0, dev)
    pre_refill = testing.clone_state(st)
    refill.refill(st, tl, ch.refill_params, p.seed, p.cycle, p.budget)
    pre_fly = testing.clone_state(st)
    fly_slab.fly(st, tl, ch.slab_params, ch.fly_substeps)
    pre_scatter = testing.clone_state(st)
    work = testing.clone_state(st)
    torch.cuda.synchronize()

    def restore(src):
        return lambda: testing.copy_state_(work, src)

    reps = 20
    c = p.cycle
    steps = {
        'refill_point': (
            pre_refill,
            lambda s: refill.refill(s, tl, ch.refill_params, 1, c, p.budget),
            lambda s: refill.refill_plain(s, tl, ch.refill_params, 1, c,
                                          p.budget)),
        'fly_uniform_slab': (
            pre_fly,
            lambda s: fly_slab.fly(s, tl, ch.slab_params, ch.fly_substeps),
            lambda s: fly_slab.fly_plain(s, tl, ch.slab_params,
                                         ch.fly_substeps)),
        'scatter_lya': (
            pre_scatter,
            lambda s: scatter.scatter(s, tl, ch.scatter_params, 1, c),
            lambda s: scatter.scatter_plain(s, tl, ch.scatter_params, 1, c)),
    }
    xs = pre_fly.xfreq.clone()
    a_ref = ch.slab_params.a_ref
    times = {}
    for k, (pre, kern, plain) in steps.items():
        copies = [testing.clone_state(pre) for _ in range(reps)]
        dev_ms = device_ms([lambda s=s: kern(s) for s in copies])
        del copies
        call_ms, plain_ms = turns(lambda: kern(work), lambda: plain(work),
                                  reps, restore(pre))
        times[k] = dev_ms, call_ms, plain_ms
    times['voigt_h'] = (device_ms([lambda: voigt(xs, a_ref)] * reps),
                        *turns(lambda: voigt(xs, a_ref),
                               lambda: voigt_plain(xs, a_ref), reps))
    for k, (dev_ms, call_ms, plain_ms) in times.items():
        res.setdefault(k, {}).update(ms=dev_ms, plain_ms=plain_ms)
        log(5, f'{k} at B={B_MAIN}: kernel {dev_ms:.6f} ms on the device '
               f'(back to back), {call_ms:.6f} ms a call with its launch; '
               f'plain {plain_ms:.6f} ms a call [{card}]')
    return rate


KERNELS = {
    'refill_point': ('lart_tpu_torch/csrc/refill.cu',
                     'lart_tpu/transport/engine.py:2557'),
    'fly_uniform_slab': ('lart_tpu_torch/csrc/fly_slab.cu',
                         'lart_tpu/transport/engine.py:671'),
    'scatter_lya': ('lart_tpu_torch/csrc/scatter_lya.cu',
                    'lart_tpu/transport/engine.py:1838'),
}


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
               if k == 'fly_uniform_slab' else {}))
            for k, (src, rep) in KERNELS.items()]}
        print(json.dumps(line))
    assert not any(m.split('.')[0] in ('jax', 'jaxlib') for m in sys.modules)
    print(smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
