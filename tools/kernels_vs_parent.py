"""Time K4 (scatter_lya), K5 (fly_cartesian) and K7 (peel) of this tree
against the same kernels of an earlier checkout, in turns, on the card.

    git archive HEAD~1 lart_tpu_torch | tar -x -C build/parent
    python3 tools/kernels_vs_parent.py --parent build/parent \
        [--kernels K4,maps,K7] [--out FILE]

--parent is the root of a checkout that holds lart_tpu_torch/.  Its
package is copied to build/parent_pkg/lart_parent and imported under that
name (the package imports itself only relatively), so it builds its own
kernels from its own csrc/ into build/parent_pkg/build/ and calls them
through its own wrappers and C signatures.  Each state is prepared as
chip_smoke.py phase 5 does (budget 1e9, B = 131072, chunk_cycles 32) and
run for one second of whole chunks; one cycle's inputs are taken, the
state K5 sees (after the refill), the state K4 sees (after the flight)
and the scatterings' events with their peel record that K7 peels (after
the scatter).  The parent's chunk is prepared from the same Params and
seed, and reads the same lane tensors (its lane fields must be among this
tree's).  Each kernel is timed back to back on the device
(chip_smoke.device_ms: 20 launches behind a sleep; K4 and K5 on a fresh
copy of the state a launch), the versions in turns A, B, B, A.

- K4 on the flagship slab (chip_smoke.py phase 5) and on the K4 states of
  t4tau7, DL20e_dust, h2_on, SiII_1193, clumps_overlap and jellyfish_pt,
  each as written: the tree's time over the parent's.
- maps: t1tau6.in as written with calcJ, calcP and calcPnew: K4 with and
  without the Pa map and K5 with and without J1/Pnew, both versions; the
  distinct bins a warp and a block of K4's resonance scatterings deposit
  Pa into, and Pa.index_add_ of the same (bin, f64 value) pairs, the
  plain atomic path's yardstick.
- K7 on phase 5's peel-off states (k7_states): the scatterings' peel of
  slab_peel, sphere_peel, vel_effect_peel, DL20e_dust with one observer on
  +z, SiII_1193, t4tau1e4, jellyfish_pt with its observer, CIV_test's
  interior observer, star_planet_a090, AlII_ex, clumps_overlap with one
  observer on +z and stars1, as written, and the stellar peel of a
  refill's newborns of a090 with its observer on +z:
  the tree's time over the parent's, whether the two versions' cubes
  agree to 1e-5 of their sums, this tree's launches a call (two where its
  first pass runs) and, where the pass does not run, the tree's time with
  the pass run on every call beside it: what the pass costs.

Each version's registers, stack frame and spill bytes a K4, K5 and K7
instance (ptxas) are logged.  The
numbers are logged with the card's name and power limit and written as
JSON to --out (kernels_vs_parent.json in the repository's output folder
by default).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import re
import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from lart_tpu_torch.kernels import build as kbuild  # noqa: E402

PARENT_DIR = ROOT / 'build' / 'parent_pkg'
# the modules that find the repo's data by a path relative to the package:
# the copy reads the repo's
DATA_MODULES = ('physics.mueller', 'physics.h2')
REPS = 20
OVER = dict(batch_size=cs.B_MAIN, nphotons=10 ** 9, chunk_cycles=32)


def log(msg):
    print(f'[vs parent] {msg}', flush=True)


def load_parent(root):
    """The package of the checkout at `root`, imported as lart_parent."""
    dst = PARENT_DIR / 'lart_parent'
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(Path(root) / 'lart_tpu_torch', dst)
    sys.path.insert(0, str(PARENT_DIR))
    for name in DATA_MODULES:
        importlib.import_module(f'lart_parent.{name}').DATA_DIR = \
            importlib.import_module(f'lart_tpu_torch.{name}').DATA_DIR
    return importlib.import_module('lart_parent')


def build_both():
    """Build this tree's kernel library and the parent's side by side;
    returns {version: {kernel instance: registers}} of K4, K5 and K7 (empty
    where the library was built before this process)."""
    mods = {v: importlib.import_module(f'{v}.kernels.build')
            for v in ('lart_tpu_torch', 'lart_parent')}
    errors = []

    def build(m):
        try:
            m.library()
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
    threads = [threading.Thread(target=build, args=(m,))
               for m in mods.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {v: registers(m.BUILD_INFO.get('ptxas', ''))
            for v, m in mods.items()}


def registers(ptxas):
    """{K4, K5 or K7 instance: [registers, stack frame, spill stores, spill
    loads]} (bytes) from ptxas's report."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        keep = name and any(k in name for k in (
            'scatter_lya', 'fly_cartesian', 'peel_'))
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and keep:
            out.setdefault(name, [0, 0, 0, 0])[1:] = map(int, m.groups())
        m = re.search(r'Used (\d+) registers', line)
        if m and keep:
            out.setdefault(name, [0, 0, 0, 0])[0] = int(m.group(1))
    return out


def parent_params(par):
    """`par` as the parent's Params (the fields it has)."""
    Params = importlib.import_module('lart_parent.config').Params
    names = {f.name for f in dataclasses.fields(Params)}
    return Params(**{f.name: getattr(par, f.name)
                     for f in dataclasses.fields(par) if f.name in names})


def as_parent(s):
    """The parent's BatchState over the lane tensors of this tree's `s`."""
    st = importlib.import_module('lart_parent.transport.state')
    return st.BatchState(**{f: getattr(s, f) for f in st.LANE_FIELDS},
                         n_launched=s.n_launched)


class Versions:
    """One cycle's inputs of a state and each version's chunk: `pre_fly`
    (the state K5 sees), `pre_sc` (the state K4 sees), and per version its
    chunk, tallies, K4 and K5 (kernel(state, tallies))."""

    def __init__(self, label, par, dev, amr_data=None):
        from lart_tpu_torch import testing
        from lart_tpu_torch.transport import refill
        p, _ = cs.rate_window(label, par, dev, amr_data=amr_data)
        ch, st = p.chunk, p.state
        tl = ch.zero_tallies(st.device)
        tl.allph = ch.allph
        refill.refill(st, tl, ch.refill_params, p.seed, p.cycle, p.budget,
                      None)
        self.pre_fly = testing.clone_state(st)
        ch.flight(st, tl, ch.fly_substeps)
        self.pre_sc = testing.clone_state(st)
        driver = importlib.import_module('lart_parent.driver')
        q = driver.prepare(parent_params(par), seed=12345, device=dev,
                           amr_data=amr_data)
        self.cycle, self.p, self.q = p.cycle, p, q
        self.tallies = {'this tree': tl, 'parent': q.chunk.zero_tallies(dev)}
        self.tallies['parent'].allph = q.chunk.allph
        torch.cuda.synchronize()

    def kernels(self, version, maps=True):
        """(wrap, K4, K5) of a version: wrap(state) the state it reads,
        K4/K5(state) a launch; maps=False leaves the maps' pointers out."""
        ch = (self.p if version == 'this tree' else self.q).chunk
        pkg = 'lart_tpu_torch' if version == 'this tree' else 'lart_parent'
        scatter = importlib.import_module(f'{pkg}.transport.scatter')
        tl = self.tallies[version]
        if not maps:
            tl = dataclasses.replace(tl, J1=None, Pa=None, Pnew=None)
        wrap = (lambda s: s) if version == 'this tree' else as_parent
        c, sp, n = self.cycle, ch.scatter_params, ch.fly_substeps
        return (wrap, lambda s: scatter.scatter(s, tl, sp, 1, c),
                lambda s: ch.flight(s, tl, n))

    def peel_inputs(self, stellar=False):
        """(state, record, mode) of one K7 launch as the chunk loop makes it:
        the scatterings' events of the cycle (K4 on pre_sc writing the peel
        record; the chunk's scatter mode), or with `stellar` a refill of
        every lane of the batch (K2 writing the newborns' limb samples;
        mode STELLAR), as chip_smoke.py stellar_times takes them."""
        from lart_tpu_torch import testing
        from lart_tpu_torch.instruments import peel as tpeel
        from lart_tpu_torch.transport import refill, scatter
        p, ch = self.p, self.p.chunk
        tl = self.tallies['this tree']
        rec = tpeel.PeelRecord.zeros(p.state.batch, p.device)
        if stellar:
            st = testing.clone_state(p.state)
            st.phase.zero_()
            refill.refill(st, tl, ch.refill_params, p.seed, self.cycle,
                          10 ** 9, rec)
            return st, rec, tpeel.STELLAR
        st = testing.clone_state(self.pre_sc)
        scatter.scatter(st, tl, ch.scatter_params, p.seed, self.cycle, rec)
        return st, rec, ch.peel.scatter_mode

    def peel(self, version, state, rec, mode):
        """(launch, cubes) of a version's K7 on the inputs: launch() peels
        into cubes, a version's own PeelCubes."""
        this = version == 'this tree'
        pkg = 'lart_tpu_torch' if this else 'lart_parent'
        tpeel = importlib.import_module(f'{pkg}.instruments.peel')
        pk = (self.p if this else self.q).chunk.peel
        r = rec if this else tpeel.PeelRecord(**{
            f: getattr(rec, f) for f in tpeel.PEEL_RECORD_FIELDS})
        s = state if this else as_parent(state)
        cubes = pk.zero_cubes(state.device)
        return (lambda: tpeel.peel(s, cubes, r, pk, mode)), cubes


def in_turns(pre, fns, reps=REPS):
    """{name: device ms a launch} of each (wrap, fn) of fns on fresh copies
    of `pre`, back to back, in turns: the order of fns, then reversed (each
    fn called once before, so that a library's first launch, which loads
    its module, stays out of the times)."""
    from lart_tpu_torch import testing
    for wrap, fn in fns.values():
        fn(wrap(testing.clone_state(pre)))
    torch.cuda.synchronize()
    got = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        wrap, fn = fns[k]
        copies = [wrap(testing.clone_state(pre)) for _ in range(reps)]
        got[k].append(cs.device_ms([lambda s=s: fn(s) for s in copies]))
        del copies
    return {k: float(np.mean(v)) for k, v in got.items()}


def per_group_distinct(keys, ok, size):
    """(mean, max) distinct keys over the groups of `size` lanes with at
    least one lane ok."""
    k, m = keys.cpu().numpy(), ok.cpu().numpy()
    counts = [len(np.unique(k[g:g + size][m[g:g + size]]))
              for g in range(0, len(k) - size + 1, size)
              if m[g:g + size].any()]
    return float(np.mean(counts)), int(np.max(counts))


def k7_states():
    """The K7 states compared (label, key, Params, AMR leaves' name,
    stellar): phase 5's windows with peel-off, each as written."""
    from lart_tpu_torch import testing
    ex = cs.PEEL_EXAMPLES
    return (
        ('slab_peel as written', 'slab_peel',
         cs.example_params(ex['slab_peel'], **OVER), None, False),
        ('sphere_peel as written', 'sphere_peel',
         cs.example_params(ex['sphere_peel'], **OVER), None, False),
        ('vel_effect_peel as written', 'vel_effect_peel',
         cs.example_params(ex['vel_effect_peel'], **OVER), None, False),
        ('DL20e_dust with one observer on +z', 'DL20e_dust_peel',
         cs.example_params(cs.DL20E_DUST, **OVER, **cs.OBSERVER), None,
         False),
        ('SiII_1193 as written', 'SiII_1193',
         cs.example_params(cs.LINE_EXAMPLES['SiII_1193'], **OVER), None,
         False),
        ('t4tau1e4 as written', 't4tau1e4', cs.example_params(cs.LYB, **OVER),
         None, False),
        ('jellyfish_pt as written with its observer', 'jellyfish_pt',
         cs.example_params(cs.JELLY, **OVER), 'jellyfish', False),
        ('CIV_test with save_peeloff (interior)', 'CIV_test',
         cs.civ_params(**OVER), None, False),
        ('star_planet_a090 as written (resonance peel)', 'a090',
         testing.source_params('a090', cs.ROOT, **OVER), None, False),
        ('AlII_ex as written (per-cell T)', 'AlII_ex',
         testing.source_params('AlII', cs.ROOT, **OVER), None, False),
        ('clumps_overlap with one observer on +z', 'clumps_overlap_peel',
         cs.clump_params('overlap', **OVER, **cs.OBSERVER), None, False),
        ('stars1 as written (Stokes)', 'stars1',
         testing.source_params('stars1', cs.ROOT, cut=False, **OVER), None,
         False),
        ('star_planet_a090 on +z (stellar peel)', 'a090_stellar_z',
         testing.source_params('a090', cs.ROOT, **OVER, beta=(0.0,),
                               save_direc0=True), None, True))


def peel_turns(fns, reps=REPS):
    """{name: device ms a launch} of each fn of fns, back to back, in
    turns: the order of fns, then reversed (each called once before)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    got = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        got[k].append(cs.device_ms([fns[k]] * reps))
    return {k: float(np.mean(v)) for k, v in got.items()}


def every_call(pk, fn):
    """fn with K7's first pass on every call: its own lane lists (not
    those of fn's Peel `pk`), told before each call that their count
    packs, so that the pass runs; the kernel still packs by the count."""
    own = {}

    def run():
        saved = dict(pk._lanes)
        pk._lanes.clear()
        pk._lanes.update(own)
        for lanes in own.values():
            for gate in lanes.gates.values():
                gate.packs, gate.event = True, None
        try:
            fn()
        finally:
            own.update(pk._lanes)
            pk._lanes.clear()
            pk._lanes.update(saved)
    return run


def compare_k7(dev, card, only=None):
    """K7 of both versions on each of k7_states (the keys in `only`, where
    given): {key: {version: ms, 'ratio': this over parent, 'cubes_rel':
    the largest difference of the two versions' cubes over their sums,
    after one launch each, 'launches_a_call': this tree's launches a call
    once its first call has sampled the first pass's count}}; where that
    is one launch off the chord, also the time with the first pass run on
    every call and 'first_pass_ms', what the pass adds."""
    got = {}
    for label, key, par, amr, stellar in k7_states():
        if only and key not in only:
            continue
        v = Versions(label, par, dev,
                     amr_data=cs.amr_leaves(amr) if amr else None)
        inputs = v.peel_inputs(stellar)
        runs = {name: v.peel(name, *inputs)
                for name in ('parent', 'this tree')}
        for fn, _ in runs.values():
            fn()
        torch.cuda.synchronize()
        rel = 0.0
        for (_, a), (_, b) in zip(runs['parent'][1].items(),
                                  runs['this tree'][1].items()):
            tot = max(float(a.double().abs().sum()), 1e-30)
            rel = max(rel, float((a - b).abs().max()) / tot)
        # one more call after the first, which sampled the first pass's
        # count: whether this tree's calls run it (two launches)
        n0 = kbuild.LAUNCHES['peel'] + kbuild.LAUNCHES['peel_stellar']
        runs['this tree'][0]()
        launches = kbuild.LAUNCHES['peel'] + kbuild.LAUNCHES['peel_stellar'] \
            - n0
        torch.cuda.synchronize()
        fns = {name: fn for name, (fn, _) in runs.items()}
        if launches == 1 and not v.p.chunk.peel.chord:
            fns['this tree, first pass every call'] = every_call(
                v.p.chunk.peel, fns['this tree'])
        t = peel_turns(fns)
        t['ratio'] = t['this tree'] / t['parent']
        t['cubes_rel'] = rel
        t['launches_a_call'] = launches
        if 'this tree, first pass every call' in t:
            t['first_pass_ms'] = t['this tree, first pass every call'] \
                - t['this tree']
        got[key] = t
        log(f'K7 on {label}: {t} [{card}]')
        del v, runs, inputs
    return got


def flagship_params():
    from lart_tpu_torch import testing
    return testing.slab_params(tau0=1e6, nz=201, nphotons=10 ** 9,
                               batch=cs.B_MAIN, chunk_cycles=32,
                               refill_every=4, scatter_rounds=4,
                               save_Jmu=False)


def k4_states():
    """The K4 states compared (label, key, Params, AMR leaves' name)."""
    return (
        ('flagship tau0=1e6 nz=201', 'flagship', flagship_params(), None),
        ('t4tau7 as written', 't4tau7',
         cs.example_params('sphere/t4tau7.in', **OVER), None),
        ('DL20e_dust as written', 'DL20e_dust',
         cs.example_params(cs.DL20E_DUST, **OVER), None),
        ('h2_on as written', 'h2_on', cs.example_params(cs.H2_ON, **OVER),
         None),
        ('SiII_1193 as written', 'SiII_1193',
         cs.example_params(cs.LINE_EXAMPLES['SiII_1193'], **OVER), None),
        ('clumps_overlap as written', 'clumps_overlap',
         cs.clump_params('overlap', **OVER), None),
        ('jellyfish_pt as written', 'jellyfish_pt',
         cs.example_params(cs.JELLY, **OVER), 'jellyfish'))


def compare_k4(dev, card):
    got = {}
    for label, key, par, amr in k4_states():
        v = Versions(label, par, dev,
                     amr_data=cs.amr_leaves(amr) if amr else None)
        t = in_turns(v.pre_sc, {name: v.kernels(name)[:2]
                                for name in ('parent', 'this tree')})
        t['ratio'] = t['this tree'] / t['parent']
        got[key] = t
        log(f'K4 on {label}: {t} [{card}]')
        del v
    return got


def compare_maps(dev, card):
    from lart_tpu_torch.transport.state import AT_SCATTER, FLYING
    v = Versions('t1tau6.in as written with calcJ, calcP and calcPnew',
                 cs.example_params('slab/t1tau6.in', **OVER, **cs.JPA_ON),
                 dev)
    got = {}
    for k, (what, pre) in enumerate((('K4', v.pre_sc), ('K5', v.pre_fly))):
        fns = {}
        for name in ('parent', 'this tree'):
            for maps in (True, False):
                wrap, k4, k5 = v.kernels(name, maps)
                fns[f'{name} {"with" if maps else "without"} the maps'] = (
                    wrap, (k4, k5)[k])
        got[what] = in_turns(pre, fns)
        log(f'{what} on t1tau6 with the maps: {got[what]} [{card}]')
    # Pa's resonance scatterings (AT_SCATTER -> FLYING) by their bins
    from lart_tpu_torch import testing
    ch = v.p.chunk
    post = testing.clone_state(v.pre_sc)
    v.kernels('this tree', maps=False)[1](post)
    ok = (v.pre_sc.phase == AT_SCATTER) & (post.phase == FLYING)
    bins = ch.flight.jpa.bin(v.pre_sc.ic, v.pre_sc.jc, v.pre_sc.kc)
    warp, block = per_group_distinct(bins, ok, 32), per_group_distinct(
        bins, ok, 256)
    vals = torch.rand(bins.numel(), dtype=torch.float64, device=dev)
    Pa = torch.zeros(ch.flight.jpa.nbin, dtype=torch.float64, device=dev)
    ia = cs.device_ms([lambda: Pa.index_add_(0, bins, vals)] * REPS)
    got['Pa bins'] = dict(scatterings=int(ok.sum()),
                          distinct=int(torch.unique(bins[ok]).numel()),
                          warp_mean=warp[0], warp_max=warp[1],
                          block_mean=block[0], block_max=block[1],
                          index_add_ms=ia)
    log(f'Pa deposits on t1tau6: {got["Pa bins"]} [{card}]')
    return got


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', required=True)
    ap.add_argument('--kernels', default='K4,maps,K7',
                    help='comma-separated: K4, maps (K4/K5 on t1tau6 with '
                         'the maps), K7, or K7:key1+key2 (those k7_states)')
    ap.add_argument('--out', default=str(ROOT / 'chiprun_out' /
                                         'kernels_vs_parent.json'))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('kernels_vs_parent: no CUDA device', file=sys.stderr)
        return 2
    from lart_tpu_torch.utils.device import resolve_device
    dev = resolve_device('cuda')
    t0 = time.time()
    load_parent(a.parent)
    regs = build_both()
    card = cs.smi()
    log(f'built both libraries in {time.time() - t0:.1f} s; registers '
        f'{regs}')
    kinds = dict(k.partition(':')[::2] for k in a.kernels.split(','))
    out = {'card': card, 'registers': regs}
    if 'K4' in kinds:
        out['K4'] = compare_k4(dev, card)
    if 'maps' in kinds:
        out['maps'] = compare_maps(dev, card)
    if 'K7' in kinds:
        out['K7'] = compare_k7(dev, card, [k for k in kinds['K7'].split('+')
                                           if k])
        ratios = [t['ratio'] for t in out['K7'].values()]
        out['K7_geomean'] = float(np.exp(np.mean(np.log(ratios))))
        log(f'K7: geometric mean of the ratios {out["K7_geomean"]:.4f} over '
            f'{len(ratios)} states, the largest {max(ratios):.4f} [{card}]')
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(out, indent=1))
    log(f'{time.time() - t0:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    sys.exit(main())
