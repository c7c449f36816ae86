"""The CUDA kernels on the card: each against its plain PyTorch version,
and the slab and sphere paths through the driver with every kernel of the
path launched.

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


LYB_H2_KEYS = {'refill_point (line type 8)', 'fly_cartesian (line type 8)',
               'scatter_lya (line type 8)', 'peel (line type 8)',
               'fly_cartesian (H2)', 'scatter_lya (H2)', 'peel (H2)',
               'fly_cartesian (H2) (line types 2, 4-7)',
               'scatter_lya (H2) (line types 2, 4-7)'}


# K8 and the AMR branches of K2, K4 and K7 (chip_smoke.phase2_amr)
AMR_KEYS = {'fly_amr', 'refill_point (AMR)', 'scatter_lya (AMR)',
            'peel (AMR)', 'scatter_lya (AMR) (line types 2, 4-7)',
            'scatter_lya (AMR) (H2)'}


# K9, K10 and the clump branches of K2, K4 and K7 (chip_smoke.phase2_clump)
CLUMP_KEYS = {'fly_clump_dense', 'fly_clump_csr', 'refill_point (clump)',
              'scatter_lya (clump)', 'peel (clump)',
              'fly_clump_dense (line types 2, 4-7)',
              'fly_clump_csr (line types 2, 4-7)',
              'scatter_lya (clump) (line types 2, 4-7)'}


# K11 and the interior branch of K7 and the exponential-cylinder births of
# K2 (chip_smoke.phase2_inside)
INSIDE_KEYS = {'sightline', 'peel (interior)',
               'refill_radial (exponential_cylinder)'}


# K2's instances of the volume and table sources (chip_smoke.phase2_sources)
SOURCE_KEYS = {'refill_volume', 'refill_radial', 'refill_alias'}


# the per-cell temperature on Cartesian grids and the per-leaf one in the
# kMulti and kH2 instances on the octree (chip_smoke.phase2_temperature)
TEMP_KEYS = {k + ' (per-cell T)' for k in (
    'refill_alias', 'refill_point', 'fly_cartesian', 'scatter_lya', 'peel',
    'sightline')} | {k + ' (per-leaf T)' for k in (
        'refill_point', 'fly_amr', 'scatter_lya', 'peel')}


# the atmospheres and the illuminations: K2's illumination instance (and its
# point instance with line_prof_file), K5's atmosphere branches, K7's mask
# walk and PEEL_STELLAR, a090's +z transit on its own (chip_smoke.
# phase2_atmosphere; its plane-profile case fills refill_alias)
ATM_KEYS = {'refill_illum', 'refill_point (atmosphere)',
            'fly_cartesian (atmosphere)', 'peel (stellar)',
            'peel (stellar, +z)'}


# K5's shear wrap and J1/Pnew deposits, K4's Pa deposit and its Jabs on a
# hot dusty state (chip_smoke.phase2_shear)
SHEAR_KEYS = {'fly_cartesian (shear)', 'fly_cartesian (J1, Pnew)',
              'scatter_lya (Pa)', 'scatter_lya (Jabs)'}


# K7's hot-bin and thick cases: the slab_peel grid's direct, resonance,
# dust and thick peels, and a090's stellar peel (chip_smoke.phase2_peel_hot);
# its packed walks on slab_peel and CIV_test (chip_smoke.peel_packed)
PEEL_HOT_KEYS = {'peel (hot bins)', 'peel (stellar) (hot bins)',
                 'peel (packed)'}


# the all-photons table: K2's five instances, K4, K5, K8, K9 and K10 with it
# (chip_smoke.phase2_allph)
ALLPH_KEYS = {k + ' (all photons)' for k in (
    'refill_point', 'refill_radial', 'refill_volume', 'refill_alias',
    'refill_illum', 'fly_cartesian', 'scatter_lya', 'fly_amr',
    'fly_clump_dense', 'fly_clump_csr')}


def test_kernels_match_plain_versions(cuda):
    import chip_smoke
    chip_smoke.B_MAIN = 8192
    chip_smoke.AMR_BIG = 32      # the AMR sphere of 48k leaves, not 3.06M
    # ~37k clumps of radius 6e-3, not the 1.48M population
    chip_smoke.FCOV1 = dict(chip_smoke.FCOV1, clump_radius=6e-3)
    res = chip_smoke.phase2(cuda)
    kernels = {'refill_point', 'fly_uniform_slab', 'fly_cartesian',
               'fly_uniform_sphere', 'scatter_lya', 'peel'}
    # the metal lines' instances (chip_smoke.phase2_lines), and line type
    # 8's and H2's branches (phase2_lyb_h2) too
    assert set(res) == kernels | {'voigt_h'} | {
        k + chip_smoke.LINES for k in kernels} | LYB_H2_KEYS | AMR_KEYS \
        | CLUMP_KEYS | INSIDE_KEYS | SOURCE_KEYS | TEMP_KEYS | ATM_KEYS \
        | SHEAR_KEYS | ALLPH_KEYS | PEEL_HOT_KEYS


# a source of each K2 instance on a 17^3 sphere: (overrides, instance)
SOURCES = {
    'uniform_sphere_continuum': (dict(source_geometry='uniform_sphere',
                                      spectral_type='continuum'),
                                 'refill_volume'),
    'gaussian_voigt0': (dict(source_geometry='gaussian', source_zscale=0.3,
                             spectral_type='voigt0', temperature0=3e4),
                        'refill_volume'),
    'exponential_continuum_gaussian': (dict(
        source_geometry='exponential', source_zscale=0.3,
        spectral_type='continuum+gaussian', EW_line=10.0), 'refill_volume'),
    'sersic': (dict(source_geometry='sersic', sersic_m=4.0, Reff=0.3),
               'refill_radial'),
    'ssh_moving': (dict(source_geometry='ssh', source_rscale=0.1,
                        velocity_type='ssh', rpeak=0.1, Vpeak=300.0,
                        DeltaV=-50.0, comoving_source=False),
                   'refill_radial'),
    'star_file': (dict(source_geometry='star_file'), 'refill_alias'),
    'density1': (dict(source_geometry='diffuse_emissivity',
                      emiss_file='density1', velocity_type='ssh',
                      rpeak=0.1, Vpeak=300.0, DeltaV=-50.0), 'refill_alias'),
    'profile': (dict(source_geometry='diffuse_emissivity'), 'refill_alias'),
}


def _source_params(case, **kw):
    from pathlib import Path

    from lart_tpu_torch import testing
    ex = Path(__file__).resolve().parents[1] / 'examples'
    over, _ = SOURCES[case]
    files = {'star_file': str(ex / 'many_stars/stars_list.txt')} \
        if case == 'star_file' else {'emiss_file': str(
            ex / 'emiss_1D_AlII/AlII_emiss_profile.txt')} \
        if case == 'profile' else {}
    return testing.sphere_params(tau0=10.0, n=17, **{**over, **files, **kw})


@pytest.mark.parametrize('case', sorted(SOURCES))
def test_source_births_match_plain(cuda, case):
    """K2's volume, radial and alias instances against their plain
    version lane by lane on a mixed state, Jin to 1e-5 of its sum."""
    import chip_smoke

    from lart_tpu_torch import testing
    from lart_tpu_torch.transport.state import DEAD
    chip_smoke.B_MAIN = 8192
    par = _source_params(case, batch_size=8192)
    cfg, meta, grid, ch = chip_smoke.sources_chunk(par, cuda)
    assert ch.refill_params.kernel == SOURCES[case][1]
    s0 = testing.mixed_state(meta, 8192, 5, cuda)
    _, sk, frac, err, _ = chip_smoke.both(meta, 5, chip_smoke.refill_step(ch),
                                          ('Jin',), cuda, state=s0)
    assert frac == 0.0 and err == 0.0
    born = s0.phase == DEAD
    assert bool(torch.isfinite(sk.x[born]).all())


@pytest.mark.parametrize('case', ['uniform_sphere_continuum', 'sersic',
                                  'star_file'])
def test_driver_runs_the_source_instances(cuda, case):
    """driver.run through each instance: its launches, and the weight
    budget against the birth weights (1 but for the star file's composite
    weights, whose Jin holds their sum)."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = _source_params(case, nphotons=2000, batch_size=2048)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=2)
    assert kb.LAUNCHES[SOURCES[case][1]] > 0, kb.LAUNCHES
    assert kb.LAUNCHES['refill_point'] == 0
    w = res.W_escape + res.W_oor
    if case == 'star_file':
        w_birth = testing.birth_weight(res)
        assert abs(w - w_birth) < 1e-3, (w, w_birth)
    else:
        assert abs(w - 1.0) < 1e-3, w


@pytest.mark.parametrize('line', ['lya', 'mg', 'h2'])
def test_driver_runs_the_temperature_cube(cuda, tmp_path, line):
    """driver.run on a 17^3 Hubble sphere whose temperature comes from a
    1e3-1e5 K FITS cube: K5, K4 and K2 launch at each cell's a and D, and
    the weight closes."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    over = {'lya': {}, 'mg': dict(line_id='MgII_2796', wavelength_min=2790.0,
                                  wavelength_max=2810.0, save_Jmu=False),
            'h2': dict(h2_model='neufeld', f_H2=0.03, xfreq_min=-12.0,
                       xfreq_max=12.0, save_Jmu=False)}[line]
    cube = testing.write_cube(tmp_path / 'T.fits',
                              testing.temperature_cube(17, 3))
    par = testing.hubble_params(tau0=10.0, n=17, nphotons=2000,
                                batch_size=2048, temp_file=cube, **over)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=2)
    assert not res.meta.uniform_temperature
    for k in ('refill_point', 'fly_cartesian', 'scatter_lya'):
        assert kb.LAUNCHES[k] > 0, kb.LAUNCHES
    w = res.W_escape + res.W_absorb + res.W_oor + (res.W_H2abs or 0.0)
    assert abs(w - 1.0) < 1e-3, w


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


FLIGHTS = {    # case: (testing helper, overrides, kernel)
    'cartesian_hubble': ('hubble_params', {}, 'fly_cartesian'),
    'cartesian_sphere': ('sphere_params', {'force_generic_kernel': True},
                         'fly_cartesian'),
    'uniform_sphere': ('sphere_params', {}, 'fly_uniform_sphere'),
}


@pytest.mark.parametrize('case', sorted(FLIGHTS))
def test_flight_kernel_matches_plain(cuda, case):
    """K5 (reflect + Hubble flow; escape) and K6 on 33^3 grids."""
    import sys

    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.kernels import build as kb
    from lart_tpu_torch.transport.engine import make_fly
    from lart_tpu_torch.transport.state import zero_tallies
    helper, over, kernel = FLIGHTS[case]
    cfg = getattr(testing, helper)(tau0=1e4, n=33, **over).resolve()
    meta, grid = build_cartesian(cfg, device=cuda)
    flight = make_fly(cfg, meta, grid)
    mod = sys.modules[type(flight).__module__]
    s0 = testing.mixed_state(meta, 65536, seed=8, device=cuda)
    sk, sp = testing.clone_state(s0), testing.clone_state(s0)
    tk = zero_tallies(meta.nxfreq, 8, cuda)
    tp = zero_tallies(meta.nxfreq, 8, cuda)
    n0 = kb.LAUNCHES[kernel]
    mod.fly(sk, tk, flight, 8)
    mod.fly_plain(sp, tp, flight, 8)
    torch.cuda.synchronize()
    assert kb.LAUNCHES[kernel] == n0 + 1
    frac, _ = testing.compare_states(sk, sp, 1e-5, 1e-6)
    assert frac <= 1e-4, frac
    for f in ('Jout', 'Jmu', 'W_oor'):
        u, v = getattr(tk, f), getattr(tp, f)
        assert float((u - v).abs().max()) <= 1e-5 * max(
            float(v.abs().sum()), 1.0), f


@pytest.mark.parametrize('helper,fly', [('sphere_params', 'fly_uniform_sphere'),
                                        ('hubble_params', 'fly_cartesian')])
def test_driver_runs_the_sphere_kernels(cuda, helper, fly):
    import numpy as np

    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = getattr(testing, helper)(tau0=10.0, n=17, nphotons=2000,
                                   batch=1024)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=1)
    assert all(kb.LAUNCHES[k] > 0 for k in ('refill_point', fly,
                                            'scatter_lya'))
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-5
    assert np.all(np.isfinite(res.Jout))


PEEL = {    # case: (testing helper, overrides, Stokes, r_max)
    'slab_stokes': ('slab_params', {'nz': 33}, True, None),
    'hubble_reflect': ('hubble_params', {'n': 33}, False, 1.0),
    'hubble_escape': ('hubble_params', {'n': 33, 'xyz_symmetry': False},
                      True, 1.0),
    'sphere_chord': ('sphere_params', {'n': 33}, True, 1.0),
}


@pytest.mark.parametrize('mode', ['direct', 'resonance'])
@pytest.mark.parametrize('case', sorted(PEEL))
def test_peel_kernel_matches_plain(cuda, case, mode):
    """K7 against its plain version: per-pair optical depth, bin and
    deposits, then the cubes to 1e-5 of their sum (chip_smoke.peel_both)."""
    import chip_smoke
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.kernels import build as kb
    from lart_tpu_torch.transport.engine import make_chunk
    helper, over, stokes, r_max = PEEL[case]
    par = testing.peel_params(getattr(testing, helper)(tau0=1e4, **over),
                              stokes=stokes)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=cuda)
    ch = make_chunk(cfg, meta, grid)
    chip_smoke.B_MAIN = 8192
    n0 = kb.LAUNCHES['peel']
    m = tpeel.DIRECT if mode == 'direct' else tpeel.RESONANCE
    n_bad, n_dep, err, _, _ = chip_smoke.peel_both(ch, meta, 5, m, cuda,
                                                   r_max)
    assert kb.LAUNCHES['peel'] > n0 and n_dep > 0


@pytest.mark.parametrize('helper', ['sphere_params', 'slab_params'])
def test_stokes_scatter_and_refill_match_plain(cuda, helper):
    """K4's Stokes branch and K2's birth triad, with their peel records."""
    import chip_smoke
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.transport.engine import make_chunk
    kw = {'n': 33} if helper == 'sphere_params' else {'core_skip': True}
    par = testing.peel_params(getattr(testing, helper)(tau0=1e4, **kw))
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=cuda)
    ch = make_chunk(cfg, meta, grid)
    chip_smoke.B_MAIN = 8192
    res = {}
    chip_smoke.k4_k2_with_record(helper, ch, meta, cuda,
                                 1.0 if helper == 'sphere_params' else None,
                                 7, res)
    assert set(res) == {'scatter_lya', 'refill_point'}


def test_driver_runs_the_peel_kernel(cuda):
    """Peel-off with Stokes through the driver on the card: K7 launched,
    the f64 cubes read once at the end, the flux closure of a central
    source in a uniform sphere."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = testing.peel_params(testing.sphere_params(
        tau0=100.0, n=17, nphotons=10_000, batch=4096), nim=17)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=1)
    assert all(kb.LAUNCHES[k] > 0 for k in ('refill_point',
                                            'fly_uniform_sphere',
                                            'scatter_lya', 'peel'))
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-5
    for c in testing.peel_closure(res):
        assert abs(c - 1.0) < 0.05, c


def test_dust_kernels_match_plain_versions(cuda):
    """On the DL20e_dust grid: K5 with rhokapD, K2's Gaussian births, K4's
    dust branch (HG, Mueller +- use_reduced_wgt) with its peel record, and
    K7 in mode dust +- Stokes (chip_smoke.phase2_dust)."""
    import chip_smoke
    chip_smoke.B_MAIN = 8192
    res = {}
    chip_smoke.phase2_dust(cuda, res)
    assert set(res) == {'fly_cartesian', 'refill_point', 'scatter_lya',
                        'peel'}


@pytest.mark.parametrize('stokes', [True, False], ids=['mueller', 'hg'])
def test_driver_runs_the_dusty_shell(cuda, stokes):
    """The dusty shell through the driver on the card, one observer: every
    kernel of the path launched, the weight closes with the absorbed share,
    and the peel deposits dust events too."""
    import dataclasses

    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = dataclasses.replace(testing.peel_params(
        testing.dust_params(nphotons=4000, stokes=stokes), stokes=stokes,
        nim=17), alpha=(0.0,), beta=(0.0,))
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=1)
    assert all(kb.LAUNCHES[k] > 0 for k in ('refill_point', 'fly_cartesian',
                                            'scatter_lya', 'peel'))
    assert abs(res.W_escape + res.W_absorb + res.W_oor - 1.0) < 1e-5
    assert 0.2 < res.W_absorb < 0.8 and res.nscatt_dust > 0.5
    (c,) = testing.peel_closure(res)
    assert abs(c - 1.0) < 3.0 * (testing.PEEL_V_DUST / 4000) ** 0.5, c


@pytest.mark.parametrize('case', ['multiplet', 'hd'])
def test_driver_runs_the_metal_lines(cuda, case):
    """The Si II multiplet (line type 5: Stokes, recoil, one observer) and
    H + D Ly-alpha (type 7) through the driver on the card: every kernel of
    the path launched, the weight closes, the Si II* fluorescent photons
    escape, the peel closes."""
    import dataclasses

    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    over = dict(spectral_type='voigt', use_stokes=True) \
        if case == 'multiplet' else dict(D_to_H_ratio=3e-3)
    par = testing.line_params(case, tau0=20.0, n=17, nphotons=10_000,
                              batch=4096, **over)
    need = ('refill_point', 'fly_uniform_sphere', 'scatter_lya')
    if case == 'multiplet':
        par = dataclasses.replace(testing.peel_params(par, nim=17),
                                  alpha=(0.0,), beta=(0.0,))
        need += ('peel',)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=1)
    assert all(kb.LAUNCHES[k] > 0 for k in need), kb.LAUNCHES
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-5
    if case == 'multiplet':
        share = res.Jout[res.xfreq < -200.0].sum() / res.Jout.sum()
        assert 0.3 < share < 0.95, share
        (c,) = testing.peel_closure(res)
        assert abs(c - 1.0) < 3.0 * (testing.PEEL_V_PHOTON / 10_000) ** 0.5


@pytest.mark.parametrize('case', ['lyb', 'lyb_dust', 'h2'])
def test_driver_runs_lyb_and_h2(cuda, case):
    import numpy as np

    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    if case == 'h2':
        par = testing.h2_params(tau0=10.0, n=17, nphotons=2000, batch=2048,
                                f_H2=30.0)
    else:
        par = testing.peel_params(testing.lyb_params(
            tau0=30.0, n=17, nphotons=2000, batch=2048,
            DGR=1e5 if case == 'lyb_dust' else 0.0), stokes=False, nim=17)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=3)
    need = ('refill_point', 'fly_cartesian', 'scatter_lya') + (
        () if case == 'h2' else ('peel',))
    assert all(kb.LAUNCHES[k] > 0 for k in need), kb.LAUNCHES
    assert np.all(np.isfinite(res.Jout))
    if case == 'h2':
        assert abs(res.W_escape + res.W_oor + res.W_H2abs - 1.0) < 1e-3
        assert res.W_H2abs > 0.0
    else:
        assert abs(res.W_esc1 + res.W_abs1 + res.W_conv - 1.0) < 1e-3
        assert abs(res.W_esc2 + res.W_abs2 - res.W_conv) < 1e-3
        assert float(res.peel['Ha'].sum()) > 0.0
        assert (res.W_abs2 > 0.0) == (case == 'lyb_dust')


@pytest.mark.parametrize('case', ['sphere', 'jellyfish'])
def test_driver_runs_the_amr_kernels(cuda, case):
    """driver.run on the AMR grid with the leaves in memory (amr_data):
    K2's AMR births, K8, K4's AMR gathers and, on the jellyfish grid (its
    observer, non-uniform T, a moving medium, dust), K7's AMR sightline."""
    import dataclasses

    import numpy as np

    import chip_smoke
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.grid.amr import make_amr_sphere
    from lart_tpu_torch.kernels import build as kb
    if case == 'sphere':
        par, leaves = testing.amr_params(16, 1, tau0=20.0, nphotons=4000,
                                         batch=2048), make_amr_sphere(16, 1)
    else:
        par = dataclasses.replace(
            chip_smoke.example_params(chip_smoke.JELLY), taumax=10.0,
            nphotons=2000, batch_size=2048, nxim=21, nyim=21, dxim=0.15,
            dyim=0.15, distance=100.0, cext_dust=1.6e-13, xfreq_min=-80.0,
            xfreq_max=80.0, nxfreq=320)
        leaves = testing.jellyfish_amr()
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=3, amr_data=leaves)
    need = ('refill_point', 'fly_amr', 'scatter_lya') + (
        ('peel',) if case == 'jellyfish' else ())
    assert all(kb.LAUNCHES[k] > 0 for k in need), kb.LAUNCHES
    assert np.all(np.isfinite(res.Jout))
    assert abs(res.W_escape + res.W_absorb + res.W_oor - 1.0) < 1e-3
    assert (res.W_absorb > 0.0) == (case == 'jellyfish')


@pytest.mark.parametrize('dense_max', [1024, 0])
def test_driver_runs_the_clump_kernels(cuda, dense_max):
    """driver.run on the 40-clump sphere with one observer on +z: K2's
    clump births, K9 (overlap mode, the owner draw in K4) or K10
    (non-overlap), K4's clump frame in a moving medium with a clump
    temperature of 9e4 K, K7's clump sightline."""
    import numpy as np

    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = testing.clump_params(
        nphotons=4000, clump_allow_overlap=dense_max > 0,
        clump_dense_max=dense_max, clump_sigma_v=20.0,
        clump_temperature=9e4, save_peeloff=True, nobs=1, nxim=17,
        nyim=17, distance=1e3, alpha=(0.0,), beta=(0.0,))
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=3)
    fly = 'fly_clump_dense' if dense_max else 'fly_clump_csr'
    need = ('refill_point', fly, 'scatter_lya', 'peel')
    assert all(kb.LAUNCHES[k] > 0 for k in need), kb.LAUNCHES
    assert np.all(np.isfinite(res.Jout))
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-3
    assert float(res.peel['scatt'].sum()) > 0.0


def test_driver_runs_the_interior_observer(cuda):
    """driver.run with an interior all-sky observer and save_sightline_tau
    on examples/healpix_CIV/CIV_test.in cut (33x33x17, nside 16, 2000
    photons): K2's exponential-cylinder births, K5, K4, K7's interior mode
    and K11 launched; the weight closes, the HEALPix maps and the tau maps
    are finite."""
    from pathlib import Path

    import numpy as np

    from lart_tpu_torch import driver
    from lart_tpu_torch.config import Params
    from lart_tpu_torch.kernels import build as kb
    par = Params.from_namelist(str(Path(__file__).resolve().parents[1]
                                   / 'examples/healpix_CIV/CIV_test.in'))
    par.save_peeloff = True
    par.nx, par.ny, par.nz, par.nside, par.nphotons = 33, 33, 17, 16, 2000
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=3)
    need = ('refill_radial', 'fly_cartesian', 'scatter_lya', 'peel',
            'sightline')
    assert all(kb.LAUNCHES[k] > 0 for k in need), kb.LAUNCHES
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-3
    assert res.peel['scatt'].shape == (1, res.meta.nxfreq, 3072, 1)
    assert float(res.peel['direc'].sum()) > 0.0
    m = res.sightline[0]
    assert m['tau_gas'].shape == (res.meta.nxfreq, 3072, 1)
    assert np.all(np.isfinite(m['tau_gas'])) and float(m['N_gas'].min()) > 0


def test_driver_runs_the_atmosphere(cuda):
    """driver.run on examples/star_planet/star_planet_a090.in cut to 33^3
    and 2e4 photons with its observer on +z and Direct0: K2's illumination
    instance, K5 with the masked core, K4 and K7's PEEL_STELLAR launched;
    the budget W_esc + W_abs2 + W_oor closes on the birth weights, and
    Direct <= Direct0 in every bin with a transit shadow."""
    from pathlib import Path

    import numpy as np

    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    par = testing.source_params(
        'a090', Path(__file__).resolve().parents[1], nx=33, ny=33, nz=33,
        nphotons=20000, beta=(0.0,), save_direc0=True)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=3)
    need = ('refill_illum', 'fly_cartesian', 'scatter_lya', 'peel_stellar')
    assert all(kb.LAUNCHES[k] > 0 for k in need), kb.LAUNCHES
    b = testing.atmosphere_budget(res)
    assert abs(b['total'] - b['birth']) < 1e-3, b
    assert b['W_abs2'] > 0.0 and res.flux_factor > 0.0
    d0, d1 = res.peel['direc0'], res.peel['direc']
    assert float(d0.sum()) > 0.0 and np.all(d1 <= d0 * (1 + 1e-6))
    assert testing.transit(res)[0] > 0.0


def test_driver_runs_the_shear_and_the_maps(cuda):
    """driver.run on tests/test_shear.py's cut of shear.in (K5's shear
    wrap, launched; the weight closes) and on the slab with calcJ, calcP
    and calcPnew (K5's deposits and K4's Pa launched; the closure
    sum(Pa raw rhokap_phys) = the scattered weight)."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    kb.reset_launch_counts()
    res = driver.run(testing.shear_params(nphotons=4000), device=cuda,
                     seed=3)
    assert kb.LAUNCHES['fly_cartesian'] > 0 and res.meta.omega_shear > 1.0
    assert abs(res.W_escape + res.W_oor - 1.0) < 1e-3
    kb.reset_launch_counts()
    res = driver.run(testing.jpa_params('slab', nphotons=4000), device=cuda,
                     seed=3)
    assert kb.LAUNCHES['fly_cartesian'] > 0 and kb.LAUNCHES['scatter_lya'] > 0
    lhs, rhs = testing.pa_closure(res)
    assert abs(lhs / rhs - 1.0) < 1e-5, (lhs, rhs)
    assert res.J1.shape == (res.meta.nxfreq, res.meta.nbin_JPa)


def test_hot_bin_deposits_match_plain(cuda):
    """The maps' hot-bin cases of chip_smoke.phase2_shear at B = 8192:
    every lane in the centre cell of t1tau6.in, t4tau7.in, the 65^3
    flat-cell box (the warp level alone) and the 1x1x33 slab (J1's block
    copy), and with J1 also in one frequency bin, through K5's J1 and Pnew
    deposits and K4's Pa; K4's Jabs on DL20e_dust.in.  Lanes at 0
    differing, each map within MAP_REL of its largest bin."""
    import chip_smoke
    chip_smoke.B_MAIN = 8192
    res = {}
    chip_smoke.phase2_hot_bins(cuda, res)
    assert set(res) == {'fly_cartesian (J1, Pnew)', 'scatter_lya (Pa)',
                        'scatter_lya (Jabs)'}


def test_allph_kernels_match_plain_versions(cuda):
    """The table's birth rows of K2's five instances (by id), the death
    rows of K4's four instances with it, of K5 (kExtra), K8, K9 and K10
    against their plain versions (chip_smoke.phase2_allph)."""
    import chip_smoke
    chip_smoke.B_MAIN = 8192
    res = {}
    chip_smoke.phase2_allph(cuda, res)
    assert set(res) == ALLPH_KEYS


def test_driver_runs_the_allph_table(cuda):
    """driver.run with save_all_photons on the 17^3 tau 2 sphere with
    Stokes: K2, K5 and K4 launched with the table, every id written, the
    closures of testing.allph_closures."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.config import Params
    from lart_tpu_torch.kernels import build as kb
    par = Params(nphotons=20000, geometry='sphere', rmax=1.0, nx=17, ny=17,
                 nz=17, xmax=1, ymax=1, zmax=1, taumax=2.0, temperature=1e4,
                 xfreq_min=-30.0, xfreq_max=30.0, save_all_photons=True,
                 use_stokes=True, batch_size=4096, chunk_cycles=16)
    kb.reset_launch_counts()
    res = driver.run(par, device=cuda, seed=3)
    assert all(kb.LAUNCHES[k] > 0 for k in (
        'refill_point', 'fly_cartesian', 'scatter_lya')), kb.LAUNCHES
    summ = testing.allph_summary(res.allph, testing.allph_edges(
        res.meta.xfreq_min, res.meta.xfreq_max, 1.0))
    for k, (v, lim) in testing.allph_closures(res, summ).items():
        assert v <= lim, (k, v, lim)
    assert 0.5 < summ['N'] < 4.0


def test_nccl_at_one_rank_is_the_single_rank_path(cuda):
    """driver.run inside a one-rank NCCL group: every chunk's all-reduce,
    the drain's shrink (B 1024 -> 512) and the end reduce of the peel cube
    and the table bit for bit the single-rank path on the same inputs
    (chip_smoke.world1_identity); run_ranks at one rank launches the
    kernels and the all-reduce, and agrees with it."""
    import chip_smoke
    from lart_tpu_torch import testing
    from lart_tpu_torch.kernels import build as kb
    from lart_tpu_torch.parallel.launch import run_ranks
    par = testing.sphere_params(tau0=100.0, n=17, nphotons=5000, batch=1024,
                                save_all_photons=True, **chip_smoke.OBSERVER)
    res, compared = chip_smoke.world1_identity(cuda, par, seed=3)
    assert compared['shrinks'] > 0 and compared['end'] == 3, compared
    kb.reset_launch_counts()
    r1 = run_ranks(par, 1, 'cuda', seed=3)
    assert all(kb.LAUNCHES[k] > 0 for k in (
        'refill_point', 'fly_cartesian', 'scatter_lya', 'peel',
        'all_reduce')), kb.LAUNCHES
    assert r1.nprocs == 1 and abs(r1.nscatt_gas / res.nscatt_gas - 1) < 0.05
