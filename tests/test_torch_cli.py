"""The port's command line on the CPU, its refusal to fall back from a
missing GPU, and its independence from jax."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from lart_tpu.analysis import read_lart
from lart_tpu_torch import __main__ as cli

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The in-process runs in one torch thread: under Tier-1's six workers
    torch's default pool oversubscribes the cores, and the peel-file case
    took 829 s of a whole run against 16 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NAMELIST = """&parameters
 par%nphotons = 2000
 par%temperature = 1e4
 par%tauhomo = 10.0
 par%xy_periodic = .true.
 par%nx = 1
 par%ny = 1
 par%nz = 33
 par%source_geometry = 'point'
 par%spectral_type = 'voigt'
 par%save_Jmu = .true.
 par%nmu = 4
 par%batch_size = 1024
 par%file_format = '{fmt}'
/
"""


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = str(ROOT) + os.pathsep + env.get('PYTHONPATH', '')
    return env


@pytest.mark.parametrize('fmt,ext', [('fits', '.fits'), ('hdf5', '.h5')])
def test_cli_writes_output_that_lart_tpu_reads(tmp_path, fmt, ext):
    nml = tmp_path / 't.in'
    nml.write_text(NAMELIST.format(fmt=fmt))
    proc = subprocess.run(
        [sys.executable, '-m', 'lart_tpu_torch', str(nml), '--device', 'cpu'],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = tmp_path / ('t' + ext)
    assert f'output written: {out}' in proc.stdout
    r = read_lart(str(out))
    assert float(r.header['nphotons']) == 2000.0
    assert abs(float(r.header['W_esc']) - 1.0) < 1e-3
    assert r.Jout.shape == r.xfreq.shape and np.all(np.isfinite(r.Jout))
    assert r.Jin is not None and r.Jin.sum() > 0.0
    assert r.Jmu.shape == (r.xfreq.size, 4)
    assert 5.0 < float(r.header['Nsc_gas']) < 200.0


PEEL_LINES = """
 par%save_peeloff = .true.
 par%save_peeloff_2D = .true.
 par%use_stokes = .true.
 par%nxim = 21
 par%nyim = 21
 par%distance = 1e3
 par%alpha(1) = 0.0
 par%beta(1) = 0.0
 par%alpha(2) = 30.0
 par%beta(2) = 60.0
/
"""


@pytest.mark.parametrize('fmt,ext', [('fits', '.fits'), ('hdf5', '.h5')])
def test_cli_writes_peel_files_that_lart_tpu_reads(tmp_path, fmt, ext):
    """Two observers with Stokes: per observer a _peel3D file (cubes, WCS,
    radial profiles) that lart_tpu's read_lart finds beside the main
    output, and a _peel2D file of frequency-integrated images."""
    from lart_tpu.io.iofile import open_read
    nml = tmp_path / 't.in'
    text = NAMELIST.format(fmt=fmt).replace('2000', '150')
    nml.write_text(text.replace('nz = 33', 'nz = 17').rstrip().rstrip('/')
                   + PEEL_LINES)
    out = tmp_path / ('t' + ext)
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    r = read_lart(str(out))
    assert abs(float(r.header['W_esc']) - 1.0) < 1e-3
    assert len(r.peel) == 2
    for k, p in enumerate(r.peel):
        assert p.filename == str(tmp_path / f't_{k + 1:03d}_peel3D{ext}')
        assert p.scatt.shape == p.direc.shape == (r.xfreq.size, 21, 21)
        assert sorted(p.stokes) == ['I', 'Q', 'U', 'V']
        np.testing.assert_allclose(p.stokes['I'], p.scatt + p.direc,
                                   rtol=1e-5, atol=1e-12)
        assert p.scatt.sum() > 0.0 and p.direc.sum() > 0.0
        assert np.all(np.isfinite(p.radial['stokes_pol']))
        assert p.header['CTYPE2'].strip() == 'RA--TAN'
        with open_read(str(tmp_path / f't_{k + 1:03d}_peel2D{ext}')) as f:
            img = np.asarray(f['Scattered/data'], np.float64)
            assert img.shape == (21, 21)
            np.testing.assert_allclose(
                img, p.scatt.sum(axis=0) * float(p.header['Dxfreq']),
                rtol=1e-5)
    # the oblique observer's viewing cosine, cos 60 deg
    assert r.peel[1].mu == pytest.approx(0.5, abs=1e-6)


# the three peel-off examples, cut to a few seconds on the CPU (photons,
# optical depth, and the 3-D grids to 17^3); their images and frequency
# axes as written
PEEL_EXAMPLES = {
    'slab_peel/t1tau4.in': dict(no_photons='200', taumax='10.0', nz='33'),
    'sphere_peel/t4tau4_peel.in': dict(nphotons='200', taumax='10.0',
                                       nx='17', ny='17', nz='17'),
    'vel_effect_peel/t4NHI2_20_V0200_peel.in': dict(
        no_photons='200', N_HI='2e14', nx='17', ny='17', nz='17'),
}


@pytest.mark.parametrize('example', sorted(PEEL_EXAMPLES))
def test_cli_runs_the_peel_examples(tmp_path, example):
    import chip_smoke
    from lart_tpu_torch.config import Params
    nml = chip_smoke.namelist_variant(example, tmp_path, batch_size='256',
                                      **PEEL_EXAMPLES[example])
    par = Params.from_namelist(str(nml))
    out = tmp_path / 'out.fits'
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    r = read_lart(str(out))
    assert abs(float(r.header['W_esc']) - 1.0) < 1e-3 or (
        example.startswith('vel') and float(r.header['W_esc']) > 0.99)
    (p,) = r.peel
    assert p.filename == str(tmp_path / 'out_peel3D.fits')
    assert p.scatt.shape == (r.xfreq.size, par.nxim, par.nyim)
    assert p.direc.sum() > 0.0 and np.all(np.isfinite(p.scatt))
    assert sorted(p.stokes) == (['I', 'Q', 'U', 'V'] if par.use_stokes
                                else [])


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    nml = tmp_path / 't.in'
    nml.write_text(NAMELIST.format(fmt='fits'))
    with pytest.raises(RuntimeError, match='cuda'):
        cli.main([str(nml), str(tmp_path / 'o.fits'), '--device', 'cuda'])
    # cuda is the default device
    with pytest.raises(RuntimeError, match='cuda'):
        cli.main([str(nml), str(tmp_path / 'o.fits')])
    assert not (tmp_path / 'o.fits').exists()


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import lart_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            lart_tpu_torch.__path__, 'lart_tpu_torch.')]
        for n in names:
            importlib.import_module(n)
        from lart_tpu_torch import driver, testing
        res = driver.run(testing.slab_params(tau0=5.0, nz=17, nphotons=300,
                                             batch=256), device='cpu')
        assert abs(res.W_escape + res.W_oor - 1.0) < 1e-6
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'h5py'))
        print(len(names), bad)
        assert not bad, bad
    """)
    env = _env()
    env.pop('JAX_PLATFORMS', None)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_mods, bad = proc.stdout.split(None, 1)
    assert int(n_mods) >= 20 and bad.strip() == '[]'


def test_port_sources_import_no_jax():
    """Every import statement of the port and of chip_smoke.py, also those
    inside functions that the subprocess run above never calls, names no
    jax or lart_tpu module, and h5py only in io/iofile.py (inside the
    functions that open an HDF5 file): the port keeps its own copies of
    the jax-free host modules."""
    bad = []
    files = sorted((ROOT / 'lart_tpu_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py']
    for fn in files:
        for node in ast.walk(ast.parse(fn.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module]
            else:
                continue
            for m in mods:
                top = m.split('.')[0]
                if top in ('jax', 'jaxlib', 'lart_tpu') or (
                        top == 'h5py' and fn.name != 'iofile.py'):
                    bad.append(f'{fn.relative_to(ROOT)}:{node.lineno} {m}')
    assert len(files) >= 20 and not bad, bad


def test_cli_runs_the_dusty_shell(tmp_path):
    """examples/DL2008/DL20e_dust.in cut to a CPU's few seconds (17^3, 300
    photons, N_HI 3.4e14 with DGR 1.8e6 so that a good share is absorbed):
    the FITS output carries the absorbed spectrum Jabs, which lart_tpu's
    read_lart and check_flux read, and the weight closes."""
    import chip_smoke
    from lart_tpu.analysis import check_flux
    nml = chip_smoke.namelist_variant(
        'DL2008/DL20e_dust.in', tmp_path, no_photons='300', N_HI='3.4e14',
        DGR='1.8e6', nx='17', ny='17', nz='17', batch_size='256')
    out = tmp_path / 'out.fits'
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    r = read_lart(str(out))
    assert r.Jabs is not None and r.Jabs.shape == r.xfreq.shape
    assert np.all(np.isfinite(r.Jabs)) and r.Jabs.sum() > 0.0
    w_abs = float(r.header['W_abs'])
    assert 0.05 < w_abs < 0.95
    assert float(r.header['Nsc_dust']) > 0.0
    assert check_flux(r, verbose=False)['W_abs'] == w_abs
    assert abs(float(r.header['W_esc']) + w_abs - 1.0) < 1e-3


def test_cli_runs_the_silicon_multiplet(tmp_path):
    """examples/SiII_1193/tau1e+2_V200.in (line type 5 with its fluorescent
    Si II* branches, a continuum source, recoil, Stokes, one observer, the
    101^3 Hubble sphere) cut to a CPU's few seconds: a 17^3 grid, 300
    photons, a 17 x 17 image.  The FITS output is read by lart_tpu's
    read_lart on the example's 240-bin axis, the weight closes, and the
    _peel3D file is written."""
    import chip_smoke
    nml = chip_smoke.namelist_variant(
        'SiII_1193/tau1e+2_V200.in', tmp_path, no_photons='300', nx='17',
        ny='17', nz='17', nxim='17', nyim='17', batch_size='512')
    out = tmp_path / 'out.fits'
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    r = read_lart(str(out))
    assert r.Jout.shape == r.xfreq.shape == (240,)
    assert np.all(np.isfinite(r.Jout)) and r.Jout.sum() > 0.0
    w = float(r.header['W_esc']) + float(r.header.get('W_oor', 0.0))
    assert abs(w - 1.0) < 1e-3
    assert float(r.header['Nsc_gas']) > 0.0
    assert (tmp_path / 'out_peel3D.fits').exists()


def test_cli_runs_the_lyman_beta_dusty_sphere(tmp_path):
    """examples/ly_beta_sphere/t4tau1e4_dust.in (line type 8: Ly-beta with
    its H-alpha band, one observer with the peel_Ha cube) cut to a CPU's
    few seconds: a 17^3 grid, tau0 30, 300 photons, a 17 x 17 image, and
    DGR raised from 1e-3 to 1e5 (as written the dust's tau is ~1e-6).  The
    FITS output carries Jout_Ha, Jabs_Ha, the two-photon spectrum and the
    band budgets, which lart_tpu's read_lart reads; the budgets close and
    the _peel3D file holds the peel_Ha cube."""
    import chip_smoke
    from lart_tpu.io.iofile import open_read
    nml = chip_smoke.namelist_variant(
        'ly_beta_sphere/t4tau1e4_dust.in', tmp_path, no_photons='300',
        taumax='30.0', DGR='1.0e5', nx='17', ny='17', nz='17', nxim='17',
        nyim='17', batch_size='512')
    out = tmp_path / 'out.fits'
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    r = read_lart(str(out))
    h = r.header
    assert r.Jout_Ha.shape == r.Jabs_Ha.shape == r.xfreq.shape
    assert r.Jout_Ha.sum() > 0.0 and r.Jabs_Ha.sum() > 0.0
    assert r.J2gam.shape == r.y_2gam.shape and r.J2gam.sum() > 0.0
    w = {k: float(h[k]) for k in ('W_conv', 'W_esc1', 'W_abs1', 'W_esc2',
                                  'W_abs2')}
    assert abs(w['W_esc1'] + w['W_abs1'] + w['W_conv'] - 1.0) < 1e-3
    assert abs(w['W_esc2'] + w['W_abs2'] - w['W_conv']) < 1e-3
    with open_read(str(tmp_path / 'out_peel3D.fits')) as f:
        assert {'Scattered', 'Direct', 'peel_Ha'} <= set(f.keys())
        ha = np.asarray(f['peel_Ha/data'])
    assert ha.shape == (r.xfreq.size, 17, 17) and ha.sum() > 0.0


def test_cli_runs_the_h2_example(tmp_path):
    """examples/h2_test/h2_on.in (Ly-alpha with the Neufeld H2 pumping,
    core-skip) cut to a CPU's few seconds: a 17^3 grid, tau 10, 200
    photons, f_H2 raised from 0.03 to 30 so that H2 destroys a share.  The
    FITS output's Spectrum keywords carry the H2 model, fraction,
    temperature and the per-photon destroyed, scattered and pumped weights,
    which read_lart reads; the weight closes with the destroyed share."""
    import chip_smoke
    nml = chip_smoke.namelist_variant(
        'h2_test/h2_on.in', tmp_path, no_photons='200', taumax='10.0',
        f_H2='30.0', nx='17', ny='17', nz='17', batch_size='512')
    out = tmp_path / 'out.fits'
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    r = read_lart(str(out))
    h = r.header
    assert str(h['H2MODEL']).strip() == 'neufeld' and int(h['H2NLINE']) == 2
    assert float(h['H2FH2']) == 30.0 and float(h['H2TEMP']) == 8000.0
    assert float(h['H2ABS']) > 0.0
    assert float(h['H2PUMP1']) + float(h['H2PUMP2']) >= float(h['H2ABS'])
    w = float(h['W_esc']) + float(h.get('W_oor', 0.0)) + float(h['H2ABS'])
    assert abs(w - 1.0) < 1e-3
    assert r.Jout.shape == r.xfreq.shape == (241,)


def test_cli_runs_the_amr_sphere(tmp_path):
    """examples/amr_sphere/amr_sphere.in (use_amr_grid on the tracked
    generic-AMR file, 48000 leaves at levels 5-6) cut to a CPU's few
    seconds: tau 10, 300 photons; the port reads amr_sphere.h5 itself
    (h5py, inside grid.amr.read_generic_amr) and walks the octree (K8's
    plain version); read_lart reads the FITS output and the weight
    closes."""
    pytest.importorskip('h5py')
    import chip_smoke
    h5 = ROOT / 'examples/amr_sphere/amr_sphere.h5'
    nml = chip_smoke.namelist_variant(
        'amr_sphere/amr_sphere.in', tmp_path, nphotons='300',
        taumax='10.0', batch_size='1024', amr_file=f"'{h5}'")
    out = tmp_path / 'out.fits'
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    r = read_lart(str(out))
    assert float(r.header['nphotons']) == 300.0
    assert abs(float(r.header['W_esc']) - 1.0) < 1e-3
    assert r.Jout.shape == r.xfreq.shape and np.all(np.isfinite(r.Jout))
    assert r.Jout.sum() > 0.0


def test_cli_runs_the_bicone_clumps(tmp_path):
    """examples/bicone/bicone_clump.in (6837 clumps in non-overlap mode:
    the CSR walker, K10's plain version) cut to a CPU's few seconds: its
    clumps' tau0 1e3 cut to 1 and 200 photons.  read_lart reads the FITS
    output, the weight closes, and the population the run saved
    (save_clump_info, <out>_clumps.h5) is the one lart_tpu builds from the
    same seed, as lart_tpu's load_clumps reads it."""
    pytest.importorskip('h5py')
    import chip_smoke
    from lart_tpu.config import Params as JParams
    from lart_tpu.grid import clump as jclump
    nml = chip_smoke.namelist_variant(
        'bicone/bicone_clump.in', tmp_path, no_photons='200',
        clump_tau0='1.0', batch_size='1024')
    out = tmp_path / 'out.fits'
    assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    r = read_lart(str(out))
    assert float(r.header['nphotons']) == 200.0
    assert abs(float(r.header['W_esc']) + float(r.header.get('W_oor', 0.0))
               - 1.0) < 1e-3
    assert r.Jout.shape == r.xfreq.shape == (121,)
    assert np.all(np.isfinite(r.Jout)) and r.Jout.sum() > 0.0
    pop = jclump.load_clumps(str(tmp_path / 'out_clumps.h5'))
    jpar = JParams.from_namelist(str(nml))
    _, jc, jd = jclump.build_clumps(jpar.resolve(), seed=jpar.iseed + 77)
    assert pop['attrs']['N_CLUMPS'] == jc.n_clumps == 6837
    np.testing.assert_array_equal(pop['pos'][:, 0], np.asarray(jd.x))
