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


# the lart_tpu modules that leave jax (and h5py) out of sys.modules
JAX_FREE = ('lart_tpu.config', 'lart_tpu.lines', 'lart_tpu.constants',
            'lart_tpu.io.iofile', 'lart_tpu.io.minifits')


def test_port_sources_import_no_jax():
    """Every import statement of the port, also those inside functions that
    the subprocess run above never calls, names no jax module."""
    bad = []
    files = sorted((ROOT / 'lart_tpu_torch').rglob('*.py'))
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
                if top in ('jax', 'jaxlib', 'h5py') or (
                        top == 'lart_tpu' and m not in JAX_FREE):
                    bad.append(f'{fn.relative_to(ROOT)}:{node.lineno} {m}')
    assert len(files) >= 20 and not bad, bad
