"""The port stands alone: every module of lart_tpu_torch, and
chip_smoke.py, imports with lart_tpu and jax made unimportable, builds an
AMR grid with its own octree builder and a clump population with its own
copy of build_clumps, builds a Cartesian grid from FITS temperature
and density cubes with astropy unimportable too (io/reader.py reads them
through the port's minifits), and builds star_planet_a090.in's
atmosphere at 9^3 and refills it (the line-profile file, the stellar
illumination and its peel), and finds the ranks' modules (parallel/)
with their budgets and seeds."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CODE = """
import importlib, pkgutil, sys
sys.modules['lart_tpu'] = None     # any import of them raises ImportError
sys.modules['jax'] = None
import lart_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lart_tpu_torch.__path__,
                                               'lart_tpu_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
from lart_tpu_torch.config import Params
cfg = Params.from_namelist('examples/sphere_peel/t4tau4_peel.in').resolve()
assert cfg.par.use_stokes and cfg.par.save_peeloff
# the H2 table comes from the data file, with nothing of lart_tpu imported
from lart_tpu_torch.physics import h2
cfg = Params.from_namelist('examples/h2_test/h2_on.in').resolve()
assert h2.H2Consts.from_config(cfg).strength[1] > 0.0
# the AMR grid: the octree by the port's own C++ builder, the fine map
from lart_tpu_torch import testing
from lart_tpu_torch.grid.amr import build_amr, make_amr_sphere
r = build_amr(testing.amr_params(8, 1).resolve(), data=make_amr_sphere(8, 1))
assert r.tree.builder == 'native' and r.dev.fine_map is not None
# the clump population and the chunk of the CSR walker
from lart_tpu_torch.grid.clump import build_clumps
from lart_tpu_torch.transport.engine import make_chunk
cfg = testing.clump_params(clump_dense_max=0).resolve()
m, c, d = build_clumps(cfg, seed=1, device='cpu')
assert c.n_clumps == 40 and d.table.shape == (c.cg_n ** 3, c.K)
assert not make_chunk(cfg, m, d, c).flight.clump.dense
# the 3-D grid files as FITS through the port's minifits, without astropy
sys.modules['astropy'] = None
import os, tempfile
from lart_tpu_torch.grid.cartesian import build_cartesian
d = tempfile.mkdtemp()
T = testing.write_cube(os.path.join(d, 'T.fits'),
                       testing.temperature_cube(9, 1))
rho = testing.write_cube(os.path.join(d, 'rho.fits.gz'), testing.turb_cube(9))
m, g = build_cartesian(testing.sphere_params(
    n=9, temp_file=T, dens_file=rho).resolve())
assert not m.uniform_temperature and g.Dfreq is not None
# the atmosphere of star_planet_a090.in (its profiles, the line-profile
# file, the stellar illumination and its peel) and one refill of it
import pathlib
from lart_tpu_torch.transport.refill import refill
from lart_tpu_torch.transport.state import init_state
par = testing.source_params('a090', pathlib.Path('.'), nx=9, ny=9, nz=9)
m, g = build_cartesian(par.resolve())
ch = make_chunk(par.resolve(), m, g)
assert ch.refill_params.kernel == 'refill_illum' and ch.peel.stellar
s = init_state(256, 'cpu')
t = ch.zero_tallies('cpu')
refill(s, t, ch.refill_params, 1, 0, 256)
assert float(t.flux_factor) > 0.0 and t.Jabs2 is not None
# the ranks' modules (parallel/): budgets, seeds and the deal
for n in ('mesh', 'distributed', 'reduce', 'launch'):
    assert 'lart_tpu_torch.parallel.' + n in names, n
from lart_tpu_torch.parallel import mesh
assert list(mesh.shard_budget(5, 2)) == [3, 2]
assert len(set(mesh.rank_seeds(1, 4))) == 4
print(len(names))
"""


def test_port_imports_without_lart_tpu_and_jax():
    env = dict(os.environ)
    env['PYTHONPATH'] = str(ROOT) + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', CODE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 32
