"""Sight-line tau / column maps (kernel K11's plain version,
instruments/sightline.py) against lart_tpu's make_sightline on the CPU.

The same grid goes to both packages (the port's Cartesian grid through
the bridge, lart_tpu's AMR grid and clump population carried over by
convert): examples/sightline_tau/sightline_car.in and sightline_inside.in
cut to 33^3 and 5 frequency bins (the TAN and the interior HEALPix rays,
the cap), a 17^3 Hubble sphere (the entry shift and the comoving updates)
seen from outside and from inside, the 16-base AMR sphere, and the
clumps_overlap.in population.  Every map entry (tau_gas per bin, N_gas,
tau_dust) agrees to 1e-5 of its value plus 1e-6 of the map's largest
entry: lart_tpu's XLA fuses tau + d rho into one fused multiply-add where
the port rounds twice, and the two CPU libms differ in the last bit of
cos, sin and tan; at most 1e-3 of the entries may miss (a ray through a
near tie of two faces steps through other cells).  The analytic check
of lart_tpu's tests/test_healpix.py:124 (a tauhomo sphere seen from its
centre: every pixel's line-centre tau the radial one), and the standalone
tool against lart_tpu's, both files read back by lart_tpu's io/iofile.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lart_tpu.grid import amr as jamr
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import sightline as jsl
from lart_tpu.io import iofile as jio
from lart_tpu.tools import make_sightline_tau as jtool
from lart_tpu_torch import convert, testing
from lart_tpu_torch.config import Params
from lart_tpu_torch.grid import amr as tamr
from lart_tpu_torch.grid import clump as tclump
from lart_tpu_torch.grid.cartesian import build_cartesian
from lart_tpu_torch.instruments import sightline as tsl
from lart_tpu_torch.physics.voigt import voigt_plain
from lart_tpu_torch.tools import make_sightline_tau as ttool

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL_REL, FRAC = 1e-5, 1e-6, 1e-3
CUT = dict(nx=33, ny=33, nz=33, nxfreq=5)


def _example(rel, **over):
    par = Params.from_namelist(str(ROOT / 'examples' / rel))
    par.save_peeloff = True
    for k, v in over.items():
        setattr(par, k, v)
    return par


def _hubble(**over):
    par = testing.hubble_params(tau0=100.0, n=17, xyz_symmetry=False,
                                nxfreq=11, save_peeloff=True, **over)
    return par


OUTSIDE = dict(nobs=1, distance=50.0, alpha=(30.0,), beta=(60.0,),
               nxim=17, nyim=17)
CASES = {
    'car': lambda: _example('sightline_tau/sightline_car.in', nxim=17,
                            nyim=17, **CUT),
    'inside': lambda: _example('sightline_tau/sightline_inside.in', nside=4,
                               **CUT),
    'hubble_tan': lambda: _hubble(**OUTSIDE),
    'hubble_inside': lambda: _hubble(nside=4, obsx=(0.3,), obsy=(-0.2,),
                                     obsz=(0.1,)),
    'amr': lambda: testing.amr_params(16, 1, tau0=100.0, nxfreq=5,
                                      save_peeloff=True, **OUTSIDE),
    'clumps_overlap': lambda: _example('clump_sphere/clumps_overlap.in',
                                       nxfreq=5, **OUTSIDE),
}


def _both(case):
    """(the port's maps, lart_tpu's) of observer 0 of CASES[case]."""
    par = CASES[case]()
    cfg, jcfg = bridge.resolve_both(par)
    jobs_meta, jodev = jobs.build_observers(jcfg)
    if case == 'amr':
        jr = jamr.build_amr(jcfg, data=tamr.make_amr_sphere(16, 1))
        meta, grid = convert.amr_from_jax(jr.meta, jr.dev)
        sl = tsl.Sightline.from_config(cfg, meta, grid)
        want = jsl.make_sightline(jcfg, jr.meta, jobs_meta)(jr.dev, jodev, 0)
    elif case == 'clumps_overlap':
        meta, cmeta, grid = tclump.build_clumps(cfg, seed=par.iseed + 77,
                                                device='cpu')
        jm, jc, jd = bridge.clump_to_jax(meta, cmeta, grid)
        sl = tsl.Sightline.from_config(cfg, meta, grid, cmeta)
        want = jsl.make_sightline(jcfg, jm, jobs_meta, cmeta=jc)(jd, jodev, 0)
    else:
        meta, grid = build_cartesian(cfg)
        jmeta, jgrid = bridge.grid_to_jax(meta, grid)
        sl = tsl.Sightline.from_config(cfg, meta, grid)
        want = jsl.make_sightline(jcfg, jmeta, jobs_meta)(jgrid, jodev, 0)
    return sl, tsl.maps(sl, tsl.sightline(sl), 0), want


@pytest.mark.parametrize('case', sorted(CASES))
def test_sightline_matches_make_sightline(case):
    sl, got, want = _both(case)
    assert sl.obs_meta.inside == ('inside' in case)
    assert sl.comoving == case.startswith('hubble')
    for name in ('tau_gas', 'N_gas', 'tau_dust'):
        a = np.asarray(got[name], np.float64)
        b = np.asarray(want[name], np.float64)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        tol = RTOL * np.abs(b) + ATOL_REL * max(np.abs(b).max(), 1e-30)
        off = np.abs(a - b) > tol
        assert off.sum() <= FRAC * a.size, (case, name, int(off.sum()),
                                            float(np.abs(a - b).max()))
    assert np.asarray(got['N_gas']).max() > 0.0
    assert np.asarray(got['tau_gas']).max() > 1.0


def test_tauhomo_sphere_from_its_centre():
    """A tauhomo-3 uniform sphere seen from its centre (lart_tpu's
    tests/test_healpix.py:124): every pixel's optical depth at the bin by
    line centre is the radial one, tauhomo H(x) / H(0), to 5% (the
    voxelized sphere's edge), and the pixels agree with each other."""
    par = Params(nphotons=10, geometry='sphere', rmax=1.0, nx=33, ny=33,
                 nz=33, xmax=1, ymax=1, zmax=1, tauhomo=3.0, temperature=1e4,
                 xfreq_min=-5.0, xfreq_max=5.0, nxfreq=11, save_peeloff=True,
                 save_sightline_tau=True, nside=2)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg)
    sl = tsl.Sightline.from_config(cfg, meta, grid)
    m = tsl.maps(sl, tsl.sightline(sl), 0)
    ctr = meta.nxfreq // 2
    t = m['tau_gas'][ctr, :, 0]
    assert t.min() > 0 and np.allclose(t, t.mean(), rtol=0.05)
    xc = meta.xfreq_min + (ctr + 0.5) * meta.dxfreq
    h = [float(voigt_plain(torch.tensor([x], dtype=torch.float32),
                           meta.voigt_a_ref)) for x in (xc, 0.0)]
    assert abs(t.mean() / (3.0 * h[0] / h[1]) - 1.0) < 0.05


def test_tool_matches_lart_tpu(tmp_path):
    """The standalone tool (--device cpu) and lart_tpu's on one namelist
    (sightline_inside.in cut), FITS, both files read by lart_tpu's
    io/iofile: the same datasets and keywords, maps to the tolerance
    above."""
    text = (ROOT / 'examples/sightline_tau/sightline_inside.in').read_text()
    text = text.replace(" par%out_file = 'sightline_inside.h5'",
                        " par%file_format = 'fits'\n par%nx = 17\n"
                        " par%ny = 17\n par%nz = 17\n par%nxfreq = 5\n"
                        " par%nside = 4")
    nml = tmp_path / 'inside.in'
    nml.write_text(text)
    ours, theirs = tmp_path / 'ours_tau.fits', tmp_path / 'theirs_tau.fits'
    assert ttool.main([str(nml), str(ours), '--device', 'cpu']) == 0
    assert jtool.main([str(nml), str(theirs)]) == 0
    with jio.open_read(str(ours)) as a, jio.open_read(str(theirs)) as b:
        assert list(a.keys()) == list(b.keys()) == ['tau_gas', 'N_gas',
                                                    'tau_dust']
        for name in a.keys():
            u = np.asarray(a[name + '/data'], np.float64)
            v = np.asarray(b[name + '/data'], np.float64)
            assert u.shape == v.shape
            tol = RTOL * np.abs(v) + ATOL_REL * max(np.abs(v).max(), 1e-30)
            assert (np.abs(u - v) > tol).sum() <= FRAC * u.size, name
            for k in ('Dxfreq', 'Xfreq1', 'Xfreq2'):
                if k in b[name].attrs:
                    assert math.isclose(float(a[name].attrs[k]),
                                        float(b[name].attrs[k]))
    with pytest.raises(RuntimeError, match='cuda'):
        ttool.main([str(nml), str(ours)])
