"""The slice end to end on the CPU: lart_tpu_torch.driver.run with an
interior all-sky observer against lart_tpu's driver.run, and the CLI on
examples/healpix_CIV/CIV_test.in cut, its files read back by lart_tpu's
io/iofile.

One run in each package (1000 photons): a point source at +0.05 x inside
a shell of gas at 0.5 < r < 1 (13^3, tau 2), seen from the centre, where
the 1/r^2 weights stay bounded (lart_tpu's tests/test_healpix.py:60 and
:95 in one).  The direct pixel: all the direct weight lands in the
HEALPix pixel of the +x arrival direction, in both packages, and the two
direct totals agree to 2% (each photon's direct deposit differs only by
its frequency's attenuation).  The shell's isotropy: each package's
scattered all-sky map is isotropic to 20% of its mean (the Monte Carlo
spread over its 12 pixels is ~5-10%, the source's offset adds less), the
two totals agree to 10% and <N_scatt> to 5%.
"""

from pathlib import Path

import numpy as np
import torch

from lart_tpu import driver as jdriver
from lart_tpu.grid import cartesian as jcart
from lart_tpu.instruments import healpix as jhp
from lart_tpu.instruments import observer as jobs
from lart_tpu.instruments import sightline as jsl
from lart_tpu.io import iofile as jio
from lart_tpu_torch import __main__ as cli
from lart_tpu_torch import testing
from lart_tpu_torch.config import Params

import _torch_jax_bridge as bridge

ROOT = Path(__file__).resolve().parents[1]


def _maps(res, cube):
    """(nxfreq, npix) all-sky maps of observer 0, summed over frequency."""
    return np.asarray(res.peel[cube][0], np.float64).sum(axis=0).reshape(-1)


def test_direct_pixel_and_shell_isotropy_match_lart_tpu():
    par = testing.sphere_params(tau0=2.0, n=13, nphotons=1000, batch=512,
                                rmin=0.5, xs_point=0.05, save_peeloff=True,
                                nside=1, obsx=(0.0,), obsy=(0.0,),
                                obsz=(0.0,), xfreq_min=-30.0, xfreq_max=30.0)
    port = bridge.run_port_cpu(par, 5)
    ref = jdriver.run(bridge.jax_params(par), seed=5)
    want = int(np.asarray(jhp.vec2pix_ring(1, *(np.float32([v]) for v in (
        1.0, 0.0, 0.0))))[0])
    direct, scatt = [], []
    for r in (port, ref):
        d, m = _maps(r, 'direc'), _maps(r, 'scatt')
        assert d[want] > 0 and d.sum() == d[want]
        assert m.min() > 0 and m.std() / m.mean() < 0.2, m.std() / m.mean()
        direct.append(d.sum())
        scatt.append(m.sum())
    assert abs(direct[0] / direct[1] - 1.0) < 0.02, direct
    assert abs(scatt[0] / scatt[1] - 1.0) < 0.1, scatt
    assert abs(port.nscatt_gas / ref.nscatt_gas - 1.0) < 0.05


def test_cli_civ_test_with_peeloff(tmp_path):
    """CIV_test.in cut (9x9x5, nside 2, 50 photons, N_gasmax 1e13) with
    save_peeloff through python -m lart_tpu_torch --device cpu, FITS: the
    _peel3D and
    _peel2D HEALPix maps (nxfreq, npix) with lart_tpu's keywords and the
    _tau file, read by lart_tpu's io/iofile; the tau maps equal to lart_tpu's
    make_sightline on the same grid to 1e-5."""
    text = (ROOT / 'examples/healpix_CIV/CIV_test.in').read_text()
    text = text.replace(" par%out_file = 'CIV_test.h5'",
                        " par%file_format = 'fits'\n par%save_peeloff = .true."
                        "\n par%save_peeloff_2D = .true.\n par%nx = 9\n"
                        " par%ny = 9\n par%nz = 5\n par%nside = 2\n"
                        " par%no_photons = 50\n par%batch_size = 64")
    text = text.replace(" par%N_gasmax      = 1.0e15",
                        " par%N_gasmax = 1.0e13")
    nml = tmp_path / 'civ.in'
    nml.write_text(text)
    out = tmp_path / 'civ.fits'
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main([str(nml), str(out), '--device', 'cpu']) == 0
    finally:
        torch.set_num_threads(nthreads)
    npix = 48
    with jio.open_read(str(tmp_path / 'civ_peel3D.fits')) as f:
        assert set(f.keys()) == {'Scattered', 'Direct'}
        for name in ('Scattered', 'Direct'):
            a = np.asarray(f[name + '/data'])
            assert a.shape[1:] == (npix,) and a.sum() > 0 and np.all(
                np.isfinite(a))
            at = f[name].attrs
            assert (at['PIXTYPE'], at['ORDERING'], int(at['NSIDE']),
                    int(at['NPIX'])) == ('HEALPIX', 'RING', 2, npix)
        nxfreq = a.shape[0]
    with jio.open_read(str(tmp_path / 'civ_peel2D.fits')) as f:
        assert np.asarray(f['Scattered/data']).shape == (npix, 1)
        assert int(f['Direct'].attrs['NSIDE']) == 2
    par = Params.from_namelist(str(nml))
    jcfg = bridge.jax_params(par).resolve()
    jmeta, jgrid = jcart.build_cartesian(jcfg)
    jobs_meta, jodev = jobs.build_observers(jcfg)
    want = jsl.make_sightline(jcfg, jmeta, jobs_meta)(jgrid, jodev, 0)
    with jio.open_read(str(tmp_path / 'civ_tau.fits')) as f:
        assert list(f.keys()) == ['tau_gas', 'N_gas', 'tau_dust']
        assert np.asarray(f['tau_gas/data']).shape == (nxfreq, npix, 1)
        for name in f.keys():
            a = np.asarray(f[name + '/data'], np.float64)
            b = np.asarray(want[name], np.float64)
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max())
