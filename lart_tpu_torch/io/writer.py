"""Main output file with the LaRT section schema (HDF5 or FITS).

Port of write_output / output_filename for the basic, non-peel output
(lart_tpu/io/writer.py:40-64, :102-287): the Spectrum section with its
keywords and the Jmu section.  It writes through lart_tpu.io.iofile, so
the file has LaRT's schema and lart_tpu's readers read it.  FITS needs
only numpy (lart_tpu/io/minifits.py); HDF5 needs h5py.  Merging into an
existing output (out_merge) is not ported.
"""

from __future__ import annotations

import numpy as np

from lart_tpu.io.iofile import default_extension, open_read, open_write

from ..tally import RunResult


def _put_attrs(g, kv):
    for k, v in kv.items():
        if v is None:
            continue
        if isinstance(v, bool):
            g.attrs[k] = np.int32(1 if v else 0)
        elif isinstance(v, str):
            g.attrs[k] = v
        elif isinstance(v, int):
            g.attrs[k] = np.int64(v)
        else:
            g.attrs[k] = np.float64(v)


def write_output(filename: str, res: RunResult) -> str:
    par = res.cfg.par
    meta = res.meta
    if par.out_merge:
        raise NotImplementedError('out_merge is not ported to lart_tpu_torch')
    bp = np.float32 if par.out_bitpix == -32 else np.float64
    with open_write(filename, par.file_format) as f:
        g = f.create_group('Spectrum')
        g.create_dataset('Xfreq', data=res.xfreq.astype(bp))
        g.create_dataset('velocity', data=res.velocity.astype(bp))
        g.create_dataset('wavelength', data=res.wavelength.astype(np.float64))
        g.create_dataset('Jout', data=np.asarray(res.Jout, bp))
        if par.save_Jabs and res.Jabs is not None:
            g.create_dataset('Jabs', data=np.asarray(res.Jabs, bp))
        if par.save_Jin and res.Jin is not None:
            g.create_dataset('Jin', data=np.asarray(res.Jin, bp))
        _put_attrs(g, {
            'ExeTime': res.exetime_s / 60.0,
            'Nprocs': 1,
            'recoil': par.recoil,
            'coreskip': par.core_skip,
            'xyz_sym': par.xyz_symmetry,
            'xy_per': par.xy_periodic,
            'save_all': par.save_all,
            'save_Jin': par.save_Jin,
            'save_Jab': par.save_Jabs,
            'nphotons': float(res.nphotons),
            'taumax': meta.taumax,
            'tauhomo': meta.tauhomo,
            'Ngasmax': meta.N_gasmax,
            'Ngashomo': meta.N_gashomo,
            'temp': par.temperature,
            'Vexp': par.Vexp,
            'DGR': par.DGR,
            'atau3': meta.atau3,
            'voigta': res.cfg.voigt_a_ref,
            'Xfreq1': meta.xfreq_min,
            'Xfreq2': meta.xfreq_max,
            'Dxfreq': meta.dxfreq,
            'Dwave': meta.dwave,
            'I_unit': par.intensity_unit,
            'Dfreq': meta.Dfreq_ref,
            'Nsc_dust': res.nscatt_dust,
            'Nsc_gas': res.nscatt_gas,
            'Nsc_tot': res.nscatt_gas + res.nscatt_dust,
            'W_esc': res.W_escape,
            'W_abs': res.W_absorb,
            'nx': meta.nx, 'ny': meta.ny, 'nz': meta.nz,
            'xmax': par.xmax, 'ymax': par.ymax, 'zmax': par.zmax,
            'EXTNAME': 'Spectrum',
            'calc_P': par.calcP, 'calc_Pnew': par.calcPnew,
            'calc_J': par.calcJ,
        })
        if res.Jmu is not None:
            gm = f.create_group('Jmu')
            gm.create_dataset('data', data=np.asarray(res.Jmu, bp))
            mu_min = 0.0 if par.xyz_symmetry else -1.0
            dmu = (1.0 - mu_min) / par.nmu
            _put_attrs(gm, {
                'EXTNAME': 'Jmu', 'CTYPE1': 'XFREQ', 'CRPIX1': 1.0,
                'CRVAL1': meta.xfreq_min + 0.5 * meta.dxfreq,
                'CDELT1': meta.dxfreq, 'CTYPE2': 'MU', 'CRPIX2': 1.0,
                'CRVAL2': mu_min + 0.5 * dmu, 'CDELT2': dmu,
                'nmu': par.nmu, 'mu_min': mu_min, 'dmu': dmu})
    return filename


def output_filename(par) -> str:
    if par.out_file.strip():
        return par.out_file
    base = par.base_name.strip() or 'lart_output'
    return base + default_extension(par.file_format)


def read_spectrum(filename: str) -> dict:
    """The Spectrum section of an output file: its keywords and its
    datasets (Xfreq, Jout, ...) in one dict."""
    with open_read(filename) as f:
        g = f['Spectrum']
        out = dict(g.attrs)
        out.update({k: np.asarray(g[k]) for k in g.keys()})
    return out
