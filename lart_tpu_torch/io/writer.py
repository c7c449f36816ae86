"""Main output file with the LaRT section schema (HDF5 or FITS).

Port of write_output / output_filename (lart_tpu/io/writer.py:40-64,
:102-287): the Spectrum section with its keywords (H2 pumping's, line
type 8's band budgets and an illumination's flux_factor and nrejected
among them) and an atmosphere's Jabs2, the Jmu section, line type 8's
Jout_Ha, Jabs_Ha and J2gam sections, the CALCJ/CALCP/CALCPnew maps'
Jx_1D, Pa_1D (Pa_3D on the flat-cell geometry) and Pa_1D_new sections with
their bin centres (radius) and geom_JPa, and with peel-off one _peel3D file
per observer (Scattered/Direct cubes with spectral + TAN WCS keywords,
RadialI, Stokes I/Q/U/V cubes and their Stokes_radial profiles, the
H-alpha band's peel_Ha cube, a stellar source's Direct0 cube;
write_output_peeling_3D, :288-407) and, with
save_peeloff_2D, one _peel2D file of frequency-integrated images (:66-99).
An interior observer's files hold all-sky HEALPix RING maps: _peel3D its
Scattered and Direct (nxfreq, npix) maps, _peel2D their frequency
integrals, with the PIXTYPE, ORDERING, NSIDE and NPIX keywords (:91-93,
:313-340).  With save_sightline_tau one _tau file per observer holds its
sight-line maps (:45-50; instruments/sightline.py).  With
save_all_photons the main output holds the AllPhotons section (:268-274):
one f32 column a field of the table (transport/allph.py), a row a photon;
in FITS a binary table.
It writes through the port's io/iofile.py, so the files have LaRT's schema
and lart_tpu's readers read them.  FITS needs only numpy (io/minifits.py);
HDF5 needs h5py.  Merging into an existing output (out_merge) is not
ported.
"""

from __future__ import annotations

import os

import numpy as np

from ..instruments.profiles import radial_intensity, radial_stokes
from ..tally import RunResult
from .iofile import default_extension, open_read, open_write


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
    """Write the main output and, with peel-off, the per-observer
    _peel3D/_peel2D files beside it (write_output_outside,
    write_output_rect.f90:24-46)."""
    out = _write_basic(filename, res)
    if res.sightline is not None:
        from ..instruments.sightline import write_sightline_tau
        base, ext = os.path.splitext(filename)
        for k, maps in enumerate(res.sightline):
            suffix = '' if len(res.sightline) == 1 else f'_{k + 1:03d}'
            write_sightline_tau(f'{base}{suffix}_tau{ext}', maps, res.cfg,
                                res.meta)
    if res.peel is not None:
        base, ext = os.path.splitext(filename)
        nobs = res.obs_meta.nobs
        for k in range(nobs):
            suffix = '' if nobs == 1 else f'_{k + 1:03d}'
            if res.cfg.par.save_peeloff_3D:
                write_output_peeling_3D(f'{base}{suffix}_peel3D{ext}', res,
                                        k)
            if res.cfg.par.save_peeloff_2D:
                write_output_peeling_2D(f'{base}{suffix}_peel2D{ext}', res,
                                        k)
    return out


def _bin_unit(res: RunResult) -> float:
    return res.meta.dwave if res.cfg.par.intensity_unit == 1 \
        else res.meta.dxfreq


def _bitpix(par):
    return np.float32 if par.out_bitpix == -32 else np.float64


def write_output_peeling_2D(filename: str, res: RunResult, iobs: int) -> str:
    """Frequency-integrated peel images of observer iobs
    (write_output_peeling_2D, write_output_rect.f90:742-1000)."""
    par = res.cfg.par
    pairs = [('Scattered', 'scatt'), ('Direct', 'direc')]
    if 'I' in res.peel:
        pairs += [(f'Stokes_{nm}', nm) for nm in 'IQUV']
    hk = {'nphotons': float(res.nphotons), 'I_unit': par.intensity_unit}
    obs = res.obs_meta
    if obs.inside:
        hk.update(PIXTYPE='HEALPIX', ORDERING='RING', NSIDE=obs.nside,
                  NPIX=obs.npix)
    with open_write(filename, par.file_format) as f:
        for name, key in pairs:
            g = f.create_group(name)
            img = res.peel[key][iobs].sum(axis=0) * _bin_unit(res)
            g.create_dataset('data', data=np.asarray(img, _bitpix(par)))
            _put_attrs(g, dict(hk, EXTNAME=name))
    return filename


def write_output_peeling_3D(filename: str, res: RunResult, iobs: int) -> str:
    """Spectral image cubes of observer iobs (write_output_peeling_3D,
    write_output_rect.f90:1003-1352): Scattered/Direct cubes with spectral
    + TAN WCS keywords, RadialI, and with Stokes the I/Q/U/V cubes and
    Stokes_radial profiles."""
    par = res.cfg.par
    meta = res.meta
    obs = res.obs_meta
    bin_unit = _bin_unit(res)
    bp = _bitpix(par)
    cubes = {'Scattered': res.peel['scatt'][iobs],
             'Direct': res.peel['direc'][iobs]}
    if 'I' in res.peel:
        for nm in 'IQUV':
            cubes[f'Stokes_{nm}'] = res.peel[nm][iobs]
    if 'Ha' in res.peel:
        # ly_beta band-2 H-alpha peel cube (write_output_rect.f90:1180-1185)
        cubes['peel_Ha'] = res.peel['Ha'][iobs]
    if 'direc0' in res.peel:
        # the unattenuated stellar direct cube (write_output_rect.f90:
        # 1170-1173)
        cubes['Direct0'] = res.peel['direc0'][iobs]
    if obs.inside:
        return _write_healpix_3D(filename, res, cubes)
    wcs = {
        'CTYPE1': 'WAVE', 'CUNIT1': 'Angstrom',
        'CRPIX1': 1.0, 'CRVAL1': float(res.wavelength[0]),
        'CD1_1': float(res.wavelength[1] - res.wavelength[0])
        if len(res.wavelength) > 1 else 0.0,
        'CTYPE2': 'RA--TAN', 'CUNIT2': 'deg',
        'CRPIX2': (obs.nxim + 1) / 2.0, 'CRVAL2': 0.0, 'CD2_2': obs.dxim,
        'CTYPE3': 'DEC-TAN', 'CUNIT3': 'deg',
        'CRPIX3': (obs.nyim + 1) / 2.0, 'CRVAL3': 0.0, 'CD3_3': obs.dyim,
        'DISTANCE': obs.distance,
        'Xfreq1': meta.xfreq_min, 'Xfreq2': meta.xfreq_max,
        'Dxfreq': meta.dxfreq, 'Dwave': meta.dwave,
        'I_unit': par.intensity_unit, 'Dfreq': meta.Dfreq_ref,
        'nphotons': float(res.nphotons),
    }
    # observer position -> viewing mu (read_lart's PeelObservation.mu)
    px, py, pz = (float(v) for v in obs.pos_host[iobs])
    wcs.update(OBSX=px, OBSY=py, OBSZ=pz)
    with open_write(filename, par.file_format) as f:
        for name in ('Scattered', 'Direct') + tuple(
                n for n in ('peel_Ha', 'Direct0') if n in cubes):
            g = f.create_group(name)
            g.create_dataset('data', data=np.asarray(cubes[name], bp))
            _put_attrs(g, dict(wcs, EXTNAME=name))
        r, rI = radial_intensity(cubes['Scattered'], cubes['Direct'],
                                 bin_unit)
        g = f.create_group('RadialI')
        g.create_dataset('radius', data=r)
        g.create_dataset('I', data=rI)
        _put_attrs(g, {'EXTNAME': 'RadialI'})
        if 'Stokes_I' in cubes:
            for name in ('I', 'Q', 'U', 'V'):
                g = f.create_group(f'Stokes_{name}')
                g.create_dataset('data',
                                 data=np.asarray(cubes[f'Stokes_{name}'], bp))
                _put_attrs(g, dict(wcs, EXTNAME=f'Stokes_{name}'))
            prof = radial_stokes(*(cubes[f'Stokes_{nm}'] for nm in 'IQUV'),
                                 bin_unit)
            g = f.create_group('Stokes_radial')
            for nm, arr in zip(('radius', 'I', 'Q', 'U', 'V', 'pol'), prof):
                g.create_dataset(nm, data=arr)
            _put_attrs(g, {'EXTNAME': 'Stokes_radial'})
    return filename


def _write_healpix_3D(filename: str, res: RunResult, cubes) -> str:
    """An interior observer's all-sky HEALPix RING maps (nxfreq, npix)
    (write_output_heal.f90's peel sections; lart_tpu/io/writer.py:
    313-340)."""
    par, meta, obs = res.cfg.par, res.meta, res.obs_meta
    hk = {'PIXTYPE': 'HEALPIX', 'ORDERING': 'RING', 'NSIDE': obs.nside,
          'NPIX': obs.npix, 'Xfreq1': meta.xfreq_min,
          'Xfreq2': meta.xfreq_max, 'Dxfreq': meta.dxfreq,
          'I_unit': par.intensity_unit, 'nphotons': float(res.nphotons)}
    with open_write(filename, par.file_format) as f:
        for name in ('Scattered', 'Direct'):
            g = f.create_group(name)
            g.create_dataset('data', data=np.asarray(
                cubes[name].reshape(meta.nxfreq, obs.npix), _bitpix(par)))
            _put_attrs(g, dict(hk, EXTNAME=name))
    return filename


def _write_basic(filename: str, res: RunResult) -> str:
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
        if res.Jabs2 is not None:
            g.create_dataset('Jabs2', data=np.asarray(res.Jabs2, bp))
        _put_attrs(g, {
            'ExeTime': res.exetime_s / 60.0,
            'Nprocs': res.nprocs,
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
        if res.flux_factor:
            _put_attrs(g, {'flux_factor': res.flux_factor,
                           'nrejected': res.nrejected})
        if par.h2_model.strip().lower() not in ('', 'none'):
            pump = res.W_H2pump if res.W_H2pump is not None else (0.0, 0.0)
            _put_attrs(g, {
                'H2MODEL': par.h2_model, 'H2FH2': par.f_H2,
                'H2TEMP': par.h2_temperature, 'H2NLINE': 2,
                'H2ABS': res.W_H2abs, 'H2SCAT': res.W_H2scat,
                'H2PUMP1': float(pump[0]), 'H2PUMP2': float(pump[1])})
        if res.Jout_Ha is not None:
            for name in ('Jout_Ha', 'Jabs_Ha'):
                gh = f.create_group(name)
                gh.create_dataset('data',
                                  data=np.asarray(getattr(res, name), bp))
                _put_attrs(gh, {'EXTNAME': name})
            _put_attrs(g, {k: getattr(res, k) for k in (
                'W_conv', 'W_esc1', 'W_abs1', 'W_esc2', 'W_abs2')})
        if res.J2gam is not None:
            g2 = f.create_group('J2gam')
            g2.create_dataset('y', data=res.y_2gam)
            g2.create_dataset('data', data=np.asarray(res.J2gam, bp))
            _put_attrs(g2, {'EXTNAME': 'J2gam'})
        # the CALCJ/CALCP/CALCPnew maps (write_output_rect.f90; lart_tpu/
        # io/writer.py:253-267): Pa_3D on the flat-cell geometry 3
        for arr, ext in ((res.J1, 'Jx_1D'),
                         (res.Pa, 'Pa_1D' if meta.geometry_JPa != 3
                          else 'Pa_3D'),
                         (res.Pnew, 'Pa_1D_new')):
            if arr is None:
                continue
            gp = f.create_group(ext)
            data = arr.reshape(meta.nx, meta.ny, meta.nz) \
                if ext == 'Pa_3D' else arr
            gp.create_dataset('data', data=np.asarray(data, bp))
            if res.r_JPa is not None and ext != 'Pa_3D':
                gp.create_dataset('radius', data=res.r_JPa)
            _put_attrs(gp, {'EXTNAME': ext, 'geom_JPa': meta.geometry_JPa})
        if res.allph:
            # the all-photons table (write_output_rect.f90:1353-1483)
            ga = f.create_group('AllPhotons')
            for nm, arr in res.allph.items():
                ga.create_dataset(nm, data=np.asarray(arr, np.float32))
            _put_attrs(ga, {'EXTNAME': 'AllPhotons'})
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
    datasets (Xfreq, Jout, ...) in one dict, with under 'allph' the
    AllPhotons section's columns, or None (lart_tpu/io/writer.py:
    446-450)."""
    with open_read(filename) as f:
        g = f['Spectrum']
        out = dict(g.attrs)
        out.update({k: np.asarray(g[k]) for k in g.keys()})
        out['allph'] = None
        if 'AllPhotons' in f.keys():
            a = f['AllPhotons']
            out['allph'] = {k: np.asarray(a[k]) for k in a.keys()}
    return out
