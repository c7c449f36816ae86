"""Format-agnostic section I/O: the analogue of the reference's io_* layer.

The reference abstracts its output format behind `io_open/io_create_section/
io_write_*` with CFITSIO and HDF5 backends selected by `par%file_format`
(reference: src/iofile_mod.f90:81-143, src/fitsio_mod.f90:61-1307,
src/hdf5io_mod.f90:77-1784).  This module provides the same contract for the
TPU framework:

  * a file is an ordered list of named *sections*;
  * each section holds named datasets plus scalar/string attributes
    (= header keywords);
  * HDF5 backend: section -> group (tracked in insertion order), dataset ->
    group dataset, attributes -> group attrs;
  * FITS backend: section -> HDU in order after an empty primary.  A section
    whose datasets are all 1-D with equal length becomes a BinTableHDU (one
    column per dataset, like the Fortran table sections); otherwise each
    dataset becomes an ImageHDU — the dataset named 'data' carries
    EXTNAME=<section>, auxiliary datasets carry EXTNAME='<section>.<name>'.
    Attributes become header keywords on the section's first HDU.

`open_write`/`open_read` choose the backend from an explicit format string
('hdf5'/'fits') or from the file extension ('auto').  Unknown format values
raise (the reference errors likewise rather than silently substituting).

The port's own copy of lart_tpu/io/iofile.py, which has no jax in it:
lart_tpu_torch imports nothing of lart_tpu.  Keep the two in step.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

_HDF5_EXT = ('.h5', '.hdf5', '.hdf')
_FITS_EXT = ('.fits', '.fits.gz', '.fit', '.fits.fz')

# structural FITS keywords that are not user attributes
_FITS_STRUCTURAL = {
    'SIMPLE', 'XTENSION', 'BITPIX', 'PCOUNT', 'GCOUNT', 'TFIELDS',
    'EXTEND', 'COMMENT', 'HISTORY', 'LARTSECT', 'EXTNAME', 'EXTVER',
}


def detect_format(path: str, file_format: str = 'auto') -> str:
    fmt = (file_format or 'auto').strip().lower()
    if fmt in ('hdf5', 'h5', 'hdf'):
        return 'hdf5'
    if fmt in ('fits', 'fits.gz'):
        return 'fits'
    if fmt == 'auto':
        low = path.lower()
        if any(low.endswith(e) for e in _FITS_EXT):
            return 'fits'
        if any(low.endswith(e) for e in _HDF5_EXT):
            return 'hdf5'
        return 'hdf5'
    raise ValueError(f"unknown file_format {file_format!r} "
                     "(expected 'hdf5', 'fits' or 'auto')")


def default_extension(file_format: str) -> str:
    fmt = (file_format or '').strip().lower()
    if fmt == 'fits':
        return '.fits'
    if fmt == 'fits.gz':
        return '.fits.gz'
    return '.h5'


# --------------------------------------------------------------------------
# write side
# --------------------------------------------------------------------------

class _Attrs(dict):
    """dict with h5py-style item assignment semantics."""


class Section:
    def __init__(self, name: str):
        self.name = name
        self.datasets: Dict[str, np.ndarray] = {}
        self._order: List[str] = []
        self.attrs = _Attrs()

    def create_dataset(self, name: str, data=None) -> None:
        self.datasets[name] = np.asarray(data)
        self._order.append(name)


class IoWriter:
    """Collects sections on the host, serializes on close."""

    def __init__(self, path: str, file_format: str = 'auto'):
        self.path = path
        self.fmt = detect_format(path, file_format)
        self._sections: List[Section] = []

    # h5py-compatible surface used by the writer module
    def create_group(self, name: str) -> Section:
        s = Section(name)
        self._sections.append(s)
        return s

    def close(self) -> None:
        if self.fmt == 'fits':
            self._write_fits()
        else:
            self._write_hdf5()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        return False

    # --- backends
    def _write_hdf5(self) -> None:
        import h5py
        with h5py.File(self.path, 'w') as f:
            f.attrs['section_order'] = [s.name for s in self._sections]
            for s in self._sections:
                g = f.create_group(s.name)
                for nm in s._order:
                    g.create_dataset(nm, data=s.datasets[nm])
                for k, v in s.attrs.items():
                    g.attrs[k] = v

    def _write_fits(self) -> None:
        from . import minifits
        hdus = [minifits.HDU({'LARTFMT': 'sections'})]
        for s in self._sections:
            hdus.extend(_section_to_hdus(s))
        minifits.write_hdus(self.path, hdus)


def _is_table(sec: Section) -> bool:
    arrs = list(sec.datasets.values())
    if not arrs:
        return False
    if any(a.ndim != 1 for a in arrs):
        return False
    n = arrs[0].shape[0]
    return all(a.shape[0] == n for a in arrs)


def _put_fits_attrs(header, attrs, section: str) -> None:
    header['LARTSECT'] = section
    for k, v in attrs.items():
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        elif isinstance(v, np.ndarray):
            if v.size == 1:
                v = v.item()
            else:
                continue   # array attributes are not representable in FITS
        header[k] = v   # long keys get the HIERARCH convention in minifits


def _section_to_hdus(sec: Section):
    from .minifits import HDU
    if _is_table(sec):
        hdr = {}
        _put_fits_attrs(hdr, sec.attrs, sec.name)
        return [HDU(hdr, {nm: sec.datasets[nm] for nm in sec._order},
                    name=sec.name)]
    hdus = []
    order = sec._order
    # the 'data' dataset leads and carries the section attributes
    if 'data' in order:
        order = ['data'] + [n for n in order if n != 'data']
    for i, nm in enumerate(order):
        ext = sec.name if nm == 'data' else f'{sec.name}.{nm}'
        hdr = {}
        if i == 0:
            _put_fits_attrs(hdr, sec.attrs, sec.name)
        else:
            hdr['LARTSECT'] = sec.name
        hdus.append(HDU(hdr, sec.datasets[nm], name=ext))
    return hdus


def open_write(path: str, file_format: str = 'auto') -> IoWriter:
    return IoWriter(path, file_format)


# --------------------------------------------------------------------------
# read side
# --------------------------------------------------------------------------

class ReadSection:
    def __init__(self, name: str):
        self.name = name
        self.datasets: Dict[str, np.ndarray] = {}
        self.attrs: Dict = {}

    def __contains__(self, k):
        return k in self.datasets

    def __getitem__(self, k):
        return self.datasets[k]

    def keys(self):
        return self.datasets.keys()


class IoReader:
    def __init__(self, path: str, file_format: str = 'auto'):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.fmt = detect_format(path, file_format)
        self._sections: Dict[str, ReadSection] = {}
        self._order: List[str] = []
        if self.fmt == 'fits':
            self._read_fits()
        else:
            self._read_hdf5()

    # mapping surface ('Section/dataset' paths supported, h5py-style)
    def __contains__(self, name):
        sec, _, ds = name.partition('/')
        if sec not in self._sections:
            return False
        return True if not ds else ds in self._sections[sec]

    def __getitem__(self, name):
        sec, _, ds = name.partition('/')
        s = self._sections[sec]
        return s[ds] if ds else s

    def keys(self):
        return list(self._order)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _read_hdf5(self) -> None:
        import h5py
        with h5py.File(self.path, 'r') as f:
            order = f.attrs.get('section_order')
            names = [n.decode() if isinstance(n, bytes) else str(n)
                     for n in order] if order is not None else list(f.keys())
            for name in names:
                if name not in f:
                    continue
                g = f[name]
                s = ReadSection(name)
                for k in g:
                    if isinstance(g[k], h5py.Dataset):
                        s.datasets[k] = np.asarray(g[k])
                s.attrs = {k: (v.item() if hasattr(v, 'item') and
                               getattr(v, 'size', 1) == 1 else v)
                           for k, v in g.attrs.items()}
                self._sections[name] = s
                self._order.append(name)

    def _read_fits(self) -> None:
        from .minifits import read_hdus
        for hdu in read_hdus(self.path)[1:]:
            ext = str(hdu.header.get('EXTNAME', '') or '').strip()
            sect = str(hdu.header.get('LARTSECT', '') or '').strip()
            if not sect:
                sect, _, _ = ext.partition('.')
            if sect not in self._sections:
                self._sections[sect] = ReadSection(sect)
                self._order.append(sect)
            s = self._sections[sect]
            if hdu.is_image:
                if hdu.data is None:
                    continue
                ds = 'data' if ('.' not in ext or ext == sect) \
                    else ext.split('.', 1)[1]
                s.datasets[ds] = np.asarray(hdu.data)
            else:
                for nm, col in hdu.data.items():
                    s.datasets[nm] = col
            if not s.attrs:
                s.attrs = {
                    k.strip(): v for k, v in hdu.header.items()
                    if k.strip().upper() not in _FITS_STRUCTURAL
                    and not k.upper().startswith(('TTYPE', 'TFORM', 'TUNIT',
                                                  'TDIM', 'NAXIS'))}


def open_read(path: str, file_format: str = 'auto') -> IoReader:
    return IoReader(path, file_format)


def read_hdf5_columns(path: str, names, key: str):
    """The datasets `names` of an HDF5 file that holds them at its root or
    in its first group holding `key` (the generic-AMR leaf list,
    lart_tpu/grid/amr.py:25-52), and the attributes of that group updated
    by the file's own: (columns dict, attributes dict)."""
    import h5py
    with h5py.File(path, 'r') as f:
        src = f
        if key not in f:
            for k in f.keys():
                if key in f[k]:
                    src = f[k]
                    break
        cols = {n: np.asarray(src[n]) for n in names if n in src}
        return cols, dict(src.attrs) | dict(f.attrs)


def write_hdf5_array(path: str, arr: np.ndarray, name: str = 'data'
                     ) -> None:
    """An HDF5 file holding one dataset at its root."""
    import h5py
    with h5py.File(path, 'w') as f:
        f.create_dataset(name, data=arr)


def read_hdf5_array(path: str, ndim=None) -> np.ndarray:
    """An array of an HDF5 file as f64 (lart_tpu/io/reader.py:51-67,
    :77-85): with ndim None the first dataset found depth-first, else the
    first dataset of ndim dimensions at the root."""
    import h5py
    with h5py.File(path, 'r') as f:
        if ndim is not None:
            for k in f:
                if isinstance(f[k], h5py.Dataset) and f[k].ndim == ndim:
                    return np.asarray(f[k], np.float64)
            raise ValueError(f'no {ndim}-D dataset in {path}')

        def first_dataset(g):
            for k in g:
                if isinstance(g[k], h5py.Dataset):
                    return np.asarray(g[k], np.float64)
                got = first_dataset(g[k])
                if got is not None:
                    return got
            return None
        arr = first_dataset(f)
        if arr is None:
            raise ValueError(f'no dataset found in {path}')
        return arr


# --------------------------------------------------------------------------
# converter (the analogue of python/lart_io.py's CLI)
# --------------------------------------------------------------------------

def convert(src: str, dst: str, src_format: str = 'auto',
            dst_format: str = 'auto') -> str:
    """Convert a section file between HDF5 and FITS, preserving section
    order, datasets and attributes (reference: python/lart_io.py:122-506)."""
    r = open_read(src, src_format)
    with open_write(dst, dst_format) as w:
        for name in r.keys():
            rs = r[name]
            s = w.create_group(name)
            for k in rs.keys():
                s.create_dataset(k, rs.datasets[k])
            for k, v in rs.attrs.items():
                if k == 'LARTSECT':
                    continue
                s.attrs[k] = v
    return dst


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description='Convert LaRT output files between HDF5 and FITS')
    p.add_argument('src')
    p.add_argument('dst')
    p.add_argument('--src-format', default='auto')
    p.add_argument('--dst-format', default='auto')
    a = p.parse_args(argv)
    out = convert(a.src, a.dst, a.src_format, a.dst_format)
    print(f'wrote {out}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
