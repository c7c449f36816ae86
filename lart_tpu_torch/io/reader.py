"""The 3-D grid files: density, temperature and emissivity cubes and the
3-component velocity cube, from HDF5 or FITS.

Port of read_3d_any / read_velocity_any (lart_tpu/io/reader.py:48-95;
read_3D and read_velocity, reference src/read_grid_data.f90:21-244).
lart_tpu reads FITS through astropy; the port reads it with its own
io/minifits.py (gzip-compressed files too), and HDF5 through
io/iofile.py, the only module that imports h5py.  A file is HDF5 by its
extension (.h5, .hdf5), else FITS (primary HDU).  Both keep the
reference's layout: a cube stored (nz, ny, nx) comes back (nx, ny, nz), a
velocity cube stored (nz, ny, nx, 3) or (3, nz, ny, nx) comes back
(nx, ny, nz, 3), all in f64.
"""

from __future__ import annotations

import numpy as np

from . import minifits
from .iofile import read_hdf5_array


def _is_hdf5(path: str) -> bool:
    return path.rsplit('.', 1)[-1].lower() in ('h5', 'hdf5')


def _fits_primary(path: str) -> np.ndarray:
    hdus = minifits.read_hdus(path)
    if not hdus or hdus[0].data is None:
        raise ValueError(f'{path}: no image in the primary HDU')
    return np.asarray(hdus[0].data, np.float64)


def read_3d_any(path: str) -> np.ndarray:
    """A 3-D array from HDF5 (the first dataset) or FITS (the primary HDU),
    transposed from its (z, y, x) storage to (x, y, z)."""
    arr = read_hdf5_array(path) if _is_hdf5(path) else _fits_primary(path)
    return np.ascontiguousarray(arr.T)


def read_velocity_any(path: str) -> np.ndarray:
    """A 3-component velocity cube [km/s] as (nx, ny, nz, 3): stored
    (nz, ny, nx, 3), or (3, nz, ny, nx)."""
    arr = read_hdf5_array(path, 4) if _is_hdf5(path) \
        else _fits_primary(path)
    if arr.ndim != 4:
        raise ValueError(f'{path}: expected 4-D velocity, got {arr.shape}')
    if arr.shape[-1] == 3:
        return np.ascontiguousarray(np.transpose(arr, (2, 1, 0, 3)))
    if arr.shape[0] == 3:
        return np.ascontiguousarray(np.transpose(arr, (3, 2, 1, 0)))
    raise ValueError(f'{path}: no length-3 component axis in {arr.shape}')
