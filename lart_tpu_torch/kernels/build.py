"""Build the CUDA kernels of csrc/ with nvcc and bind them with ctypes.

The sources are compiled on first use into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds): one nvcc per
source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC --fmad=false -Xptxas -v -c -o <source>.o <source>

then one nvcc -shared links the objects into
build/cuda_kernels/liblart_tpu_torch_<hash>.so at the root of the
checkout, named by a hash of the sources and flags, so an edit rebuilds.  No --use_fast_math:
tanf near the pole and atan2f must stay accurate for the far-wing sampler.
--fmad=false keeps a kernel's arithmetic identical to its plain PyTorch
version, which rounds every operation separately.

Every C entry point returns cudaGetLastError() after its launch; `check`
raises if it is not 0.  LAUNCHES counts the launches of each kernel in this
process: a wrapper adds one where it launches its kernel, and nowhere else
(K7 in mode PEEL_STELLAR under 'peel_stellar', its other modes under
'peel': two launches a call where it runs its first pass, which
instruments/peel.py LaneList decides, one otherwise), and 'all_reduce'
the per-chunk tally all-reduces across ranks (parallel/reduce.py, NCCL or
gloo).  A run of several ranks counts in each
rank's process; parallel/launch.py adds the ranks' counts into the
caller's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'cuda_kernels'
SOURCES = ('voigt.cu', 'refill.cu', 'fly_slab.cu', 'scatter_lya.cu',
           'fly_cartesian.cu', 'fly_sphere.cu', 'peel.cu', 'fly_amr.cu',
           'fly_clump.cu', 'sightline.cu')
HEADERS = ('lart.cuh', 'philox.cuh', 'voigt.cuh', 'samplers.cuh', 'walk.cuh',
           'mueller.cuh', 'line.cuh', 'h2.cuh', 'amr.cuh', 'clump.cuh',
           'healpix.cuh', 'allph.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '--fmad=false', '-Xptxas', '-v')

LAUNCHES = {'voigt_h': 0, 'refill_point': 0, 'refill_radial': 0,
            'refill_volume': 0, 'refill_alias': 0, 'refill_illum': 0,
            'fly_uniform_slab': 0,
            'fly_cartesian': 0, 'fly_uniform_sphere': 0, 'scatter_lya': 0,
            'peel': 0, 'peel_stellar': 0, 'fly_amr': 0, 'fly_clump_dense': 0,
            'fly_clump_csr': 0, 'sightline': 0, 'all_reduce': 0}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_LANES = ctypes.POINTER(ctypes.c_void_p)    # the lane-field pointer table
_ARGTYPES = {
    'lart_voigt_h': [_P, _P, _P, _I, _P],
    'lart_flight_params_size': [],
    'lart_line_params_size': [],
    'lart_peel_params_size': [],
    'lart_scatter_params_size': [],
    'lart_amr_grid_size': [],
    'lart_clump_grid_size': [],
    'lart_sightline_params_size': [],
    'lart_source_params_size': [],
}

_lib = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    cands = [shutil.which('nvcc')]
    for env in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], 'bin', 'nvcc'))
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails.  Returns their stderr and each one's wall seconds, in
    order."""
    t0 = time.time()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs, secs = [None] * len(procs), [0.0] * len(procs)

    def wait(i):
        outs[i] = procs[i].communicate()
        secs[i] = time.time() - t0
    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed ({p.returncode}):\n'
                               f'{" ".join(c)}\n{so}{se}')
    return [se for _, se in outs], secs


def build() -> Path:
    """Compile csrc/ into the shared library unless it already exists."""
    out = BUILD_DIR / f'liblart_tpu_torch_{_digest()}.so'
    if out.exists():
        BUILD_INFO.setdefault('path', str(out))
        BUILD_INFO.setdefault('seconds', 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, s + '.o') for s in SOURCES]
        ptxas, secs = _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', o,
                                 str(CSRC / s)]
                                for s, o in zip(SOURCES, objs)])
        lib = os.path.join(tmpdir, out.name)
        _run_all([[nvcc, '-shared', '-o', lib, *objs]])
        # atomic: a concurrent build never sees half a file
        os.replace(lib, out)
    BUILD_INFO.update(path=str(out), seconds=time.time() - t0,
                      ptxas=''.join(ptxas),
                      source_seconds=dict(zip(SOURCES, secs)))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        # the modules of the kernels import this one: their structs come
        # in here
        from ..instruments.peel import PeelParams
        from ..instruments.sightline import SightParams
        from ..physics.line import LineC
        from ..transport.flight import AllPhC, AmrC, ClumpC, FlightParams
        from ..transport.refill import ProfC, SourceC
        from ..transport.scatter import ScatterC
        lib = ctypes.CDLL(str(build()))
        flight = ctypes.POINTER(FlightParams)    # K5-K8 grid, by pointer
        line = ctypes.POINTER(LineC)
        argtypes_of = dict(
            _ARGTYPES,
            lart_refill_point=[_LANES, _LANES, _I, _P, _I, _U, _U, _F, _F, _F,
                               _I, _I, _I, _F, _I, _F, _F, _F, _F, _F, _I, _F,
                               _F, _I, _P, _F, _F, _F, line,
                               ctypes.POINTER(AmrC), ctypes.POINTER(ClumpC),
                               _P, _P, _P, _P, _P, ctypes.POINTER(SourceC),
                               ctypes.POINTER(ProfC), _P, _P,
                               ctypes.POINTER(AllPhC), _I, _P],
            lart_fly_uniform_slab=[_LANES, _I, _I, _F, _F, _F, _F, _F, _F, _F,
                                   _I, _F, _F, _F, _F, _I, _I, _I, _F, _F, _I,
                                   _P, _P, _P, _F, line, _P],
            lart_fly_cartesian=[_LANES, _I, _I, flight, _I, _I, _P],
            lart_fly_uniform_sphere=[_LANES, _I, _I, flight, _P],
            lart_fly_amr=[_LANES, _I, _I, flight, _P],
            lart_fly_clump_dense=[_LANES, _I, _I, flight, _P],
            lart_fly_clump_csr=[_LANES, _I, _I, flight, _P],
            lart_peel=[_LANES, _LANES, _I, _I, flight,
                       ctypes.POINTER(PeelParams), _I, _P, _I, _I, _P],
            lart_scatter_lya=[_LANES, _LANES, _I, _U, _U,
                              ctypes.POINTER(ScatterC), _I, _P],
            lart_sightline=[flight, ctypes.POINTER(SightParams), _P])
        for name, argtypes in argtypes_of.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for fn, struct, where in (
                (lib.lart_line_params_size, LineC,
                 'csrc/line.cuh and physics/line.py'),
                (lib.lart_amr_grid_size, AmrC,
                 'csrc/amr.cuh and transport/flight.py'),
                (lib.lart_clump_grid_size, ClumpC,
                 'csrc/clump.cuh and transport/flight.py'),
                (lib.lart_flight_params_size, FlightParams,
                 'csrc/lart.cuh and transport/flight.py'),
                (lib.lart_peel_params_size, PeelParams,
                 'csrc/peel.cu and instruments/peel.py'),
                (lib.lart_scatter_params_size, ScatterC,
                 'csrc/scatter_lya.cu and transport/scatter.py'),
                (lib.lart_sightline_params_size, SightParams,
                 'csrc/sightline.cu and instruments/sightline.py'),
                (lib.lart_source_params_size, SourceC,
                 'csrc/refill.cu and transport/refill.py')):
            if fn() != ctypes.sizeof(struct):
                raise RuntimeError(f'{struct.__name__}: {where} disagree '
                                   f'on its layout')
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'cudaError {err}')


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel takes contiguous CUDA tensors only."""
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'{name}: tensor on {t.device}, kernel needs CUDA')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensor is not contiguous')
