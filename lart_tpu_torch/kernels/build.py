"""Build the CUDA kernels of csrc/ with nvcc and bind them with ctypes.

The sources are compiled on first use into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas -v
         -o build/cuda_kernels/liblart_tpu_torch_<hash>.so ...

It lands in build/cuda_kernels/ at the root of the checkout, named by a
hash of the sources and flags, so an edit rebuilds.  No --use_fast_math:
tanf near the pole and atan2f must stay accurate for the far-wing sampler.
--fmad=false keeps a kernel's arithmetic identical to its plain PyTorch
version, which rounds every operation separately.

Every C entry point returns cudaGetLastError() after its launch; `check`
raises if it is not 0.  LAUNCHES counts the launches of each kernel in this
process: a wrapper adds one where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'cuda_kernels'
SOURCES = ('voigt.cu', 'refill.cu', 'fly_slab.cu', 'scatter_lya.cu')
HEADERS = ('lart.cuh', 'philox.cuh', 'voigt.cuh', 'samplers.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '--fmad=false',
              '-Xptxas', '-v')

LAUNCHES = {'voigt_h': 0, 'refill_point': 0, 'fly_uniform_slab': 0,
            'scatter_lya': 0}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_LANES = ctypes.POINTER(ctypes.c_void_p)    # the lane-field pointer table
_ARGTYPES = {
    'lart_voigt_h': [_P, _P, _P, _I, _P],
    'lart_refill_point': [_LANES, _I, _P, _I, _U, _U, _F, _F, _F, _I, _I, _I, _F,
                          _I, _F, _F, _F, _I, _P, _P],
    'lart_fly_uniform_slab': [_LANES, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _F,
                              _F, _F, _F, _I, _I, _I, _F, _F, _I, _P, _P, _P,
                              _P],
    'lart_scatter_lya': [_LANES, _I, _U, _U, _I, _F, _F, _P, _P, _P],
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


def build() -> Path:
    """Compile csrc/ into the shared library unless it already exists."""
    out = BUILD_DIR / f'liblart_tpu_torch_{_digest()}.so'
    if out.exists():
        BUILD_INFO.setdefault('path', str(out))
        BUILD_INFO.setdefault('seconds', 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp,
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)    # atomic: a concurrent build never sees half a file
    BUILD_INFO.update(path=str(out), seconds=time.time() - t0,
                      ptxas=proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
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
