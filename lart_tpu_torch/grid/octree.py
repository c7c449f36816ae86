"""Linear octree of the AMR grid: host build (C++ or NumPy), device tensors.

The port's copy of lart_tpu/grid/octree.py, whose module imports jax.  The
tree is flat arrays with a 6-face neighbor table: the host builds it in the
C++ library of native/octree.cpp (the port's own copy), compiled with the
host compiler into build/octree/ at the root of the checkout at first use
and loaded through ctypes, or, where no compiler is found, with the NumPy
builder, which gives the same arrays.  `build_fine_map` paints every node,
coarse level first, so a voxel belongs to the deepest node that covers it
(a gap resolves to its internal node, as the octant descent does).
`AmrDevice` holds the tree and the per-leaf physics as f32 and int32
tensors on one device, as lart_tpu's to_device lays them out.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent.parent / 'native' / 'octree.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'octree'
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17', '-Wall')
_LIB = None


def _build_native() -> Path:
    """Compile native/octree.cpp unless the library of this source exists."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f'liblart_octree_{h.hexdigest()[:16]}.so'
    if out.exists():
        return out
    cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
    if not cxx:
        raise RuntimeError('no C++ compiler found')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        subprocess.run([cxx, *CXX_FLAGS, '-o', lib, str(SOURCE)], check=True,
                       capture_output=True)
        os.replace(lib, out)    # atomic: a concurrent build sees all or none
    return out


def load_native():
    """The ctypes library of native/octree.cpp, or None where it cannot be
    built (the NumPy builder then builds the tree)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(str(_build_native()))
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return None
    f64 = np.ctypeslib.ndpointer(np.float64)
    i32 = np.ctypeslib.ndpointer(np.int32)
    lib.lart_octree_build.restype = ctypes.c_int64
    lib.lart_octree_build.argtypes = [ctypes.c_int32, f64, f64, f64, i32, f64]
    lib.lart_octree_ncells.restype = ctypes.c_int32
    lib.lart_octree_ncells.argtypes = [ctypes.c_int64]
    lib.lart_octree_levelmax.restype = ctypes.c_int32
    lib.lart_octree_levelmax.argtypes = [ctypes.c_int64]
    lib.lart_octree_fill.argtypes = [ctypes.c_int64, i32, i32, i32, f64, f64,
                                     f64, f64, i32, i32, i32]
    lib.lart_octree_free.argtypes = [ctypes.c_int64]
    _LIB = lib
    return lib


@dataclasses.dataclass
class HostOctree:
    """Host-side flat octree (0-based indices; -1 = none)."""
    ncells: int
    nleaf: int
    levelmax: int
    box: tuple                      # (xmin, xmax, ymin, ymax, zmin, zmax)
    parent: np.ndarray              # (ncells,) int32
    children: np.ndarray            # (ncells, 8) int32
    level: np.ndarray               # (ncells,)
    cx: np.ndarray
    cy: np.ndarray
    cz: np.ndarray
    ch: np.ndarray
    ileaf: np.ndarray               # (ncells,) leaf id or -1
    icell_of_leaf: np.ndarray       # (nleaf,)
    neighbor: np.ndarray            # (ncells, 6)
    builder: str = 'native'         # 'native' (C++) or 'numpy'


def build_octree(xl, yl, zl, lev, box) -> HostOctree:
    """Build the linear octree + neighbor table from a flat leaf list."""
    xl = np.ascontiguousarray(xl, np.float64)
    yl = np.ascontiguousarray(yl, np.float64)
    zl = np.ascontiguousarray(zl, np.float64)
    lev = np.ascontiguousarray(lev, np.int32)
    boxa = np.ascontiguousarray(box, np.float64)
    n = len(xl)
    lib = load_native()
    if lib is None:
        return _build_octree_numpy(xl, yl, zl, lev, boxa)
    h = lib.lart_octree_build(n, xl, yl, zl, lev, boxa)
    ncells = int(lib.lart_octree_ncells(h))
    levelmax = int(lib.lart_octree_levelmax(h))
    parent = np.empty(ncells, np.int32)
    children = np.empty((ncells, 8), np.int32)
    level = np.empty(ncells, np.int32)
    cx, cy, cz, ch = (np.empty(ncells) for _ in range(4))
    ileaf = np.empty(ncells, np.int32)
    icell_of_leaf = np.empty(n, np.int32)
    neighbor = np.empty((ncells, 6), np.int32)
    lib.lart_octree_fill(h, parent, children, level, cx, cy, cz, ch, ileaf,
                         icell_of_leaf, neighbor)
    lib.lart_octree_free(h)
    # from 1-based (the C++ keeps the Fortran convention) to 0-based
    return HostOctree(
        ncells=ncells, nleaf=n, levelmax=levelmax, box=tuple(boxa),
        parent=parent - 1, children=children - 1, level=level,
        cx=cx, cy=cy, cz=cz, ch=ch, ileaf=ileaf - 1,
        icell_of_leaf=icell_of_leaf - 1, neighbor=neighbor - 1)


def _build_octree_numpy(xl, yl, zl, lev, box) -> HostOctree:
    """Pure-Python builder (slow; used when no C++ compiler is found)."""
    xmin, xmax, ymin, ymax, zmin, zmax = box
    n = len(xl)
    parent = [-1]
    children = [[-1] * 8]
    level = [0]
    cx = [0.5 * (xmin + xmax)]
    cy = [0.5 * (ymin + ymax)]
    cz = [0.5 * (zmin + zmax)]
    ch = [0.5 * (xmax - xmin)]
    ileaf = [-1]
    icell_of_leaf = np.full(n, -1, np.int32)
    levelmax = 0
    for i in range(n):
        t = int(lev[i])
        levelmax = max(levelmax, t)
        ic = 0
        while level[ic] < t:
            io = (1 if xl[i] >= cx[ic] else 0) \
                + (2 if yl[i] >= cy[ic] else 0) \
                + (4 if zl[i] >= cz[ic] else 0)
            child = children[ic][io]
            if child < 0:
                h = ch[ic] * 0.5
                child = len(parent)
                parent.append(ic)
                children.append([-1] * 8)
                level.append(level[ic] + 1)
                cx.append(cx[ic] + (h if io & 1 else -h))
                cy.append(cy[ic] + (h if io & 2 else -h))
                cz.append(cz[ic] + (h if io & 4 else -h))
                ch.append(h)
                ileaf.append(-1)
                children[ic][io] = child
            ic = child
        ileaf[ic] = i
        icell_of_leaf[i] = ic
    ncells = len(parent)
    cxa, cya, cza, cha = map(np.asarray, (cx, cy, cz, ch))
    leva = np.asarray(level, np.int32)
    childa = np.asarray(children, np.int32)
    ileafa = np.asarray(ileaf, np.int32)
    parenta = np.asarray(parent, np.int32)

    def find_at_level(x, y, z, t):
        if not (xmin <= x <= xmax and ymin <= y <= ymax and zmin <= z <= zmax):
            return -1
        ic = 0
        while True:
            if leva[ic] >= t or ileafa[ic] >= 0:
                return ic
            io = (1 if x >= cxa[ic] else 0) + (2 if y >= cya[ic] else 0) \
                + (4 if z >= cza[ic] else 0)
            c = childa[ic, io]
            if c < 0:
                return ic
            ic = c

    def is_anc(anc, desc):
        c = desc
        while c >= 0:
            c = parenta[c]
            if c == anc:
                return True
        return False

    neighbor = np.full((ncells, 6), -1, np.int32)
    for ic in range(ncells):
        hp = 2.0 * cha[ic]
        q = [(cxa[ic] + hp, cya[ic], cza[ic]), (cxa[ic] - hp, cya[ic], cza[ic]),
             (cxa[ic], cya[ic] + hp, cza[ic]), (cxa[ic], cya[ic] - hp, cza[ic]),
             (cxa[ic], cya[ic], cza[ic] + hp), (cxa[ic], cya[ic], cza[ic] - hp)]
        for f, (qx, qy, qz) in enumerate(q):
            nb = find_at_level(qx, qy, qz, leva[ic])
            if nb >= 0 and nb != ic and is_anc(nb, ic):
                nb = -1
            neighbor[ic, f] = nb
    return HostOctree(ncells=ncells, nleaf=n, levelmax=levelmax,
                      box=tuple(box), parent=parenta, children=childa,
                      level=leva, cx=cxa, cy=cya, cz=cza, ch=cha,
                      ileaf=ileafa, icell_of_leaf=icell_of_leaf,
                      neighbor=neighbor, builder='numpy')


def build_fine_map(tree: HostOctree, limit: int = 34_000_000):
    """fine_map[i, j, k] = the deepest node covering fine voxel (i, j, k) of
    the uniform grid at the octree's deepest level, or None where
    (2^levelmax)^3 exceeds `limit` voxels (the walk then descends octant by
    octant).  With it, the cell a point enters is one gather."""
    nf = 1 << tree.levelmax
    if nf ** 3 > limit:
        return None
    xmin, _, ymin, _, zmin, _ = tree.box
    dxf = 2.0 * tree.ch[0] / nf
    fm = np.full((nf, nf, nf), -1, np.int32)
    # every node paints its extent, coarse level first: each voxel ends up
    # owned by the deepest node covering it, a gap by its internal node
    order = np.argsort(tree.level, kind='stable')
    lev_sorted = tree.level[order]
    for L in np.unique(lev_sorted):
        ids = order[lev_sorted == L]
        w = 1 << (tree.levelmax - int(L))
        i0, j0, k0 = (np.rint((c[ids] - tree.ch[ids] - lo) / dxf)
                      .astype(np.int64)
                      for c, lo in ((tree.cx, xmin), (tree.cy, ymin),
                                    (tree.cz, zmin)))
        if w == 1:
            fm[i0, j0, k0] = ids
        else:
            for m, idx in enumerate(ids):
                fm[i0[m]:i0[m] + w, j0[m]:j0[m] + w, k0[m]:k0[m] + w] = idx
    assert (fm >= 0).all()
    return fm


@dataclasses.dataclass(eq=False)
class AmrDevice:
    """The AMR grid on one device: the tree's topology by node, the leaves'
    geometry and physics by leaf id; optional entries are None where a fast
    path applies (uniform T: no Dfreq/voigt_a; static medium: no
    velocities; no dust: no rhokapD; no fine map: the octant descent)."""
    children: torch.Tensor      # (ncells, 8) int32, -1 = none
    node_cx: torch.Tensor       # (ncells,) f32
    node_cy: torch.Tensor
    node_cz: torch.Tensor
    node_ch: torch.Tensor       # (ncells,) f32 half-width
    ileaf: torch.Tensor         # (ncells,) int32 leaf id or -1
    neighbor: torch.Tensor      # (ncells, 6) int32
    leaf_cx: torch.Tensor       # (nleaf,) f32
    leaf_cy: torch.Tensor
    leaf_cz: torch.Tensor
    leaf_ch: torch.Tensor
    leaf_cell: torch.Tensor     # (nleaf,) int32 cell index of each leaf
    rhokap: torch.Tensor        # (nleaf,) f32
    rhokapD: Optional[torch.Tensor]
    Dfreq: Optional[torch.Tensor]
    voigt_a: Optional[torch.Tensor]
    vfx: Optional[torch.Tensor]
    vfy: Optional[torch.Tensor]
    vfz: Optional[torch.Tensor]
    fine_map: Optional[torch.Tensor] = None   # (nf, nf, nf) int32

    @property
    def ncells(self) -> int:
        return self.ileaf.numel()

    @property
    def nf(self) -> int:
        """The fine map's width, 0 without one."""
        return 0 if self.fine_map is None else self.fine_map.shape[0]

    def tensors(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if getattr(self, f.name) is not None)


def to_device(tree: HostOctree, rhokap, rhokapD=None, Dfreq=None,
              voigt_a=None, vfx=None, vfy=None, vfz=None,
              fine_limit: int = 34_000_000, device='cpu') -> AmrDevice:
    def f32(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)
    lc = tree.icell_of_leaf
    fm = build_fine_map(tree, fine_limit) if fine_limit > 0 else None
    return AmrDevice(
        children=i32(tree.children),
        node_cx=f32(tree.cx), node_cy=f32(tree.cy), node_cz=f32(tree.cz),
        node_ch=f32(tree.ch),
        ileaf=i32(tree.ileaf), neighbor=i32(tree.neighbor),
        leaf_cx=f32(tree.cx[lc]), leaf_cy=f32(tree.cy[lc]),
        leaf_cz=f32(tree.cz[lc]), leaf_ch=f32(tree.ch[lc]),
        leaf_cell=i32(lc),
        rhokap=f32(rhokap), rhokapD=f32(rhokapD), Dfreq=f32(Dfreq),
        voigt_a=f32(voigt_a), vfx=f32(vfx), vfy=f32(vfy), vfz=f32(vfz),
        fine_map=None if fm is None else i32(fm))
