"""The lidar branch's host ops (port of ``ddp_tpu/native/__init__.py``):
hard voxelization and the sparse-convolution rulebooks, in C++
(``sparse_ops.cpp``, a copy of the JAX package's), bound with ctypes.

The library is built at first use with ``g++ -O3 -shared -fPIC -std=c++17``
into ``ddp_tpu_torch/_build/`` under a name keyed by a hash of the source and
flags, and loaded once per process; importing this module builds nothing. A
failed build raises with the compiler's output: nothing falls back to the
numpy versions.

The numpy versions (``*_plain``) compute the same arrays, bit for bit, in
Python loops: they are the plain twins the tests hold the C++ to, and no path
of the package calls them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "sparse_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I32P, _F32P = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
# every exported entry: (restype, argtypes)
_ENTRIES = {
    # points, n_points, n_feat, range, voxel_sz, max_points, max_voxels,
    # voxels, coords, num_per_voxel -> n_voxels
    "hard_voxelize": (_I32, [_F32P, _I64, _I32, _F32P, _F32P, _I32, _I32, _F32P, _I32P,
                             _I32P]),
    # coords, n_voxels, cap, kernel, gather
    "build_subm_rulebook": (None, [_I32P, _I32, _I32, _I32, _I32P]),
    # coords, n_voxels, in_shape, kernel, stride, pad, cap, out_coords, gather -> n_out
    "build_sparse_rulebook": (_I32, [_I32P, _I32, _I32P, _I32, _I32, _I32, _I32, _I32P,
                                     _I32P]),
    # coords, n_voxels, in_shape, kernel[3], stride[3], pad[3], cap, out_coords,
    # gather -> n_out
    "build_sparse_rulebook_aniso": (_I32, [_I32P, _I32, _I32P, _I32P, _I32P, _I32P, _I32,
                                           _I32P, _I32P]),
}


def library_path() -> str:
    """Where the library of the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsparse_ops_{h.hexdigest()[:16]}.so")


def _compile(out_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = ["g++", *CXX_FLAGS, "-o", lib, SOURCE]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: the lidar host ops are built at first use "
                               f"({' '.join(cmd)})") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, out_path)  # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the host ops' library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            for name, (restype, argtypes) in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _p(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _triple(v) -> np.ndarray:
    return np.asarray([v] * 3 if np.isscalar(v) else v, np.int32)


# --------------------------------------------------------------------------------------
def hard_voxelize(points: np.ndarray, pc_range, voxel_size, max_points: int,
                  max_voxels: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Points [P, F] (x, y, z first) -> (voxels [max_voxels, max_points, F]
    zero-padded, coords [max_voxels, 3] int32 (x, y, z cells), counts
    [max_voxels] int32, n_voxels). Voxels are numbered in order of their
    first point; a point outside ``pc_range`` (xmin, ymin, zmin, xmax, ymax,
    zmax), past ``max_points`` in its voxel or in a voxel past
    ``max_voxels`` is dropped."""
    points = np.ascontiguousarray(points, np.float32)
    n, f = points.shape
    rng = np.ascontiguousarray(pc_range, np.float32)
    vs = np.ascontiguousarray(voxel_size, np.float32)
    voxels = np.zeros((max_voxels, max_points, f), np.float32)
    coords = np.zeros((max_voxels, 3), np.int32)
    counts = np.zeros(max_voxels, np.int32)
    nv = load_library().hard_voxelize(
        _p(points, ctypes.c_float), n, f, _p(rng, ctypes.c_float), _p(vs, ctypes.c_float),
        max_points, max_voxels, _p(voxels, ctypes.c_float), _p(coords, ctypes.c_int32),
        _p(counts, ctypes.c_int32))
    return voxels, coords, counts, int(nv)


def build_subm_rulebook(coords: np.ndarray, n_voxels: int, cap: int,
                        kernel: int = 3) -> np.ndarray:
    """The submanifold rulebook: gather [kernel^3, cap] int32, gather[k, o] =
    the voxel at coords[o] + offset k (offsets x-major over [-r, r]^3), or -1."""
    coords = np.ascontiguousarray(coords, np.int32)
    gather = np.empty((kernel ** 3, cap), np.int32)
    load_library().build_subm_rulebook(_p(coords, ctypes.c_int32), n_voxels, cap, kernel,
                                       _p(gather, ctypes.c_int32))
    return gather


def build_sparse_rulebook(coords: np.ndarray, n_voxels: int, in_shape, kernel, stride,
                          pad, cap: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """The strided rulebook: (out_coords [cap, 3] int32, gather [K, cap] int32,
    n_out). Output sites are numbered as first reached, offset by offset;
    ``kernel``, ``stride`` and ``pad`` are ints (cubic) or 3-tuples."""
    coords = np.ascontiguousarray(coords, np.int32)
    shape = np.ascontiguousarray(in_shape, np.int32)
    lib = load_library()
    out_coords = np.zeros((cap, 3), np.int32)
    if np.isscalar(kernel):
        gather = np.empty((int(kernel) ** 3, cap), np.int32)
        n_out = lib.build_sparse_rulebook(
            _p(coords, ctypes.c_int32), n_voxels, _p(shape, ctypes.c_int32), int(kernel),
            int(stride), int(pad), cap, _p(out_coords, ctypes.c_int32),
            _p(gather, ctypes.c_int32))
    else:
        k, s, p = _triple(kernel), _triple(stride), _triple(pad)
        gather = np.empty((int(np.prod(k)), cap), np.int32)
        n_out = lib.build_sparse_rulebook_aniso(
            _p(coords, ctypes.c_int32), n_voxels, _p(shape, ctypes.c_int32),
            _p(k, ctypes.c_int32), _p(s, ctypes.c_int32), _p(p, ctypes.c_int32), cap,
            _p(out_coords, ctypes.c_int32), _p(gather, ctypes.c_int32))
    return out_coords, gather, int(n_out)


# --- the plain twins --------------------------------------------------------------------
def hard_voxelize_plain(points: np.ndarray, pc_range, voxel_size, max_points: int,
                        max_voxels: int):
    """``hard_voxelize`` in numpy."""
    points = np.ascontiguousarray(points, np.float32)
    f = points.shape[1]
    rng = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    nx = np.round((rng[3:] - rng[:3]) / vs).astype(np.int64)
    cell = np.floor((points[:, :3] - rng[:3]) / vs).astype(np.int64)
    ok = np.all((cell >= 0) & (cell < nx), axis=1) & np.all(points[:, :3] >= rng[:3], axis=1)
    voxels = np.zeros((max_voxels, max_points, f), np.float32)
    coords = np.zeros((max_voxels, 3), np.int32)
    counts = np.zeros(max_voxels, np.int32)
    vid_of = {}
    nv = 0
    for i in np.nonzero(ok)[0]:
        key = tuple(cell[i])
        vid = vid_of.get(key)
        if vid is None:
            if nv >= max_voxels:
                continue
            vid = nv
            vid_of[key] = vid
            coords[vid] = key
            nv += 1
        c = counts[vid]
        if c < max_points:
            voxels[vid, c] = points[i]
            counts[vid] = c + 1
    return voxels, coords, counts, nv


def build_subm_rulebook_plain(coords: np.ndarray, n_voxels: int, cap: int,
                              kernel: int = 3) -> np.ndarray:
    """``build_subm_rulebook`` in numpy."""
    coords = np.asarray(coords, np.int32)
    gather = np.full((kernel ** 3, cap), -1, np.int32)
    idx_of = {tuple(coords[i]): i for i in range(n_voxels)}
    r = kernel // 2
    offsets = [(dx, dy, dz) for dx in range(-r, r + 1) for dy in range(-r, r + 1)
               for dz in range(-r, r + 1)]
    for k, d in enumerate(offsets):
        for o in range(n_voxels):
            j = idx_of.get(tuple(int(c) for c in coords[o] + d))
            if j is not None:
                gather[k, o] = j
    return gather


def build_sparse_rulebook_plain(coords: np.ndarray, n_voxels: int, in_shape, kernel, stride,
                                pad, cap: int):
    """``build_sparse_rulebook`` in numpy."""
    coords = np.asarray(coords, np.int32)
    kernel, stride, pad = _triple(kernel), _triple(stride), _triple(pad)
    out_dim = (np.asarray(in_shape, np.int32) + 2 * pad - kernel) // stride + 1
    gather = np.full((int(np.prod(kernel)), cap), -1, np.int32)
    out_coords = np.zeros((cap, 3), np.int32)
    out_of = {}
    n_out = 0
    offsets = [(dx, dy, dz) for dx in range(kernel[0]) for dy in range(kernel[1])
               for dz in range(kernel[2])]
    for k, d in enumerate(offsets):
        for i in range(n_voxels):
            iv = coords[i] + pad - np.asarray(d)
            if np.any(iv < 0) or np.any(iv % stride):
                continue
            ov = iv // stride
            if np.any(ov >= out_dim):
                continue
            key = tuple(int(c) for c in ov)
            oid = out_of.get(key)
            if oid is None:
                if n_out >= cap:
                    continue
                oid = n_out
                out_of[key] = oid
                out_coords[oid] = ov
                n_out += 1
            gather[k, oid] = i
    return out_coords, gather, n_out
