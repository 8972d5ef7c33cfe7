"""Build and load the port's CUDA kernels at first use.

All ``ddp_tpu_torch/csrc/*.cu`` sources are compiled by one ``nvcc`` call into
a shared library with a plain C interface, written to
``ddp_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, and loaded with ``ctypes``. Nothing here includes PyTorch's headers,
so a build takes seconds. Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of ddp_tpu_torch are built at first use")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, headers


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libddp_kernels_{h.hexdigest()[:16]}.so")


def _compile(out_path: str) -> None:
    srcs, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out_path)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            fn = lib.ddp_encode_map
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
