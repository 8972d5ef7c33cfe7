"""Build and load the port's CUDA kernels at first use.

Each ``ddp_tpu_torch/csrc/*.cu`` source is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, written to ``ddp_tpu_torch/_build/`` under
a name keyed by a hash of the sources and flags, and loaded with ``ctypes``.
Nothing here includes PyTorch's headers, so a build takes seconds. Importing
this module builds nothing.
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
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# every exported kernel entry and its C signature (pointers and the stream
# are c_void_p; ctypes would otherwise pass them as 32-bit ints)
_ENTRIES = {
    # labels, table, out, n, c, k, bit_scale, dtype, stream
    "ddp_encode_map": [_P, _P, _P, _I64, _I, _I, _F, _I, _P],
    # labels, table, alpha, sigma, noise, out, n, c, k, bit_scale, dtype, stream
    "ddp_q_sample": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _F, _I, _P],
    # labels, demb, out, n, c, k, stream
    "ddp_dtable": [_P, _P, _P, _I64, _I, _I, _P],
    # logits, labels, sums, lse, nb, h, w, k, scale, ignore_index, dtype,
    # tile_h, tile_w, grid_x, grid_y, threads, smem_bytes, stream
    "ddp_upsample_ce_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I64, _I,
                            _I, _I, _I, _I, _I, _I, _P],
    # logits, labels, lse, g, dlogits, nb, h, w, k, scale, ignore_index, dtype,
    # tile_h, tile_w, grid_x, grid_y, grid_z, smem_bytes, stream
    "ddp_upsample_ce_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I64, _I,
                            _I, _I, _I, _I, _I, _I, _P],
    # scale, dtype, out int[4] (no stream: they launch nothing)
    "ddp_upsample_ce_fwd_attrs": [_I, _I, _P],
    "ddp_upsample_ce_bwd_attrs": [_I, _I, _P],
}


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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        failed = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, out_path)  # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int  # cudaError_t of the launch
            _lib = lib
        return _lib


def launch(entry: str, device, *args) -> None:
    """Call the C entry ``entry`` with ``args`` and the current CUDA stream of
    ``device``; raise if the launch returned a CUDA error."""
    import torch

    fn = getattr(load_library(), entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA kernel launch failed: cudaError {err}")
