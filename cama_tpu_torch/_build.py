"""Build and load the package's CUDA kernels (nvcc -> shared library ->
ctypes).

The kernels are plain C entry points (csrc/*.cu, no PyTorch headers), so
one nvcc call builds them in seconds.  The library is built at first use
into build/cama_tpu_torch/ at the repository root, named by a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "fused_compact.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cama_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of the nvcc call that built the library


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of cama_tpu_torch are built from source at first use")
    return path


def library_path():
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcama_fc_{digest.hexdigest()[:16]}.so")


def _bind(lib):
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [i] * 5 + [fl] * 6  # P, F, C, W, H, crop lo xyz, crop hi xyz
    lib.cama_fc_blocks.argtypes = [i]
    lib.cama_fc_blocks.restype = i
    lib.cama_fc_count.argtypes = [p] * 6 + geo + [p, p, p, p]
    lib.cama_fc_count.restype = i
    lib.cama_fc_project.argtypes = [p] * 6 + geo + [i] + [p, p, p, p, p]
    lib.cama_fc_project.restype = i
    return lib


def load():
    """The kernel library, built on first call (raises when nvcc fails)."""
    global _lib, BUILD_SECONDS
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.tmp{os.getpid()}"
                t0 = time.perf_counter()
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                        f"{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, so)  # atomic: concurrent builders race safely
                BUILD_SECONDS = time.perf_counter() - t0
            _lib = _bind(ctypes.CDLL(so))
    return _lib
