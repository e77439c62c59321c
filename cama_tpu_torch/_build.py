"""Build and load the package's CUDA kernels (nvcc -> shared library ->
ctypes).

The kernels are plain C entry points (csrc/*.cu, no PyTorch headers), so
nvcc builds each in seconds.  At first use every csrc/*.cu is compiled to
an object, one nvcc process per source, all started together, and the
objects are linked into one library in build/cama_tpu_torch/ at the
repository root.  The library is named by a hash of every source and header
and of the flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
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
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cama_tpu_torch")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of the nvcc calls that built the library
BUILD_LOG = ""        # what nvcc printed (ptxas registers, shared memory)


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libcama_{digest.hexdigest()[:16]}.so")


def _compile(so):
    """One nvcc per source in parallel, then one link into `so`."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            out = proc.communicate()[0]
            log.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"{src}:\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        part = os.path.join(tmp, os.path.basename(so))
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", part,
                               *(obj for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) linking "
                               f"{so}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(part, so)  # atomic: concurrent builders race safely
    return "\n".join(log)


def _bind(lib):
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [i] * 5 + [fl] * 6  # P, F, C, W, H, crop lo xyz, crop hi xyz
    lib.cama_fc_scratch_words.argtypes = [i, i]
    lib.cama_fc_scratch_words.restype = ctypes.c_longlong
    lib.cama_fc_count.argtypes = [p] * 6 + geo + [p, p]
    lib.cama_fc_count.restype = i
    lib.cama_fc_project.argtypes = [p] * 6 + geo + [i] + [p, p, p, p]
    lib.cama_fc_project.restype = i
    lib.cama_pp_project.argtypes = [p] * 5 + geo + [p, p, p]
    lib.cama_pp_project.restype = i
    lib.cama_paint_max.argtypes = [p] * 3 + [i] * 4 + [p, p]
    lib.cama_paint_max.restype = i
    return lib


def load():
    """The kernel library, built on first call (raises when nvcc fails)."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                t0 = time.perf_counter()
                BUILD_LOG = _compile(so)
                BUILD_SECONDS = time.perf_counter() - t0
            _lib = _bind(ctypes.CDLL(so))
    return _lib
