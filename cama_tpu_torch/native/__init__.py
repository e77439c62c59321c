"""The host mosaic compositor: compositor.cpp built with g++ on first use
and bound with ctypes.

A copy of cama_tpu/native/__init__.py's compositing half.  The library is
built into build/cama_tpu_torch/ at the repository root, named by a hash of
the source, and never next to the source.  Without a toolchain, or when the
build fails, `available()` is False and the pipeline composites with NumPy
(byte-identical, slower).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from cama_tpu_torch._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "compositor.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    with open(_SRC, "rb") as f:
        stamp = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libcompositor_{stamp}.so")


def _build_and_load():
    """Build compositor.cpp into its content-addressed library (once) and
    dlopen it; None when the toolchain or the build is unavailable."""
    so_path = library_path()
    if os.path.exists(so_path):
        try:
            return ctypes.CDLL(so_path)
        except OSError:  # corrupt or foreign library: rebuilt over it
            pass
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
                        "-o", tmp], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, so_path)  # atomic: concurrent builders race safely
        return ctypes.CDLL(so_path)
    except (OSError, subprocess.SubprocessError):
        return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            lib = _build_and_load()
            if lib is not None:
                i64, i32, u8p, i32p = (ctypes.c_int64, ctypes.c_int32,
                                       ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.POINTER(ctypes.c_int32))
                for fn in (lib.cama_composite, lib.cama_composite_packed2):
                    fn.argtypes = [u8p, i64, u8p, i64, u8p, i32, i32, u8p, i64]
                lib.cama_paint_sparse.argtypes = [i32p, i64, u8p, i32, i32,
                                                  u8p, i64]
                for fn in (lib.cama_composite, lib.cama_composite_packed2,
                           lib.cama_paint_sparse):
                    fn.restype = None
            _lib, _tried = lib, True
    return _lib


def available():
    """True when the native compositor is built and loadable."""
    return _load() is not None


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check_hw3(arr, h, w, name):
    """Validate a [H, W, 3] uint8 image whose rows may be a strided view
    (mosaic slot); pixels within a row must be packed."""
    if arr.dtype != np.uint8 or arr.shape != (h, w, 3):
        raise ValueError(f"{name}: expected uint8 [{h},{w},3], got "
                         f"{arr.dtype} {arr.shape}")
    if arr.strides[1] != 3 or arr.strides[2] != 1:
        raise ValueError(f"{name}: rows must be packed (strides {arr.strides})")
    return arr.strides[0]


def _pad_table(color_table):
    """[n<=8, 3] uint8 BGR -> contiguous [8, 3] (unused rows black) so the
    kernel's (cls & 7) index is always in range."""
    t = np.ascontiguousarray(color_table, dtype=np.uint8)
    if t.ndim != 2 or t.shape[1] != 3 or t.shape[0] > 8:
        raise ValueError(f"color_table must be [<=8, 3], got {t.shape}")
    out = np.zeros((8, 3), np.uint8)
    out[: t.shape[0]] = t
    return out


def _base_args(base, h, w):
    if base is None:  # paint onto `out` in place
        return None, 0
    return _u8p(base), _check_hw3(base, h, w, "base")


def composite(base, raster, color_table, out):
    """Fused base-copy + overlay paint: out = base, then
    out[raster != 0] = color_table[raster - 1].

    base: [H, W, 3] uint8 (row-strided views ok) or None (paint onto `out`
          in place); raster: [H, W] uint8 class raster (0 = unpainted, else
          class_id + 1); out: [H, W, 3] uint8, may be a mosaic slot view.
    Returns out."""
    lib = _load()
    h, w = raster.shape
    out_stride = _check_hw3(out, h, w, "out")
    if raster.dtype != np.uint8 or raster.strides[1] != 1:
        raster = np.ascontiguousarray(raster, dtype=np.uint8)
    base_ptr, base_stride = _base_args(base, h, w)
    lib.cama_composite(base_ptr, base_stride, _u8p(raster), raster.strides[0],
                       _u8p(_pad_table(color_table)), h, w, _u8p(out),
                       out_stride)
    return out


def composite_packed2(base, packed2, color_table, out, width):
    """composite(), but straight from the 2-bit packed device raster
    ([H, ceil(W/4)] uint8 — ops/raster.py pack_cls_2bit): the host never
    materializes the unpacked [H, W] raster."""
    lib = _load()
    h = packed2.shape[0]
    out_stride = _check_hw3(out, h, width, "out")
    if packed2.dtype != np.uint8 or packed2.strides[1] != 1:
        packed2 = np.ascontiguousarray(packed2, dtype=np.uint8)
    if packed2.shape[1] * 4 < width:
        raise ValueError(f"packed2 width {packed2.shape[1]}*4 < {width}")
    base_ptr, base_stride = _base_args(base, h, width)
    lib.cama_composite_packed2(base_ptr, base_stride, _u8p(packed2),
                               packed2.strides[0],
                               _u8p(_pad_table(color_table)), h, width,
                               _u8p(out), out_stride)
    return out


def paint_sparse(vals, count, color_table, width, out):
    """Order-exact cv2.circle(radius=2) paint of a sparse list (the first
    `count` entries of ops/raster.py compact_points' encodings) onto `out`,
    which already holds base pixels and may be a mosaic slot view.  Writes
    the same bytes as ops.raster.paint_sparse_host."""
    lib = _load()
    n = int(count)
    if n <= 0:
        return out
    v = np.ascontiguousarray(vals[:n], dtype=np.int32)
    h = out.shape[0]
    out_stride = _check_hw3(out, h, out.shape[1], "out")
    lib.cama_paint_sparse(v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          n, _u8p(_pad_table(color_table)), h, width,
                          _u8p(out), out_stride)
    return out
