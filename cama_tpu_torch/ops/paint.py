"""Max-paint of points into int32 rasters: out[y, x] = max(out[y, x], prio)
over every point with prio >= 0, into rasters that start at -1.

Counterpart of the Pallas probe in tools/bench_pallas.py (`probe_kernel`),
the serial in-kernel paint whose TPU timing kept the overlay scatter on XLA.
On Hopper the same question has an atomicMax answer
(csrc/paint_max.cu); cama_tpu_torch.tools.bench_kernels times it against
`scatter_reduce_`.  It does not serve the overlay path: the rasterizers of
ops/raster.py keep their scatter, as the JAX package does.

`paint_max` launches the CUDA kernel for CUDA tensors and runs the plain
version `paint_max_ref` only for CPU tensors.  The result does not depend on
the order of the updates, so kernel and plain version agree exactly.
"""
from __future__ import annotations

import torch

from cama_tpu_torch.ops.geometry import route
from cama_tpu_torch.ops.raster import scatter_max

# launches of the CUDA kernel, counted by its wrapper (plain-version calls on
# CPU tensors do not count)
LAUNCHES = {"paint_max": 0}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(py, px, prio):
    for name, t in (("py", py), ("px", px), ("prio", prio)):
        if t.dtype != torch.int32 or t.dim() not in (1, 2):
            raise ValueError(f"{name}: expected int32 [K] or [N_img, K], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.shape != py.shape or t.device != py.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, py "
                             f"{tuple(py.shape)} on {py.device}")
    return (1 if py.dim() == 1 else py.shape[0]), py.shape[-1]


def paint_max_ref(py, px, prio, height, width_pad):
    """Plain PyTorch version: `scatter_reduce_` amax onto -1 rasters.

    py, px, prio: int32 [K] or [N_img, K].  Returns [height, width_pad] or
    [N_img, height, width_pad] int32; points with prio < 0 or (py, px)
    outside the raster are skipped."""
    n_img, K = _check(py, px, prio)
    ok = ((prio >= 0) & (py >= 0) & (py < height) & (px >= 0)
          & (px < width_pad))
    hw = height * width_pad
    pix = torch.where(ok, py * width_pad + px, hw)
    out = scatter_max(pix.reshape(n_img, K),
                      torch.where(ok, prio, -1).reshape(n_img, K), hw)
    return out.reshape(py.shape[:-1] + (height, width_pad))


def _launch(py, px, prio, height, width_pad):
    from cama_tpu_torch import _build

    n_img, K = _check(py, px, prio)
    lib = _build.load()
    dev = py.device
    ins = [t.contiguous() for t in (py, px, prio)]
    out = torch.empty(py.shape[:-1] + (height, width_pad), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        err = lib.cama_paint_max(*(t.data_ptr() for t in ins), n_img, K,
                                 int(height), int(width_pad), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paint_max: CUDA launch failed with error {err}")
    LAUNCHES["paint_max"] += 1
    return out


def paint_max(py, px, prio, height, width_pad):
    """Max-paint of points into [height, width_pad] int32 rasters that start
    at -1 (same arguments and result as paint_max_ref).  CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version."""
    if route(py, "paint_max") == "cpu":
        return paint_max_ref(py, px, prio, height, width_pad)
    return _launch(py, px, prio, height, width_pad)
