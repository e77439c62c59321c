"""Kernel-strategy measurements on one CUDA card: the port of
tools/bench_pallas.py, at that tool's sizes (W, H, P, C = 960, 540, 49152,
6) and on its inputs (the same numpy seeds).

    python -m cama_tpu_torch.tools.bench_kernels

1. projection: the CUDA kernel behind raster_kernel='pallas'
   (ops/pallas_project.py) against the plain project_frames, ms per frame,
   with keep equality and the max (v, u) difference over kept points;
2. compaction: a stable sort against a cumsum + searchsorted + gather
   (bench_pallas.py's two candidates) and the cumsum-rank scatter that
   ops/raster.py compact_points uses, all plain PyTorch, ms per 6-camera
   compaction to 8192 entries;
3. paint: the atomicMax kernel (ops/paint.py, the counterpart of the TPU's
   serial max-paint probe) against scatter_reduce_, ns per point, for 4096
   points into a [540, 1024] raster.

Times are CUDA-event medians of RUNS calls after warm-up, on the card named
in the output.  Prints one JSON line; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from cama_tpu_torch.ops.geometry import crop_bounds
from cama_tpu_torch.ops.pallas_project import (project_frame_pallas,
                                               project_frame_pallas_ref)
from cama_tpu_torch.ops.paint import paint_max, paint_max_ref
from cama_tpu_torch.ops.raster import MAX_CLS, compact_rows

W, H, P, C = 960, 540, 49152, 6
N_PROBE, WPAD = 4096, 1024
KB = 8192  # compaction list size
RUNS = 20


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs=RUNS):
    """Median CUDA-event time of fn() over `runs` calls after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def projection_inputs(device):
    """bench_pallas.py's _inputs: P points in a 120 m cube, identity chassis
    frame, six cameras yawed around the vertical, one valid frame."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-60, 60, (P, 3)).astype(np.float32)
    K = np.array([[800.0, 0, W / 2], [0, 800.0, H / 2], [0, 0, 1.0]])
    B = np.zeros((1, C, 3, 4), np.float32)
    for c in range(C):
        yaw = 2 * np.pi * c / C
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [0, 0, -1],
                      [np.sin(yaw), np.cos(yaw), 0]])
        E = np.eye(4)
        E[:3, :3] = R
        B[0, c] = (K @ E[:3]).astype(np.float32)
    arrays = (pts, np.ones(P, bool), np.eye(4, dtype=np.float32)[None], B,
              np.ones(1, bool))
    return [torch.from_numpy(a).to(device) for a in arrays]


def paint_inputs_from_list(vals, width):
    """(py, px, prio) int32 of a compacted survivor list vals [..., K]
    (ops/raster.py compact_points): the points rasterize_from_compact
    scatters, with their paint priorities (-1 = empty slot)."""
    ok = vals >= 0
    pix = torch.div(vals, MAX_CLS, rounding_mode="floor")
    order = torch.arange(vals.shape[-1], dtype=torch.int32,
                         device=vals.device)
    prio = torch.where(ok, order * MAX_CLS + vals % MAX_CLS, -1)
    py = torch.where(ok, pix // width, -1)
    px = torch.where(ok, pix % width, -1)
    return py.to(torch.int32), px.to(torch.int32), prio.to(torch.int32)


def bench_projection(device):
    lo, hi = crop_bounds()
    args = (*projection_inputs(device), W, H, lo, hi)
    vu_k, keep_k = project_frame_pallas(*args)
    vu_r, keep_r = project_frame_pallas_ref(*args)
    torch.cuda.synchronize()
    return {
        "kernel_ms": time_ms(lambda: project_frame_pallas(*args)),
        "plain_ms": time_ms(lambda: project_frame_pallas_ref(*args)),
        "kept": int(keep_r.sum()),
        "keep_equal": bool(torch.equal(keep_k, keep_r)),
        "vu_max_diff_px": float((vu_k - vu_r).abs()[keep_r].max())
        if keep_r.any() else 0.0,
    }


def _compact_sort(enc, keep, k):
    n = enc.shape[-1]
    order = torch.arange(n, dtype=torch.int32, device=enc.device)
    key = torch.where(keep, order, n + order)
    idx = torch.sort(key, dim=-1, stable=True).indices[..., :k]
    return torch.gather(enc, -1, idx)


def _compact_gather(enc, keep, k):
    pos = torch.cumsum(keep, dim=-1, dtype=torch.int32)
    j = torch.arange(1, k + 1, dtype=torch.int32, device=enc.device)
    idx = torch.searchsorted(pos, j.expand(pos.shape[0], k).contiguous())
    vals = torch.gather(enc, -1, idx.clamp(max=enc.shape[-1] - 1))
    return torch.where(j <= pos[..., -1:], vals, -1)


def _compaction_and_probe_inputs(device):
    """bench_pallas.py's inputs of its second and third measurements: one
    generator seeded 1 draws the compaction's encodings and keep mask
    [C, P], then the probe's N_PROBE points (py, px, prio)."""
    rng = np.random.default_rng(1)
    enc = rng.integers(0, W * H * 8, (C, P)).astype(np.int32)
    keep = rng.random((C, P)) < 0.08
    arrays = (np.where(keep, enc, -1).astype(np.int32), keep,
              rng.integers(0, H, N_PROBE).astype(np.int32),
              rng.integers(0, W, N_PROBE).astype(np.int32),
              rng.integers(0, 1 << 20, N_PROBE).astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays]


def probe_inputs(device):
    """(py, px, prio) of the paint probe: N_PROBE points into [H, WPAD]."""
    return _compaction_and_probe_inputs(device)[2:]


_COMPACTIONS = (("sort", _compact_sort),
                ("searchsorted_gather", _compact_gather),
                ("cumsum_scatter", compact_rows))


def bench_compaction(device):
    enc, keep = _compaction_and_probe_inputs(device)[:2]
    lists = [fn(enc, keep, KB) for _, fn in _COMPACTIONS]
    out = {f"{name}_ms": time_ms(lambda fn=fn: fn(enc, keep, KB))
           for name, fn in _COMPACTIONS}
    out["all_equal"] = all(torch.equal(v, lists[0]) for v in lists)
    return out


def bench_paint(device):
    py, px, prio = probe_inputs(device)
    got = paint_max(py, px, prio, H, WPAD)
    want = paint_max_ref(py, px, prio, H, WPAD)
    torch.cuda.synchronize()
    per_point = 1e6 / N_PROBE  # ms per call -> ns per point
    return {
        "kernel_ns_per_point":
            time_ms(lambda: paint_max(py, px, prio, H, WPAD)) * per_point,
        "scatter_reduce_ns_per_point":
            time_ms(lambda: paint_max_ref(py, px, prio, H, WPAD)) * per_point,
        "max_abs_err": int((got - want).abs().max()),
    }


def run(device="cuda"):
    """Every measurement on `device` (a CUDA device); returns the record
    main() prints."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"bench_kernels measures a CUDA device, got {device}")
    return {"device": torch.cuda.get_device_name(device), "card": card_line(),
            "shape": {"W": W, "H": H, "P": P, "C": C, "n_probe": N_PROBE,
                      "raster": [H, WPAD], "compaction_k": KB},
            "projection": bench_projection(device),
            "compaction_6cam": bench_compaction(device),
            "paint": bench_paint(device)}


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_kernels: torch.cuda.is_available() is False — the "
                 "measurements need a CUDA device")
    print(json.dumps(run("cuda")), flush=True)


if __name__ == "__main__":
    main()
