#!/usr/bin/env python3
"""Smoke test of cama_tpu_torch on one CUDA card (NVIDIA Hopper).

    python3 chip_smoke.py          # from the repository root

Phases, each printing its own line; any failure raises and the script exits
non-zero (also when no CUDA device is present, or when the package is not
next to this script):

  1. environment: the card, its power limit (nvidia-smi), TF32 off, the
     nvcc build of every kernel from cama_tpu_torch/csrc (one nvcc per
     source, in parallel) with ptxas' register, shared-memory and spill
     report (any spill fails), and the g++ build of the host mosaic
     compositor (required: the timed stream is the native path);
  2. kernels vs their plain versions on the card, all exact:
     fused_compact_project and its counting entry point count_union on the
     compute-bound fixture scene (17 frames, ~253,600 points) tiled to
     1,048,576 points as one chunk of 16 frames, on a tile-boundary case,
     on a crop-straddling case (P = 31k + 5, two cameras) at 1 and 16
     frames, and on that case with an overflowing list (count > k_cap);
     the kernels each of them runs per call (torch.profiler);
     project_frame_pallas on the tiled scene and a ragged case; paint_max
     at the TPU probe's shape and on one chunk's survivor lists of the
     'pallas' lane (48 rasters of 540 x 960);
  3. the main paths, each with every launch count set to 0 just before it
     and read just after: ClipPipeline(device='cuda').iter_overlay_rasters
     over every frame of the 'cama' source, raster_kernel 'fused' and then
     'pallas', each raster composited into the 3x2 mosaic by the native
     compositor over a 6-thread pool (as write_videos does) onto black base
     images; rasters held against the float64 host lane (>= 0.99999 per
     frame), against the plain versions' programs on the card and against
     each other (exact); and the kernel-strategy tool
     (cama_tpu_torch.tools.bench_kernels), the path of paint_max;
  4. times: kernels, plain versions and library calls (CUDA events, median
     of 20 runs after warm-up) beside each kernel's bound on this run's
     inputs; per-chunk device time of each stage of both lanes' device
     programs; frames/s of the streams over windows of at least
     MIN_WINDOW_S seconds, with the host phase split and the device busy
     share (torch.profiler).

The last two lines are the kernels' JSON record and the result line.  The
script fails if any module of jax or of the JAX package cama_tpu was
loaded.  Needs numpy and torch with CUDA, nvcc and g++; no cv2, yaml or
ffmpeg.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
N_POINTS = 1_048_576   # tiled point count of the kernel phase
CHUNK_TILED = 16       # frames per chunk of the kernel phase
CHUNK = 8              # ClipPipeline's default frame chunk (main path)
AGREE_MIN = 0.99999    # per-frame raster agreement vs the host f64 lane
MIN_WINDOW_S = 1.0     # each timed stream window loops the clip this long
WINDOWS = 3
POOL_THREADS = 6       # write_videos' default compositor pool
DEVICE = "cuda"
# mangled-name fragments of the kernels -> the names ptxas' report is shown by
KERNEL_SYMBOLS = {"fc_tileILb0": "fc_tile<false> (count_union)",
                  "fc_tileILb1": "fc_tile<true> (fused_compact_project)",
                  "pp_kernel": "pp_kernel", "paint_kernel": "paint_kernel"}
# the least time the card could take (NVIDIA's H100 SXM data sheet: HBM3
# bandwidth and the float32 rate outside the tensor cores, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def wide_clip():
    """The compute-bound fixture clip (bench.py's get_wide_fixture)."""
    from cama_tpu_torch.io.fixture import make_fixture_clip

    shutil.rmtree(WORK, ignore_errors=True)
    return make_fixture_clip(WORK, scene_name="scene-wide-17", n_frames=17,
                             with_images=False, label_span=(-290.0, 210.0))


def tiled_inputs(pipe, device):
    """bench.py's 1M-point tiling of the wide scene: copies spread by 0.35 m
    steps across the road so they rasterize to distinct pixels, one chunk of
    CHUNK_TILED valid frames."""
    import numpy as np
    import torch

    fp = pipe.scene.flat["cama"]
    pts, cls, valid = fp.points, fp.cls, fp.valid
    reps = -(-N_POINTS // len(pts))
    offs = (np.arange(reps, dtype=np.float32)[:, None]
            * np.asarray([0.35, 0.17, 0.0], np.float32))
    pts = (pts[None] + offs[:, None]).reshape(-1, 3)[:N_POINTS]
    cls = np.tile(cls, reps)[:N_POINTS]
    valid = np.tile(valid, reps)[:N_POINTS]
    fm = pipe.frame_matrices("cama")
    sel = np.resize(np.flatnonzero(fm.frame_valid), CHUNK_TILED)
    arrays = (pts, valid, cls, fm.A[sel].astype(np.float32),
              fm.B[sel].astype(np.float32), np.ones(CHUNK_TILED, bool))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def case_tensors(case, device):
    """A cama_tpu_torch.tools.fused_cases case on the card: (args, geo)."""
    import torch

    arrays, (w, h, lo, hi) = case[:6], case[6:]
    return ([torch.from_numpy(a.copy()).to(device) for a in arrays],
            (w, h, lo, hi))


def compare_project(args, geo, k_cap):
    """fused_compact_project and count_union vs their plain versions on the
    same card tensors: (max |diff| over counts and the live rows up to
    k_cap, max |diff| of the counting entry point, min count, max count);
    both differences must be 0."""
    import torch

    from cama_tpu_torch.ops import fused_compact as fc

    vals_k, cnt_k = fc.fused_compact_project(*args, *geo, k_cap)
    vals_r, cnt_r = fc.fused_compact_project_ref(*args, *geo, k_cap)
    cnt_c = fc.count_union(*args, *geo)
    cnt_cr = fc.count_union_ref(*args, *geo)
    torch.cuda.synchronize()
    err = int((cnt_k - cnt_r).abs().max())
    err_count = int((cnt_c - cnt_cr).abs().max())
    for f in range(cnt_r.shape[0]):
        n = min(int(cnt_r[f]), k_cap)
        if n:
            err = max(err, int((vals_k[f, :n] - vals_r[f, :n]).abs().max()))
    return err, err_count, int(cnt_r.min()), int(cnt_r.max())


def device_work(fn, reps=3):
    """({device kernel or memset name: runs per call}, device ms of one
    call: the median over reps calls of the summed durations of its
    kernels and memsets) from torch.profiler, or (None, None) when no
    trace shows device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen, times = None, []
    for _ in range(reps):  # a trace that caught no device event is skipped
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got, us = {}, 0.0
        for e in prof.events():
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
                name = "memset" if "memset" in e.name.lower() else e.name
                got[name] = got.get(name, 0) + 1
                us += e.time_range.elapsed_us()
        if got:
            seen = got
            times.append(us / 1000.0)
    if not times:
        return None, None
    return seen, statistics.median(times)


def per_call(entry, fn, symbol, launches, device_ms):
    """Print the device work of one call of fn; record in launches[entry]
    how many of its kernels are the entry's own and in device_ms[entry]
    its device time (None: not measured)."""
    seen, ms = device_work(fn)
    launches[entry] = (None if seen is None else
                       sum(n for name, n in seen.items() if symbol in name))
    device_ms[entry] = ms
    say("kernel", f"{entry}: device work of one call (torch.profiler): "
                  + ("not measured" if seen is None else
                     f"{seen}, {ms:.5f} ms on the card"))
    return seen


def fmt(ms, scale):
    return "not measured" if ms is None else f"{ms * scale:.4f}"


def bound(nbytes, ops):
    """(least ms, "bytes" or "operations", ms of the bytes, ms of the
    operations) for moving nbytes and doing ops float32 operations on this
    card."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def in_crop(args, geo):
    """[F, P] bool: the point-frames of args (points, valid, [cls,] A, B,
    frame_valid) that the crop box and validity keep (float32 einsum)."""
    import torch

    points, valid, A, fv = args[0], args[1], args[-3], args[-1]
    lo = torch.as_tensor(geo[2], device=points.device)
    hi = torch.as_tensor(geo[3], device=points.device)
    p4 = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    xyz = torch.einsum("fij,pj->fpi", A[:, :3], p4)
    return ((xyz >= lo) & (xyz <= hi)).all(-1) & valid[None] & fv[:, None]


def projection_work(args, geo, kept=None):
    """(input bytes, float32 operations) of projecting the points of args
    into every frame and camera: each input read once (class ids
    excluded); the crop test (three rows of 4 multiplies and 3 adds) of
    every point and frame, and each camera's three rows and two divides
    for every point or, given kept (the number of point-frames the crop
    and validity keep), only for those."""
    points, B = args[0], args[-2]
    P, F, C = points.shape[0], B.shape[0], B.shape[1]
    nbytes = P * 13 + F * (1 + 64 + C * 48)
    return nbytes, F * P * 21 + (F * P if kept is None else kept) * 23 * C


def run_stream(pipe, source, pool, rasters=None, min_seconds=0.0):
    """The main path as write_videos runs it, less decode and encode:
    iter_overlay_rasters, then the native mosaic compositor over `pool`
    onto black base images (the fixture clip has no JPEGs).  Passes over
    the clip repeat until `min_seconds` have elapsed.
    Returns (frames, seconds, mosaic)."""
    import numpy as np

    from cama_tpu_torch.io.video import concat_camera_grid
    from cama_tpu_torch.ops.raster import unpack_cls_2bit

    h, w = pipe.scene.output_size
    base = {cam: np.zeros((h, w, 3), np.uint8) for cam in pipe.scene.camera_list}
    mosaic = np.empty((2 * h, 3 * w, 3), np.uint8)
    n = 0
    t0 = time.perf_counter()
    while True:
        for idx, raster in pipe.iter_overlay_rasters(source, unpack=False):
            with pipe.timers.phase("host_composite"):
                if not pipe.composite_mosaic_frame(source, idx, raster, base,
                                                   mosaic, pool=pool):
                    full = unpack_cls_2bit(raster, w) if raster.shape[-1] != w else raster
                    concat_camera_grid(pipe.composite_frame(
                        source, idx, full, pool=pool, base=base), out=mosaic)
            if rasters is not None:
                rasters[idx] = (raster if raster.shape[-1] == w
                                else unpack_cls_2bit(raster, w))
            n += 1
        secs = time.perf_counter() - t0
        if secs >= min_seconds:
            return n, secs, mosaic


def device_busy_ms(fn):
    """Device time of everything fn() runs on the card (torch.profiler:
    kernels and copies, summed self device time), or None when the trace
    shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / 1000.0 if us > 0 else None


def compare_projection(args, geo):
    """project_frame_pallas vs its plain version on the same card tensors:
    (max |vu diff| over every entry, keep entries that differ, kept)."""
    import torch

    from cama_tpu_torch.ops import pallas_project as pp

    vu_k, keep_k = pp.project_frame_pallas(*args, *geo)
    vu_r, keep_r = pp.project_frame_pallas_ref(*args, *geo)
    torch.cuda.synchronize()
    return (float((vu_k - vu_r).abs().max()), int((keep_k != keep_r).sum()),
            int(keep_r.sum()))


def compare_paint(py, px, prio, height, width):
    """paint_max vs its plain version: (max |diff|, painted pixels)."""
    import torch

    from cama_tpu_torch.ops import paint

    got = paint.paint_max(py, px, prio, height, width)
    ref = paint.paint_max_ref(py, px, prio, height, width)
    torch.cuda.synchronize()
    return int((got - ref).abs().max()), int((ref >= 0).sum())


def reset_all_launches():
    from cama_tpu_torch.ops import fused_compact, paint, pallas_project

    for mod in (fused_compact, pallas_project, paint):
        mod.reset_launches()


def all_launches():
    from cama_tpu_torch.ops import fused_compact, paint, pallas_project

    return {**fused_compact.LAUNCHES, **pallas_project.LAUNCHES,
            **paint.LAUNCHES}


def chunk_rasters(program, pipe, source, *extra):
    """{image_idx: uint8 raster [C, H, W]} of a chunk program of
    cama_tpu_torch.pipeline run over every chunk of `source` on the
    pipeline's device (unpacked rasters, no 2-bit packing)."""
    st = pipe.scene_tensors(source)
    fm, _, _, _, F = pipe._chunked_AB(source)
    h, w = pipe.scene.output_size
    out = {}
    for s in range(0, st.A.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        rasters, _ = program(st.points, st.valid, st.cls, st.A[sl], st.B[sl],
                             st.frame_valid[sl], pipe._crop_lo, pipe._crop_hi,
                             w, h, *extra, False)
        rasters = rasters.cpu().numpy()
        for j in range(rasters.shape[0]):
            if s + j < F and fm.frame_valid[s + j]:
                out[int(fm.frame_indices[s + j])] = rasters[j]
    return out


def pixels_apart(a, b):
    if set(a) != set(b):
        raise RuntimeError("the two streams yield different frames")
    return sum(int((a[i] != b[i]).sum()) for i in a)


def stream_rates(pipe, source, pool, windows):
    """Median frames/s over `windows` warm windows of >= MIN_WINDOW_S, the
    rates, and the host phase split of the last window (ms/frame)."""
    rates, split = [], {}
    for _ in range(windows):
        pipe.timers = type(pipe.timers)()
        n, secs, _ = run_stream(pipe, source, pool, min_seconds=MIN_WINDOW_S)
        rates.append(n / secs)
        split = {k: 1000.0 * v / n for k, v in pipe.timers.total.items()}
    return statistics.median(rates), rates, split


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script needs a CUDA device")
    sys.path.insert(0, ROOT)
    try:
        from cama_tpu_torch import _build, native
        from cama_tpu_torch import pipeline as tp
        from cama_tpu_torch.ops import fused_compact as fc
        from cama_tpu_torch.ops import paint
        from cama_tpu_torch.ops import pallas_project as pp
        from cama_tpu_torch.ops.raster import (compact_points, pack_cls_2bit,
                                               packed_to_cls,
                                               rasterize_from_compact)
        from cama_tpu_torch.tools import bench_kernels as bk
        from cama_tpu_torch.tools import fused_cases
    except ImportError as e:
        sys.exit(f"chip_smoke: cama_tpu_torch not importable next to "
                 f"{__file__}: {e}")
    ClipPipeline, time_ms = tp.ClipPipeline, bk.time_ms

    # ---- phase 1: environment + build ----
    name = torch.cuda.get_device_name(0)
    card = bk.card_line()
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda} | "
               f"device {name} | nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("env", f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
               f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.load()
    built = ("built in %.2f s" % _build.BUILD_SECONDS
             if _build.BUILD_SECONDS is not None else "loaded (already built)")
    srcs = ", ".join(os.path.relpath(p, ROOT) for p in _build.sources())
    say("build", f"{os.path.relpath(_build.library_path(), ROOT)} from "
                 f"{srcs} {built}; load {time.perf_counter() - t0:.2f} s; "
                 f"nvcc {' '.join(_build.NVCC_FLAGS)}")
    kernel, spills = None, []
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            kernel = next((short for sym, short in KERNEL_SYMBOLS.items()
                           if sym in line), line)
        elif "spill stores" in line and kernel:
            say("build", f"ptxas {kernel}: {line.strip()}")
            if re.search(r"[1-9]\d* bytes spill (stores|loads)", line):
                spills.append(kernel)
        elif "Used " in line and kernel:
            say("build", f"ptxas {kernel}: {line.split(':', 1)[1].strip()}")
    if spills:
        raise RuntimeError(f"ptxas reports register spills in {spills}")
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the host mosaic compositor did not build (g++): "
                           "the stream would time the NumPy fallback")
    say("build", f"host mosaic compositor: native, "
                 f"{os.path.relpath(native.library_path(), ROOT)} "
                 f"({time.perf_counter() - t0:.2f} s)")

    # ---- phase 2: kernels vs plain versions ----
    dev = torch.device(DEVICE)
    clip = wide_clip()
    probe = ClipPipeline(clip_path=clip, chunk=CHUNK, device=dev)
    tiled = tiled_inputs(probe, dev)
    h, w = probe.scene.output_size
    geo = (w, h, probe._crop_lo, probe._crop_hi)
    k_tiled = tp._pow2_cap(int(fc.count_union(*tiled, *geo).max()), N_POINTS)
    crop1 = case_tensors(fused_cases.crop_straddle_case(1), dev)
    crop16 = case_tensors(fused_cases.crop_straddle_case(16), dev)
    tb_args, tb_geo = case_tensors(fused_cases.tile_boundary_case(8192 + 512),
                                   dev)
    k_over = int(fc.count_union_ref(*crop16[0], *crop16[1]).max()) // 2
    fused_checks = {
        f"{N_POINTS} points x {CHUNK_TILED} frames": (tiled, geo, k_tiled),
        "tile boundaries, 1 frame": (tb_args, tb_geo, 4096),
        "crop-straddling, 1 frame": (*crop1, 16384),
        f"crop-straddling, {CHUNK_TILED} frames": (*crop16, 16384),
        f"crop-straddling, {CHUNK_TILED} frames, overflow": (*crop16, k_over)}
    fused_err = count_err = 0
    for label, (args, g, k) in fused_checks.items():
        err, err_c, lo_c, hi_c = compare_project(args, g, k)
        fused_err, count_err = max(fused_err, err), max(count_err, err_c)
        say("kernel", f"fused_compact_project, {label} "
                      f"({args[0].shape[0]} points): counts {lo_c}..{hi_c}, "
                      f"k_cap {k}, max |kernel - plain| {err}; count_union "
                      f"max |kernel - plain| {err_c}; tolerance 0 (exact)")
        if "overflow" in label and hi_c <= k:
            raise RuntimeError("the overflow case does not overflow")
    if fused_err or count_err:
        raise RuntimeError("fused CUDA kernel disagrees with its plain version")
    launches_per_call, dev_ms = {}, {}
    for entry, fn in (
            ("fused_compact_project",
             lambda: fc.fused_compact_project(*tiled, *geo, k_tiled)),
            ("count_union", lambda: fc.count_union(*tiled, *geo))):
        seen = per_call(entry, fn, "fc_tile", launches_per_call, dev_ms)
        if seen is not None and (launches_per_call[entry] != 1 or len(seen) > 2
                                 or seen.get("memset", 1) != 1):
            raise RuntimeError(f"{entry} is not one memset and one launch a "
                               f"call: {seen}")

    proj_tiled = [tiled[i] for i in (0, 1, 3, 4, 5)]  # no class ids
    vu_big, keep_big, kept_big = compare_projection(proj_tiled, geo)
    # the boundary case cut to a point count that is no multiple of a block
    tb_proj = [tb_args[0][:-37], tb_args[1][:-37], *tb_args[3:]]
    vu_tb, keep_tb, kept_tb = compare_projection(tb_proj, tb_geo)
    pp_err = max(vu_big, keep_big, vu_tb, keep_tb)
    say("kernel", f"project_frame_pallas, {N_POINTS} points x {CHUNK_TILED} "
                  f"frames: {kept_big} kept, max |vu kernel - plain| {vu_big}, "
                  f"keep entries differing {keep_big}; tile-boundary case at "
                  f"{tb_proj[0].shape[0]} points: {kept_tb} kept, max |vu "
                  f"diff| {vu_tb}, keep differing {keep_tb}; tolerance 0")
    if pp_err != 0:
        raise RuntimeError("projection CUDA kernel disagrees with its plain "
                           "version")

    probe_pts = bk.probe_inputs(dev)
    err_probe, painted_probe = compare_paint(*probe_pts, bk.H, bk.WPAD)
    # the main path's shape: one chunk's survivor lists of the 'pallas'
    # lane, 8 frames x 6 cameras, painted into 540 x 960 rasters
    pal = ClipPipeline(clip_path=clip, chunk=CHUNK, raster_kernel="pallas",
                       device=dev)
    k_pal = pal.overlay_mode("cama")[1]
    st = pal.scene_tensors("cama")
    sl = slice(0, CHUNK)
    proj_args = (st.points, st.valid, st.A[sl], st.B[sl], st.frame_valid[sl],
                 w, h, pal._crop_lo, pal._crop_hi)
    vu0, keep0 = pp.project_frame_pallas(*proj_args)
    vals0, cnt0 = compact_points(vu0, keep0, st.cls, w, h, k_pal)
    n_img = vals0.shape[0] * vals0.shape[1]
    chunk_pts = bk.paint_inputs_from_list(vals0.reshape(n_img, k_pal), w)
    err_chunk, painted_chunk = compare_paint(*chunk_pts, h, w)
    paint_err = max(err_probe, err_chunk)
    say("kernel", f"paint_max: probe {bk.N_PROBE} points into [{bk.H}, "
                  f"{bk.WPAD}]: {painted_probe} pixels painted, max |kernel - "
                  f"plain| {err_probe}; one 'pallas' chunk's survivor lists "
                  f"({int(cnt0.sum())} points, k {k_pal}) into [{n_img}, {h}, "
                  f"{w}]: {painted_chunk} painted, max |diff| {err_chunk}; "
                  f"tolerance 0")
    if paint_err != 0:
        raise RuntimeError("paint CUDA kernel disagrees with its plain version")
    per_call("project_frame_pallas",
             lambda: pp.project_frame_pallas(*proj_tiled, *geo), "pp_kernel",
             launches_per_call, dev_ms)
    per_call("paint_max", lambda: paint.paint_max(*chunk_pts, h, w),
             "paint_kernel", launches_per_call, dev_ms)

    # ---- phase 3: the main paths ----
    pool = ThreadPoolExecutor(max_workers=POOL_THREADS)
    n_chunks = st.A.shape[0] // CHUNK
    paths = {}
    for lane in ("fused", "pallas"):
        reset_all_launches()
        pipe = ClipPipeline(clip_path=clip, chunk=CHUNK, raster_kernel=lane,
                            device=dev)
        streamed = {}
        n_frames, secs, mosaic = run_stream(pipe, "cama", pool, streamed)
        launches = all_launches()
        paths[lane] = (pipe, streamed, n_frames, secs, launches)
        k = pipe.overlay_mode("cama")[1]
        say("main", f"'{lane}' lane: {n_frames} frames of 'cama' "
                    f"({int(pipe.scene.flat['cama'].valid.sum())} points, "
                    f"chunk {CHUNK}, k {k}, {POOL_THREADS} compositor threads) "
                    f"in {secs:.3f} s, counting pass included; launches "
                    f"{launches}")
        if mosaic.shape != (2 * h, 3 * w, 3) or n_frames < 2:
            raise RuntimeError(f"bad stream: {n_frames} frames, {mosaic.shape}")
    expect = {"fused": {"fused_compact_project": n_chunks,
                        "count_union": n_chunks, "project_frame_pallas": 0,
                        "paint_max": 0},
              "pallas": {"fused_compact_project": 0, "count_union": 0,
                         "project_frame_pallas": 2 * n_chunks,
                         "paint_max": 0}}
    for lane, want in expect.items():
        if paths[lane][4] != want:
            raise RuntimeError(f"'{lane}' launches {paths[lane][4]} != {want} "
                               f"({n_chunks} chunks: counting pass + serve)")

    pipe, streamed = paths["fused"][:2]
    host = dict(pipe.iter_overlay_rasters_host("cama"))
    worst = {}
    for lane in ("fused", "pallas"):
        got_all = paths[lane][1]
        if set(host) != set(got_all):
            raise RuntimeError(f"'{lane}' and host lanes yield different frames")
        worst[lane] = 1.0
        for idx, ref in host.items():
            got = got_all[idx]
            if got.shape != ref.shape or got.dtype != np.uint8 or got.max() > 3:
                raise RuntimeError(f"frame {idx}: raster {got.shape} {got.dtype}")
            if not got.any():
                raise RuntimeError(f"frame {idx}: nothing painted")
            worst[lane] = min(worst[lane], float((got == ref).mean()))
    # the fused device program with the plain version as its front end
    k_cap = pipe.overlay_mode("cama")[1]
    st = pipe.scene_tensors("cama")
    fm, _, _, _, F = pipe._chunked_AB("cama")
    mismatched = 0
    for s in range(0, st.A.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        vals, count = fc.fused_compact_project_ref(
            st.points, st.valid, st.cls, st.A[sl], st.B[sl],
            st.frame_valid[sl], w, h, pipe._crop_lo, pipe._crop_hi, k_cap)
        ref = packed_to_cls(fc.rasterize_from_union(vals, count, w, h)).cpu().numpy()
        for j in range(ref.shape[0]):
            fidx = s + j
            if fidx < F and fm.frame_valid[fidx]:
                mismatched += int((ref[j] != streamed[int(fm.frame_indices[fidx])]).sum())
    say("main", f"'fused' agreement vs host float64 lane: min "
                f"{worst['fused']:.10f} per frame (>= {AGREE_MIN}); pixels "
                f"differing from the plain-version device program on the "
                f"card: {mismatched} (must be 0)")
    # the 'pallas' lane with project_frame_pallas_ref (= project_frames) as
    # its front end is the 'compact' lane's program; 'scatter' paints every
    # kept point of the same projection
    pal, pal_streamed = paths["pallas"][:2]
    k_pal = pal.overlay_mode("cama")[1]
    apart = {
        "plain-projection program ('compact')": pixels_apart(
            pal_streamed, chunk_rasters(tp._overlay_chunk_compact, pal,
                                        "cama", k_pal)),
        "'scatter' program": pixels_apart(
            pal_streamed, chunk_rasters(tp._overlay_chunk, pal, "cama")),
        "'fused' lane": pixels_apart(pal_streamed, streamed)}
    say("main", f"'pallas' agreement vs host float64 lane: min "
                f"{worst['pallas']:.10f} per frame (>= {AGREE_MIN}); pixels "
                "differing on the card from "
                + ", ".join(f"the {k} {v}" for k, v in apart.items())
                + " (each must be 0)")
    if min(worst.values()) < AGREE_MIN or mismatched or any(apart.values()):
        raise RuntimeError("main-path rasters out of contract")

    # the paint kernel's path: the kernel-strategy tool
    reset_all_launches()
    bench = bk.run(dev)
    bench_launches = all_launches()
    say("bench", f"cama_tpu_torch.tools.bench_kernels: {json.dumps(bench)}")
    say("bench", f"launches {bench_launches}")
    if bench_launches["paint_max"] < 1 or bench["paint"]["max_abs_err"] != 0:
        raise RuntimeError("bench_kernels did not run the paint kernel right")
    if not (bench["projection"]["keep_equal"]
            and bench["projection"]["vu_max_diff_px"] == 0
            and bench["compaction_6cam"]["all_equal"]):
        raise RuntimeError("bench_kernels' comparisons disagree")

    # ---- phase 4: times ----
    card = bk.card_line()
    per = 1.0 / CHUNK_TILED
    ms_k = time_ms(lambda: fc.fused_compact_project(*tiled, *geo, k_tiled))
    ms_r = time_ms(lambda: fc.fused_compact_project_ref(*tiled, *geo, k_tiled))
    ms_ck = time_ms(lambda: fc.count_union(*tiled, *geo))
    ms_cr = time_ms(lambda: fc.count_union_ref(*tiled, *geo))
    rows = int(fc.count_union(*tiled, *geo).clamp(max=k_tiled).sum())
    C_t = tiled[4].shape[1]
    inside = in_crop(tiled, geo)
    # 32-point groups (a warp's points) with any point the crop keeps
    groups = inside[:, :N_POINTS // 32 * 32].reshape(CHUNK_TILED, -1, 32)
    share_points = 100.0 * float(inside.float().mean())
    share_groups = 100.0 * float(groups.any(-1).float().mean())
    say("kernel", f"tiled scene: {share_points:.2f} % of the point-frames "
                  f"and {share_groups:.2f} % of the 32-point groups lie in "
                  f"the crop (valid points); union rows "
                  f"{rows / CHUNK_TILED:.1f} per frame")
    in_bytes, ops = projection_work(tiled, geo, kept=int(inside.sum()))
    # the compaction also reads every class id and writes the live rows
    bound_k, by_k, bk_b, bk_o = bound(in_bytes + N_POINTS * 4
                                      + rows * C_t * 4 + CHUNK_TILED * 4, ops)
    bound_c, by_c, bc_b, bc_o = bound(in_bytes + CHUNK_TILED * 4, ops)
    say("time", f"fused_compact_project at {N_POINTS} points: kernel "
                f"{ms_k * per:.4f} ms/frame (card alone "
                f"{fmt(dev_ms['fused_compact_project'], per)}), plain "
                f"{ms_r * per:.4f} ms/frame, bound {bound_k * per:.5f} "
                f"ms/frame ({by_k}; bytes {bk_b * per:.5f}, operations "
                f"{bk_o * per:.5f}); count_union: kernel {ms_ck * per:.4f} "
                f"(card alone {fmt(dev_ms['count_union'], per)}), plain "
                f"{ms_cr * per:.4f}, bound {bound_c * per:.5f} ms/frame "
                f"({by_c}; bytes {bc_b * per:.5f}, operations "
                f"{bc_o * per:.5f}) (chunk of {CHUNK_TILED}, median of "
                f"{bk.RUNS}) | {card}")
    ms_pk = time_ms(lambda: pp.project_frame_pallas(*proj_tiled, *geo))
    ms_pr = time_ms(lambda: pp.project_frame_pallas_ref(*proj_tiled, *geo))
    in_bytes, ops = projection_work(proj_tiled, geo)
    # every (v, u) pair and keep byte of every frame, camera and point out
    bound_p, by_p = bound(in_bytes + CHUNK_TILED * C_t * N_POINTS * 9, ops)[:2]
    say("time", f"project_frame_pallas at {N_POINTS} points: kernel "
                f"{ms_pk * per:.4f} ms/frame (card alone "
                f"{fmt(dev_ms['project_frame_pallas'], per)}), plain "
                f"{ms_pr * per:.4f} ms/frame, "
                f"bound {bound_p * per:.4f} ms/frame ({by_p}) (chunk of "
                f"{CHUNK_TILED}, median of {bk.RUNS}) | {card}")
    ms_ak = time_ms(lambda: paint.paint_max(*chunk_pts, h, w))
    ms_ar = time_ms(lambda: paint.paint_max_ref(*chunk_pts, h, w))
    # the library call: scatter_reduce_ amax onto a fresh -1 raster, from
    # the flat pixel indices (skipped points aimed at a spare column)
    py_, px_, prio_ = chunk_pts
    ok_ = prio_ >= 0
    flat = torch.where(ok_, py_ * w + px_, h * w).to(torch.int64)
    def library():
        return torch.full((n_img, h * w + 1), -1, dtype=torch.int32,
                          device=dev).scatter_reduce_(1, flat, prio_, "amax")

    ms_al = time_ms(library)
    ms_al_card = device_work(library)[1]
    bound_a, by_a = bound(3 * 4 * py_.numel() + n_img * h * w * 4,
                          int(ok_.sum()))[:2]
    say("time", f"paint_max, one 'pallas' chunk's survivor lists into "
                f"[{n_img}, {h}, {w}]: kernel {ms_ak:.4f} ms (card alone "
                f"{fmt(dev_ms['paint_max'], 1.0)}), plain "
                f"{ms_ar:.4f} ms, library (scatter_reduce_) {ms_al:.4f} ms "
                f"(card alone {fmt(ms_al_card, 1.0)}), "
                f"bound {bound_a:.4f} ms ({by_a}); probe: kernel "
                f"{bench['paint']['kernel_ns_per_point']:.4f} ns/point, plain "
                f"{bench['paint']['scatter_reduce_ns_per_point']:.4f} "
                f"ns/point | {card}")

    # each lane's device program, stage by stage, one chunk of CHUNK
    sl = slice(0, CHUNK)
    chunk_args = (st.points, st.valid, st.cls, st.A[sl], st.B[sl],
                  st.frame_valid[sl])
    vals, count = fc.fused_compact_project(*chunk_args, w, h, pipe._crop_lo,
                                           pipe._crop_hi, k_cap)
    packed = fc.rasterize_from_union(vals, count, w, h)
    cls_r = packed_to_cls(packed)
    stages = {
        "count_union (k sizing, once per chunk)": time_ms(
            lambda: fc.count_union(*chunk_args, w, h, pipe._crop_lo,
                                   pipe._crop_hi)),
        "fused_compact_project": time_ms(lambda: fc.fused_compact_project(
            *chunk_args, w, h, pipe._crop_lo, pipe._crop_hi, k_cap)),
        "rasterize_from_union": time_ms(
            lambda: fc.rasterize_from_union(vals, count, w, h)),
        "packed_to_cls": time_ms(lambda: packed_to_cls(packed)),
        "pack_cls_2bit": time_ms(lambda: pack_cls_2bit(cls_r)),
        "whole chunk": time_ms(lambda: tp._overlay_chunk_fused(
            *chunk_args, pipe._crop_lo, pipe._crop_hi, w, h, k_cap, True)),
    }
    for entry, fn in (
            ("count_union", lambda: fc.count_union(
                *chunk_args, w, h, pipe._crop_lo, pipe._crop_hi)),
            ("fused_compact_project", lambda: fc.fused_compact_project(
                *chunk_args, w, h, pipe._crop_lo, pipe._crop_hi, k_cap)),
            ("whole chunk", lambda: tp._overlay_chunk_fused(
                *chunk_args, pipe._crop_lo, pipe._crop_hi, w, h, k_cap,
                True))):
        stages[f"{entry} on the card alone (torch.profiler)"] = (
            device_work(fn)[1] or float("nan"))
    say("time", "'fused' device program, ms per chunk of "
                f"{CHUNK} frames at {st.points.shape[0]} points (CUDA events, "
                f"median of {bk.RUNS}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
                + f" | {card}")
    packed0 = rasterize_from_compact(vals0, w, h)
    pal_stages = {
        "project_frame_pallas": time_ms(
            lambda: pp.project_frame_pallas(*proj_args)),
        "compact_points": time_ms(
            lambda: compact_points(vu0, keep0, st.cls, w, h, k_pal)),
        "rasterize_from_compact": time_ms(
            lambda: rasterize_from_compact(vals0, w, h)),
        "packing (packed_to_cls + pack_cls_2bit)": time_ms(
            lambda: pack_cls_2bit(packed_to_cls(packed0))),
        "whole chunk": time_ms(lambda: tp._overlay_chunk_pallas(
            *chunk_args, pal._crop_lo, pal._crop_hi, w, h, k_pal, True)),
        "whole chunk on the card alone (torch.profiler)": device_work(
            lambda: tp._overlay_chunk_pallas(
                *chunk_args, pal._crop_lo, pal._crop_hi, w, h, k_pal,
                True))[1] or float("nan"),
    }
    say("time", "'pallas' device program, ms per chunk of "
                f"{CHUNK} frames at {st.points.shape[0]} points (CUDA events, "
                f"median of {bk.RUNS}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in pal_stages.items())
                + f" | {card}")

    rate, rates, split = stream_rates(pipe, "cama", pool, WINDOWS)
    n_frames, secs = paths["fused"][2:4]
    busy = device_busy_ms(lambda: run_stream(pipe, "cama", pool))
    busy_line = ("device busy share not measured (no device time in the "
                 "trace)" if busy is None else
                 f"device busy {busy / n_frames:.4f} ms/frame (torch.profiler, "
                 f"one pass) = {100.0 * busy / n_frames * rate / 1000.0:.2f} % "
                 f"of the median window's wall time")
    say("time", f"'fused' stream, warm, windows of >= {MIN_WINDOW_S} s: "
                f"{', '.join(f'{r:.2f}' for r in rates)} frames/s (median "
                f"{rate:.2f}); first run {n_frames / secs:.2f} frames/s "
                f"(counting pass and first-use allocations) | {card}")
    say("time", "host phase split of the last window, ms/frame: "
                + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                + f" | {busy_line} | {card}")
    p_rate, _, p_split = stream_rates(pal, "cama", pool, 1)
    p_frames, p_secs = paths["pallas"][2:4]
    say("time", f"'pallas' stream, warm, one window of >= {MIN_WINDOW_S} s: "
                f"{p_rate:.2f} frames/s; first run {p_frames / p_secs:.2f} "
                "frames/s; host phase split, ms/frame: "
                + ", ".join(f"{k} {v:.4f}" for k, v in p_split.items())
                + f" | {card}")
    pool.shutdown()

    loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split(".")[0] in ("jax", "jaxlib", "cama_tpu"))
    say("env", f"modules of jax or of the JAX package cama_tpu loaded: "
               f"{len(loaded)}")
    if loaded:
        raise RuntimeError(f"the port loaded jax or cama_tpu: {loaded[:5]}")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound_ms,
              bound_by, library_ms, launches_per_call, scale, **extra):
        card_ms = dev_ms[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms,
                "device_ms": None if card_ms is None else card_ms * scale,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
                "launches_per_call": launches_per_call,
                **extra}

    fused_src = "cama_tpu_torch/csrc/fused_compact.cu"
    print(card, flush=True)
    print(json.dumps({"kernels": [
        # times of the two projection kernels in ms per frame (chunk of 16
        # at 1,048,576 points); no single PyTorch call computes them.  ms:
        # CUDA events around one call, the host's enqueue included;
        # device_ms: the call's kernels and memsets alone (torch.profiler)
        entry("fused_compact_project", fused_src,
              "cama_tpu/ops/fused_compact.py:241",
              paths["fused"][4]["fused_compact_project"], fused_err,
              ms_k * per, ms_r * per, bound_k * per, by_k, None,
              launches_per_call["fused_compact_project"], per,
              unit="ms/frame"),
        # the same kernel without the writes, which sizes k on the main
        # path (the JAX package counts with XLA: pipeline.py:447)
        entry("count_union", fused_src, "cama_tpu/pipeline.py:447",
              paths["fused"][4]["count_union"], count_err, ms_ck * per,
              ms_cr * per, bound_c * per, by_c, None,
              launches_per_call["count_union"], per, unit="ms/frame"),
        entry("project_frame_pallas", "cama_tpu_torch/csrc/pallas_project.cu",
              "cama_tpu/ops/pallas_project.py:82",
              paths["pallas"][4]["project_frame_pallas"], pp_err,
              ms_pk * per, ms_pr * per, bound_p * per, by_p, None,
              launches_per_call["project_frame_pallas"], per,
              unit="ms/frame"),
        # its path is the kernel-strategy tool; ms per call at the main
        # path's shape (one chunk's survivor lists), the probe's ns per
        # point beside it
        entry("paint_max", "cama_tpu_torch/csrc/paint_max.cu",
              "tools/bench_pallas.py:148", bench_launches["paint_max"],
              paint_err, ms_ak, ms_ar, bound_a, by_a, ms_al,
              launches_per_call["paint_max"], 1.0, unit="ms/call",
              library_device_ms=ms_al_card,
              probe_ns_per_point=bench["paint"]["kernel_ns_per_point"],
              probe_plain_ns_per_point=
              bench["paint"]["scatter_reduce_ns_per_point"])]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
