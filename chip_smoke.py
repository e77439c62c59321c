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
     and read just after, each frame composited into the 3x2 mosaic by the
     native compositor over a 6-thread pool (as write_videos does) onto
     black base images:
     - the main path, the mode write_videos serves: ClipPipeline(
       raster_kernel='auto', device='cuda').serving_mode, which is 'sparse'
       on the wide fixture (the JAX package's decision, held here), then
       iter_sparse_points over every frame of 'cama' and the host paint of
       the lists; the lists held on the card against the plain program
       (fused_compact_project_ref, then sparse_from_union) and the
       'pallas' and 'compact' lanes' sparse programs (exact), the mosaics
       against the dense path's (byte for byte) and the float64 host
       lane's (>= 0.99999 per frame);
     - iter_overlay_rasters, the dense path, raster_kernel 'fused' and then
       'pallas'; rasters held against the float64 host lane (>= 0.99999 per
       frame), against the plain versions' programs on the card and against
       each other (exact); the 'compact' lane, which goes two-stage here,
       against 'fused' (exact);
     - MultiScenePipeline over the wide and the default fixture, both
       sources, every raster equal to its scene's solo raster (exact);
     - the kernel-strategy tool (cama_tpu_torch.tools.bench_kernels), the
       path of paint_max;
  4. times: kernels, plain versions and library calls (CUDA events, median
     of 20 runs after warm-up) beside each kernel's bound on this run's
     inputs; per-chunk device time of each stage of the sparse program and
     of both lanes' dense programs, the lists' copy to the host and the
     host paint of a frame (sparse lists against 2-bit rasters); frames/s
     of the streams over windows of at least MIN_WINDOW_S seconds (three
     for the main path, one for each other stream), with the host phase
     split and the device busy share (torch.profiler).

  5. the correctness path (cama_tpu_torch.validate), all on the wide
     fixture's 'cama' source:
     - the error-free-transform probe on the card: _df_dot4 on the triple
       that exposed a compiler's rewrite, within 1e-7 relative of the
       float64 sum, and _two_prod / _two_sum exact on seeded data;
     - the exact lane: ClipPipeline(raster_kernel='compact').
       iter_overlay_rasters_exact, every frame's class raster byte-equal to
       the float64 anchor that needs no cv2 (validate.host_exact_rasters:
       project_frame_exact per frame, floored, painted by
       rasterize_cls_host); prints the flagged points per frame, the patch
       size M, the lane's phase split, project_frames_checked's ms per
       chunk (CUDA events, and the card alone), its device launches per
       frame and the lane's peak device memory;
     - the agreement matrix: each of validate.DEVICE_PATHS forced through
       validate.forced_path_stream, its minimum per-frame agreement with
       that anchor ('exact' must be 1.0, the others >= AGREE_MIN); 'fused'
       must launch fused_compact_project and 'pallas' project_frame_pallas,
       and no kernel's plain version may run;
     - when cv2 imports: validate.main on the default fixture with images,
       its JSON report printed, ok required (the report needs cv2 to read
       and paint images; without it only this sub-phase is left out, and
       the line says so);
     - the counts sidecar: a second pipeline on the clip decides the same
       mode with 0 counting launches; time to the first frame's lists with
       and without the sidecar;
     - a measurement that no path of the port uses: a float64 projection on
       the card in project_frame_exact's op order (matmul, and elementwise)
       against the host chain's keep bits and pixel floors, with its time.

Pipelines of phases 2-4 that are expected to run the counting pass first
delete the clip's counts sidecar (forget_counts).

The last two lines are the kernels' JSON record and the result line.  The
script fails if any module of jax or of the JAX package cama_tpu was
loaded.  Needs numpy and torch with CUDA, nvcc and g++; no yaml or ffmpeg,
and cv2 only for the one sub-phase named above.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
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


def black_bases(pipe):
    """({camera: black [H, W, 3] base image}, an empty mosaic) of a
    pipeline's scene (the fixture clip has no JPEGs)."""
    import numpy as np

    h, w = pipe.scene.output_size
    return ({cam: np.zeros((h, w, 3), np.uint8)
             for cam in pipe.scene.camera_list},
            np.empty((2 * h, 3 * w, 3), np.uint8))


def composite(pipe, source, idx, payload, kind, base, mosaic, pool):
    """One frame into the mosaic by the native compositor (required)."""
    if not pipe.composite_mosaic_frame(source, idx, payload, kind, base,
                                       mosaic, pool=pool):
        raise RuntimeError("the native mosaic compositor is unavailable")


def run_stream(pipe, source, pool, rasters=None, mosaics=None,
               min_seconds=0.0):
    """The dense path as write_videos runs it, less decode and encode:
    iter_overlay_rasters, then the native mosaic compositor over `pool`
    onto black base images.  Passes over the clip repeat until
    `min_seconds` have elapsed; the first pass's rasters and mosaics go
    into the given dicts.  Returns (frames, seconds, mosaic)."""
    from cama_tpu_torch.ops.raster import unpack_cls_2bit

    w = pipe.scene.output_size[1]
    base, mosaic = black_bases(pipe)
    n = 0
    t0 = time.perf_counter()
    while True:
        for idx, raster in pipe.iter_overlay_rasters(source, unpack=False):
            with pipe.timers.phase("host_composite"):
                composite(pipe, source, idx, raster, "raster", base, mosaic,
                          pool)
            if rasters is not None:
                rasters[idx] = (raster if raster.shape[-1] == w
                                else unpack_cls_2bit(raster, w))
            if mosaics is not None:
                mosaics[idx] = mosaic.copy()
            n += 1
        rasters = mosaics = None
        secs = time.perf_counter() - t0
        if secs >= min_seconds:
            return n, secs, mosaic


def run_sparse_stream(pipe, source, pool, lists=None, mosaics=None,
                      min_seconds=0.0):
    """The main path as write_videos runs it for a scene that serves
    sparse, less decode and encode: serving_mode, iter_sparse_points, then
    each camera's list painted by the native compositor into its mosaic
    slot over `pool`, onto black base images; a frame whose list overflows
    is painted from its dense raster (_overlay_single), as write_videos
    does.  Passes repeat until `min_seconds` have elapsed; the first
    pass's lists and mosaics go into the given dicts.
    Returns (frames, seconds, mosaic)."""
    mode, k = pipe.serving_mode(source)
    if mode != "sparse":
        raise RuntimeError(f"{source} serves {mode}, not sparse")
    base, mosaic = black_bases(pipe)
    n = 0
    t0 = time.perf_counter()
    while True:
        for idx, vals, counts in pipe.iter_sparse_points(source, k=k):
            with pipe.timers.phase("host_composite"):
                if counts.max() > vals.shape[-1]:
                    pipe.timers.add("sparse_overflow", 0.0)
                    composite(pipe, source, idx,
                              pipe._overlay_single(source, idx), "raster",
                              base, mosaic, pool)
                else:
                    composite(pipe, source, idx, (vals, counts), "sparse",
                              base, mosaic, pool)
            if lists is not None:
                lists[idx] = (vals, counts)
            if mosaics is not None:
                mosaics[idx] = mosaic.copy()
            n += 1
        lists = mosaics = None
        secs = time.perf_counter() - t0
        if secs >= min_seconds:
            return n, secs, mosaic


def run_batched_stream(msp, sources, pool, rasters=None, min_seconds=0.0):
    """MultiScenePipeline as its write_videos runs it, less decode and
    encode: iter_frame_groups over `sources`, each raster composited into
    its scene's mosaic.  Returns (video-frames over every scene and
    source, seconds); the first pass's rasters go into `rasters`, keyed
    (scene, source, image_idx)."""
    from cama_tpu_torch.ops.raster import unpack_cls_2bit

    w = msp.pipelines[0].scene.output_size[1]
    base, mosaic = black_bases(msp.pipelines[0])
    n = 0
    t0 = time.perf_counter()
    while True:
        for si, idx, by_src in msp.iter_frame_groups(sources, unpack=False):
            pipe = msp.pipelines[si]
            for src, raster in by_src.items():
                with msp.timers.phase("host_composite"):
                    composite(pipe, src, idx, raster, "raster", base, mosaic,
                              pool)
                if rasters is not None:
                    rasters[(si, src, idx)] = (
                        raster if raster.shape[-1] == w
                        else unpack_cls_2bit(raster, w))
                n += 1
        rasters = None
        secs = time.perf_counter() - t0
        if secs >= min_seconds:
            return n, secs


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


def busy_share(busy_ms, n_frames, rate):
    """The device busy line of one traced pass of n_frames, against the
    wall time per frame at `rate` frames/s."""
    if busy_ms is None:
        return "device busy share not measured (no device time in the trace)"
    per = busy_ms / n_frames
    return (f"device busy {per:.4f} ms/frame (torch.profiler, one pass) = "
            f"{100.0 * per * rate / 1000.0:.2f} % of the median window's "
            "wall time")


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


def stream_rates(pipe, source, pool, windows, runner=run_stream):
    """Median frames/s over `windows` warm windows of >= MIN_WINDOW_S of
    runner (run_stream or run_sparse_stream), the rates, and the host
    phase split of the last window (ms/frame)."""
    rates, split = [], {}
    for _ in range(windows):
        pipe.timers = type(pipe.timers)()
        n, secs, _ = runner(pipe, source, pool, min_seconds=MIN_WINDOW_S)
        rates.append(n / secs)
        split = {k: 1000.0 * v / n for k, v in pipe.timers.total.items()}
    return statistics.median(rates), rates, split


def host_paint_ms(pipe, source, payloads, kind, pool, passes=3):
    """Median wall ms of composite_mosaic_frame over the frames of
    `payloads` ({image_idx: payload}), `passes` times each."""
    base, mosaic = black_bases(pipe)
    times = []
    for _ in range(passes):
        for idx, payload in payloads.items():
            t0 = time.perf_counter()
            composite(pipe, source, idx, payload, kind, base, mosaic, pool)
            times.append(1000.0 * (time.perf_counter() - t0))
    return statistics.median(times)


def forget_counts(clip):
    """Delete the clip's counts sidecar, so the next pipeline on it runs the
    counting pass."""
    path = os.path.join(clip, ".cama_tpu", "overlay_counts.json")
    if os.path.exists(path):
        os.remove(path)


def valid_ids(pipe, source):
    fm = pipe.frame_matrices(source)
    return {int(i) for i, v in zip(fm.frame_indices, fm.frame_valid) if v}


def eft_probe(dev):
    """The error-free transforms on the card.  Returns (relative error of
    _df_dot4's s + e on the probe triple against the float64 sum, entries of
    seeded data where _two_prod's p + e is not the float64 product exactly,
    the same for _two_sum)."""
    import numpy as np
    import torch

    from cama_tpu_torch.ops import geometry as tg

    row = np.array([[612.9723510742188, -664.3383178710938,
                     -0.1483260989189148, 5025.9521484375],
                    [1.0, 2.0, 3.0, 4.0], [0.1, 0.2, 0.3, 0.4]], np.float32)
    p4 = np.array([-257.9800109863281, -243.37962341308594,
                   0.07289975136518478, 1.0], np.float32)
    s, e = tg._df_dot4(torch.from_numpy(row).to(dev),
                       torch.from_numpy(p4).to(dev))
    want = float(np.sum(row[0].astype(np.float64) * p4.astype(np.float64)))
    rel = abs(float(s[0]) + float(e[0]) - want) / abs(want)
    rng = np.random.default_rng(11)
    a = (rng.normal(size=1 << 20) * 50.0).astype(np.float32)
    b = (rng.normal(size=1 << 20) * 7.0).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    bad = []
    for fn, want in ((tg._two_prod, a.astype(np.float64) * b),
                     (tg._two_sum, a.astype(np.float64) + b)):
        v, err = fn(ta, tb)
        got = v.cpu().numpy().astype(np.float64) + err.cpu().numpy()
        bad.append(int((got != want).sum()))
    return rel, bad[0], bad[1]


def lists_to_raster(vals, counts, width, height):
    """Sparse lists (vals [C, k] encodings in paint order, counts [C]) ->
    the class raster [C, H, W] uint8 they paint, by rasterize_cls_host."""
    import numpy as np

    from cama_tpu_torch.ops.raster import MAX_CLS
    from cama_tpu_torch.pipeline import rasterize_cls_host

    out = []
    for c in range(vals.shape[0]):
        enc = vals[c, :int(counts[c])]
        pix = enc // MAX_CLS
        vu = np.stack([pix // width, pix % width], -1).astype(np.float32)
        out.append(rasterize_cls_host(vu[None], np.ones((1, len(enc)), bool),
                                      enc % MAX_CLS, width, height)[0])
    return np.stack(out)


def f64_on_card(pipe, source, dev, card):
    """An open question measured, not a path of the port: does a float64
    projection on the card, in project_frame_exact's op order, give the
    host chain's keep bits and pixel floors?  Two variants per frame: the
    matrix products as torch.matmul (cuBLAS), and as elementwise
    ((m0*x + m1*y) + m2*z) + m3 rows.  Prints, over every valid frame, the
    point-cameras whose keep bit differs from the host's and the kept ones
    whose floor differs, and the ms per chunk of CHUNK frames."""
    import numpy as np
    import torch

    from cama_tpu_torch.ops.geometry import project_frame_exact
    from cama_tpu_torch.ops.lift import CROP_BOX as crop
    from cama_tpu_torch.tools.bench_kernels import time_ms

    scene, fm = pipe.scene, pipe.frame_matrices(source)
    fp = scene.flat[source]
    h, w = scene.output_size
    f64 = dict(dtype=torch.float64, device=dev)
    pts = torch.from_numpy(fp.points).to(**f64)
    ph = torch.cat([pts, torch.ones((len(pts), 1), **f64)], dim=-1)
    c2c = torch.from_numpy(scene.chassis2cam).to(**f64)
    K = torch.from_numpy(scene.K_scaled).to(**f64)

    def rows(m, x):
        """m [R, 4 or 3] applied to x [P, 4 or 3], summed left to right."""
        acc = m[:, 0, None] * x[:, 0]
        for j in range(1, m.shape[1]):
            acc = acc + m[:, j, None] * x[:, j]
        return acc.T

    def frame(A64, matmul):
        mm = (lambda m, x: (m @ x.T).T) if matmul else rows
        chassis = mm(A64, ph)[:, :3]
        m = ((chassis[:, 0] >= crop["x_min"]) & (chassis[:, 0] <= crop["x_max"])
             & (chassis[:, 1] >= crop["y_min"]) & (chassis[:, 1] <= crop["y_max"])
             & (chassis[:, 2] >= crop["z_min"]) & (chassis[:, 2] <= crop["z_max"]))
        ch_h = torch.cat([chassis, torch.ones((len(chassis), 1), **f64)], -1)
        vus, keeps = [], []
        for c in range(len(c2c)):
            proj = mm(K[c], mm(c2c[c], ch_h)[:, :3])
            div = proj / proj[:, 2:]
            keeps.append(m & (proj[:, 2] > 0) & (div[:, 2] > 0)
                         & (div[:, 0] >= 0) & (div[:, 0] < w)
                         & (div[:, 1] >= 0) & (div[:, 1] < h))
            vus.append(div[:, [1, 0]])
        return torch.stack(vus), torch.stack(keeps)

    frames = [k for k in range(len(fm.frame_indices)) if fm.frame_valid[k]]
    A64s = [torch.from_numpy(np.linalg.inv(fm.chassis2world_f32[k]))
            .to(**f64) for k in frames]
    result = {}
    for label, matmul in (("matmul (cuBLAS)", True), ("elementwise", False)):
        keep_diff = floor_diff = total = 0
        for k, A64 in zip(frames, A64s):
            vu_d, keep_d = (t.cpu().numpy() for t in frame(A64, matmul))
            host = project_frame_exact(
                fp.points, np.linalg.inv(fm.chassis2world_f32[k]),
                scene.chassis2cam, scene.K_scaled, w, h)
            for c, (vu_h, keep_h) in enumerate(host):
                keep_diff += int((keep_d[c] != keep_h).sum())
                both = keep_d[c] & keep_h
                floor_diff += int((np.floor(vu_d[c][both])
                                   != np.floor(vu_h[both])).any(-1).sum())
                total += len(keep_h)
        ms = time_ms(lambda: [frame(A64, matmul) for A64 in A64s[:CHUNK]],
                     runs=5)
        result[label] = (keep_diff, floor_diff, total, ms)
    say("exact", "float64 on the card in project_frame_exact's op order "
                 f"(measurement only; the exact lane does not use it), "
                 f"{len(frames)} frames of {len(pts)} points: "
                 + "; ".join(
                     f"{label}: keep bits differing from the host chain's "
                     f"{kd}, floors differing among the kept {fd}, of {n} "
                     f"point-cameras, {ms:.3f} ms per chunk of {CHUNK} frames"
                     for label, (kd, fd, n, ms) in result.items())
                 + f" | {card}")


def correctness_phase(clip, dev, card):
    """Phase 5 (module docstring).  Raises on any failed check."""
    import numpy as np
    import torch

    from cama_tpu_torch import pipeline as tp
    from cama_tpu_torch import validate
    from cama_tpu_torch.io.fixture import make_fixture_clip
    from cama_tpu_torch.ops import fused_compact as fc
    from cama_tpu_torch.ops import geometry as tg
    from cama_tpu_torch.ops import paint
    from cama_tpu_torch.ops import pallas_project as pp
    from cama_tpu_torch.tools.bench_kernels import time_ms

    rel, bad_prod, bad_sum = eft_probe(dev)
    say("exact", f"error-free transforms on the card: _df_dot4 probe s + e "
                 f"off the float64 sum by {rel:.3e} relative (< 1e-7); "
                 f"_two_prod inexact on {bad_prod}, _two_sum on {bad_sum} of "
                 f"1048576 seeded pairs (each must be 0)")
    if not rel < 1e-7 or bad_prod or bad_sum:
        raise RuntimeError("an error-free transform is not exact on the card")

    # ---- the exact lane at full width ----
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pipe = tp.ClipPipeline(clip_path=clip, chunk=CHUNK,
                           raster_kernel="compact", device=dev)
    h, w = pipe.scene.output_size
    ids = valid_ids(pipe, "cama")
    t0 = time.perf_counter()
    exact = dict(pipe.iter_overlay_rasters_exact("cama"))
    first_secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    stats = list(pipe.exact_stats)
    pipe.timers = type(pipe.timers)()
    t0 = time.perf_counter()
    again = dict(pipe.iter_overlay_rasters_exact("cama"))
    warm_secs = time.perf_counter() - t0
    split = {k: 1000.0 * v / len(stats) for k, v in pipe.timers.total.items()}
    t0 = time.perf_counter()
    anchor = validate.host_exact_rasters(pipe, "cama", ids)
    anchor_secs = time.perf_counter() - t0
    apart = pixels_apart(exact, anchor) + pixels_apart(again, anchor)
    flagged = [n for s in stats for n in s["flagged"]]
    P = int(pipe.scene.flat["cama"].points.shape[0])
    say("exact", f"exact lane, wide fixture 'cama' ({P} points, {len(exact)} "
                 f"frames, chunk {CHUNK}, {w}x{h}): pixels differing from the "
                 f"float64 anchor (project_frame_exact + rasterize_cls_host, "
                 f"{anchor_secs:.2f} s on the host) {apart} over two passes "
                 f"(must be 0); flagged points per frame max {max(flagged)}, "
                 f"mean {statistics.mean(flagged):.2f}, "
                 f"{100.0 * statistics.mean(flagged) / P:.4f} % of the "
                 f"points; patch size M {sorted({s['M'] for s in stats})}; "
                 f"list size {pipe.overlay_mode('cama')[1]} + M")
    if apart or set(exact) != ids or not all(r.any() for r in exact.values()):
        raise RuntimeError("the exact lane is not bit-exact")
    st = pipe.scene_tensors("cama")
    B_lo = torch.from_numpy(pipe.exact_B_lo("cama")).to(dev)
    sl = slice(0, CHUNK)

    def checked():
        return tg.project_frames_checked(
            st.points, st.valid, st.A[sl], st.B[sl], B_lo[sl],
            st.frame_valid[sl], w, h, pipe._crop_lo, pipe._crop_hi)

    ms_checked = time_ms(checked, runs=5)
    seen, card_ms = device_work(checked, reps=2)
    n_chunks = len(stats)
    say("exact", f"project_frames_checked, one chunk of {CHUNK} frames: "
                 f"{ms_checked:.3f} ms by CUDA events (median of 5), "
                 f"{fmt(card_ms, 1.0)} ms on the card alone, "
                 + ("launches not measured" if seen is None else
                    f"{sum(seen.values())} device launches = "
                    f"{sum(seen.values()) / CHUNK:.1f} a frame")
                 + f"; the whole lane {1000.0 * warm_secs / n_chunks:.3f} ms "
                 f"a chunk warm (wall; first pass "
                 f"{1000.0 * first_secs / n_chunks:.3f}), phase split "
                 f"ms/chunk: "
                 + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                 + f"; peak device memory of the lane "
                 f"{peak / 2**20:.1f} MiB, of which {resident / 2**20:.1f} "
                 f"MiB were resident before it | {card}")

    # ---- the agreement matrix ----
    plain_calls = {}
    originals = [(fc, "fused_compact_project_ref"), (fc, "count_union_ref"),
                 (pp, "project_frame_pallas_ref"), (paint, "paint_max_ref")]

    def counted(mod, name):
        real = getattr(mod, name)

        def call(*a, **k):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return real(*a, **k)

        return real, call

    reals = []
    for mod, name in originals:
        real, call = counted(mod, name)
        reals.append((mod, name, real))
        setattr(mod, name, call)
    matrix, launched = {}, {}
    try:
        for name in validate.DEVICE_PATHS:
            reset_all_launches()
            _, kind, stream = validate.forced_path_stream(
                pipe.scene, name, "cama", CHUNK, dev)
            rasters = {idx: (payload[0] if kind == "raster"
                             else lists_to_raster(*payload, w, h))
                       for idx, *payload in stream}
            if set(rasters) != ids:
                raise RuntimeError(f"path {name!r} yields other frames")
            matrix[name] = min(float((rasters[i] == anchor[i]).mean())
                               for i in ids)
            launched[name] = all_launches()
    finally:
        for mod, name, real in reals:
            setattr(mod, name, real)
    say("exact", "agreement matrix, min per-frame agreement of each path's "
                 "class rasters with the float64 anchor: "
                 + ", ".join(f"{k} {v:.10f}" for k, v in matrix.items())
                 + f" ('exact' must be 1.0, the others >= {AGREE_MIN}); "
                 f"launches 'fused' {launched['fused']}, 'pallas' "
                 f"{launched['pallas']}; plain versions of kernels run: "
                 f"{plain_calls or 0} (must be 0)")
    if matrix["exact"] != 1.0 or min(matrix.values()) < AGREE_MIN:
        raise RuntimeError("a path disagrees with the float64 anchor")
    if (launched["fused"]["fused_compact_project"] < n_chunks
            or launched["fused"]["project_frame_pallas"]
            or launched["pallas"]["project_frame_pallas"] < n_chunks
            or launched["pallas"]["fused_compact_project"] or plain_calls):
        raise RuntimeError("'fused' or 'pallas' did not run its own kernel")

    # ---- validate.main with images, where cv2 is installed ----
    if importlib.util.find_spec("cv2") is None:
        say("exact", "cv2 is not installed: validate.main (the image-level "
                     "report) not run; the raster-level checks above ran")
    else:
        img_clip = make_fixture_clip(os.path.join(WORK, "validate"),
                                     scene_name="scene-validate", n_frames=6)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = validate.main(["--clip", img_clip, "--frames", "3",
                                "--device", DEVICE])
        report = json.loads(out.getvalue().strip().splitlines()[-1])
        say("exact", f"cv2 present: validate.main on the default fixture with "
                     f"images, 3 frames a source, "
                     f"{time.perf_counter() - t0:.2f} s, exit code {rc}: "
                     f"{json.dumps(report)}")
        if rc != 0 or report.get("ok") is not True \
                or report.get("exact_lane_min_agreement") != 1.0:
            raise RuntimeError("validate.main reports a failure")

    # ---- the counts sidecar ----
    first_ms = {"without": [], "with": []}
    for _ in range(3):
        forget_counts(clip)
        seen_launches, decisions = {}, {}
        for label in ("without", "with"):
            reset_all_launches()
            p = tp.ClipPipeline(clip_path=clip, chunk=CHUNK,
                                raster_kernel="auto", device=dev)
            p.scene_tensors("cama")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mode, k = p.serving_mode("cama")
            head = next(iter(p.iter_sparse_points("cama", k=k)))
            first_ms[label].append(1000.0 * (time.perf_counter() - t0))
            seen_launches[label] = all_launches()
            decisions[label] = ((mode, k), p._fused_k["cama"],
                                p._two_stage["cama"], p._k["cama"],
                                head[0], int(head[2].max()))
        want = {"without": {"count_union": n_chunks,
                            "fused_compact_project": 2 * n_chunks},
                "with": {"count_union": 0,
                         "fused_compact_project": n_chunks}}
        for label, expect in want.items():
            got = {k: seen_launches[label][k] for k in expect}
            if got != expect:
                raise RuntimeError(f"sidecar: {label} it, launches {got} != "
                                   f"{expect}")
        if decisions["with"] != decisions["without"]:
            raise RuntimeError(f"sidecar: decisions differ: {decisions}")
    say("exact", f"counts sidecar: a second pipeline decides "
                 f"{decisions['with'][:4]} as the first did, with 0 "
                 f"count_union launches and {n_chunks} fused_compact_project "
                 f"(the first: {n_chunks} and {2 * n_chunks}); serving_mode "
                 f"to the first frame's lists on the host, ms, 3 runs each: "
                 f"without the sidecar "
                 + " / ".join(f"{t:.3f}" for t in first_ms["without"])
                 + ", with it "
                 + " / ".join(f"{t:.3f}" for t in first_ms["with"])
                 + f" | {card}")
    f64_on_card(pipe, "cama", dev, card)


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
        from cama_tpu_torch.io.fixture import make_fixture_clip
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
    lo, hi = probe._crop_lo, probe._crop_hi

    # the main path: the mode write_videos serves, with 'auto' (the CLI's
    # default lane)
    reset_all_launches()
    forget_counts(clip)
    sp = ClipPipeline(clip_path=clip, chunk=CHUNK, raster_kernel="auto",
                      device=dev)
    sp_lists, sp_mosaics = {}, {}
    sp_frames, sp_secs, _ = run_sparse_stream(sp, "cama", pool, sp_lists,
                                              sp_mosaics)
    sp_launches = all_launches()
    mode, k_sp = sp.serving_mode("cama")
    ku, k1 = sp._fused_k["cama"], sp._two_stage["cama"]
    say("main", f"main path, raster_kernel 'auto': serving_mode ('{mode}', "
                f"{k_sp}), union cap {ku}, two-stage split {k1}; "
                f"{sp_frames} frames of 'cama' in {sp_secs:.3f} s, counting "
                f"pass included; sparse overflows "
                f"{sp.timers.count.get('sparse_overflow', 0)}; launches "
                f"{sp_launches}")
    # the JAX package's decision on this fixture (tests/test_torch_sparse.py)
    if ((mode, k_sp), ku, k1) != (("sparse", 4096), 8192, 65536):
        raise RuntimeError("the serving decision differs from the JAX "
                           "package's on the wide fixture")
    want = {"fused_compact_project": 2 * n_chunks, "count_union": n_chunks,
            "project_frame_pallas": 0, "paint_max": 0}
    if sp_launches != want or sp.timers.count.get("sparse_overflow"):
        raise RuntimeError(f"main-path launches {sp_launches} != {want} "
                           f"({n_chunks} chunks: count_union and one "
                           "fused_compact_project in the counting pass, one "
                           "fused_compact_project to serve), or a list "
                           "overflowed")

    paths = {}
    for lane in ("fused", "pallas"):
        reset_all_launches()
        forget_counts(clip)
        pipe = ClipPipeline(clip_path=clip, chunk=CHUNK, raster_kernel=lane,
                            device=dev)
        streamed, mosaics = {}, {}
        n_frames, secs, mosaic = run_stream(pipe, "cama", pool, streamed,
                                            mosaics)
        launches = all_launches()
        paths[lane] = (pipe, streamed, n_frames, secs, launches, mosaics)
        say("main", f"dense path, '{lane}' lane: {n_frames} frames of 'cama' "
                    f"({int(pipe.scene.flat['cama'].valid.sum())} points, "
                    f"chunk {CHUNK}, list size {pipe._k['cama']}, "
                    f"{POOL_THREADS} compositor threads) in {secs:.3f} s, "
                    f"counting pass included; launches {launches}")
        if mosaic.shape != (2 * h, 3 * w, 3) or n_frames < 2:
            raise RuntimeError(f"bad stream: {n_frames} frames, {mosaic.shape}")
    expect = {"fused": {"fused_compact_project": 2 * n_chunks,
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
    k_cap = pipe._k["cama"]
    st = pipe.scene_tensors("cama")
    fm, _, _, _, F = pipe._chunked_AB("cama")
    mismatched = 0
    for s in range(0, st.A.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        vals, count = fc.fused_compact_project_ref(
            st.points, st.valid, st.cls, st.A[sl], st.B[sl],
            st.frame_valid[sl], w, h, lo, hi, k_cap)
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
    k_pal = pal._k["cama"]
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

    # the main path's lists against the plain program and the other lanes'
    # sparse programs on the card, chunk by chunk; its mosaics against the
    # dense path's and the host lane's
    list_apart = {"plain program (fused_compact_project_ref, then "
                  "sparse_from_union)": 0, "'pallas' sparse program": 0,
                  "'compact' sparse program": 0, "streamed lists": 0}
    for s in range(0, st.A.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        args = (st.points, st.valid, st.cls, st.A[sl], st.B[sl],
                st.frame_valid[sl])
        got_v, got_n, union = tp._project_compact_chunk(
            *args, lo, hi, w, h, k_sp, lane="fused", k_cap=ku)
        u_ref, c_ref = fc.fused_compact_project_ref(*args, w, h, lo, hi, ku)
        refs = {"plain": (*fc.sparse_from_union(u_ref, c_ref, k_sp), c_ref)}
        for lane in ("pallas", "compact"):
            refs[lane] = tp._project_compact_chunk(*args, lo, hi, w, h, k_sp,
                                                   lane=lane)
        for label, (rv, rn, _) in zip(list_apart, refs.values()):
            list_apart[label] += (int((got_v != rv).sum())
                                  + int((got_n != rn).sum()))
        list_apart["plain program (fused_compact_project_ref, then "
                   "sparse_from_union)"] += int((union != c_ref).sum())
        got_v, got_n = got_v.cpu().numpy(), got_n.cpu().numpy()
        for j in range(got_v.shape[0]):
            if s + j < F and fm.frame_valid[s + j]:
                v, n = sp_lists[int(fm.frame_indices[s + j])]
                list_apart["streamed lists"] += (int((v != got_v[j]).sum())
                                                 + int((n != got_n[j]).sum()))
    dense_mosaics = paths["fused"][5]
    mosaic_apart = pixels_apart(sp_mosaics, dense_mosaics)
    base, host_mosaic = black_bases(sp)
    worst["sparse"] = 1.0
    for idx, raster in host.items():
        composite(sp, "cama", idx, raster, "raster", base, host_mosaic, pool)
        worst["sparse"] = min(worst["sparse"], float(
            (sp_mosaics[idx] == host_mosaic).all(-1).mean()))
    say("main", "main path: list entries and counts differing on the card "
                "from the "
                + ", ".join(f"{k} {v}" for k, v in list_apart.items())
                + f" (each must be 0); mosaic bytes differing from the dense "
                f"'fused' path's {mosaic_apart} (must be 0); agreement vs "
                f"host float64 lane: min {worst['sparse']:.10f} of the "
                f"pixels per frame (>= {AGREE_MIN})")
    if any(list_apart.values()) or mosaic_apart or worst["sparse"] < AGREE_MIN:
        raise RuntimeError("main-path lists or mosaics out of contract")

    # the 'compact' lane goes two-stage on this scene (k1 = 65536): its
    # rasters against the 'fused' lane's
    staged = []
    two_stage = tp._overlay_chunk_two_stage

    def counted_two_stage(*a):
        staged.append(a[-3:-1])
        return two_stage(*a)

    tp._overlay_chunk_two_stage = counted_two_stage
    try:
        cmp_pipe = ClipPipeline(clip_path=clip, chunk=CHUNK,
                                raster_kernel="compact", device=dev)
        cmp_rasters = dict(cmp_pipe.iter_overlay_rasters("cama"))
    finally:
        tp._overlay_chunk_two_stage = two_stage
    cmp_apart = pixels_apart(cmp_rasters, streamed)
    say("main", f"'compact' lane: two-stage split {cmp_pipe._two_stage['cama']}"
                f", chunks served two-stage {len(staged)} at (k1, k2) "
                f"{sorted(set(staged))}; pixels differing from the 'fused' "
                f"lane {cmp_apart} (must be 0)")
    if (cmp_pipe._two_stage["cama"] != 65536 or len(staged) != n_chunks
            or cmp_apart):
        raise RuntimeError("the 'compact' lane's two-stage path is out of "
                           "contract")

    # MultiScenePipeline over the wide and the default fixture, both sources
    default_clip = make_fixture_clip(
        os.path.join(WORK, "default"), scene_name="scene-default",
        with_images=False)
    reset_all_launches()
    forget_counts(clip)
    members = [ClipPipeline(clip_path=c, chunk=CHUNK, device=dev)
               for c in (clip, default_clip)]
    msp = tp.MultiScenePipeline(members, chunk=CHUNK)
    sources = ["cama", "nuscenes"]
    batched = {}
    b_frames, b_secs = run_batched_stream(msp, sources, pool, batched)
    b_launches = all_launches()
    chunks = {src: [m.scene_tensors(src).A.shape[0] // CHUNK for m in members]
              for src in sources}
    want = {"fused_compact_project": sum(sum(n) + len(n) * max(n)
                                         for n in chunks.values()),
            "count_union": sum(sum(n) for n in chunks.values()),
            "project_frame_pallas": 0, "paint_max": 0}
    b_apart = 0
    for si, member in enumerate(members):
        for src in sources:
            solo = dict(member.iter_overlay_rasters(src))
            got = {idx: r for (i, s_, idx), r in batched.items()
                   if i == si and s_ == src}
            b_apart += pixels_apart(got, solo)
    say("main", f"MultiScenePipeline, wide + default fixture "
                f"({', '.join(str(int(m.scene.flat['cama'].valid.sum())) for m in members)}"
                f" 'cama' points), both sources: {b_frames} video-frames in "
                f"{b_secs:.3f} s, counting passes included; launches "
                f"{b_launches} (expected {want}); pixels differing from the "
                f"solo rasters {b_apart} (must be 0)")
    if b_launches != want or b_apart:
        raise RuntimeError("MultiScenePipeline out of contract")

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

    # the main path's sparse program, stage by stage, one chunk of CHUNK
    union_v, union_c = fc.fused_compact_project(*chunk_args, w, h, lo, hi, ku)
    lists_v, lists_n = fc.sparse_from_union(union_v, union_c, k_sp)
    host_v = torch.empty(lists_v.shape, dtype=lists_v.dtype, pin_memory=True)
    host_n = torch.empty(lists_n.shape, dtype=lists_n.dtype, pin_memory=True)
    host_u = torch.empty(union_c.shape, dtype=union_c.dtype, pin_memory=True)

    def fetch_lists():
        host_v.copy_(lists_v, non_blocking=True)
        host_n.copy_(lists_n, non_blocking=True)
        host_u.copy_(union_c, non_blocking=True)

    def sparse_chunk():
        return tp._project_compact_chunk(*chunk_args, lo, hi, w, h, k_sp,
                                         lane="fused", k_cap=ku)

    link_bytes = sum(t.numel() * t.element_size()
                     for t in (lists_v, lists_n, union_c))
    ms_fetch = time_ms(fetch_lists)
    sp_stages = {
        "count_union (counting pass, once per chunk)": stages[
            "count_union (k sizing, once per chunk)"],
        f"fused_compact_project at k_cap {ku} (counting pass, and again to "
        "serve)": time_ms(lambda: fc.fused_compact_project(
            *chunk_args, w, h, lo, hi, ku)),
        "sparse_from_union": time_ms(
            lambda: fc.sparse_from_union(union_v, union_c, k_sp)),
        "whole serving chunk (fused_compact_project + sparse_from_union)":
            time_ms(sparse_chunk),
        f"D2H of the lists ({link_bytes} bytes, "
        f"{link_bytes / CHUNK:.0f} a frame, pinned, non_blocking)": ms_fetch,
    }
    for entry, fn in (
            ("fused_compact_project", lambda: fc.fused_compact_project(
                *chunk_args, w, h, lo, hi, ku)),
            ("sparse_from_union",
             lambda: fc.sparse_from_union(union_v, union_c, k_sp)),
            ("whole serving chunk", sparse_chunk),
            ("D2H of the lists", fetch_lists)):
        sp_stages[f"{entry} on the card alone (torch.profiler)"] = (
            device_work(fn)[1] or float("nan"))
    say("time", "main path's sparse program, ms per chunk of "
                f"{CHUNK} frames at {st.points.shape[0]} points, k {k_sp} "
                f"(CUDA events, median of {bk.RUNS}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in sp_stages.items())
                + f"; the lists cross at {link_bytes / ms_fetch / 1e6:.2f} "
                f"GB/s | {card}")
    # the host paint of one frame: sparse lists against 2-bit rasters
    packed = dict(pipe.iter_overlay_rasters("cama", unpack=False))
    paint_ms = {"paint_sparse (sparse lists)": host_paint_ms(
                    sp, "cama", sp_lists, "sparse", pool),
                "composite_packed2 (2-bit rasters)": host_paint_ms(
                    pipe, "cama", packed, "raster", pool)}
    say("time", "host_composite of one frame into the mosaic, median ms "
                f"over {len(sp_lists)} frames x 3 ({POOL_THREADS} threads, "
                "base copy included): "
                + ", ".join(f"{k} {v:.4f}" for k, v in paint_ms.items())
                + f" | {card}")

    s_rate, s_rates, s_split = stream_rates(sp, "cama", pool, WINDOWS,
                                            run_sparse_stream)
    s_busy = device_busy_ms(lambda: run_sparse_stream(sp, "cama", pool))
    say("time", f"main path (sparse stream, 'auto'), warm, windows of >= "
                f"{MIN_WINDOW_S} s: {', '.join(f'{r:.2f}' for r in s_rates)} "
                f"frames/s (median {s_rate:.2f}); first run "
                f"{sp_frames / sp_secs:.2f} frames/s (counting pass and "
                f"first-use allocations) | {card}")
    say("time", "main path host phase split of the last window, ms/frame: "
                + ", ".join(f"{k} {v:.4f}" for k, v in s_split.items())
                + " | " + busy_share(s_busy, sp_frames, s_rate) + f" | {card}")
    rate, rates, split = stream_rates(pipe, "cama", pool, 1)
    n_frames, secs = paths["fused"][2:4]
    busy = device_busy_ms(lambda: run_stream(pipe, "cama", pool))
    say("time", f"dense 'fused' stream, warm, one window of >= "
                f"{MIN_WINDOW_S} s: {rate:.2f} frames/s; first run "
                f"{n_frames / secs:.2f} frames/s | {card}")
    say("time", "dense 'fused' host phase split, ms/frame: "
                + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                + " | " + busy_share(busy, n_frames, rate) + f" | {card}")
    p_rate, _, p_split = stream_rates(pal, "cama", pool, 1)
    p_frames, p_secs = paths["pallas"][2:4]
    say("time", f"dense 'pallas' stream, warm, one window of >= "
                f"{MIN_WINDOW_S} s: {p_rate:.2f} frames/s; first run "
                f"{p_frames / p_secs:.2f} frames/s; host phase split, "
                "ms/frame: "
                + ", ".join(f"{k} {v:.4f}" for k, v in p_split.items())
                + f" | {card}")
    msp.timers = type(msp.timers)()
    n_b, secs_b = run_batched_stream(msp, sources, pool,
                                     min_seconds=MIN_WINDOW_S)
    say("time", f"MultiScenePipeline stream (wide + default fixture, both "
                f"sources), warm, one window of >= {MIN_WINDOW_S} s: "
                f"{n_b / secs_b:.2f} video-frames/s; first run "
                f"{b_frames / b_secs:.2f}; host phase split, ms/video-frame: "
                + ", ".join(f"{k} {1000.0 * v / n_b:.4f}"
                            for k, v in msp.timers.total.items())
                + f" | {card}")
    pool.shutdown()

    # ---- phase 5: the correctness path ----
    correctness_phase(clip, dev, card)

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
        # device_ms: the call's kernels and memsets alone (torch.profiler).
        # launches: the main path's (the sparse stream), counting pass
        # included
        entry("fused_compact_project", fused_src,
              "cama_tpu/ops/fused_compact.py:241",
              sp_launches["fused_compact_project"], fused_err,
              ms_k * per, ms_r * per, bound_k * per, by_k, None,
              launches_per_call["fused_compact_project"], per,
              unit="ms/frame"),
        # the same kernel without the writes, which sizes k on the main
        # path (the JAX package counts with XLA: pipeline.py:447)
        entry("count_union", fused_src, "cama_tpu/pipeline.py:447",
              sp_launches["count_union"], count_err, ms_ck * per,
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
