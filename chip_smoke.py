#!/usr/bin/env python3
"""Smoke test of cama_tpu_torch on one CUDA card (NVIDIA Hopper).

    python3 chip_smoke.py          # from the repository root

Phases, each printing its own line; any failure raises and the script exits
non-zero (also when no CUDA device is present, or when the package is not
next to this script):

  1. environment: the card, its power limit (nvidia-smi), TF32 off, and the
     nvcc build of the fused kernel from cama_tpu_torch/csrc;
  2. kernel vs plain version on the card: the compute-bound fixture scene
     (17 frames, ~253,600 points) tiled to 1,048,576 points, one chunk of 16
     frames, and a tile-boundary case — count and every live row identical;
  3. the main path: ClipPipeline(device='cuda').iter_overlay_rasters over
     every frame of the 'cama' source, each raster composited into the 3x2
     mosaic by the native compositor over a 6-thread pool (as write_videos
     does) onto black base images; launch counts read around that run;
     rasters held against the float64 host lane (>= 0.99999 per frame) and
     against the plain version's chunk program on the card (exact);
  4. times: kernel and plain version ms/frame at 1,048,576 points (CUDA
     events, median of 20 runs after warm-up); per-chunk device time of
     each stage of the main path's device program; frames/s of the phase-3
     stream over windows of at least MIN_WINDOW_S seconds, with the host
     phase split and the device busy share (torch.profiler).

The last two lines are the kernels' JSON record and the result line.
Needs numpy and torch with CUDA, nvcc and g++; no cv2, yaml or ffmpeg.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
N_POINTS = 1_048_576   # tiled point count of the kernel phase
CHUNK_TILED = 16       # frames per chunk of the kernel phase
CHUNK = 8              # ClipPipeline's default frame chunk (main path)
AGREE_MIN = 0.99999    # per-frame raster agreement vs the host f64 lane
TIMED_RUNS = 20
MIN_WINDOW_S = 1.0     # each timed stream window loops the clip this long
WINDOWS = 3
POOL_THREADS = 6       # write_videos' default compositor pool
DEVICE = "cuda"


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def tile_boundary_inputs(device):
    """Same-pixel runs (a new pixel every 3 points) across every warp and
    block boundary, invalid points inside runs, exact identity geometry."""
    import numpy as np
    import torch

    P = 8192 + 512
    rng = np.random.default_rng(3)
    B = np.zeros((1, 1, 3, 4), np.float32)
    B[0, 0, 0, 0] = B[0, 0, 1, 1] = B[0, 0, 2, 2] = 1.0
    base = np.repeat(np.arange(P // 3 + 2), 3)[:P]
    pts = np.stack([(base % 64).astype(np.float32),
                    ((base // 64) % 64).astype(np.float32),
                    np.ones(P, np.float32)], axis=1)
    valid = np.ones(P, bool)
    valid[rng.choice(P, 200, replace=False)] = False
    cls = (base % 3).astype(np.int32)
    arrays = (pts, valid, cls, np.eye(4, dtype=np.float32)[None], B,
              np.ones(1, bool))
    geo = (64, 64, np.full(3, -1e6, np.float32), np.full(3, 1e6, np.float32))
    return [torch.from_numpy(a).to(device) for a in arrays], geo


def compare_project(args, geo, k_cap):
    """Kernel vs plain version on the same card tensors; returns the max
    absolute difference over counts and live rows (must be 0)."""
    import torch

    from cama_tpu_torch.ops import fused_compact as fc

    vals_k, cnt_k = fc.fused_compact_project(*args, *geo, k_cap)
    vals_r, cnt_r = fc.fused_compact_project_ref(*args, *geo, k_cap)
    cnt_c = fc.count_union(*args, *geo)
    cnt_cr = fc.count_union_ref(*args, *geo)
    torch.cuda.synchronize()
    err = int((cnt_k - cnt_r).abs().max())
    err_count = int((cnt_c - cnt_cr).abs().max())
    if int(cnt_r.max()) > k_cap:
        raise RuntimeError(f"k_cap {k_cap} below count {int(cnt_r.max())}")
    for f in range(cnt_r.shape[0]):
        n = int(cnt_r[f])
        if n:
            err = max(err, int((vals_k[f, :n] - vals_r[f, :n]).abs().max()))
    return err, err_count, int(cnt_r.min()), int(cnt_r.max())


def time_ms(fn, runs=TIMED_RUNS):
    """Median CUDA-event time of fn() over `runs` calls after warm-up."""
    import torch

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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script needs a CUDA device")
    sys.path.insert(0, ROOT)
    try:
        from cama_tpu_torch import _build, native
        from cama_tpu_torch.ops import fused_compact as fc
        from cama_tpu_torch.ops.raster import pack_cls_2bit, packed_to_cls
        from cama_tpu_torch.pipeline import (ClipPipeline, _overlay_chunk_fused,
                                             _pow2_cap)
    except ImportError as e:
        sys.exit(f"chip_smoke: cama_tpu_torch not importable next to "
                 f"{__file__}: {e}")

    # ---- phase 1: environment + build ----
    name = torch.cuda.get_device_name(0)
    card = card_line()
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
    say("build", f"{os.path.relpath(_build.library_path(), ROOT)} {built}; "
                 f"load {time.perf_counter() - t0:.2f} s; "
                 f"nvcc {' '.join(_build.NVCC_FLAGS)}")
    t0 = time.perf_counter()
    composer = "native" if native.available() else "NumPy fallback"
    say("build", f"host mosaic compositor: {composer} "
                 f"({time.perf_counter() - t0:.2f} s)")

    # ---- phase 2: kernel vs plain version ----
    dev = torch.device(DEVICE)
    clip = wide_clip()
    probe = ClipPipeline(clip_path=clip, chunk=CHUNK, device=dev)
    tiled = tiled_inputs(probe, dev)
    h, w = probe.scene.output_size
    geo = (w, h, probe._crop_lo, probe._crop_hi)
    k_tiled = _pow2_cap(int(fc.count_union(*tiled, *geo).max()), N_POINTS)
    err_big, err_big_c, lo_c, hi_c = compare_project(tiled, geo, k_tiled)
    tb_args, tb_geo = tile_boundary_inputs(dev)
    err_tb, err_tb_c, tb_n, _ = compare_project(tb_args, tb_geo, 4096)
    max_err = max(err_big, err_big_c, err_tb, err_tb_c)
    say("kernel", f"{N_POINTS} points x {CHUNK_TILED} frames: union counts "
                  f"{lo_c}..{hi_c}, k_cap {k_tiled}, max |kernel - plain| "
                  f"{err_big} (counting passes {err_big_c}); tile-boundary "
                  f"case: {tb_n} rows, max |diff| {err_tb} "
                  f"(counting passes {err_tb_c}); tolerance 0 (exact)")
    if max_err != 0:
        raise RuntimeError("CUDA kernel disagrees with its plain version")

    # ---- phase 3: the main path ----
    pool = ThreadPoolExecutor(max_workers=POOL_THREADS)
    fc.reset_launches()
    pipe = ClipPipeline(clip_path=clip, chunk=CHUNK, raster_kernel="fused",
                        device=dev)
    streamed = {}
    n_frames, secs, mosaic = run_stream(pipe, "cama", pool, streamed)
    launches = dict(fc.LAUNCHES)
    n_chunks = pipe.scene_tensors("cama").A.shape[0] // CHUNK
    k_cap = pipe.overlay_mode("cama")[1]
    say("main", f"{n_frames} frames of 'cama' ({int(pipe.scene.flat['cama'].valid.sum())} "
                f"points, chunk {CHUNK}, k_cap {k_cap}, {POOL_THREADS} "
                f"compositor threads) in {secs:.3f} s, counting pass "
                f"included; launches {launches}, expected {n_chunks} each "
                f"(counting pass + device program)")
    if launches != {"fused_compact_project": n_chunks, "count_union": n_chunks}:
        raise RuntimeError(f"main path launches {launches} != {n_chunks} chunks")
    if mosaic.shape != (2 * h, 3 * w, 3) or n_frames < 2:
        raise RuntimeError(f"bad stream: {n_frames} frames, {mosaic.shape}")
    host = dict(pipe.iter_overlay_rasters_host("cama"))
    if set(host) != set(streamed):
        raise RuntimeError("device and host lanes yield different frames")
    worst = 1.0
    for idx, ref in host.items():
        got = streamed[idx]
        if got.shape != ref.shape or got.dtype != np.uint8 or got.max() > 3:
            raise RuntimeError(f"frame {idx}: raster {got.shape} {got.dtype}")
        if not got.any():
            raise RuntimeError(f"frame {idx}: nothing painted")
        worst = min(worst, float((got == ref).mean()))
    # the device program with the plain version as its front end, on the card
    st = pipe.scene_tensors("cama")
    fm, _, _, _, F = pipe._chunked_AB("cama")
    mismatched = 0
    for s in range(0, st.A.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        vals, count = fc.fused_compact_project_ref(
            st.points, st.valid, st.cls, st.A[sl], st.B[sl],
            st.frame_valid[sl], w, h, pipe._crop_lo, pipe._crop_hi, k_cap)
        ref = packed_to_cls(fc.rasterize_from_union(vals, count, w, h)).cpu().numpy()
        for k in range(ref.shape[0]):
            fidx = s + k
            if fidx < F and fm.frame_valid[fidx]:
                mismatched += int((ref[k] != streamed[int(fm.frame_indices[fidx])]).sum())
    say("main", f"agreement vs host float64 lane: min {worst:.10f} per frame "
                f"(>= {AGREE_MIN}); pixels differing from the plain-version "
                f"device program on the card: {mismatched} (must be 0)")
    if worst < AGREE_MIN or mismatched:
        raise RuntimeError("main-path rasters out of contract")

    # ---- phase 4: times ----
    card = card_line()
    ms_k = time_ms(lambda: fc.fused_compact_project(*tiled, *geo, k_tiled))
    ms_r = time_ms(lambda: fc.fused_compact_project_ref(*tiled, *geo, k_tiled))
    ms_ck = time_ms(lambda: fc.count_union(*tiled, *geo))
    ms_cr = time_ms(lambda: fc.count_union_ref(*tiled, *geo))
    per = 1.0 / CHUNK_TILED
    say("time", f"fused_compact_project at {N_POINTS} points: kernel "
                f"{ms_k * per:.4f} ms/frame, plain {ms_r * per:.4f} ms/frame "
                f"(chunk of {CHUNK_TILED}, median of {TIMED_RUNS}); its "
                f"counting passes alone (count_union): kernel "
                f"{ms_ck * per:.4f}, plain {ms_cr * per:.4f} ms/frame | {card}")

    # the main path's device program, stage by stage, one chunk of CHUNK
    sl = slice(0, CHUNK)
    chunk_args = (st.points, st.valid, st.cls, st.A[sl], st.B[sl],
                  st.frame_valid[sl])
    vals, count = fc.fused_compact_project(*chunk_args, w, h, pipe._crop_lo,
                                           pipe._crop_hi, k_cap)
    packed = fc.rasterize_from_union(vals, count, w, h)
    cls_r = packed_to_cls(packed)
    stages = {
        "fused_compact_project": time_ms(lambda: fc.fused_compact_project(
            *chunk_args, w, h, pipe._crop_lo, pipe._crop_hi, k_cap)),
        "rasterize_from_union": time_ms(
            lambda: fc.rasterize_from_union(vals, count, w, h)),
        "packed_to_cls": time_ms(lambda: packed_to_cls(packed)),
        "pack_cls_2bit": time_ms(lambda: pack_cls_2bit(cls_r)),
        "whole chunk": time_ms(lambda: _overlay_chunk_fused(
            *chunk_args, pipe._crop_lo, pipe._crop_hi, w, h, k_cap, True)),
    }
    say("time", "main-path device program, ms per chunk of "
                f"{CHUNK} frames at {st.points.shape[0]} points (CUDA events, "
                f"median of {TIMED_RUNS}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
                + f" | {card}")

    rates, split = [], {}
    for _ in range(WINDOWS):
        pipe.timers = type(pipe.timers)()
        n2, secs2, _ = run_stream(pipe, "cama", pool, min_seconds=MIN_WINDOW_S)
        rates.append(n2 / secs2)
        split = {k: 1000.0 * v / n2 for k, v in pipe.timers.total.items()}
    busy = device_busy_ms(lambda: run_stream(pipe, "cama", pool))
    rate = statistics.median(rates)
    busy_line = ("device busy share not measured (no device time in the "
                 "trace)" if busy is None else
                 f"device busy {busy / n_frames:.4f} ms/frame (torch.profiler, "
                 f"one pass) = {100.0 * busy / n_frames * rate / 1000.0:.2f} % "
                 f"of the median window's wall time")
    say("time", f"main-path stream, warm, windows of >= {MIN_WINDOW_S} s: "
                f"{', '.join(f'{r:.2f}' for r in rates)} frames/s (median "
                f"{rate:.2f}); first run {n_frames / secs:.2f} frames/s "
                f"(counting pass and first-use allocations) | {card}")
    say("time", "host phase split of the last window, ms/frame: "
                + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                + f" | {busy_line} | {card}")
    pool.shutdown()

    jax_mods = sorted(m for m in sys.modules if sys.modules[m] is not None
                      and m.split(".")[0] in ("jax", "jaxlib"))
    reused = sorted(m for m in sys.modules if m.split(".")[0] == "cama_tpu")
    say("env", f"modules of the JAX package loaded: {reused}; jax modules "
               f"loaded: {len(jax_mods)}")
    if jax_mods:
        raise RuntimeError(f"the port imported jax: {jax_mods[:5]}")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_compact_project", "route": "cuda",
        "source": "cama_tpu_torch/csrc/fused_compact.cu",
        "replaces": "cama_tpu/ops/fused_compact.py:241",
        "launches": launches["fused_compact_project"],
        "max_abs_err": max(err_big, err_tb),
        "ms": ms_k * per, "plain_ms": ms_r * per,
        # the same kernel's counting passes (count + scan), run alone by the
        # k_cap sizing of the main path
        "count_launches": launches["count_union"],
        "count_max_abs_err": max(err_big_c, err_tb_c),
        "count_ms": ms_ck * per, "count_plain_ms": ms_cr * per}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
