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
     the device work of one call of each (a CUDA graph's nodes);
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
     inputs, and the card alone by one method for every kernel and the
     library call (device_work: a CUDA graph of 20 back-to-back calls),
     with the library call's device events; per-chunk device time of each
     stage of the sparse program and
     of both lanes' dense programs, the lists' copy to the host and the
     host paint of a frame (sparse lists against 2-bit rasters); frames/s
     of the streams over windows of at least MIN_WINDOW_S seconds (three
     for the main path, one for each other stream), with the host phase
     split and the device busy share (torch.profiler, a trace that lost
     a launch's device event refused).

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

  6. map evaluation (cama_tpu_torch.eval.map_metrics), lines tagged [eval];
     plain tensor work, no kernel of csrc/:
     - the ops at full width, no cv2 needed: ground-truth ids
       [8, 6, 540, 960] uint16 drawn from a seed (thin strokes, some closer
       than 2 * tolerance, exact ties, one empty camera) and one real
       projection chunk of the wide fixture, full-P and crop-compacted; on
       the card against the same code on CPU tensors fed the same (vu,
       keep): both distance fields, both vote fields, the count raster, the
       votes under keep and the Chebyshev partials differ in 0 entries, the
       Euclidean sre_sum by at most 1e-6 relative; squared_edt equals
       scipy's; _eval_chunk_build then _eval_chunk_serve give equal outputs,
       with their ms per chunk (CUDA events, and the card alone) and device
       launches;
     - when cv2 imports: add_instance_masks on the wide fixture (drawn
       MASK_SHIFT_PX low), then
       MapEvaluator.evaluate_scene_all on ClipPipeline(device='cuda'), cold
       and warm, for both distances: equal dicts, equal to compact='off' and
       resident='off', within 1e-4 of backend='host'; evaluated frames/s,
       the card's busy share, resident bytes, peak device memory and the
       evaluator's PhaseTimers report.  Every chunk function of the
       evaluator is wrapped to raise on a CPU tensor.

  7. the CAMAv2 site path (cama_tpu_torch.aggregate), lines tagged [site]
     and [lidar]; _chamfer_pairs, _refine_step and _transform_points are
     wrapped to raise on a tensor off the card:
     - two fixture clips over overlapping road, the second in a misaligned
       SfM frame: Site.from_clips(refine=True) on the card, the Sim(3)
       estimate against the injected one, the refinement's first and last
       loss, the count dedupe removes; member_overlay_rasters (the merged
       map through MultiScenePipeline on the source 'site') byte-equal to
       each member's own ClipPipeline rasters, with fused_compact_project
       launched on that path; cli._run_sites writing the labels and member
       videos when ffmpeg or cv2 can write video;
     - a seeded site at the size users run (tools/site_cases.py: 16 clips,
       1,885 elements, 8,567 candidate pairs at tol 2.0, every clip but the
       first perturbed by 1-1.5 deg and 0.5-0.8 m): refine_alignment(600)
       must lower the loss below SITE_LOSS_RATIO_MAX of the first and leave
       at most SITE_ROT_ERR_MAX_DEG and SITE_TRANS_ERR_MAX_M of the
       perturbation (ms per step by events and on the card, launches per
       step, peak memory); dedupe(0.5) on the card against the same code on
       CPU tensors (a pair within 1e-5 of tol may fall either way; counted),
       ms and pairs/s;
     - LiDAR at nuScenes density (200 sweeps of up to 34,720 points, a
       ragged valid mask, poses from a seed): _transform_points against its
       host mirror (<= 1e-4 m, the same NaN mask), ms by events and on the
       card beside its bound at 3.35 TB/s, the copies both ways,
       voxel_downsample(0.2) on the host; aggregate_lidar on the fixture
       clips on the card against backend='host' (same counts, <= 1e-4 m).

  8. device compositing, the QA report and the tools, lines tagged [qa]
     (needs cv2 and yaml), on the wide fixture rebuilt with camera JPEGs
     (102 of 1600x900) and phase 6's ground truth, and a copy of it;
     composite_mosaic_device is wrapped to raise on a tensor off the card:
     - ClipPipeline.mosaics_device(['cama', 'nuscenes'], idx) for every
       valid frame, 0 bytes apart from the native composite_mosaic_frame of
       the same rasters, with fused_compact_project launched and no plain
       version run; per frame, by CUDA events (and the card alone), the
       base's H2D, composite_mosaic_device against its bound, the mosaic's
       D2H and the whole call, beside the host compositor's ms a mosaic;
     - remap_bilinear on a fixture JPEG: 0 entries apart from the same
       code on CPU tensors, entries within 1 of cv2.remap, ms;
     - report.main --device cuda over both copies and a two-member site:
       rc 0, failures 0, each scene's 'cama' map metrics within 1e-4 of
       phase 6's evaluate_scene_all, the wall seconds;
     - doctor.main: the card reachable, nvidia-smi's line, nvcc, the
       kernel library built;
     - warmup.main --frames: images cached, hit rate, then the first frame
       of a fresh pipeline without and with the frame store;
     - profiling.device_trace around one serving chunk: in a fresh process
       a Chrome trace that names the fused kernel (fc_tile); in this one,
       where torch.profiler may drop the card's events, the kernel named
       or device_trace's warning that events are missing.

  9. the multi-device tier (cama_tpu_torch.parallel), lines tagged
     [mesh], on the wide fixture's 'cama' at full width (every valid
     frame, every point):
     - 9a: this process as a world of one rank (NCCL), a 1x1 mesh:
       sharded_overlay_step with each of its four kernels ('fast',
       'compact', 'two_stage', 'fused'), each run with the launch counts
       set to 0 just before it and read just after: rasters byte-equal to
       ClipPipeline(raster_kernel='fused') and the painted counts equal to
       its painted pixels, no kernel's plain version run, the 'fused' step
       launching fused_compact_project (and count_union, which sizes its
       list); ms a step by CUDA events; with cv2,
       evaluate_scene_batch_sharded on a 1x1 ('scenes', 'frames') mesh
       over phase 8's two wide copies (both scenes on the one rank, the
       crop compaction engaged) within 1e-4 of evaluate_scene_batch.  A
       1x1 mesh's collectives are identities, so 9a runs no NCCL
       collective: it checks the mesh's construction under NCCL and the
       steps' single-rank path;
     - 9b: four ranks on this one card, each a child process
       (cama_tpu_torch.tools.mesh_child, launched by the port's
       run_local_cluster) with backend='gloo' (NCCL refuses two ranks on
       one device; gloo stages CUDA tensors through host memory):
       every kernel on the ('frames', 'points') meshes (4, 1), (2, 2) and
       (1, 4), the gathered rasters byte-equal to 9a's and the counts
       equal, per rank the ms a step and the all-reduce's ms and share;
       a 'fused' step whose union list overflows on some point shards
       raises on every rank; sharded_multi_scene_step over the wide and
       the default fixture on a (2, 2) ('scenes', 'frames') mesh equal to
       each scene's solo rasters; sharded_map_metrics (full and
       crop-compacted) and sharded_scene_batch_metrics on phase 6's seeded
       ground truth against the unsharded program (sre_sum within 1e-6
       relative, counts exact); with cv2, evaluate_scene_batch_sharded on
       phase 8's two wide copies within 1e-4 of evaluate_scene_batch; the
       cross-host pieces (assign_scenes, run_local_scenes with a failing
       scene, reduce_metric_partials); and every rank loaded no module of
       jax or cama_tpu.  Four ranks share one card here: these lines
       measure correctness and gloo's host-staged collective, not
       scale-out.

  10. the benchmark and the CLI as a user runs them, lines tagged
     [benchmark]: `python -m cama_tpu_torch.bench` in a child process on the
     card (every stage, its headline clip cut to BENCH_FRAMES frames; the
     wide scene, the 1,048,576-point device lane and the rest at their
     full sizes): exit 0, one JSON line last with a nonzero fps, no
     failed or skipped stage, every stage's number, backend 'cuda' and
     the device lane's launches of fused_compact_project and
     project_frame_pallas (the CUDA kernels: a wrapper on a card tensor
     launches its kernel or raises); then `python -m cama_tpu_torch
     --config` on examples/config.yaml with its data locations pointed at
     the bench's headline clip (the file's own locations are placeholders,
     and the clip carries its labels, so no label release is named): exit
     0, both videos written.
     10b: each tool and demo of the port, its main called once in this
     process on the card at a small size (3- to 6-frame fixture clips of
     320 x 180 images): profile_pipeline under device_trace with --eval,
     fuzz_sweep (3 trials each), gen_golden against tests/golden,
     validate_convert_real (no nuScenes copy here: exit 2, "waiting"),
     demo, demo_adaptive ('fused' served, its kernel launched),
     demo_device_compositing and demo_multihost (two gloo ranks on the
     card): each its exit code and its output's telling line.  The bench
     line's keys time bench.py's programs: the headline the single-stage
     'compact' program, device_ms_per_frame the two-stage one (equal to
     device_ms_per_frame_two_stage), both 'compact' programs launching no
     kernel; device_resident_fps_fused, device_ms_per_frame_compact and
     hbm_gbps_lower_bound must be nonzero.

  11. the driver-contract entry points (cama_tpu_torch.graft_entry, the
     port of __graft_entry__.py), lines tagged [graft]: entry() on the card,
     its rasters [8, 6, 96, 128] byte-equal to entry(device='cpu')'s plain
     program, fused_compact_project launched once (one launch covers the
     chunk's eight frames) and no plain version run; dryrun_multichip(1), a
     rank under NCCL and the multihost job on two gloo ranks sharing the
     card, then dryrun_multichip(4), four gloo ranks sharing the card: the
     ten checks of the JAX dryrun, each printing its `dryrun_multichip ok:`
     line, with the seconds each took.

Pipelines of phases 2-4 that are expected to run the counting pass first
delete the clip's counts sidecar (forget_counts).

The last two lines are the kernels' JSON record and the result line.  The
script fails if any module of jax or of the JAX package cama_tpu was
loaded.  Needs numpy, scipy and torch with CUDA, nvcc and g++; cv2 and
yaml for phase 8 and the sub-phases named above; no ffmpeg.
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
import subprocess
import sys
import time
import warnings
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
MASK_SHIFT_PX = 6.0    # phase 6 draws its ground truth this far off the map
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


@contextlib.contextmanager
def traced():
    """torch.profiler over host and CUDA activity, the card synchronized
    before the window closes.  Its device events can be lost (PERF.md):
    complete_events() says whether a finished trace holds them all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def complete_events(prof):
    """(launch calls, calls without a device event) of a finished trace:
    profiling.untraced_launches on its Chrome export."""
    from cama_tpu_torch.profiling import untraced_launches

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "trace_check.json")
    prof.export_chrome_trace(path)
    try:
        return untraced_launches(path)
    finally:
        os.remove(path)


def device_events_of(prof):
    """[(name, device us)] of the device events (kernels, memsets, copies)
    of a finished trace."""
    import torch

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]


def device_events(fn):
    """{event name: [count, device us]} of every device event in one traced
    call of fn (torch.profiler), and the count of the call's launches that
    the trace lost."""
    import torch

    fn()
    torch.cuda.synchronize()
    with traced() as prof:
        fn()
    out = {}
    for name, us in device_events_of(prof):
        entry = out.setdefault(name[:70], [0, 0.0])
        entry[0] += 1
        entry[1] += us
    return out, complete_events(prof)[1]


def device_work(fn, calls=20, reps=5):
    """({device node: runs per call}, device ms of one call) of fn on the
    card alone: cama_tpu_torch.tools.bench_kernels.device_work, a CUDA
    graph of `calls` back-to-back calls replayed `reps` times between CUDA
    events (median), its nodes read from the graph's DOT dump.  (None,
    None), and a line saying why, when fn cannot be captured (a host sync
    or a pageable copy inside it)."""
    from cama_tpu_torch.tools import bench_kernels

    seen, ms, why = bench_kernels.device_work(fn, WORK, calls, reps)
    if why is not None:
        say("time", f"not measured on the card alone: {why}")
    return seen, ms


def per_call(entry, fn, symbol, launches, device_ms):
    """Print the device work of one call of fn (device_work); record in
    launches[entry] how many of its kernels are the entry's own and in
    device_ms[entry] its device time.  Raises unless a call is one launch
    of the entry's kernel, beside at most one memset and `symbol`-free
    work the wrapper does."""
    seen, ms = device_work(fn)
    if seen is None:
        raise RuntimeError(f"{entry}: its call cannot be captured")
    launches[entry] = sum(n for name, n in seen.items() if symbol in name)
    device_ms[entry] = ms
    say("kernel", f"{entry}: device work of one call (a CUDA graph of 20 "
                  f"calls): {seen}, {ms:.5f} ms on the card")
    if launches[entry] != 1 or seen.get("memset", 0) > 1:
        raise RuntimeError(f"{entry} is not one launch a call: {seen}")
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
    kernels and copies, summed self device time), or None, and a line
    saying why, when the trace lost a launch's device event or shows no
    device time."""
    with traced() as prof:
        fn()
    calls, lost = complete_events(prof)
    if lost:
        say("time", f"device busy not measured: the trace lost {lost} of "
                    f"{calls} launches' device events")
        return None
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / 1000.0 if us > 0 else None


def busy_share(busy_ms, n_frames, rate):
    """The device busy line of one traced pass of n_frames, against the
    wall time per frame at `rate` frames/s."""
    if busy_ms is None:
        return ("device busy share not measured (the trace is incomplete or "
                "shows no device time)")
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


@contextlib.contextmanager
def counting_plain_versions():
    """Count the calls of every kernel's plain version while the block
    runs: yields {plain function name: calls}, empty when none ran."""
    from cama_tpu_torch.ops import fused_compact, paint, pallas_project

    calls = {}
    originals = [(fused_compact, "fused_compact_project_ref"),
                 (fused_compact, "count_union_ref"),
                 (pallas_project, "project_frame_pallas_ref"),
                 (paint, "paint_max_ref")]

    def counted(name, real):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        return call

    reals = [(mod, name, getattr(mod, name)) for mod, name in originals]
    for mod, name, real in reals:
        setattr(mod, name, counted(name, real))
    try:
        yield calls
    finally:
        for mod, name, real in reals:
            setattr(mod, name, real)


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
    from cama_tpu_torch.ops import geometry as tg
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
    seen, card_ms = device_work(checked, calls=3, reps=2)
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
    matrix, launched = {}, {}
    with counting_plain_versions() as plain_calls:
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


def synthetic_gt_ids(shape, seed=6):
    """[K, C, H, W] uint16 instance ids drawn with NumPy from a seed: per
    camera a dozen thin strokes (1 to 3 px) with ids up to 60000, each third
    one shadowed 6 px away by another id (closer than 2 * tolerance), a few
    pixel pairs that leave the pixels between them exactly tied (along a
    row, along a column), and one camera left empty."""
    import numpy as np

    rng = np.random.default_rng(seed)
    K, C, H, W = shape
    ids = np.zeros(shape, np.uint16)
    for k in range(K):
        for c in range(C):
            if (k, c) == (K - 1, C - 1):
                continue  # the empty camera
            img = ids[k, c]
            for j in range(12):
                y0, y1 = rng.integers(0, H, 2)
                x0, x1 = rng.integers(0, W, 2)
                n = 2 * max(abs(int(y1) - int(y0)), abs(int(x1) - int(x0))) + 2
                yy = np.rint(np.linspace(y0, y1, n)).astype(np.int64)
                xx = np.rint(np.linspace(x0, x1, n)).astype(np.int64)
                for t in range(int(rng.integers(1, 4))):
                    img[np.clip(yy + t, 0, H - 1), xx] = 1 + j * 5000
                if j % 3 == 0:
                    img[np.clip(yy + 6, 0, H - 1), xx] = 2 + j * 5000
            y, x = int(rng.integers(20, H - 20)), int(rng.integers(20, W - 20))
            img[y - 8:y + 9, x - 8:x + 9] = 0
            img[y, x - 2], img[y, x + 2] = 101, 102      # tie at (y, x)
            img[y - 6, x - 6], img[y - 2, x - 6] = 103, 104  # column tie
    return ids


def forget_gt_store(pipe):
    """Delete the clip's GT-mask store and make the pipeline resolve it
    again, so the next evaluation decodes and remaps every PNG."""
    cache = pipe.gt_mask_cache()
    if cache is not None:
        cache.flush()
        for path in (cache._data_path, cache._valid_path, cache._key_path):
            with contextlib.suppress(OSError):
                os.remove(path)
    pipe._gtcache = False


def eval_phase(clip, dev, card):
    """Phase 6 (module docstring): map evaluation.  Raises on any failed
    check.  Returns the Chebyshev evaluate_scene_all dict of the wide
    fixture's 'cama' (None when cv2 is missing), phase 8's reference."""
    import numpy as np
    import torch

    from cama_tpu_torch import pipeline as tp
    from cama_tpu_torch.eval import map_metrics as tm
    from cama_tpu_torch.io.fixture import add_instance_masks
    from cama_tpu_torch.ops.geometry import project_frames
    from cama_tpu_torch.tools.bench_kernels import time_ms

    TOL, RAD = 5, 20
    cpu = torch.device("cpu")

    # every chunk function of the evaluator must see tensors on the card
    # (dev) only
    guarded = ("_eval_chunk_build", "_eval_chunk_serve",
               "frame_metrics_chunk_packed", "frame_metrics_rows_packed",
               "_metrics_and_votes_chunk", "instance_votes_chunk")
    calls = dict.fromkeys(guarded, 0)

    def on_card(name, real):
        def call(*a, **k):
            out = real(*a, **k)
            flat = list(a) + list(k.values())
            for o in (out if isinstance(out, tuple) else (out,)):
                flat += list(o.values()) if isinstance(o, dict) else [o]
            for t in flat:
                if isinstance(t, torch.Tensor) and t.device.type != dev.type:
                    raise RuntimeError(f"{name}: a tensor on {t.device}")
            calls[name] += 1
            return out
        return call

    reals = {name: getattr(tm, name) for name in guarded}
    for name, real in reals.items():
        setattr(tm, name, on_card(name, real))

    forget_counts(clip)
    pipe = tp.ClipPipeline(clip_path=clip, chunk=CHUNK, raster_kernel="auto",
                           device=dev)
    pipe.overlay_mode("cama")  # the counting pass sizes the crop-first split
    k1 = pipe.crop_compact_k("cama")
    st = pipe.scene_tensors("cama")
    h, w = pipe.scene.output_size
    lo, hi = pipe._crop_lo, pipe._crop_hi
    P = int(st.points.shape[0])
    C = len(pipe.scene.camera_list)
    if k1 is None:
        raise RuntimeError("the wide fixture did not engage the crop split")
    sl = slice(0, CHUNK)
    geo = (st.points, st.valid, st.A[sl], st.B[sl], st.frame_valid[sl])

    # ---- the ops at full width, card against CPU on the same (vu, keep) ----
    ids_np = synthetic_gt_ids((CHUNK, C, h, w))
    ids_c = tm.device_ids(ids_np, dev)
    ids_h = torch.from_numpy(ids_np)
    if not torch.equal(ids_c.cpu().view(torch.int16), ids_h.view(torch.int16)):
        raise RuntimeError("device_ids does not rebuild the id stack")
    vu_full, keep_full = project_frames(*geo, w, h, lo, hi)
    vu_k, keep_k, sel_k = tm._project_compact_chunk_eval(*geo, w, h, lo, hi,
                                                         k1)
    fv = st.frame_valid[sl].to(torch.float32)
    diffs = {}

    def differ(name, a, b):
        """Entries of the card's tensor a that differ from the CPU's b."""
        a, b = tm._bits16(a.cpu()), tm._bits16(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f"{name}: {a.dtype}{tuple(a.shape)} on the "
                               f"card, {b.dtype}{tuple(b.shape)} on the CPU")
        diffs[name] = int((a != b).sum())

    mask_c, mask_h = tm._foreground(ids_c), tm._foreground(ids_h)
    fields = {}
    for distance in ("chebyshev", "euclidean"):
        rounds = tm._dist_rounds(RAD, TOL, distance)
        fields[distance] = (tm._dist_field(mask_c, rounds, distance),
                            tm._dist_field(mask_h, rounds, distance))
        differ(f"dist_field {distance}", *fields[distance])
    tie_ok = True
    for assignment in ("nearest", "chebyshev"):
        vf_c = tm._vote_field(ids_c, TOL, assignment)
        vf_h = tm._vote_field(ids_h, TOL, assignment)
        differ(f"vote_field {assignment}", vf_c, vf_h)
        if assignment == "nearest":
            # the tied pixels go to the smaller column / the upper row
            vf = vf_h.numpy()
            for k in range(CHUNK):
                for c in range(C):
                    ys, xs = np.nonzero(ids_np[k, c] == 101)
                    if len(ys):
                        y, x = int(ys[0]), int(xs[0]) + 2
                        tie_ok &= (vf[k, c, y, x] == 101
                                   and vf[k, c, y - 4, x - 6] == 103)
    rel_sre = 0.0
    for label, (vu, keep) in (("full P", (vu_full, keep_full)),
                              ("k1", (vu_k, keep_k))):
        vu_h, keep_h = vu.cpu(), keep.cpu()
        keep_np = keep_h.numpy()
        vi, ui = tm._clip_pixels(vu, h, w)
        vi_h, ui_h = tm._clip_pixels(vu_h, h, w)
        cnt_c = tm._point_count_raster(vi, ui, keep, h, w)
        differ(f"count raster {label}", cnt_c,
               tm._point_count_raster(vi_h, ui_h, keep_h, h, w))
        if label == "k1":
            diffs["count raster k1 vs full P"] = int((cnt_c != cnt_full).sum())
        else:
            cnt_full = cnt_c
        votes_c = tm.instance_votes_chunk(ids_c, vu, keep, TOL).cpu().numpy()
        votes_h = reals["instance_votes_chunk"](  # unguarded: the CPU side
            ids_h, vu_h, keep_h, TOL).numpy()
        diffs[f"votes under keep {label}"] = int(
            (votes_c[keep_np] != votes_h[keep_np]).sum())
        for distance in ("chebyshev", "euclidean"):
            f_c, f_h = fields[distance]
            p_c = tm._frame_metrics_from_field(mask_c, f_c, vu, keep, RAD,
                                               TOL, distance)
            p_h = tm._frame_metrics_from_field(mask_h, f_h, vu_h, keep_h, RAD,
                                               TOL, distance)
            bad = 0
            for key in tm.PARTIAL_KEYS:
                a, b = p_c[key].cpu().numpy(), p_h[key].numpy()
                if distance == "euclidean" and key == "sre_sum":
                    rel_sre = max(rel_sre, float(
                        np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
                else:
                    bad += int((a != b).sum())
            diffs[f"{distance} partials {label}"] = bad
    from scipy import ndimage

    one = mask_h[0, 0].numpy()
    edt = tm.squared_edt(mask_c[0, 0]).cpu().numpy()
    diffs["squared_edt vs scipy"] = int((edt != (
        ndimage.distance_transform_edt(~one) ** 2).astype(np.float32)).sum())
    n_kept = int(keep_k.sum())
    say("eval", f"ops at full width, GT ids [{CHUNK}, {C}, {h}, {w}] uint16 "
                f"({int(mask_h.sum())} labelled pixels, one camera empty), "
                f"one projection chunk of the wide fixture ({P} points, k1 "
                f"{k1}, {n_kept} kept point-cameras), card against the same "
                f"code on CPU tensors fed the same (vu, keep); entries "
                f"differing: "
                + ", ".join(f"{k} {v}" for k, v in diffs.items())
                + f" (each must be 0); exact ties resolved as documented: "
                f"{bool(tie_ok)}; Euclidean sre_sum relative difference "
                f"{rel_sre:.3e} (<= 1e-6)")
    if any(diffs.values()) or not tie_ok or not rel_sre <= 1e-6 or not n_kept:
        raise RuntimeError("an evaluation op on the card disagrees with the "
                           "CPU")

    # ---- the fused chunk: build, then serve ----
    fvb = st.frame_valid[sl]
    rows = []
    for distance in ("chebyshev", "euclidean"):
        args = (w, h, lo, hi, k1, RAD, TOL, distance)
        built = tm._eval_chunk_build(*geo[:4], fvb, ids_c, *args, "nearest",
                                     True)
        served = tm._eval_chunk_serve(*geo[:4], fvb, *built[4:], *args)
        same = (all(torch.equal(served[0][k], built[0][k])
                    for k in tm.PARTIAL_KEYS)
                and torch.equal(tm._bits16(served[1]), tm._bits16(built[1]))
                and torch.equal(served[2], built[2])
                and torch.equal(served[3], built[3]))
        if not same:
            raise RuntimeError(f"{distance}: serve differs from build")
        nbytes = sum(t.numel() * t.element_size() for t in built[4:])

        def build():
            return tm._eval_chunk_build(*geo[:4], fvb,
                                        tm.device_ids(ids_np, dev), *args,
                                        "nearest", True)

        def serve():
            return tm._eval_chunk_serve(*geo[:4], fvb, *built[4:], *args)

        line = []
        for name, fn in (("build (ids upload, fields, evaluation)", build),
                         ("serve", serve)):
            ms = time_ms(fn, runs=5)
            seen, card_ms = device_work(fn, calls=3, reps=2)
            line.append(f"{name} {ms:.3f} ms by CUDA events (median of 5), "
                        f"{fmt(card_ms, 1.0)} ms on the card alone, "
                        + ("launches not measured" if seen is None else
                           f"{sum(seen.values())} device launches"))
        rows.append(f"{distance}: " + "; ".join(line)
                    + f"; fields kept {nbytes / 1e6:.1f} MB")
        del built, served
    say("eval", f"_eval_chunk_build then _eval_chunk_serve, one chunk of "
                f"{CHUNK} frames with votes, outputs equal; "
                + " | ".join(rows) + f" | {card}")
    del fields, cnt_full, cnt_c, vf_c, vf_h, ids_c, mask_c
    torch.cuda.empty_cache()

    # ---- the scene, through the entry point ----
    scene_ref = None
    if importlib.util.find_spec("cv2") is None:
        say("eval", "scene run skipped: cv2 not importable")
    else:
        t0 = time.perf_counter()
        add_instance_masks(clip, shift_px=MASK_SHIFT_PX)
        mask_secs = time.perf_counter() - t0
        for distance in ("chebyshev", "euclidean"):
            forget_gt_store(pipe)  # a cold pass decodes and remaps the PNGs
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ev = tm.MapEvaluator(tolerance=TOL, max_radius=RAD,
                                 distance=distance)
            n_before = dict(calls)
            t0 = time.perf_counter()
            cold = ev.evaluate_scene_all(pipe)
            cold_secs = time.perf_counter() - t0
            cold_report = ev.timers.report()
            peak = torch.cuda.max_memory_allocated()
            ev.timers = type(ev.timers)()
            warm_secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                warm = ev.evaluate_scene_all(pipe)
                warm_secs.append(time.perf_counter() - t0)
                if warm != cold:
                    raise RuntimeError(f"{distance}: warm {warm} != cold "
                                       f"{cold}")
            n_chunks = calls["_eval_chunk_build"] - n_before["_eval_chunk_build"]
            n_serve = calls["_eval_chunk_serve"] - n_before["_eval_chunk_serve"]
            if n_chunks != 2 or n_serve != 6:
                raise RuntimeError(f"{distance}: {n_chunks} builds and "
                                   f"{n_serve} serves, expected 2 and 6")
            busy = device_busy_ms(lambda: ev.evaluate_scene_all(pipe))
            store = ev._resident_fields[pipe]
            for kw in ({"compact": "off"}, {"resident": "off"}):
                other = tm.MapEvaluator(tolerance=TOL, max_radius=RAD,
                                        distance=distance,
                                        **kw).evaluate_scene_all(pipe)
                if other != cold:
                    raise RuntimeError(f"{distance} {kw}: {other} != {cold}")
            t0 = time.perf_counter()
            hev = tm.MapEvaluator(tolerance=TOL, max_radius=RAD,
                                  distance=distance, backend="host")
            host = (hev.evaluate_scene_all(pipe) if distance == "chebyshev"
                    else hev.evaluate_scene(pipe))
            host_secs = time.perf_counter() - t0
            apart = max(abs(cold[k] - host[k]) for k in host
                        if isinstance(host[k], float))
            n = cold["frames_evaluated"]
            wm = statistics.median(warm_secs)
            say("eval", f"MapEvaluator(distance={distance!r})."
                        f"evaluate_scene_all on ClipPipeline(device='cuda'), "
                        f"wide fixture 'cama', {n} frames: {json.dumps(cold)}; "
                        f"warm == cold (3 warm passes), compact='off' and "
                        f"resident='off' give the same dict; "
                        f"backend='host' "
                        f"({'evaluate_scene_all' if distance == 'chebyshev' else 'evaluate_scene'}, "
                        f"{host_secs:.2f} s) differs by at most {apart:.3e} "
                        f"(<= 1e-4); cold {n / cold_secs:.2f} evaluated "
                        f"frames/s ({cold_secs:.3f} s), warm "
                        f"{n / wm:.2f} ({1000.0 * wm:.3f} ms, median of 3; "
                        + " / ".join(f"{1000.0 * t:.3f}" for t in warm_secs)
                        + f"), card busy in a warm pass "
                        f"{fmt(busy, 1.0)} ms"
                        + ("" if busy is None else
                           f" = {100.0 * busy / (1000.0 * wm):.2f} % of it")
                        + f"; resident fields {store['bytes'] / 1e6:.1f} MB "
                        f"in {len(store['chunks'])} chunks; peak device "
                        f"memory of the cold pass {peak / 2**20:.1f} MiB, "
                        f"{before / 2**20:.1f} MiB allocated before it | "
                        f"{card}")
            say("eval", f"{distance} PhaseTimers, cold pass:\n{cold_report}")
            say("eval", f"{distance} PhaseTimers, 3 warm passes:\n"
                        f"{ev.timers.report()}")
            if not apart <= 1e-4 or n != 16 or set(host) - set(cold):
                raise RuntimeError(f"{distance}: device and host disagree")
            if distance == "chebyshev":
                scene_ref = cold
        say("eval", f"instance masks of the wide fixture written in "
                    f"{mask_secs:.2f} s (add_instance_masks, 96 PNGs, drawn "
                    f"{MASK_SHIFT_PX} px low so the metrics are not all 1.0)")
    for name, real in reals.items():
        setattr(tm, name, real)
    say("eval", "calls of the evaluator's chunk functions, every tensor of "
                f"each on the card: {calls}")
    return scene_ref


SITE_ITERS = 600        # phase 7: Adam steps of the refinement
LIDAR_SWEEPS = 200      # phase 7: a 20 s nuScenes scene at every=2
LIDAR_POINTS = 34_720   # phase 7: LIDAR_TOP's largest sweep
# phase 7's bounds on the seeded 16-clip site: the refined loss against the
# first, and the perturbation left after refinement (an H100 at 700 W read
# 0.1192, 0.0620 deg and 0.0741 m; PERF.md)
SITE_LOSS_RATIO_MAX = 0.45
SITE_ROT_ERR_MAX_DEG = 0.2
SITE_TRANS_ERR_MAX_M = 0.1


def site_clips(root, with_images):
    """Two clips over overlapping road (tests/test_aggregate.py's site
    clips): the second 0.7 s further along and in an SfM frame turned by
    8 deg and shifted by (15, -7) m.  Small JPEGs when cv2 can write them,
    so the CLI can write the member videos."""
    from cama_tpu_torch.io.fixture import make_fixture_clip

    shutil.rmtree(root, ignore_errors=True)
    common = dict(n_frames=14, flat_height=True, with_images=with_images,
                  image_size=(320, 180))
    a = make_fixture_clip(root, scene_name="scene-a", **common)
    b = make_fixture_clip(root, scene_name="scene-b", traj_t_offset=0.7,
                          t0_ms=1600000100000,
                          world_sim3={"yaw_deg": 8.0, "tx": 15.0, "ty": -7.0},
                          **common)
    return a, b


def sim3_error(r, t, s, yaw_deg, tx, ty):
    """(degrees, metres) between an estimated SfM->world Sim(3) and the
    inverse of the fixture's world->SfM misalignment, the metres at the
    SfM origin, and |s - 1|."""
    import numpy as np

    a = np.deg2rad(yaw_deg)
    M = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]])
    Rres = np.asarray(r) @ M
    deg = float(np.degrees(np.arccos(np.clip(0.5 * (np.trace(Rres) - 1.0),
                                             -1.0, 1.0))))
    t_true = -M.T @ np.array([tx, ty, 0.0])
    return deg, float(np.linalg.norm(np.asarray(t) - t_true)), abs(s - 1.0)


def site_phase(dev, card):
    """Phase 7 (module docstring): the CAMAv2 site path and LiDAR
    aggregation, with every device step of the site path wrapped to raise
    on a tensor off the card.  Raises on any failed check."""
    import torch

    from cama_tpu_torch.aggregate import lidar as tl
    from cama_tpu_torch.aggregate import site as ts

    # the site path's device steps must see tensors on the card only
    guarded = {(ts, "_chamfer_pairs"): 0, (ts, "_refine_step"): 0,
               (tl, "_transform_points"): 0}
    reals = {key: getattr(*key) for key in guarded}

    def on_card(key, real):
        def call(*a, **k):
            flat = list(a) + list(k.values())
            for x in list(flat):
                if isinstance(x, dict):
                    flat += list(x.values())
            for x in flat:
                if isinstance(x, torch.Tensor) and x.device.type != dev.type:
                    raise RuntimeError(f"{key[1]}: a tensor on {x.device}")
            guarded[key] += 1
            return real(*a, **k)
        return call

    for key, real in reals.items():
        setattr(*key, on_card(key, real))
    try:
        site_checks(dev, card, reals[(ts, "_chamfer_pairs")])
    finally:
        for key, real in reals.items():
            setattr(*key, real)
    say("site", "guarded calls, every tensor on the card: "
                + ", ".join(f"{k[1]} {n}" for k, n in guarded.items()))
    if not all(guarded.values()):
        raise RuntimeError(f"a device step of the site path never ran: {guarded}")


def site_checks(dev, card, chamfer_cpu):
    """The checks of phase 7; chamfer_cpu is _chamfer_pairs unwrapped, for
    the comparison on CPU tensors."""
    import numpy as np
    import torch

    from cama_tpu_torch import cli
    from cama_tpu_torch.aggregate import lidar as tl
    from cama_tpu_torch.aggregate import site as ts
    from cama_tpu_torch.pipeline import ClipPipeline
    from cama_tpu_torch.tools.bench_kernels import time_ms
    from cama_tpu_torch.tools.site_cases import make_site_case, recovery_errors

    # ---- 1. the path end to end on fixture clips ----
    has_cv2 = importlib.util.find_spec("cv2") is not None
    clips = site_clips(os.path.join(WORK, "site"), has_cv2)
    results = {}
    real_refine, real_dedupe = ts.Site.refine_alignment, ts.Site.dedupe

    def recorded(name, real):
        def call(self, *a, **k):
            results[name] = real(self, *a, **k)
            return results[name]
        return call

    ts.Site.refine_alignment = recorded("refine", real_refine)
    ts.Site.dedupe = recorded("dedupe", real_dedupe)
    try:
        t0 = time.perf_counter()
        site = ts.Site.from_clips(list(clips), refine=True, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        ts.Site.refine_alignment, ts.Site.dedupe = real_refine, real_dedupe
    est = ts.estimate_sim3_to_world(site.clips[1][1])
    e_deg, e_m, e_s = sim3_error(*est, 8.0, 15.0, -7.0)
    r_deg, r_m, r_s = sim3_error(*site.clips[1][2], 8.0, 15.0, -7.0)
    before, after = results["refine"]
    say("site", f"Site.from_clips(2 fixture clips, refine=True, "
                f"device={dev.type}) in {secs:.3f} s: clip 1's Sim(3) "
                f"against the injected one (yaw 8 deg, (15, -7) m): "
                f"estimate {e_deg:.6f} deg, {e_m:.6f} m, |s-1| {e_s:.2e}; "
                f"refined {r_deg:.6f} deg, {r_m:.6f} m, |s-1| {r_s:.2e}; "
                f"refinement before {before:.6f}, after {after:.6f}; dedupe "
                f"removed {results['dedupe']} of "
                f"{results['dedupe'] + len(site.instances)} elements")
    if e_deg > 1e-3 or e_m > 1e-3 or results["dedupe"] != 8 or \
            [ci for _, _, ci in site.instances] != [0] * 8:
        raise RuntimeError("the site of the fixture clips is wrong")
    reset_all_launches()
    got = {(ci, idx): r for ci, idx, r in
           site.member_overlay_rasters(chunk=CHUNK)}
    launched = all_launches()
    apart, n_frames = 0, 0
    for ci in range(len(clips)):
        solo = dict(site.pipeline_for_clip(ci, chunk=CHUNK)
                    .iter_overlay_rasters("site"))
        if {i for c, i in got if c == ci} != set(solo):
            raise RuntimeError(f"member {ci}: the site path yields other frames")
        apart += sum(int((got[(ci, i)] != r).sum()) for i, r in solo.items())
        n_frames += len(solo)
    say("site", f"member_overlay_rasters (MultiScenePipeline, source 'site', "
                f"on the card): {n_frames} frames, {apart} pixels apart from "
                f"each member's own ClipPipeline rasters; launches on that "
                f"path: {launched}")
    if apart or launched["fused_compact_project"] <= 0:
        raise RuntimeError("the site rasters differ from the members' own, or "
                           "fused_compact_project did not run on the path")
    writes_video = shutil.which("ffmpeg") is not None or has_cv2
    if writes_video:
        conv = os.path.dirname(clips[0])
        names = [os.path.basename(c) for c in clips]
        out_dir = os.path.join(WORK, "site_videos")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        prepared = [(n, ClipPipeline(clip_path=c, device=dev), {})
                    for n, c in zip(names, clips)]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            failures = cli._run_sites(
                {"sites": [{"name": "overlap", "scenes": names}]},
                prepared, conv, out_dir, dev)
        secs = time.perf_counter() - t0
        made = sorted(os.listdir(out_dir))
        say("site", f"cli._run_sites in {secs:.2f} s: "
                    f"failures {failures}, wrote {made}")
        if failures or made != ["overlap_labels.json",
                                "overlap_scene-a_site.mp4",
                                "overlap_scene-b_site.mp4"]:
            raise RuntimeError(f"cli._run_sites failed: {buf.getvalue()[-2000:]}")
    else:
        say("site", "cli._run_sites not run: neither ffmpeg nor cv2 can "
                    "write video here")

    # ---- 2. a site at the size users run, from a seed ----
    case = make_site_case()
    n_clips = len(case["perturb"])
    big = ts.Site(name="seeded", device=dev)
    big.instances = list(case["instances"])
    big.clips = [(f"clip-{c}", None, (np.eye(3), np.zeros(3), 1.0))
                 for c in range(n_clips)]
    _, _, ii, _, _, _ = ts._candidate_pairs(big.instances, 128, 2.0)
    n_pairs = len(ii)
    say("site", f"seeded site: {n_clips} clips, {len(big.instances)} "
                f"elements, {n_pairs} candidate pairs at tol 2.0 "
                f"(S = 128, {ts._group_pairs(128)} pairs an op group)")
    if not 8192 <= n_pairs <= 65536:
        raise RuntimeError(f"{n_pairs} candidate pairs, not in 8192..65536")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    before, after = big.refine_alignment(iters=SITE_ITERS)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    errs = recovery_errors(big.clips, case["perturb"])
    rot_err = max(e[0] for e in errs)
    trans_err = max(e[1] for e in errs)
    # one step's device work, on a scratch state
    pts, w, ii, jj, clip, _ = ts._candidate_pairs(big.instances, 128, 2.0)
    data, _ = ts.refine_data(pts, w, ii, jj, clip, dev)
    params, opt, anchor = ts.refine_state(n_clips, 2e-2, dev)
    seen, step_ms = device_work(
        lambda: ts._refine_step(params, opt, anchor, data))
    launches = None if seen is None else sum(seen.values())
    say("site", f"refine_alignment(iters={SITE_ITERS}) on the card: before "
                f"{before:.6f}, after {after:.6f} (ratio "
                f"{after / before:.4f}); perturbation left, worst clip: "
                f"{rot_err:.4f} deg, {trans_err:.4f} m; "
                f"{e0.elapsed_time(e1) / SITE_ITERS:.4f} ms/step by events "
                f"({wall:.3f} s wall, probe and folding included), "
                + ("device time and launches not measured" if seen is None
                   else f"{step_ms:.4f} ms/step on the card, {launches} "
                        f"device launches/step")
                + f"; peak device memory {peak:.1f} MiB | {card}")
    if not (after < SITE_LOSS_RATIO_MAX * before
            and rot_err <= SITE_ROT_ERR_MAX_DEG
            and trans_err <= SITE_TRANS_ERR_MAX_M):
        raise RuntimeError(
            f"refinement did not recover the perturbation: ratio "
            f"{after / before:.4f} (max {SITE_LOSS_RATIO_MAX}), "
            f"{rot_err:.4f} deg (max {SITE_ROT_ERR_MAX_DEG}), "
            f"{trans_err:.4f} m (max {SITE_TRANS_ERR_MAX_M}): {errs}")
    # dedupe at 0.5 m on the refined site, card against the same code on
    # CPU tensors; a pair within 1e-5 of tol may fall either way
    tol = 0.5
    pts, w, ii, jj, _, _ = ts._candidate_pairs(big.instances, 256, tol)
    args_card = [torch.from_numpy(x).to(dev) for x in (pts, w, ii, jj)]
    args_cpu = [torch.from_numpy(x) for x in (pts, w, ii, jj)]
    d_card = ts._chamfer_pairs(*args_card).cpu().numpy()
    d_ms = time_ms(lambda: ts._chamfer_pairs(*args_card), runs=5)
    t0 = time.perf_counter()
    d_cpu = chamfer_cpu(*args_cpu).numpy()
    cpu_s = time.perf_counter() - t0
    near = np.abs(d_cpu - tol) <= 1e-5
    flips = (d_card < tol) != (d_cpu < tol)
    I = len(big.instances)
    masks = []
    for d in (d_card, d_cpu):
        close = np.zeros((I, I), bool)
        close[jj, ii] = d < tol
        masks.append(ts.greedy_keep(close))
    removed = big.dedupe(tol=tol)
    say("site", f"dedupe(tol={tol}) of {I} elements: {len(ii)} pairs (S = "
                f"256), {removed} removed; _chamfer_pairs {d_ms:.4f} ms on "
                f"the card by events = {len(ii) / d_ms * 1e3:.0f} pairs/s "
                f"(CPU tensors: {cpu_s * 1e3:.1f} ms host wall); card "
                f"against CPU: max |diff| {np.abs(d_card - d_cpu).max():.3e}, "
                f"{int(near.sum())} pairs within 1e-5 of tol, "
                f"{int(flips.sum())} decisions differ, "
                f"{int((masks[0] != masks[1]).sum())} keep entries differ | "
                f"{card}")
    if (flips & ~near).any() or (not flips.any() and (masks[0] != masks[1]).any()) \
            or removed != int((~masks[0]).sum()):
        raise RuntimeError("dedupe on the card differs from the CPU")

    # ---- 3. LiDAR at nuScenes density ----
    rng = np.random.default_rng(7)
    F, N = LIDAR_SWEEPS, LIDAR_POINTS
    counts = rng.integers(N // 2, N + 1, F)
    counts[0] = N
    valid = np.arange(N)[None, :] < counts[:, None]
    r = rng.uniform(1.0, 80.0, (F, N)).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, (F, N)).astype(np.float32)
    el = rng.uniform(-0.53, 0.19, (F, N)).astype(np.float32)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1).astype(np.float32)
    pts[~valid] = 0.0
    yaw = np.cumsum(rng.normal(0.0, 0.01, F))
    T = np.tile(np.eye(4), (F, 1, 1))
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = (
        np.cos(yaw), -np.sin(yaw), np.sin(yaw), np.cos(yaw))
    T[:, :3, 3] = np.stack([np.linspace(-100.0, 100.0, F),
                            rng.normal(0, 0.5, F), np.full(F, 1.8)], -1)
    T32 = T.astype(np.float32)
    T_c, p_c, v_c = (torch.from_numpy(x).to(dev) for x in (T32, pts, valid))
    out = tl._transform_points(T_c, p_c, v_c).cpu().numpy()
    host = tl._transform_points_host(T32, pts, valid)
    nan_same = bool((np.isnan(out) == np.isnan(host)).all())
    err = float(np.nanmax(np.abs(out - host)))
    ms = time_ms(lambda: tl._transform_points(T_c, p_c, v_c))
    _, card_ms = device_work(lambda: tl._transform_points(T_c, p_c, v_c))
    nbytes = F * N * (12 + 1 + 12) + F * 64
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    h2d = time_ms(lambda: [torch.from_numpy(x).to(dev) for x in (pts, valid)],
                  runs=3)
    d2h = time_ms(lambda: tl._transform_points(T_c, p_c, v_c).cpu(), runs=3)
    flat = out.reshape(-1, 3)
    flat = flat[~np.isnan(flat[:, 0])].astype(np.float64)
    t0 = time.perf_counter()
    vox = tl.voxel_downsample(flat, 0.2)
    vox_ms = 1e3 * (time.perf_counter() - t0)
    say("lidar", f"_transform_points, {F} sweeps x {N} points "
                 f"({int(counts.sum())} valid): max |card - host mirror| "
                 f"{err:.3e} m, NaN masks {'equal' if nan_same else 'DIFFER'}; "
                 f"{ms:.4f} ms by events, "
                 + ("not measured" if card_ms is None else f"{card_ms:.4f} ms")
                 + f" on the card, bound {bound_ms:.4f} ms ({nbytes} bytes "
                 f"at 3.35 TB/s); H2D of the sweeps {h2d:.3f} ms, transform + "
                 f"D2H {d2h:.3f} ms; voxel_downsample(0.2) {len(flat)} -> "
                 f"{len(vox)} points in {vox_ms:.1f} ms on the host | {card}")
    if err > 1e-4 or not nan_same:
        raise RuntimeError("the LiDAR transform on the card differs from the "
                           "host mirror")
    worst = 0.0
    for c in clips:
        a = tl.aggregate_lidar(c, device=dev)
        b = tl.aggregate_lidar(c, backend="host")
        if a.shape != b.shape:
            raise RuntimeError(f"aggregate_lidar: {a.shape} on the card, "
                               f"{b.shape} on the host")
        worst = max(worst, float(np.abs(a - b).max()))
    cloud = site.aggregate_lidar(voxel=0.2, every=2)
    say("lidar", f"aggregate_lidar on the fixture clips, card against "
                 f"backend='host': same point counts, max |diff| {worst:.3e} "
                 f"m; Site.aggregate_lidar(voxel 0.2) {len(cloud)} points")
    if worst > 1e-4:
        raise RuntimeError("aggregate_lidar on the card differs from the host")


QA_SOURCES = ("cama", "nuscenes")
QA_FRAMES = 17  # phase 8's wide fixture: 17 frames, 16 of them valid
QA_RUNS = 5     # CUDA-event timings of phase 8: median of this many calls


# phase 8's trace check, run as `python -c TRACE_CHILD <repo> <clip>
# <trace dir>`: a fresh process serves one sparse chunk of the clip inside
# profiling.device_trace and prints its fused-kernel launches as JSON
TRACE_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from cama_tpu_torch import pipeline as tp
from cama_tpu_torch.ops import fused_compact as fc
from cama_tpu_torch.profiling import device_trace

pipe = tp.ClipPipeline(clip_path=sys.argv[2], device="cuda")
pipe.overlay_mode("cama")
fc.reset_launches()
with device_trace(sys.argv[3], device="cuda"):
    it = pipe.iter_sparse_points("cama", max_in_flight=1)
    next(it)
    it.close()
print(json.dumps({"launched": fc.LAUNCHES["fused_compact_project"]}))
"""


def qa_clips():
    """Phase 8's scenes: the wide fixture rebuilt with camera JPEGs and its
    ground truth drawn as phase 6 draws it (the same scene: the images take
    nothing from the fixture's random stream), and a copy of it, the second
    member of the report's site.  Returns (root, clip, twin)."""
    from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip

    root = os.path.join(WORK, "qa")
    shutil.rmtree(root, ignore_errors=True)
    clip = make_fixture_clip(root, scene_name="scene-wide-17",
                             n_frames=QA_FRAMES, label_span=(-290.0, 210.0),
                             with_lidar=False)
    add_instance_masks(clip, shift_px=MASK_SHIFT_PX)
    twin = shutil.copytree(clip, os.path.join(root, "scene-wide-17b"))
    return root, clip, twin


def json_of(fn, argv):
    """(return value, last stdout line parsed as JSON, wall seconds) of an
    entry point's main(argv)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    secs = time.perf_counter() - t0
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), secs


def forget_frame_store(clip):
    """Delete the clip's frame store (io.frame_cache), so the next pipeline
    decodes its JPEGs again."""
    cache_dir = os.path.join(clip, ".cama_tpu")
    for name in os.listdir(cache_dir):
        if name.startswith("frames_"):
            os.remove(os.path.join(cache_dir, name))


def first_frame_secs(pipe, source):
    """Wall seconds from iter_frames to its first composited frame."""
    t0 = time.perf_counter()
    it = pipe.iter_frames(source)
    next(it)
    it.close()
    return time.perf_counter() - t0


def qa_phase(dev, card, scene_ref):
    """Phase 8 (module docstring): device compositing and undistort, the QA
    report, doctor, warmup and the device trace.  scene_ref: phase 6's
    Chebyshev evaluate_scene_all dict of the wide fixture's 'cama'.
    Raises on any failed check."""
    import torch

    from cama_tpu_torch import pipeline as tp

    missing = [m for m in ("cv2", "yaml") if importlib.util.find_spec(m) is None]
    if missing or scene_ref is None:
        raise RuntimeError(f"phase 8 needs cv2 and yaml (missing {missing}) "
                           "and phase 6's scene evaluation")
    t_phase = time.perf_counter()
    root, clip, twin = qa_clips()
    say("qa", f"wide fixture with camera JPEGs ({6 * QA_FRAMES} of 1600x900) and ground "
              f"truth drawn {MASK_SHIFT_PX} px low, and its copy, written in "
              f"{time.perf_counter() - t_phase:.2f} s")

    # composite_mosaic_device must see tensors on the card only
    real_composite = tp.composite_mosaic_device
    composites = [0]

    def on_card(*a, **k):
        for t in a:
            if isinstance(t, torch.Tensor) and t.device.type != dev.type:
                raise RuntimeError(f"composite_mosaic_device: a tensor on "
                                   f"{t.device}")
        composites[0] += 1
        return real_composite(*a, **k)

    tp.composite_mosaic_device = on_card
    try:
        qa_checks(dev, card, scene_ref, root, clip, twin)
    finally:
        tp.composite_mosaic_device = real_composite
    say("qa", f"composite_mosaic_device calls, every tensor on the card: "
              f"{composites[0]}; phase 8 took "
              f"{time.perf_counter() - t_phase:.1f} s")
    if not composites[0]:
        raise RuntimeError("the device mosaic never ran")


def qa_checks(dev, card, scene_ref, root, clip, twin):
    """The checks of phase 8."""
    import cv2
    import numpy as np
    import torch
    import yaml

    from cama_tpu_torch import doctor, report, warmup
    from cama_tpu_torch import pipeline as tp
    from cama_tpu_torch.eval.map_metrics import MapEvaluator
    from cama_tpu_torch.ops.raster import composite_mosaic_device
    from cama_tpu_torch.ops.undistort import remap_bilinear
    from cama_tpu_torch.profiling import device_trace
    from cama_tpu_torch.tools.bench_kernels import time_ms

    # ---- the device mosaic, both sources, every valid frame ----
    forget_counts(clip)
    pipe = tp.ClipPipeline(clip_path=clip, chunk=CHUNK, raster_kernel="auto",
                           device=dev)
    ids = sorted(valid_ids(pipe, "cama"))
    if set(ids) != valid_ids(pipe, "nuscenes") or len(ids) != QA_FRAMES - 1:
        raise RuntimeError("the sources' valid frames differ")
    reset_all_launches()
    with counting_plain_versions() as plain:
        t0 = time.perf_counter()
        mosaics = {idx: pipe.mosaics_device(QA_SOURCES, idx) for idx in ids}
        first_secs = time.perf_counter() - t0
    launches = all_launches()
    h, w = pipe.scene.output_size
    pool = ThreadPoolExecutor(max_workers=POOL_THREADS)
    rasters, bases, apart, host_ms = {}, {}, 0, []
    host_mosaic = np.empty((2 * h, 3 * w, 3), np.uint8)
    for idx in ids:
        bases[idx] = pipe.base_images(idx)
        for source in QA_SOURCES:
            rasters[idx, source] = pipe._overlay_single(source, idx)
            got = mosaics[idx][source]
            if got.shape != host_mosaic.shape or got.dtype != np.uint8:
                raise RuntimeError(f"device mosaic {got.shape} {got.dtype}")
            for _ in range(3):
                t0 = time.perf_counter()
                composite(pipe, source, idx, rasters[idx, source], "raster",
                          bases[idx], host_mosaic, pool)
                host_ms.append(1000.0 * (time.perf_counter() - t0))
            apart += int((got != host_mosaic).sum())
    pool.shutdown()
    painted = min(int((r > 0).sum()) for r in rasters.values())
    say("qa", f"mosaics_device({list(QA_SOURCES)}, idx) over the {len(ids)} "
              f"valid frames of the wide fixture ({len(ids) * 2} mosaics of "
              f"{2 * h}x{3 * w}, first pass {first_secs:.3f} s with the "
              f"counting passes and the JPEG decode): bytes differing from "
              f"composite_mosaic_frame of the same rasters {apart} (must be "
              f"0); fewest painted pixels in a raster {painted}; launches "
              f"{launches}; plain versions of kernels run: {plain or 0} "
              f"(must be 0)")
    if (apart or not painted or plain
            or launches["fused_compact_project"] < len(ids) * 2):
        raise RuntimeError("the device mosaic is out of contract")

    # its steps on the card, per frame (CUDA events, median over frames of
    # the median of QA_RUNS calls); the card alone for the first frame by a
    # CUDA graph of back-to-back calls (pageable copies cannot be captured)
    cams = pipe.scene.camera_list
    grid = torch.tensor([pipe._grid_positions()[c][0] * 3
                         + pipe._grid_positions()[c][1] for c in cams],
                        dtype=torch.int64, device=dev)
    table = torch.from_numpy(pipe._color_tables["cama"]).to(dev)
    steps = {"H2D of the base": [], "composite_mosaic_device": [],
             "D2H of the mosaic": [], "whole mosaics_device call (both "
             "sources, rasters from the fused dense program)": []}
    card_ms = {}
    for n, idx in enumerate(ids):
        stacked = np.stack([np.asarray(bases[idx][c]) for c in cams])
        base_d = torch.from_numpy(stacked).to(dev)
        cls_d = torch.from_numpy(rasters[idx, "cama"]).to(dev)
        out_d = composite_mosaic_device(base_d, cls_d, table, grid)
        fns = {"H2D of the base": lambda: torch.from_numpy(stacked).to(dev),
               "composite_mosaic_device": lambda: composite_mosaic_device(
                   base_d, cls_d, table, grid),
               "D2H of the mosaic": lambda: out_d.cpu()}
        for name, fn in fns.items():
            steps[name].append(time_ms(fn, runs=QA_RUNS))
        if n == 0:
            card_ms["composite_mosaic_device"] = device_work(
                fns["composite_mosaic_device"])[1]
        steps[list(steps)[-1]].append(time_ms(
            lambda: pipe.mosaics_device(QA_SOURCES, idx), runs=3))
    in_bytes = stacked.nbytes + cls_d.numel() + table.numel() + 8 * len(cams)
    bound_c = bound(in_bytes + out_d.numel(), 0)[0]
    med = {k: statistics.median(v) for k, v in steps.items()}
    say("time", "device mosaic, ms per frame (CUDA events, median over the "
                f"{len(ids)} frames of the median of {QA_RUNS} calls; card "
                "alone: a CUDA graph of 20 calls, first frame): "
                + ", ".join(f"{k} {v:.4f}" + (f" (card alone "
                            f"{fmt(card_ms[k], 1.0)})" if k in card_ms else "")
                            for k, v in med.items())
                + f"; composite_mosaic_device bound {bound_c:.5f} ms (bytes: "
                f"{in_bytes} in, {out_d.numel()} out at 3.35 TB/s); host "
                f"composite_mosaic_frame of the same rasters and base images "
                f"(native, {POOL_THREADS} threads) "
                f"{statistics.median(host_ms):.4f} ms per mosaic (median of "
                f"{len(host_ms)}) | {card}")

    # ---- remap_bilinear on the card ----
    cam, idx = "camera_front", ids[0]
    c = cams.index(cam)
    img = cv2.imread(pipe.scene.image_path(cam, idx))
    sc = pipe.scene
    mapx, mapy = pipe.remaps.get(cam, sc.K_orig[c], sc.d[c], sc.K_scaled[c],
                                 (h, w))
    mx_d, my_d = pipe.remaps.get_device(cam, sc.K_orig[c], sc.d[c],
                                        sc.K_scaled[c], (h, w), dev)
    img_d = torch.from_numpy(img).to(dev)
    got = remap_bilinear(img_d, mx_d, my_d)
    cpu = remap_bilinear(torch.from_numpy(img), torch.from_numpy(mapx),
                         torch.from_numpy(mapy))
    remap_apart = int((got.cpu() != cpu).sum())
    ref = cv2.remap(img, mapx, mapy, interpolation=cv2.INTER_LINEAR)
    diff = np.abs(got.cpu().numpy().astype(np.int32) - ref.astype(np.int32))
    ms_remap = time_ms(lambda: remap_bilinear(img_d, mx_d, my_d))
    card_remap = device_work(lambda: remap_bilinear(img_d, mx_d, my_d))[1]
    bound_r = bound(img.nbytes + mapx.nbytes + mapy.nbytes + got.numel(),
                    0)[0]
    say("qa", f"remap_bilinear, {img.shape[1]}x{img.shape[0]} uint8 -> "
              f"{w}x{h} ({cam}, frame {idx}): entries differing from the same "
              f"code on CPU tensors {remap_apart} (must be 0); against "
              f"cv2.remap: {int((diff <= 1).sum())} of {diff.size} entries "
              f"within 1, max |diff| {int(diff.max())}; {ms_remap:.4f} ms by "
              f"CUDA events, {fmt(card_remap, 1.0)} ms on the card alone (a CUDA "
              f"graph of 20 calls), "
              f"bound {bound_r:.5f} ms (bytes) | {card}")
    if remap_apart:
        raise RuntimeError("remap_bilinear differs between the card and CPU")

    # ---- the QA report on the card ----
    names = [os.path.basename(clip), os.path.basename(twin)]
    cfg = os.path.join(root, "config.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"converted_dataroot": root, "scene_names": names,
                        "output_video_dir": os.path.join(root, "report"),
                        "sites": [{"name": "twins", "scenes": names,
                                   "refine": True}]}, f)
    # the report's metrics must come from the batched evaluation on the
    # card: _batch_metrics swallows its failures and scene_summary then
    # evaluates per scene, so both are watched
    summaries, sites, batched, per_scene = [], [], [], []
    real = {"scene_summary": report.scene_summary,
            "site_summary": report.site_summary,
            "evaluate_scene_batch": MapEvaluator.evaluate_scene_batch,
            "evaluate_scene_all": MapEvaluator.evaluate_scene_all}

    def kept_summary(*a, **k):
        summaries.append(real["scene_summary"](*a, **k))
        return summaries[-1]

    def kept_site(*a, **k):
        sites.append(real["site_summary"](*a, **k))
        return sites[-1]

    def watched_batch(self, pipes, source, *a, **k):
        if self.backend != "device" or any(p.device.type != dev.type
                                           for p in pipes):
            raise RuntimeError("evaluate_scene_batch off the card")
        res = real["evaluate_scene_batch"](self, pipes, source, *a, **k)
        batched.append((source, sum(bool(r and r.get("frames_evaluated"))
                                    for r in res)))
        return res

    def watched_all(self, pipe, source, *a, **k):
        per_scene.append(source)
        return real["evaluate_scene_all"](self, pipe, source, *a, **k)

    report.scene_summary, report.site_summary = kept_summary, kept_site
    MapEvaluator.evaluate_scene_batch = watched_batch
    MapEvaluator.evaluate_scene_all = watched_all
    reset_all_launches()
    try:
        with counting_plain_versions() as plain:
            rc, line, secs = json_of(report.main, ["-c", cfg, "--device",
                                                   dev.type])
    finally:
        report.scene_summary = real["scene_summary"]
        report.site_summary = real["site_summary"]
        MapEvaluator.evaluate_scene_batch = real["evaluate_scene_batch"]
        MapEvaluator.evaluate_scene_all = real["evaluate_scene_all"]
    launches = all_launches()
    worst = max(abs(s["sources"]["cama"]["map_metrics"][k] - v)
                for s in summaries for k, v in scene_ref.items())
    thumbs = sum(len(s.get("thumbs", ())) for s in summaries)
    site = sites[0] if len(sites) == 1 else {}
    say("qa", f"report.main --device {dev.type}, both copies of the wide fixture "
              f"and a two-member site with refine: rc {rc}, "
              f"{json.dumps(line)}; {secs:.2f} s wall; evaluate_scene_batch "
              f"on the card, (source, scenes evaluated): {batched} (each "
              f"must be 2), per-scene evaluate_scene_all calls {per_scene} "
              f"(must be none); 'cama' map metrics of each scene within "
              f"{worst:.3e} of phase 6's evaluate_scene_all (<= 1e-4); "
              f"{thumbs} thumbnails; site: refined {site.get('refined')}, "
              f"chamfer {site.get('refine_chamfer_before_m')} m before, "
              f"{site.get('refine_chamfer_after_m')} m after; launches "
              f"{launches}; plain versions run: {plain or 0} | {card}")
    if (rc or line["failures"] or line["scenes"] != 2 or line["sites"] != 1
            or len(summaries) != 2 or not worst <= 1e-4 or plain
            or not launches["fused_compact_project"] or thumbs != 6
            or sorted(batched) != [(s, 2) for s in sorted(QA_SOURCES)]
            or per_scene or not site.get("refined")
            or "refine_chamfer_before_m" not in site
            or "refine_chamfer_after_m" not in site):
        raise RuntimeError("the QA report is out of contract")

    # ---- doctor ----
    rc, doc, secs = json_of(doctor.main, ["-c", cfg, "--timeout", "60"])
    be, tc = doc["backend"], doc["toolchain"]
    say("qa", f"doctor.main ({secs:.2f} s): backend {json.dumps(be)}; "
              f"toolchain {json.dumps(tc)}; native compositor "
              f"{doc['native_compositor']}; scenes {json.dumps(doc['scenes'])}")
    if (rc or not be["reachable"] or not be.get("nvidia_smi")
            or be["name"] != torch.cuda.get_device_name(0) or not tc["nvcc"]
            or not tc["kernels"]["built"]):
        raise RuntimeError("the doctor's report is out of contract")

    # ---- warmup --frames, then the first frame of fresh pipelines ----
    forget_frame_store(twin)
    forget_counts(twin)
    rc, warm, secs = json_of(warmup.main, ["-c", cfg, "--scene", names[1],
                                           "--device", dev.type, "--frames"])
    entry = warm["scenes"][names[1]]
    cold_first = first_frame_secs(tp.ClipPipeline(
        {"frame_cache": False}, twin, device=dev), "cama")
    warm_first = first_frame_secs(tp.ClipPipeline(clip_path=twin, device=dev),
                                  "cama")
    say("qa", f"warmup.main --frames ({secs:.2f} s): {json.dumps(entry)}, "
              f"first_frame_latency_seconds "
              f"{warm.get('first_frame_latency_seconds')}; a fresh pipeline's "
              f"first composited frame {1000.0 * cold_first:.1f} ms without "
              f"the frame store, {1000.0 * warm_first:.1f} ms with it (counts "
              f"sidecar present in both) | {card}")
    if (rc or entry["frames"]["images_cached"] != 6 * QA_FRAMES
            or entry["frames"]["hit_rate"] != 1.0
            or entry["kernels"]["cama"]["mode"] != "sparse"):
        raise RuntimeError("warmup is out of contract")

    # ---- the device trace around one serving chunk ----
    # in a fresh process, as a user's trace would start, it must name the
    # fused kernel; in this one, minutes old, torch.profiler may drop the
    # card's events (PERF.md): then device_trace must say so
    reset_all_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with device_trace(os.path.join(root, "trace_here"),
                          device=dev) as prof:
            it = pipe.iter_sparse_points("cama", max_in_flight=1)
            next(it)
            it.close()
    warned = [str(w.message) for w in caught
              if "have no device event" in str(w.message)]
    here = (all_launches()["fused_compact_project"],
            sum("fc_tile" in name for name, _ in device_events_of(prof)),
            len(device_events_of(prof)))
    trace_dir = os.path.join(root, "trace")
    proc = subprocess.run([sys.executable, "-c", TRACE_CHILD, ROOT, clip,
                           trace_dir], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode:
        raise RuntimeError(f"the trace child failed:\n{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    fused = sum("fc_tile" in name for name in kernels)
    say("qa", f"device_trace around one serving chunk, in a fresh process: "
              f"{files} ({os.path.getsize(os.path.join(trace_dir, files[0]))}"
              f" bytes, {len(events)} events, {len(kernels)} kernel events, "
              f"{fused} naming fc_tile; fused_compact_project launched "
              f"{child['launched']} time(s)); in this process: launched "
              f"{here[0]}, {here[2]} device events traced, {here[1]} naming "
              f"fc_tile, device_trace's warning: {warned or 'none'}")
    if len(files) != 1 or not fused or child["launched"] != 1:
        raise RuntimeError("the device trace does not show the fused kernel")
    if here[0] != 1 or not (here[1] or warned):
        raise RuntimeError("device_trace lost the fused kernel silently")

MESH_RANKS = 4          # phase 9b: gloo ranks sharing the one card
MESH_SHAPES = ((4, 1), (2, 2), (1, 4))  # ('frames', 'points') meshes of 9b
MESH_KERNELS = ("fast", "compact", "two_stage", "fused")
MESH_REPS = 3           # 9b steps per kernel and mesh; the first warms up
MESH_FRAMES = CHUNK     # frames per scene of 9b's scene and metric steps
MESH_TOL, MESH_RAD = 5, 20  # phase 6's metric caps


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_inputs(pipe, n_frames=None):
    """A pipeline's 'cama' as the sharded steps' global host arrays: every
    point and the first n_frames valid frames (all by default).  Returns
    (arrays, the frames' image indices)."""
    import numpy as np

    fm = pipe.frame_matrices("cama")
    fp = pipe.scene.flat["cama"]
    sel = np.flatnonzero(fm.frame_valid)[:n_frames]
    h, w = pipe.scene.output_size
    pad = (0, (-len(fp.points)) % MESH_RANKS)  # invalid points
    return {"points": np.pad(np.asarray(fp.points, np.float32), (pad, (0, 0))),
            "valid": np.pad(np.asarray(fp.valid, bool), pad),
            "cls": np.pad(np.asarray(fp.cls, np.int32), pad),
            "A": fm.A[sel].astype(np.float32),
            "B": fm.B[sel].astype(np.float32),
            "fv": np.ones(len(sel), bool),
            "lo": np.asarray(pipe._crop_lo, np.float32),
            "hi": np.asarray(pipe._crop_hi, np.float32),
            "width": w, "height": h}, [int(fm.frame_indices[i]) for i in sel]


def stack_scenes(scenes):
    """Scenes' step inputs (with the same frame count) stacked [S, ...],
    points padded with invalid ones to a common P."""
    import numpy as np

    P = max(len(a["points"]) for a in scenes)
    out = {key: np.stack([np.pad(a[key], [(0, P - len(a[key]))]
                                 + [(0, 0)] * (a[key].ndim - 1))
                          for a in scenes])
           for key in ("points", "valid", "cls")}
    out.update({key: np.stack([a[key] for a in scenes])
                for key in ("A", "B", "fv", "gt") if key in scenes[0]})
    return {**out, **{key: scenes[0][key]
                      for key in ("lo", "hi", "width", "height")}}


def on_device(a, dev):
    """Step inputs' point and frame arrays as tensors on dev."""
    import numpy as np
    import torch

    return {key: torch.from_numpy(np.asarray(a[key])).to(dev)
            for key in ("points", "valid", "cls", "A", "B", "fv")}


def list_size(a, dev):
    """The per-camera list size the 'compact' program needs on step inputs
    a: the pipeline's power-of-two cap over the largest effective count."""
    from cama_tpu_torch import pipeline as tp
    from cama_tpu_torch.ops.geometry import project_frames
    from cama_tpu_torch.ops.raster import effective_counts

    t = on_device(a, dev)
    w, h = int(a["width"]), int(a["height"])
    vu, keep = project_frames(t["points"], t["valid"], t["A"], t["B"],
                              t["fv"], w, h, a["lo"], a["hi"])
    n = int(effective_counts(vu, keep, t["cls"], w, h).max())
    return tp._pow2_cap(n, len(a["points"]))


def metric_partials(a, gt, dev, k1=None):
    """The unsharded program's partial sums (float64) over every frame of
    step inputs a against ground truth gt [F, C, H, W] bool, on dev."""
    import torch

    from cama_tpu_torch.eval.map_metrics import (PARTIAL_KEYS,
                                                 frame_metrics_rows)
    from cama_tpu_torch.ops.geometry import (crop_compact_project_idx,
                                             project_frames)

    t = on_device(a, dev)
    geo = (t["points"], t["valid"], t["A"], t["B"], t["fv"], int(a["width"]),
           int(a["height"]), a["lo"], a["hi"])
    vu, keep = (crop_compact_project_idx(*geo, k1)[:2] if k1
                else project_frames(*geo))
    rows = frame_metrics_rows(torch.from_numpy(gt).to(dev), vu, keep,
                              MESH_RAD, MESH_TOL)
    return {k: float(rows[k].to(torch.float64).sum()) for k in PARTIAL_KEYS}


def partials_apart(got, want):
    """(sre_sum's relative difference, the count partials that differ)."""
    rel = abs(got["sre_sum"] - want["sre_sum"]) / max(abs(want["sre_sum"]),
                                                     1e-30)
    return rel, [k for k in want if k != "sre_sum" and got[k] != want[k]]


def results_apart(got, want):
    """(largest difference of the result values, the counts that differ)
    of two evaluate_scene_batch lists."""
    worst, counts = 0.0, []
    for g, w_ in zip(got, want):
        if (g is None) != (w_ is None):
            return float("inf"), ["presence"]
        if g is None:
            continue
        worst = max([worst] + [abs(g[k] - w_[k]) for k in
                               ("SRE", "precision", "recall", "f1")])
        counts += [k for k in ("n_points", "gt_pixels", "frames_evaluated")
                   if g[k] != w_[k]]
    return worst, counts


def mesh_phase(clip, dev, card, backend="nccl"):
    """Phase 9 (module docstring): the multi-device tier.  Raises on any
    failed check.  Returns the fused kernel's launches on 9a's 'fused'
    step."""
    import numpy as np
    import torch.distributed as dist

    from cama_tpu_torch import pipeline as tp
    from cama_tpu_torch.eval.map_metrics import MapEvaluator
    from cama_tpu_torch.ops import fused_compact as fc
    from cama_tpu_torch.parallel import (make_mesh, make_scene_mesh,
                                         sharded_overlay_step)
    from cama_tpu_torch.parallel.cluster import free_port, run_local_cluster
    from cama_tpu_torch.tools.bench_kernels import time_ms

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    pipe = tp.ClipPipeline(clip_path=clip, chunk=CHUNK, raster_kernel="fused",
                           device=dev)
    single = dict(pipe.iter_overlay_rasters("cama"))
    k1 = pipe.crop_compact_k("cama")
    if k1 is None:
        raise RuntimeError("the wide fixture did not engage the crop split")
    a, idxs = step_inputs(pipe)
    w, h = int(a["width"]), int(a["height"])
    P, F, C = len(a["points"]), len(idxs), a["B"].shape[1]
    args = [a[key] for key in ("points", "valid", "cls", "A", "B", "fv",
                               "lo", "hi")]
    painted = sum(int((single[i] > 0).sum()) for i in idxs)

    qa = [os.path.join(WORK, "qa", n) for n in ("scene-wide-17",
                                                 "scene-wide-17b")]
    qa_pipes = want_eval = None
    if importlib.util.find_spec("cv2") and all(map(os.path.isdir, qa)):
        qa_pipes = [tp.ClipPipeline(clip_path=c, chunk=CHUNK, device=dev)
                    for c in qa]
        for p in qa_pipes:
            p.overlay_mode("cama")  # sizes the crop compaction
        want_eval = MapEvaluator(MESH_TOL, MESH_RAD).evaluate_scene_batch(
            qa_pipes, "cama")

    # ---- 9a: one rank on the card ----
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    ref, fused_launches = {}, 0
    try:
        mesh = make_mesh(1, 1, device=dev)
        for kernel in MESH_KERNELS:
            step = sharded_overlay_step(
                mesh, w, h, kernel, k1=k1 if kernel == "two_stage" else None)
            reset_all_launches()
            with counting_plain_versions() as plain:
                rasters, counts = step(*args)
                sync(dev)
            launches = all_launches()
            ref[kernel] = rasters.cpu().numpy(), counts.cpu().numpy()
            apart = sum(int((ref[kernel][0][j] != single[i]).sum())
                        for j, i in enumerate(idxs))
            ms = time_ms(lambda: step(*args), runs=5)
            say("mesh", f"9a: {dist.get_backend()}, world of 1, 1x1 mesh, "
                        f"{kernel!r} step over {F} frames x {P} points at "
                        f"{w}x{h}: pixels apart from ClipPipeline("
                        f"raster_kernel='fused') {apart} (must be 0); painted "
                        f"per class {ref[kernel][1].tolist()} (sum "
                        f"{int(ref[kernel][1].sum())}, painted pixels "
                        f"{painted}); launches {launches}; plain versions run "
                        f"{plain or 0}; {ms:.3f} ms a step by CUDA events "
                        f"(host arrays in: the shard's upload included) | "
                        f"{card}")
            if apart or int(ref[kernel][1].sum()) != painted or plain:
                raise RuntimeError(f"9a {kernel!r} step out of contract")
            if kernel == "fused":
                fused_launches = launches["fused_compact_project"]
                if fused_launches < 1 or launches["count_union"] < 1:
                    raise RuntimeError("the fused step did not launch the "
                                       "fused kernel and its count")
        if want_eval is not None:
            # both scenes on the one rank, the crop compaction engaged
            ev = MapEvaluator(MESH_TOL, MESH_RAD)
            got = ev.evaluate_scene_batch_sharded(
                qa_pipes, make_scene_mesh(1, 1, device=dev), "cama")
            worst, differing = results_apart(got, want_eval)
            k1s = [key[-1] for key in ev._sharded_steps]
            say("mesh", f"9a evaluate_scene_batch_sharded, 1x1 ('scenes', "
                        f"'frames') mesh, phase 8's two wide copies on the "
                        f"one rank: largest difference from "
                        f"evaluate_scene_batch {worst:.3e} (<= 1e-4), counts "
                        f"differing {differing}; k1 {k1s}")
            if worst > 1e-4 or differing or None in k1s:
                raise RuntimeError("9a evaluate_scene_batch_sharded out of "
                                   "contract")
    finally:
        dist.destroy_process_group()

    # ---- 9b: four gloo ranks sharing the card ----
    np.savez(os.path.join(root, "overlay.npz"), **a)
    t = on_device(a, dev)
    q = P // MESH_RANKS
    maxima = sorted(int(fc.count_union(
        t["points"][i * q:(i + 1) * q], t["valid"][i * q:(i + 1) * q],
        t["cls"][i * q:(i + 1) * q], t["A"], t["B"], t["fv"], w, h,
        a["lo"], a["hi"]).max()) for i in range(MESH_RANKS))
    if maxima[0] == maxima[-1]:
        raise RuntimeError("the point shards' union lists are alike")
    k_over = (maxima[0] + maxima[-1]) // 2
    default_clip = os.path.join(WORK, "default", "scene-default")
    scene_pipes = [pipe, tp.ClipPipeline(clip_path=default_clip, chunk=CHUNK,
                                         raster_kernel="fused", device=dev)]
    scene_in = [step_inputs(p, MESH_FRAMES) for p in scene_pipes]
    k_scenes = max(list_size(s, dev) for s, _ in scene_in)
    gts = [synthetic_gt_ids((MESH_FRAMES, C, h, w), seed=6 + s) > 0
           for s in range(len(scene_in))]
    scenes = stack_scenes([{**s, "gt": g} for (s, _), g in zip(scene_in,
                                                               gts)])
    np.savez(os.path.join(root, "scenes.npz"), **scenes)
    one = {**scene_in[0][0], "gt": gts[0]}
    np.savez(os.path.join(root, "map.npz"), **one)
    want_map = {k1_: metric_partials(one, gts[0], dev, k1_)
                for k1_ in (None, k1)}
    want_scenes = [metric_partials(s, g, dev) for (s, _), g in zip(scene_in,
                                                                   gts)]
    solo = [single, dict(scene_pipes[1].iter_overlay_rasters("cama"))]

    jobs = [{"kind": "overlay", "name": f"{kern}_{f}x{p}",
             "inputs": os.path.join(root, "overlay.npz"), "shape": [f, p],
             "kernel": kern, "k1": k1 if kern == "two_stage" else None,
             "reps": MESH_REPS, "collective": p > 1}
            for f, p in MESH_SHAPES for kern in MESH_KERNELS]
    jobs += [{"kind": "overflow", "name": "overflow",
              "inputs": os.path.join(root, "overlay.npz"), "shape": [1, 4],
              "kernel": "fused", "k": k_over},
             {"kind": "multi_scene", "name": "scenes",
              "inputs": os.path.join(root, "scenes.npz"), "shape": [2, 2],
              "k": k_scenes}]
    jobs += [{"kind": "map_metrics", "name": f"map_{k1_}",
              "inputs": os.path.join(root, "map.npz"), "shape": [4, 1],
              "max_radius": MESH_RAD, "tolerance": MESH_TOL, "k1": k1_}
             for k1_ in (None, k1)]
    jobs += [{"kind": "scene_metrics", "name": "scene_metrics",
              "inputs": os.path.join(root, "scenes.npz"), "shape": [2, 2],
              "max_radius": MESH_RAD, "tolerance": MESH_TOL}]
    if want_eval is not None:
        jobs.append({"kind": "evaluate", "name": "evaluate", "clips": qa,
                     "shape": [2, 2], "chunk": CHUNK, "tolerance": MESH_TOL,
                     "max_radius": MESH_RAD})
    jobs.append({"kind": "multihost", "name": "multihost"})
    plan = {"world": MESH_RANKS, "port": free_port(), "backend": "gloo",
            "device": (str(dev) if dev.type == "cpu"
                       else f"cuda:{dev.index or 0}"),
            "out": root, "jobs": jobs}
    with open(os.path.join(root, "plan.json"), "w") as f:
        json.dump(plan, f)
    say("mesh", f"9b: prepared in {time.perf_counter() - t_phase:.1f} s; "
                f"{MESH_RANKS} ranks, backend gloo, every rank on "
                f"{plan['device']}: FOUR RANKS SHARE ONE CARD HERE, so the "
                f"times below measure correctness and gloo's host-staged "
                f"collective, not scale-out")
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    outs = run_local_cluster(
        [[sys.executable, "-m", "cama_tpu_torch.tools.mesh_child",
          os.path.join(root, "plan.json"), str(r)]
         for r in range(MESH_RANKS)], env=env, timeout=480)
    secs = time.perf_counter() - t0
    mesh_checks(outs, root, ref, k_over, maxima, solo, scene_in, want_map,
                want_scenes, want_eval, card)
    say("mesh", f"9b: the cluster ran in {secs:.1f} s (the ranks' jobs "
                f"{max(o['seconds'] for o in outs):.1f} s); phase 9 took "
                f"{time.perf_counter() - t_phase:.1f} s")
    return fused_launches


def mesh_checks(outs, root, ref, k_over, maxima, solo, scene_in, want_map,
                want_scenes, want_eval, card):
    """The checks of phase 9b on the ranks' payloads and rank 0's
    gathered arrays."""
    import numpy as np

    def job(name):
        return [o["jobs"][name] for o in outs]

    def gathered(name):
        with np.load(os.path.join(root, f"{name}.npz")) as z:
            return {k: z[k] for k in z.files}

    bad = []
    for o in outs:
        if o["modules"] or o["backend"] != "gloo":
            bad.append(f"rank {o['rank']}: backend {o['backend']}, modules "
                       f"{o['modules'][:5]}")
    for f, p in MESH_SHAPES:
        for kern in MESH_KERNELS:
            name = f"{kern}_{f}x{p}"
            got = gathered(name)
            apart = int((got["rasters"] != ref[kern][0]).sum())
            counts_eq = bool((got["counts"] == ref[kern][1]).all())
            ranks = job(name)
            ms = [round(statistics.median(r["ms"][1:]), 3) for r in ranks]
            line = (f"9b mesh {f}x{p} {kern!r}: pixels apart from 9a {apart}"
                    f" (must be 0), counts equal {counts_eq}; ms a step per "
                    f"rank {ms}")
            if p > 1:
                ar = [round(r["allreduce_ms"], 3) for r in ranks]
                share = [round(100 * x / y, 1) for x, y in zip(ar, ms)]
                line += (f"; all_reduce(MAX) of the packed raster over "
                         f"'points' ({ranks[0]['allreduce_bytes']} B a rank) "
                         f"ms per rank {ar} = {share} % of the step")
            if kern == "fused":
                fl = [r["launches"]["fused_compact_project"] for r in ranks]
                line += f"; fused_compact_project launches per rank {fl}"
                if min(fl) < 1:
                    bad.append(f"{name}: the fused kernel did not launch")
            say("mesh", f"{line} | 4 ranks on one card | {card}")
            if apart or not counts_eq:
                bad.append(f"{name}: {apart} pixels apart, counts "
                           f"{got['counts'].tolist()}")
    over = job("overflow")
    say("mesh", f"9b overflow, fused k={k_over} on the (1, 4) mesh (point "
                f"shards' union maxima {maxima}): raised on every rank "
                f"{all(r['raised'] for r in over)}, the ranks' own maxima "
                f"{[r['local_max'] for r in over]}; message "
                f"{over[0]['message']!r}")
    if not all(r["raised"] for r in over):
        bad.append("the overflow did not raise on every rank")
    got = gathered("scenes")["rasters"]
    apart = sum(int((got[s, j] != solo[s][i]).sum())
                for s, (_, idxs) in enumerate(scene_in)
                for j, i in enumerate(idxs))
    say("mesh", f"9b sharded_multi_scene_step, (2, 2) ('scenes', 'frames') "
                f"mesh, wide + default fixture x {MESH_FRAMES} frames: pixels "
                f"apart from each scene's solo ClipPipeline rasters {apart} "
                f"(must be 0); ms per rank "
                f"{[round(r['ms'][0], 3) for r in job('scenes')]}")
    if apart:
        bad.append(f"multi-scene: {apart} pixels apart")
    for k1_, want in want_map.items():
        sums = job(f"map_{k1_}")
        rel, counts = partials_apart(sums[0]["sums"], want)
        alike = all(r["sums"] == sums[0]["sums"] for r in sums)
        say("mesh", f"9b sharded_map_metrics, (4, 1) mesh, k1 {k1_}: "
                    f"sre_sum relative difference from the unsharded program "
                    f"{rel:.3e} (<= 1e-6), count partials differing {counts},"
                    f" the same on every rank {alike}; {sums[0]['sums']}")
        if rel > 1e-6 or counts or not alike:
            bad.append(f"map metrics k1={k1_}")
    sums = job("scene_metrics")[0]["sums"]
    for s, want in enumerate(want_scenes):
        rel, counts = partials_apart({k: v[s] for k, v in sums.items()},
                                     want)
        say("mesh", f"9b sharded_scene_batch_metrics, (2, 2) mesh, scene "
                    f"{s}: sre_sum relative difference {rel:.3e} (<= 1e-6), "
                    f"count partials differing {counts}")
        if rel > 1e-6 or counts:
            bad.append(f"scene metrics, scene {s}")
    if want_eval is None:
        say("mesh", "9b evaluate_scene_batch_sharded: left out (no cv2 or "
                    "no phase 8 clips)")
    else:
        ev = job("evaluate")
        worst, counts = results_apart(ev[0]["results"], want_eval)
        alike = all(r["results"] == ev[0]["results"] for r in ev)
        say("mesh", f"9b evaluate_scene_batch_sharded on phase 8's two wide "
                    f"copies, (2, 2) mesh: largest difference from "
                    f"evaluate_scene_batch {worst:.3e} (<= 1e-4), counts "
                    f"differing {counts}, the same list on every rank "
                    f"{alike}; ms per rank "
                    f"{[round(r['ms'][0], 1) for r in ev]}; k1 "
                    f"{ev[0]['k1']}")
        if worst > 1e-4 or counts or not alike:
            bad.append("evaluate_scene_batch_sharded")
    mh = job("multihost")
    ok = (all(r["scene_rasters_ok"] and r["scene_metrics_ok"] for r in mh)
          and all(r["totals"] == mh[0]["totals"] for r in mh)
          and sorted(sum((r["failed_scenes"] for r in mh), [])) == ["c"])
    say("mesh", f"9b multihost across the ranks: totals {mh[0]['totals']}, "
                f"failed scenes {[r['failed_scenes'] for r in mh]}, hosts sum "
                f"{mh[0]['hosts_sum']}, scene steps across ranks ok {ok}")
    if not ok:
        bad.append("multihost")
    if bad:
        raise RuntimeError(f"phase 9b out of contract: {bad}")


BENCH_FRAMES = 17   # phase 10: frames of the bench's headline clip
# phase 10: the bench line's numbers that must be present and nonzero
BENCH_KEYS = ("overlay_stream_fps", "frame_stream_fps",
              "dual_video_write_fps", "dual_video_write_cold_fps",
              "multi_scene_stream_fps_batched",
              "multi_scene_stream_fps_sequential", "map_eval_fps",
              "wide_scene_fps", "wide_scene_eval_fps", "device_ms_per_frame",
              "device_ms_per_frame_fused", "device_ms_per_frame_pallas",
              "device_ms_per_frame_two_stage", "device_ms_per_frame_compact",
              "device_resident_fps_fused", "hbm_gbps_lower_bound",
              "cli_time_to_first_video_s")


def bench_phase(card):
    """Phase 10: the benchmark in a child process on the card, then the
    CLI on examples/config.yaml (module docstring)."""
    import yaml

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "bench")
    env = {**os.environ, "PYTHONPATH": ROOT, "CAMA_BENCH_DIR": root,
           "CAMA_BENCH_FRAMES": str(BENCH_FRAMES)}
    proc = subprocess.run([sys.executable, "-m", "cama_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=720)
    secs = time.perf_counter() - t_phase
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"cama_tpu_torch.bench: rc {proc.returncode}; "
                           f"stdout {proc.stdout[-1500:]!r}; stderr "
                           f"{proc.stderr[-3000:]!r}")
    line = json.loads(lines[-1])
    d = line["details"]
    say("benchmark", f"python -m cama_tpu_torch.bench: rc 0 in {secs:.1f} "
                     f"s; {line['metric']} {line['value']} {line['unit']} "
                     f"(vs_baseline {line['vs_baseline']}) | {card}")
    say("benchmark", "details: " + json.dumps(d))
    missing = [k for k in BENCH_KEYS if not d.get(k)]
    launches = d.get("device_lane_launches", {})
    bad = []
    if (line["metric"] != "6cam_full_scene_reprojection_fps"
            or not line["value"] or line["unit"] != "frames/sec"):
        bad.append(f"{line['metric']} {line['value']} {line['unit']}")
    if missing:
        bad.append(f"numbers missing or 0: {missing}")
    if d.get("failures") or d.get("skipped"):
        bad.append(f"failed {d.get('failures')}, skipped {d.get('skipped')}")
    if d.get("backend") != "cuda" or not d.get("validate_ok"):
        bad.append(f"backend {d.get('backend')}, validate_ok "
                   f"{d.get('validate_ok')}")
    if not (launches.get("fused", {}).get("fused_compact_project")
            and launches.get("pallas", {}).get("project_frame_pallas")):
        bad.append(f"device lane launches {launches}")
    # bench.py's device_ms_per_frame is the two-stage program; the headline
    # the single-stage 'compact' one, the fused one under its own key
    if d.get("device_ms_per_frame") != d.get("device_ms_per_frame_two_stage"):
        bad.append(f"device_ms_per_frame {d.get('device_ms_per_frame')} is "
                   f"not two-stage's {d.get('device_ms_per_frame_two_stage')}")
    if any(launches.get(lane, {}).get(k) for lane in ("compact", "two_stage")
           for k in ("fused_compact_project", "project_frame_pallas")):
        bad.append(f"the 'compact' programs launched a kernel: {launches}")
    if d.get("raster_kernel") != "compact":
        bad.append(f"raster_kernel {d.get('raster_kernel')}")
    if bad:
        raise RuntimeError(f"the bench line is out of contract: {bad}")

    with open(os.path.join(ROOT, "examples", "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    clip = os.path.join(root, f"scene-bench-{BENCH_FRAMES}")
    videos = os.path.join(WORK, "cli_videos")
    shutil.rmtree(videos, ignore_errors=True)
    cfg.update(converted_dataroot=root, scene_names=[os.path.basename(clip)],
               output_video_dir=videos)
    cfg.pop("cama_label_file")  # the clip carries its labels
    cfg_path = os.path.join(WORK, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cama_tpu_torch",
                           "--config", cfg_path], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    written = sorted(os.listdir(videos)) if os.path.isdir(videos) else []
    want = [f"{os.path.basename(clip)}_cama.mp4",
            f"{os.path.basename(clip)}_nuScenes.mp4"]
    first = re.search(r"first video frame at [0-9.]+s", proc.stdout)
    say("benchmark", f"python -m cama_tpu_torch --config "
                     f"(examples/config.yaml, data at the bench's headline "
                     f"clip): rc {proc.returncode} in {secs:.1f} s, "
                     f"{first.group(0) if first else 'no frame'}, wrote "
                     f"{written}; phase 10 took "
                     f"{time.perf_counter() - t_phase:.1f} s | {card}")
    if proc.returncode != 0 or written != want:
        raise RuntimeError(f"python -m cama_tpu_torch: rc {proc.returncode}, "
                           f"videos {written}; stdout {proc.stdout[-1500:]!r}"
                           f"; stderr {proc.stderr[-1500:]!r}")


def graft_phase(dev, card):
    """Phase 11: the driver-contract entry points (module docstring)."""
    import torch

    from cama_tpu_torch import graft_entry
    from cama_tpu_torch.ops import fused_compact as fc

    t_phase = time.perf_counter()
    fn, args = graft_entry.entry()
    if {a.device.type for a in args} != {"cuda"}:
        raise RuntimeError("entry() did not put its arguments on the card")
    reset_all_launches()
    with counting_plain_versions() as plain:
        rasters = fn(*args)
        sync(dev)
    launches = all_launches()
    fn_cpu, args_cpu = graft_entry.entry(device="cpu")
    want = fn_cpu(*args_cpu).numpy()
    got = rasters.cpu().numpy()
    apart = int((got != want).sum()) if got.shape == want.shape else -1
    say("graft", f"entry(): rasters {tuple(got.shape)} {got.dtype} on "
                 f"{rasters.device}, {int((got > 0).sum())} painted pixels; "
                 f"bytes apart from entry(device='cpu')'s plain program "
                 f"{apart} of {want.size} (must be 0); launches {launches} "
                 f"(fused_compact_project once for the chunk of "
                 f"{got.shape[0]} frames); plain versions run {plain or 0} "
                 f"| {card}")
    if (apart or got.shape != (8, 6, 96, 128) or plain
            or launches["fused_compact_project"] != 1):
        raise RuntimeError("entry() on the card out of contract")
    for n, clusters in ((1, [(1, "nccl"), (2, "gloo")]), (4, [(4, "gloo")])):
        t0 = time.perf_counter()
        result = graft_entry.dryrun_multichip(n)
        secs = time.perf_counter() - t0
        say("graft", f"dryrun_multichip({n}): {len(result['checks'])} checks "
                     f"in {secs:.1f} s; clusters (ranks, backend) "
                     f"{result['clusters']} on {torch.cuda.device_count()} "
                     f"card(s) | {card}")
        if len(result["checks"]) != 10 or (
                torch.cuda.device_count() == 1
                and result["clusters"] != clusters):
            raise RuntimeError(f"dryrun_multichip({n}) out of contract: "
                               f"{result}")
    say("graft", f"phase 11 took {time.perf_counter() - t_phase:.1f} s")


def _run_main(mod, argv):
    """(rc, stdout, stderr, seconds) of mod.main(argv) in this process."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def scripts_phase(card):
    """Phase 10b: each of the port's tools and demos, its main called once
    on the card at a small size (module docstring)."""
    from cama_tpu_torch.examples import (demo, demo_adaptive,
                                         demo_device_compositing,
                                         demo_multihost)
    from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
    from cama_tpu_torch.tools import (fuzz_sweep, gen_golden,
                                      profile_pipeline, validate_convert_real)

    root = os.path.join(WORK, "scripts")
    shutil.rmtree(root, ignore_errors=True)
    clip = make_fixture_clip(os.path.join(root, "clips"), scene_name="s",
                             n_frames=3, image_size=(320, 180),
                             with_lidar=False)
    add_instance_masks(clip)
    bare = make_fixture_clip(os.path.join(root, "bare"), n_frames=3,
                             with_images=False, with_lidar=False)
    small = ["--image-size", "320", "180"]

    def launches_of_pass_2(out):
        m = re.findall(r"'fused_compact_project': (\d+)", out)
        return len(m) == 2 and int(m[1]) > 0

    runs = [
        ("tools.profile_pipeline", profile_pipeline,
         ["--clip", clip, "--device", "cuda", "--with-images", "--eval",
          "--trace-dir", os.path.join(root, "trace")], 0,
         lambda out: "warm pass: 2 frames" in out and "warm eval: 2 frames"
         in out),
        ("tools.fuzz_sweep", fuzz_sweep, ["--trials", "3", "--device",
                                          "cuda"], 0,
         lambda out: "raster-vs-cv2: 3/3 passed" in out
         and "polygon-union: 3/3 passed" in out),
        ("tools.gen_golden", gen_golden,
         [os.path.join(root, "golden"), "--against",
          os.path.join(ROOT, "tests", "golden")], 0,
         lambda out: json.loads(out.strip().splitlines()[-1])["ok"]),
        # no nuScenes copy on this machine: the tool says so and exits 2
        ("tools.validate_convert_real", validate_convert_real,
         ["--work-dir", os.path.join(root, "convert")], 2,
         lambda out: "waiting" in json.loads(out.strip().splitlines()[-1])),
        ("examples.demo", demo,
         [os.path.join(root, "demo"), "--device", "cuda", "--frames", "6",
          *small], 0,
         lambda out: '"precision": 1.0' in out
         and "merged map elements from 2 clips" in out),
        ("examples.demo_adaptive", demo_adaptive, [bare, "--device", "cuda"],
         0, lambda out: "'auto' serves 'fused' on cuda" in out
         and launches_of_pass_2(out)),
        ("examples.demo_device_compositing", demo_device_compositing,
         [os.path.join(root, "dc"), "--device", "cuda", "--frames", "4",
          *small], 0,
         lambda out: "identical (1080, 2880, 3) frames" in out
         and "['cama', 'nuscenes'] in" in out),
        ("examples.demo_multihost", demo_multihost,
         ["2", "--device", "cuda", "--workdir", os.path.join(root, "mh")], 0,
         lambda out: "all 2 processes agree on the global metrics: True"
         in out),
    ]
    bad = []
    for name, mod, argv, want_rc, check in runs:
        try:
            rc, out, err, secs = _run_main(mod, argv)
            ok = rc == want_rc and check(out)
        except Exception as e:  # a script that raises fails the phase
            rc, out, err, secs, ok = repr(e)[:300], "", "", 0.0, False
        tail = out.strip().splitlines()[-1][:160] if out.strip() else ""
        shown = [os.path.relpath(a, ROOT) if a.startswith(ROOT) else a
                 for a in argv]
        say("benchmark", f"10b python -m cama_tpu_torch.{name} "
                         f"{' '.join(shown)}: rc {rc} (want {want_rc}) "
                         f"in {secs:.1f} s, output as expected {ok}; last "
                         f"line {tail!r} | {card}")
        for line in err.splitlines():
            if "warning" in line:
                say("benchmark", f"10b {name} stderr: {line[:200]}")
        if not ok:
            bad.append(name)
            say("benchmark", f"10b {name} stdout {out[-1500:]!r} stderr "
                             f"{err[-1500:]!r}")
    if bad:
        raise RuntimeError(f"phase 10b: out of contract: {bad}")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script needs a CUDA device")
    sys.path.insert(0, ROOT)
    try:
        from cama_tpu_torch import _build, native
        from cama_tpu_torch import bench as port_bench
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
    tiled = port_bench.tiled_inputs(probe, dev, N_POINTS, CHUNK_TILED)
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
        if len(seen) > 2 or seen.get("memset") != 1:
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
    # the card alone, by the method of every kernel row (device_work: a
    # CUDA graph of 20 back-to-back calls, every fill, memset and kernel
    # of a call timed, no host enqueue between them)
    seen_al, ms_al_card = device_work(library)
    ev_ak, lost_ak = device_events(lambda: paint.paint_max(*chunk_pts, h, w))
    ev_al, lost_al = device_events(library)
    say("time", f"library call's device work (a CUDA graph of 20 calls): "
                f"{seen_al}; device events of one call (torch.profiler; "
                f"name: [count, us]): paint_max {json.dumps(ev_ak)} "
                f"({lost_ak} launches lost by the trace); library (torch.full "
                f"+ scatter_reduce_) {json.dumps(ev_al)} ({lost_al} lost) "
                f"| {card}")
    bound_a, by_a = bound(3 * 4 * py_.numel() + n_img * h * w * 4,
                          int(ok_.sum()))[:2]
    say("time", f"paint_max, one 'pallas' chunk's survivor lists into "
                f"[{n_img}, {h}, {w}]: kernel {ms_ak:.4f} ms (card alone: "
                f"CUDA graph of 20 calls {fmt(dev_ms['paint_max'], 1.0)}), plain "
                f"{ms_ar:.4f} ms, library (scatter_reduce_) {ms_al:.4f} ms "
                f"(card alone: CUDA graph of 20 calls "
                f"{fmt(ms_al_card, 1.0)}), "
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
        stages[f"{entry} on the card alone (a CUDA graph)"] = (
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
        "whole chunk on the card alone (a CUDA graph)": device_work(
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
        sp_stages[f"{entry} on the card alone (a CUDA graph)"] = (
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

    # ---- phase 6: map evaluation ----
    scene_ref = eval_phase(clip, dev, card)

    # ---- phase 7: the site path and LiDAR aggregation ----
    site_phase(dev, card)

    # ---- phase 8: device compositing, the QA report and the tools ----
    qa_phase(dev, card, scene_ref)

    # ---- phase 9: the multi-device tier ----
    mesh_launches = mesh_phase(clip, dev, card)

    # ---- phase 10: the benchmark and the CLI as a user runs them ----
    bench_phase(card)
    scripts_phase(card)

    # ---- phase 11: the driver-contract entry points ----
    graft_phase(dev, card)

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
        # device_ms: the call's kernels and memsets alone (a CUDA graph).
        # launches: the main path's (the sparse stream), counting pass
        # included; mesh_launches: phase 9a's 'fused' sharded step's
        entry("fused_compact_project", fused_src,
              "cama_tpu/ops/fused_compact.py:241",
              sp_launches["fused_compact_project"], fused_err,
              ms_k * per, ms_r * per, bound_k * per, by_k, None,
              launches_per_call["fused_compact_project"], per,
              unit="ms/frame", mesh_launches=mesh_launches),
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
