"""Benchmark of the PyTorch port on one CUDA card: 6-camera full-scene
reprojection frames/s.  The counterpart of bench.py, stage for stage and
with the same function names, on this package's pipeline and kernels.

    python -m cama_tpu_torch.bench                # on the card
    python -m cama_tpu_torch.bench --device cpu   # plain versions, CPU

Stages, in order (each but the first can be switched off with its
environment variable set to 0):

  core pipeline   bench_ours on a raster_kernel='compact' pipeline, as
                  bench.py builds it: the headline (device_resident_fps,
                  the single-stage 'compact' dense program with the rasters
                  left on the device), the same on the fused kernel
                  (details.device_resident_fps_fused, the port's own key),
                  the overlay stream, the frame stream, and both overlay
                  videos written by write_videos, cold and warm
  CAMA_BENCH_MULTI     bench_multi_scene: MultiScenePipeline's batched
                       program against one scene at a time
  CAMA_BENCH_EVAL      bench_map_eval: warm MapEvaluator.evaluate_scene
  CAMA_BENCH_WIDE      bench_wide_scene ('production': the fused
                       program, as the JAX package's rule serves it there)
                       and bench_wide_eval on the 253,952-point fixture
                       (get_wide_fixture)
  CAMA_BENCH_DEVICE    bench_device_compute: the wide scene tiled to
                       1,048,576 points, the two-stage program
                       (device_ms_per_frame, as in bench.py), the
                       single-stage 'compact', 'fused' and 'pallas' ones,
                       by CUDA events and by a CUDA graph
  CAMA_BENCH_CLI       bench_cli_first_frame: the port's CLI in a child
                       process, seconds to its first video frame
  CAMA_BENCH_VALIDATE  run_validate: cama_tpu_torch.validate over every
                       path of the fixture clip

The reference loop (bench_reference) runs when CAMA_REFERENCE_ROOT names a
checkout of the original CAMA; vs_baseline is null otherwise.  Fixture clips
are built on first use under CAMA_BENCH_DIR (default: build/bench in the
checkout).  CAMA_BENCH_FRAMES (65) and CAMA_BENCH_CHUNK (64) size the
headline clip and the headline's chunk.  Every key that bench.py prints
times bench.py's program for it; the port's other lanes have keys of their
own (device_resident_fps_fused, device_ms_per_frame_{fused,pallas}).

Prints ONE JSON line last: {"metric": "6cam_full_scene_reprojection_fps",
"value", "unit", "vs_baseline", "details"}.  A stage that raises is listed in
details.failures and the script exits 1.  Without a CUDA card (and no
`--device cpu`) nothing is measured: the line carries details.backend
"unavailable" and value 0.0, with the host lane's validation evidence
(run with device 'cpu'), and the script exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_ROOT = os.environ.get("CAMA_BENCH_DIR",
                              os.path.join(REPO, "build", "bench"))
# benchmark-definition version of this package's line: bumped whenever a
# metric's measurement recipe changes
BENCH_DEF = 2  # 2: each bench.py key times bench.py's program
# 65 raw frames -> 64 processable (the reference loop starts at index 1)
N_FRAMES = int(os.environ.get("CAMA_BENCH_FRAMES", "65"))
N_POINTS = 1_048_576  # the device lane's tiled point count
REFERENCE_ROOT = os.environ.get("CAMA_REFERENCE_ROOT")
# the card's HBM peak (H100 SXM data sheet), the bytes model's denominator
HBM_PEAK_GBPS = 3350.0
# the JAX package's rule for serving the fused kernel
# (cama_tpu/pipeline.py:_finish_overlay_mode): a union list within its
# on-chip budget, and pixel codes within 24 bits
FUSED_K_LIMIT, FUSED_K_BLOCK = 262144, 128
REF_FRAME_BUDGET = int(os.environ.get("CAMA_BENCH_REF_FRAMES", "20"))
REF_REPEATS = int(os.environ.get("CAMA_BENCH_REF_REPEATS", "3"))
CAMERAS = ["camera_front_left", "camera_front", "camera_front_right",
           "camera_rear_left", "camera_rear", "camera_rear_right"]


def get_fixture():
    from cama_tpu_torch.io.fixture import make_fixture_clip

    clip = os.path.join(FIXTURE_ROOT, f"scene-bench-{N_FRAMES}")
    if not os.path.exists(os.path.join(clip, "attribute.json")):
        make_fixture_clip(
            FIXTURE_ROOT, scene_name=f"scene-bench-{N_FRAMES}",
            n_frames=N_FRAMES, with_images=True, with_lidar=False)
    return clip


def get_wide_fixture(n_frames=17):
    """The compute-bound fixture clip (built on first use): a 500 m label
    span, 253,952 padded points at 17 frames."""
    from cama_tpu_torch.io.fixture import make_fixture_clip

    name = f"scene-wide-{n_frames}"
    clip = os.path.join(FIXTURE_ROOT, name)
    if not os.path.exists(os.path.join(clip, "attribute.json")):
        make_fixture_clip(FIXTURE_ROOT, scene_name=name, n_frames=n_frames,
                          with_images=False, with_lidar=False,
                          label_span=(-290.0, 210.0))
    return clip


def _work_dir():
    """A fresh directory under FIXTURE_ROOT, removed with its context."""
    os.makedirs(FIXTURE_ROOT, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=FIXTURE_ROOT)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _best_rate(run, tries=3):
    """Frames/s of run() (which returns the frames it served), best of
    until two passes agree within 5 % (at most `tries`): single passes on
    a shared host swing widely."""
    best = 0.0
    for _ in range(tries):
        t0 = time.perf_counter()
        n = run()
        rate = n / (time.perf_counter() - t0)
        converged = rate <= best * 1.05
        best = max(best, rate)
        if converged:
            break
    return best


def bench_reference(clip, max_frames, with_video=False, video_path=None):
    """The reference's per-frame loop (seek -> transform -> crop -> project
    -> undistort -> render), timed; a list of fps per repeat, or None when
    CAMA_REFERENCE_ROOT names no checkout of it.  with_video also builds
    the reference's 3x2 grid and encodes it through this package's
    VideoSink, as bench.py does."""
    if not REFERENCE_ROOT or not os.path.isdir(
            os.path.join(REFERENCE_ROOT, "cama")):
        return None
    sys.path.insert(0, REFERENCE_ROOT)
    from cama.dataset_reader import DatasetReader
    from cama.pose_transformer import PoseTransformer
    from cama.reproject import CameraManager, MapManager

    from cama_tpu_torch.io.video import VideoSink

    mm = MapManager()
    with open(os.path.join(clip, "maps", "map_labels.json")) as f:
        labels = json.load(f)
    bev = np.load(os.path.join(clip, "maps", "vision_road_mlp_ft.npy"))
    imap0 = mm.calculate_3d_instance_maps(bev, labels)
    dr = DatasetReader(clip)
    pt = PoseTransformer()
    chassis2cam = dr.get_extrinsic("chassis", "camera_front")
    pt.loadarray(dr.get_odometry("scmv_camera_front.txt"))
    pt.right_rotate(chassis2cam)
    cm_list = [CameraManager(clip, cam) for cam in CAMERAS]
    times = dr.get_sensor_timestamp("camera_front", sync=True)
    fps = []
    for rep in range(REF_REPEATS):
        sink = (VideoSink(f"{video_path}.{rep}.mp4", output_shape=(2880, 1080))
                if with_video else None)
        n = 0
        t0 = time.perf_counter()
        for image_idx in range(1, len(times)):
            if n >= max_frames:
                break
            try:
                c2w = pt.seek_by_timestamp(times[image_idx], t_max_diff=0.5,
                                           interpolate=True).astype(np.float32)
            except RuntimeError:
                continue
            imap = mm.transform_3d_instance_maps(imap0, np.linalg.inv(c2w))
            imap = mm.crop_3d_instance_maps(imap)
            rendered = {}
            for cm in cm_list:
                cam_map = mm.transform_3d_instance_maps(
                    imap, cm.get_chassis2camera())
                image = cm.read_resized_image_by_index(image_idx)
                rendered[cm.camera_name] = cm.render_maps(
                    image, cm.project_to_image(cam_map))
            if sink is not None:
                rows = [np.concatenate([rendered[c] for c in CAMERAS[i:i + 3]],
                                       axis=1) for i in (0, 3)]
                sink.add_frame(np.concatenate(rows, axis=0))
            n += 1
        if sink is not None:
            sink.close()
        if n:
            fps.append(n / (time.perf_counter() - t0))
    return fps or None


def dense_program(pipe, source, kernel):
    """(program, limit, served): program(A, B, frame_valid) -> (class
    rasters, list counts) of bench.py's `kernel` over frame matrices on the
    device, the list size(s) its counts are held against, and the program
    it serves.  Sizes come from the pipeline's counting pass.

    'compact': the single-stage program at the per-camera list size, even
    where the counting pass engaged the two-stage split; 'production': the
    fused program at the union cap where the JAX package's rule serves it
    (fused_serves), else two-stage where the split engaged, else
    'compact'; 'fused' and 'pallas': the port's own lanes, at the union
    cap and the per-camera size."""
    from cama_tpu_torch import pipeline as tp

    st = pipe.scene_tensors(source)
    h, w = pipe.scene.output_size
    _, k = pipe.overlay_mode(source)
    ku, k1 = pipe._fused_k[source], pipe._two_stage[source]
    if kernel == "production":
        kernel = ("fused" if fused_serves(ku, w, h) else
                  "two_stage" if k1 is not None else "compact")

    def args(A, B, frame_valid):
        return (st.points, st.valid, st.cls, A, B, frame_valid,
                pipe._crop_lo, pipe._crop_hi, w, h)

    if kernel == "two_stage":
        return (lambda A, B, fv: tp._overlay_chunk_two_stage(
            *args(A, B, fv), k1, min(k, k1), False),
            np.asarray([k1, min(k, k1)]), kernel)
    sizes = {"compact": k, "fused": ku, "pallas": k}
    if kernel not in sizes:
        raise ValueError(f"unknown kernel {kernel!r}")
    return (lambda A, B, fv: tp._overlay_chunk_lists(
        kernel, *args(A, B, fv), sizes[kernel], False), sizes[kernel], kernel)


def fused_serves(k_union, width, height):
    """Whether the JAX package serves the fused kernel at this union cap
    and output size."""
    from cama_tpu_torch.ops.raster import MAX_CLS

    return (k_union + FUSED_K_BLOCK <= FUSED_K_LIMIT
            and width * height * MAX_CLS < 1 << 24)


def device_resident_fps(pipe, source="cama", bench_chunk=64,
                        kernel="compact", tile_to=None):
    """Frames/s of bench.py's `kernel` program (dense_program) with the
    rasters left on the device: only one checksum a chunk comes back.  The
    first pass holds every chunk's list counts against their sizes.

    tile_to=N repeats the scene's real frames to N before chunking, so a
    short fixture measures enough chunks in flight; pad frames (identity A,
    zero B, frame_valid False) fill the last chunk and count as frames, as
    in bench.py."""
    import torch

    from cama_tpu_torch import pipeline as tp

    fm = pipe.frame_matrices(source)
    A, B, fv = fm.A, fm.B, fm.frame_valid
    if len(fv) == 0:
        raise ValueError(f"fixture {pipe.scene.clip_path!r} yielded no frames "
                         f"for source {source!r}")
    if tile_to is not None and len(fv) < tile_to:
        reps = -(-tile_to // len(fv))
        A = np.tile(A, (reps, 1, 1))[:tile_to]
        B = np.tile(B, (reps,) + (1,) * (B.ndim - 1))[:tile_to]
        fv = np.tile(fv, reps)[:tile_to]
    pad = (-len(fv)) % bench_chunk
    A = np.concatenate([A, np.tile(np.eye(4), (pad, 1, 1))]).astype(np.float32)
    B = np.concatenate([B, np.zeros((pad,) + B.shape[1:])]).astype(np.float32)
    fv = np.concatenate([fv, np.zeros(pad, bool)])
    A, B, fv = (torch.from_numpy(a).to(pipe.device) for a in (A, B, fv))
    program, limit, served = dense_program(pipe, source, kernel)
    starts = range(0, len(fv), bench_chunk)

    def one_pass():
        sums = [program(A[s:s + bench_chunk], B[s:s + bench_chunk],
                        fv[s:s + bench_chunk])[0].sum(dtype=torch.int64)
                for s in starts]
        return torch.stack(sums).cpu()

    for s in starts:  # first-use allocations; the lists checked
        counts = program(A[s:s + bench_chunk], B[s:s + bench_chunk],
                         fv[s:s + bench_chunk])[1].cpu().numpy()
        tp._check_lists(f"device_resident_fps {source}", served, s, counts,
                        limit)
    for _ in range(2):  # the second pass is the steady state
        t0 = time.perf_counter()
        one_pass()
        dt = time.perf_counter() - t0
    return len(fv) / dt


def bench_ours(clip, device="cuda"):
    """The core stage on the headline fixture, on bench.py's pipeline
    (raster_kernel 'compact': its streams and videos serve the 'compact'
    lane): (frame stream fps, overlay stream fps, device-resident fps of
    the single-stage 'compact' program, both videos warm fps, both videos
    cold fps, frames of the last frame stream, device-resident fps of the
    fused program)."""
    from cama_tpu_torch.pipeline import ClipPipeline

    pipe = ClipPipeline(clip_path=clip, chunk=8, raster_kernel="compact",
                        device=device)
    bench_chunk = int(os.environ.get("CAMA_BENCH_CHUNK", "64"))
    dev_fps = device_resident_fps(pipe, "cama", bench_chunk)
    dev_fps_fused = device_resident_fps(pipe, "cama", bench_chunk,
                                        kernel="fused")

    # overlay streaming: the dense program and the rasters' download
    list(pipe.iter_overlay_rasters("cama"))  # first-use allocations
    stream_fps = _best_rate(
        lambda: sum(1 for _ in pipe.iter_overlay_rasters("cama")))

    def write_both(p, td):
        counts = p.write_videos({"cama": os.path.join(td, "c.mp4"),
                                 "nuscenes": os.path.join(td, "n.mp4")})
        return sum(counts.values())

    # both overlay videos in one pass, encode included.  Cold: an empty
    # frame store (JPEG decode + undistort, the store built); best of 2,
    # each in its own empty store
    dual_cold_fps = 0.0
    for _ in range(2):
        with _work_dir() as td:
            cold = ClipPipeline(clip_path=clip, chunk=8,
                                raster_kernel="compact", device=device,
                                configs={"frame_cache_dir":
                                         os.path.join(td, "fc")})
            t0 = time.perf_counter()
            n = write_both(cold, td)
            dual_cold_fps = max(dual_cold_fps,
                                n / (time.perf_counter() - t0))

    # the frame stream (serving mode, host compositing, no encode) once the
    # frame store holds every frame
    fc = pipe.frame_cache()
    for _ in range(10):  # store writes drop when full: loop until resident
        rate0 = fc.hit_rate() if fc else 1.0
        n = sum(1 for _ in pipe.iter_frames("cama"))
        if fc is None:
            break
        fc.flush()
        rate = fc.hit_rate()
        if rate >= 1.0 - 1.0 / max(n, 1) or rate <= rate0:
            break
    n_frames = [0]

    def frames():
        n_frames[0] = sum(1 for _ in pipe.iter_frames("cama"))
        return n_frames[0]

    e2e_fps = _best_rate(frames)

    def dual():
        with _work_dir() as td:
            return write_both(pipe, td)

    dual_fps = _best_rate(dual)
    return (e2e_fps, stream_fps, dev_fps, dual_fps, dual_cold_fps,
            n_frames[0], dev_fps_fused)


def _warm_eval_fps(clip, device, tries):
    """Warm evaluated frames/s of MapEvaluator.evaluate_scene on the clip's
    'cama' (ground-truth masks drawn first when missing; one cold pass
    fills the GT mask store)."""
    from cama_tpu_torch.eval.map_metrics import MapEvaluator
    from cama_tpu_torch.io.fixture import add_instance_masks
    from cama_tpu_torch.pipeline import ClipPipeline

    if not os.path.isdir(os.path.join(clip, "lane_ins_camera_front")):
        add_instance_masks(clip)
    pipe = ClipPipeline(clip_path=clip, chunk=8, device=device)
    ev = MapEvaluator()
    ev.evaluate_scene(pipe, "cama")
    cache = pipe.gt_mask_cache()
    if cache is not None:
        cache.flush()

    def one():
        r = ev.evaluate_scene(pipe, "cama")
        _sync(device)
        return r["frames_evaluated"]

    return _best_rate(one, tries)


def bench_map_eval(clip, device="cuda"):
    """Warm scene-level SRE / precision / recall evaluation, evaluated
    frames/s (best of until converged, at most 3 passes)."""
    return _warm_eval_fps(clip, device, 3)


def bench_wide_eval(clip, device="cuda"):
    """Warm evaluation at the wide scene's point count (best of 2)."""
    return _warm_eval_fps(clip, device, 2)


def bench_wide_scene(n_frames=17, device="cuda", bench_chunk=16, tile_to=64):
    """The compute-bound regime: the wide scene's 'production' program
    (the fused kernel there, as in the JAX package) on the device, with
    the rasters left there, its frames tiled to `tile_to` in chunks of
    `bench_chunk`.  Returns (fps, valid points, clip)."""
    from cama_tpu_torch.pipeline import ClipPipeline

    clip = get_wide_fixture(n_frames)
    pipe = ClipPipeline(clip_path=clip, chunk=8, raster_kernel="compact",
                        device=device)
    n_points = int(np.asarray(pipe.scene.flat["cama"].valid).sum())
    fps = device_resident_fps(pipe, "cama", bench_chunk, kernel="production",
                              tile_to=tile_to)
    return fps, n_points, clip


def tiled_inputs(pipe, device, n_points=N_POINTS, chunk=16):
    """bench.py's tiling of a scene's 'cama' points to n_points: copies
    spread by 0.35 m steps across the road, so that they rasterize to
    distinct pixels, and one chunk of `chunk` valid frames.  [points,
    valid, cls, A, B, frame_valid] on the device."""
    import torch

    fp = pipe.scene.flat["cama"]
    reps = -(-n_points // len(fp.points))
    offs = (np.arange(reps, dtype=np.float32)[:, None]
            * np.asarray([0.35, 0.17, 0.0], np.float32))
    pts = (fp.points[None] + offs[:, None]).reshape(-1, 3)[:n_points]
    cls = np.tile(fp.cls, reps)[:n_points]
    valid = np.tile(fp.valid, reps)[:n_points]
    fm = pipe.frame_matrices("cama")
    sel = np.resize(np.flatnonzero(fm.frame_valid), chunk)
    arrays = (pts, valid, cls, fm.A[sel].astype(np.float32),
              fm.B[sel].astype(np.float32), np.ones(chunk, bool))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _times_ms(fn, device):
    """(ms of one call, ms of one call on the card alone or None): CUDA
    events (median of bench_kernels.RUNS) and a CUDA graph of 20 calls
    (bench_kernels.device_work) on a card; the median wall time of 3
    calls on the CPU."""
    import torch

    from cama_tpu_torch.tools import bench_kernels as bk

    if torch.device(device).type == "cuda":
        card = bk.device_work(fn, os.path.join(FIXTURE_ROOT, "graphs"))[1]
        return bk.time_ms(fn), card
    fn()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls), None


def bench_device_compute(n_target_points=None, chunk=16, device="cuda"):
    """The device's own time on the kernels: the wide scene tiled to
    n_target_points (default N_POINTS) as one chunk of `chunk` frames, and
    four dense programs over it: the 'compact' lane's crop-first two-stage
    program (plain PyTorch; bench.py's device_ms_per_frame, the program
    the JAX counting pass engages at this span), its single-stage program
    ('compact'), 'fused' (the fused CUDA kernel, then the raster stage)
    and 'pallas' (the CUDA projection kernel, then compaction and the
    raster stage).  List sizes come from counting on the same tiled
    inputs, by the pipeline's rule, so no list overflows.  Each program is
    timed by CUDA events around one call and on the card alone (a CUDA
    graph of 20 calls); ms per frame.  With
    them, the kernel launches of one call of each lane's program (the
    call whose lists are checked): the timed calls, whose captured
    wrapper calls launch nothing and whose graph replays pass no wrapper,
    are not counted.  With bench.py's bytes model, a lower bound on the
    achieved HBM rate: P * (12 + 1 + 1 + 8) bytes a frame (positions,
    class, validity, the crop pass's scan state) over the two-stage time,
    and its share of HBM_PEAK_GBPS."""
    import torch

    from cama_tpu_torch import pipeline as tp
    from cama_tpu_torch.ops import fused_compact as fc
    from cama_tpu_torch.ops import pallas_project as pp
    from cama_tpu_torch.ops.geometry import crop_mask
    from cama_tpu_torch.ops.raster import _encode_effective

    n_target_points = n_target_points or N_POINTS
    pipe = tp.ClipPipeline(clip_path=get_wide_fixture(), chunk=8,
                           device=device)
    args = tiled_inputs(pipe, device, n_target_points, chunk)
    points, valid, cls, A, B, fv = args
    h, w = pipe.scene.output_size
    lo, hi = pipe._crop_lo, pipe._crop_hi
    P = int(points.shape[0])
    geo = (w, h, lo, hi)
    k_crop = int(crop_mask(points, valid, A, fv, lo, hi).sum(-1).max())
    vu, keep = pp.project_frame_pallas(points, valid, A, B, fv, *geo)
    k_cam = int(_encode_effective(vu, keep, cls, w, h)[1].sum(-1).max())
    del vu, keep
    ku = tp._pow2_cap(int(fc.count_union(*args, *geo).max()), P)
    k1, k2 = tp._pow2_cap(k_crop, P), tp._pow2_cap(k_cam, P)
    chunk_args = (*args, lo, hi, w, h)
    programs = {
        "two_stage": (lambda: tp._overlay_chunk_two_stage(
            *chunk_args, k1, min(k1, k2), False), np.asarray([k1, min(k1, k2)])),
        "compact": (lambda: tp._overlay_chunk_lists(
            "compact", *chunk_args, k2, False), k2),
        "fused": (lambda: tp._overlay_chunk_lists(
            "fused", *chunk_args, ku, False), ku),
        "pallas": (lambda: tp._overlay_chunk_lists(
            "pallas", *chunk_args, k2, False), k2),
    }
    out, launches = {}, {}
    for lane, (fn, limit) in programs.items():
        before = {**fc.LAUNCHES, **pp.LAUNCHES}
        counts = fn()[1].cpu().numpy()
        launches[lane] = {k: v - before[k]
                          for k, v in {**fc.LAUNCHES, **pp.LAUNCHES}.items()}
        tp._check_lists(f"device lane {lane}", lane, 0, counts, limit)
        ms, card_ms = _times_ms(fn, device)
        out[f"device_ms_per_frame_{lane}"] = ms / chunk
        out[f"device_card_ms_per_frame_{lane}"] = (
            None if card_ms is None else card_ms / chunk)
    s_prod = out["device_ms_per_frame_two_stage"] / 1e3
    gbps = P * (12 + 1 + 1 + 8) / s_prod / 1e9
    _sync(device)
    return {
        "device_ms_per_frame": out["device_ms_per_frame_two_stage"],
        **out,
        "device_lane_points": P,
        "device_pts_per_sec": P / s_prod,
        "hbm_gbps_lower_bound": gbps,
        "hbm_util_lower_bound": gbps / HBM_PEAK_GBPS,
        "device_lane_chunk": chunk,
        "device_lane_k": {"union": ku, "crop": k1, "camera": k2},
        "device_lane_launches": launches,
    }


def bench_multi_scene(n_scenes=4, n_frames=17, device="cuda", rasters=None):
    """Scene-batched against sequential serving ('compact' lane, chunk 8),
    rasters left on the device: MultiScenePipeline's program (each scene's
    lists, one raster stage over all scenes a chunk) against each scene's
    own chunk program.  Returns (batched fps, sequential fps).  rasters: a
    dict to fill with {"batched": ..., "sequential": ...}, each {(scene,
    image_idx): uint8 raster [C, H, W]} of the valid frames."""
    import torch

    from cama_tpu_torch import pipeline as tp
    from cama_tpu_torch.io.fixture import make_fixture_clip

    clips = []
    for i in range(n_scenes):
        name = f"scene-ms-{i}"
        clip = os.path.join(FIXTURE_ROOT, name)
        if not os.path.exists(os.path.join(clip, "attribute.json")):
            make_fixture_clip(FIXTURE_ROOT, scene_name=name,
                              n_frames=n_frames, with_images=False,
                              with_lidar=False, seed=i)
        clips.append(clip)
    chunk = 8
    pipes = [tp.ClipPipeline(clip_path=c, chunk=chunk, raster_kernel="compact",
                             device=device) for c in clips]
    msp = tp.MultiScenePipeline(pipes, chunk=chunk)
    state = msp._source_state("cama")
    A, B, fv, k = state["A"], state["B"], state["fv"], state["k"]
    lo, hi = pipes[0]._crop_lo, pipes[0]._crop_hi
    h, w = pipes[0].scene.output_size
    n_real = sum(int(fm.frame_valid.sum()) for fm in state["fms"])
    starts = range(0, fv.shape[1], chunk)

    # each program's rasters of chunk s: tensors that concatenate to
    # [S, chunk, C, H, W]
    def batched(s):
        return [msp._chunk_program(state, s, False)[0]]

    def sequential(s):
        sl = slice(s, s + chunk)
        out = []
        for i, p in enumerate(pipes):
            st = p.scene_tensors("cama")
            out.append(tp._overlay_chunk_compact(
                st.points, st.valid, st.cls, A[i, sl], B[i, sl], fv[i, sl],
                lo, hi, w, h, k, False)[0][None])
        return out

    def timed(program):
        def one_pass():
            return torch.stack([r.sum(dtype=torch.int64) for s in starts
                                for r in program(s)]).cpu()

        one_pass()  # first-use allocations
        t0 = time.perf_counter()
        one_pass()
        return n_real / (time.perf_counter() - t0)

    fps = (timed(batched), timed(sequential))
    if rasters is not None:
        for name, program in (("batched", batched),
                              ("sequential", sequential)):
            got = rasters.setdefault(name, {})
            for s in starts:
                r = torch.cat(program(s)).cpu().numpy()
                for i, (fm, F) in enumerate(zip(state["fms"], state["Fs"])):
                    for j in range(r.shape[1]):
                        if s + j < F and fm.frame_valid[s + j]:
                            got[(i, int(fm.frame_indices[s + j]))] = r[i, j]
    return fps


def bench_cli_first_frame(n_scenes=2, n_frames=9, device="cuda"):
    """A fresh process of the port's CLI (`python -m cama_tpu_torch
    --config`) on prepared clips (scene caches built): seconds to its first
    video frame, parsed from the CLI's own 'first video frame at Xs' line,
    and the child's wall seconds.  (None, wall) when the child fails."""
    from cama_tpu_torch.io.fixture import make_fixture_clip
    from cama_tpu_torch.pipeline import ClipPipeline

    names = []
    for i in range(n_scenes):
        name = f"scene-cli-{i}"
        clip = os.path.join(FIXTURE_ROOT, name)
        if not os.path.exists(os.path.join(clip, "attribute.json")):
            make_fixture_clip(FIXTURE_ROOT, scene_name=name,
                              n_frames=n_frames, with_images=True,
                              with_lidar=False, seed=i)
        ClipPipeline(clip_path=clip, device=device)  # the scene cache
        names.append(name)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    with _work_dir() as td:
        cfg_path = os.path.join(td, "config.yaml")
        with open(cfg_path, "w") as f:
            json.dump({  # yaml is a superset of json
                "converted_dataroot": FIXTURE_ROOT,
                "scene_names": names,
                "output_video_dir": os.path.join(td, "videos"),
            }, f)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "cama_tpu_torch", "--config", cfg_path,
             "--device", str(device)],
            capture_output=True, text=True, cwd=REPO, env=env,
            timeout=int(os.environ.get("CAMA_BENCH_CLI_TIMEOUT", "1200")))
        wall = time.perf_counter() - t0
    m = re.search(r"first video frame at ([0-9.]+)s", r.stdout)
    if r.returncode != 0 or m is None:
        print(f"bench_cli_first_frame: rc={r.returncode} stdout tail: "
              f"{r.stdout[-500:]} stderr tail: {r.stderr[-500:]}",
              file=sys.stderr)
        return None, wall
    return float(m.group(1)), wall


def run_validate(clip, device="cuda", out_path=None, kernel=None):
    """cama_tpu_torch.validate over the clip (6 frames a source, every
    path, or `kernel` alone; against the reference when
    CAMA_REFERENCE_ROOT names it), its report written to out_path
    (default: FIXTURE_ROOT/VALIDATE_torch.json; the committed
    VALIDATE.json is the JAX package's).  Returns the report's verdict:
    ok, the least per-frame agreement (against the reference where it
    ran, else against the float64 host lane) and, where the reference ran,
    whether the host lane is byte-identical to it."""
    from cama_tpu_torch import validate as val

    out_path = out_path or os.path.join(FIXTURE_ROOT, "VALIDATE_torch.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    argv = ["--clip", clip, "--frames", "6", "--device", str(device),
            "--out", out_path]
    if kernel:
        argv += ["--kernel", kernel]
    if REFERENCE_ROOT:
        argv += ["--reference", REFERENCE_ROOT]
    rc = val.main(argv)
    with open(out_path) as f:
        rep = json.load(f)
    return {
        "validate_ok": bool(rep.get("ok")) and rc == 0,
        "validate_min_agreement": rep.get(
            "device_vs_reference_min_agreement",
            rep.get("device_vs_host_exact_min_agreement")),
        "host_exact_byte_identical_to_reference": rep.get(
            "host_exact_byte_identical_to_reference"),
    }


def _stage(name):
    print(f"bench: {name}...", file=sys.stderr, flush=True)


# soft wall-clock budget: optional stages that would start past it are
# skipped (listed in details.skipped) so that a slow run still prints its
# JSON line
BENCH_BUDGET_S = float(os.environ.get("CAMA_BENCH_BUDGET_S", "1800"))


def _optional_stage(name, env, thunk, default, state):
    """Run a stage with its switch, the budget and failure isolation: a
    stage that raises prints its traceback, is listed in
    state["failures"] and yields `default`."""
    if env is not None and os.environ.get(env, "1") == "0":
        return default
    elapsed = time.perf_counter() - state["t0"]
    if elapsed > BENCH_BUDGET_S:
        print(f"bench: SKIPPING {name} (over the {BENCH_BUDGET_S:.0f} s "
              f"wall-clock budget at {elapsed:.0f} s)", file=sys.stderr,
              flush=True)
        state["skipped"].append(name)
        return default
    _stage(name)
    try:
        return thunk()
    except Exception as e:
        import traceback

        traceback.print_exc()
        state["failures"].append({"stage": name, "error": repr(e)[:300]})
        return default


def _line(value, vs_baseline, details):
    return json.dumps({"metric": "6cam_full_scene_reprojection_fps",
                       "value": value, "unit": "frames/sec",
                       "vs_baseline": vs_baseline, "details": details})


def _round(x, nd=2):
    return None if x is None else round(x, nd)


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(
        description="Benchmark of cama_tpu_torch (one JSON line last).")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; without a card the line "
                             "reports the outage and nothing is measured) "
                             "or 'cpu' (the kernels' plain versions)")
    args = parser.parse_args(argv)
    state = {"t0": time.perf_counter(), "failures": [], "skipped": []}
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        details = {"error": "no CUDA device (torch.cuda.is_available() is "
                            "False): no measurement made",
                   "backend": "unavailable"}

        def host_lane_validate():  # the NumPy float64 lane, on the CPU
            v = run_validate(get_fixture(), "cpu", os.path.join(
                FIXTURE_ROOT, "VALIDATE_torch_outage.json"), "host_lane")
            return {"validate_host_lane_ok": v["validate_ok"],
                    "validate_host_lane_min_agreement":
                        v["validate_min_agreement"],
                    "host_exact_byte_identical_to_reference":
                        v["host_exact_byte_identical_to_reference"]}

        details.update(_optional_stage(
            "host-lane validation (device cpu)", "CAMA_BENCH_VALIDATE",
            host_lane_validate, {}, state))
        details["failures"] = state["failures"]
        print(_line(0.0, None, details), flush=True)
        return 2

    from cama_tpu_torch import native
    from cama_tpu_torch.tools import bench_kernels

    clip = get_fixture()
    core = _optional_stage("core pipeline", None,
                           lambda: bench_ours(clip, device),
                           (None,) * 7, state)
    e2e_fps, stream_fps, dev_fps, dual_fps, dual_cold_fps, n, dev_fused = core
    ms_batched, ms_seq = _optional_stage(
        "multi-scene batching", "CAMA_BENCH_MULTI",
        lambda: bench_multi_scene(device=device), (None, None), state)
    map_eval_fps = _optional_stage(
        "map evaluation", "CAMA_BENCH_EVAL",
        lambda: bench_map_eval(clip, device), None, state)

    def wide():
        fps, pts, wclip = bench_wide_scene(device=device)
        return fps, pts, bench_wide_eval(wclip, device)

    wide_fps, wide_points, wide_eval_fps = _optional_stage(
        "wide scene (compute-bound regime)", "CAMA_BENCH_WIDE", wide,
        (None, None, None), state)
    dev_lane = _optional_stage(
        "device-only compute lane", "CAMA_BENCH_DEVICE",
        lambda: bench_device_compute(device=device), {}, state)
    cli_first, cli_wall = _optional_stage(
        "CLI fresh-process first frame", "CAMA_BENCH_CLI",
        lambda: bench_cli_first_frame(device=device), (None, None), state)
    val_info = _optional_stage(
        "pixel-parity validation", "CAMA_BENCH_VALIDATE",
        lambda: run_validate(clip, device), {}, state)
    if val_info and not val_info["validate_ok"]:
        state["failures"].append({"stage": "pixel-parity validation",
                                  "error": "the validation report is not ok"})
    if cli_wall is not None and cli_first is None:
        state["failures"].append({"stage": "CLI fresh-process first frame",
                                  "error": "the CLI child failed"})
    ref_runs = ref_video_runs = None
    if REFERENCE_ROOT:
        _stage("reference loop")
        ref_runs = bench_reference(clip, REF_FRAME_BUDGET)
        with _work_dir() as td:
            ref_video_runs = bench_reference(
                clip, min(REF_FRAME_BUDGET, 16), with_video=True,
                video_path=os.path.join(td, "ref"))
    ref_fps = float(np.mean(ref_runs)) if ref_runs else None
    ref_video_fps = float(np.mean(ref_video_runs)) if ref_video_runs else None
    on_card = device.type == "cuda"
    details = {
        # the headline's program on the fused kernel (the port's own key)
        "device_resident_fps_fused": _round(dev_fused),
        # the pipeline's dense program and the 2-bit rasters' download
        "overlay_stream_fps": _round(stream_fps),
        # frames in the serving mode with host compositing, no encode
        "frame_stream_fps": _round(e2e_fps),
        # both overlay videos in one pass, encode included; warm and cold
        "dual_video_write_fps": _round(dual_fps),
        "dual_video_write_cold_fps": _round(dual_cold_fps),
        "end_to_end_video_ratio": (_round(dual_fps / ref_video_fps)
                                   if dual_fps and ref_video_fps else None),
        "reference_video_write_fps": _round(ref_video_fps, 3),
        "reference_cpu_fps": _round(ref_fps, 3),
        "reference_cpu_fps_min": _round(min(ref_runs or [None]), 3),
        "reference_cpu_fps_max": _round(max(ref_runs or [None]), 3),
        "reference_repeats": len(ref_runs) if ref_runs else 0,
        "multi_scene_stream_fps_batched": _round(ms_batched),
        "multi_scene_stream_fps_sequential": _round(ms_seq),
        "map_eval_fps": _round(map_eval_fps),
        "wide_scene_fps": _round(wide_fps),
        "wide_scene_points": wide_points,
        "wide_scene_eval_fps": _round(wide_eval_fps),
        **dev_lane,
        "cli_time_to_first_video_s": cli_first,
        "cli_wall_s": _round(cli_wall, 1),
        **val_info,
        "frames": n,
        "bench_def": BENCH_DEF,
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device) if on_card
                        else "cpu"),
        # the card's name and power limit, as nvidia-smi gives them
        "card": bench_kernels.card_line() if on_card else None,
        # the lane of the headline's pipeline, its streams and videos
        "raster_kernel": "compact",
        "native_compositor": native.available(),
        "skipped": state["skipped"],
        "failures": state["failures"],
    }
    vs = dev_fps / ref_fps if dev_fps and ref_fps else None
    print(_line(_round(dev_fps) or 0.0, _round(vs), details), flush=True)
    return 1 if state["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
