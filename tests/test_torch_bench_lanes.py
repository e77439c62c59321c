"""Which program each key of cama_tpu_torch.bench's line times, on CPU.

One run of bench.main --device cpu at a small depth, with the port's chunk
programs spied on (_overlay_chunk_lists by lane, _overlay_chunk_two_stage,
_overlay_chunk, the sparse _project_compact_chunk by lane) and each stage
tagged: the headline, the overlay and frame streams and both videos run
the 'compact' lane, as bench.py's pipeline (raster_kernel='compact') does;
device_resident_fps_fused alone runs 'fused'; the wide scene runs
'production', which is the fused program there; device_ms_per_frame is
the two-stage program's.  Every details key that bench.py can print is in
the port's line, read from bench.py's source."""
import ast
import contextlib
import inspect
import io
import json
import os
from functools import partial, wraps

import pytest
import torch

from cama_tpu_torch import bench
from cama_tpu_torch import pipeline as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# device_resident_fps' frames/s and the device lane's ms a call, faked per
# program so that each key shows which program it timed
RESIDENT_FPS = {"compact": 1000.0, "fused": 2000.0, "production": 3000.0}
LANE_MS = {"two_stage": 8.0, "compact": 6.0, "fused": 2.0, "pallas": 4.0}
CHUNK = 2  # the device lane's frames
# bench.py's details keys that the port's line from a run on a card (or
# the CPU) does not carry, and why
OUTAGE_ONLY = {"error", "validate_host_lane_ok",
               "validate_host_lane_min_agreement"}
VALIDATE_ERROR_ONLY = {"validate_error"}  # the port lists it in failures
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "details"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tagged(stage, fn):
    """fn, with `stage` (a name, or a function of fn's arguments naming it)
    pushed on the stage stack while it runs, generators included."""
    stack = _tagged.stack

    def name(args, kwargs):
        return stage(*args, **kwargs) if callable(stage) else stage

    if inspect.isgeneratorfunction(fn):
        @wraps(fn)
        def gen(*args, **kwargs):
            stack.append(name(args, kwargs))
            try:
                yield from fn(*args, **kwargs)
            finally:
                stack.pop()
        return gen

    @wraps(fn)
    def call(*args, **kwargs):
        stack.append(name(args, kwargs))
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()
    return call


_tagged.stack = []


def _resident_kernel(pipe, source="cama", bench_chunk=64, kernel="compact",
                     tile_to=None):
    return f"resident:{kernel}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """bench.main --device cpu once: its line, and the (stage stack, kind,
    lane) of every chunk program it ran."""
    calls, stack = [], _tagged.stack
    root = tmp_path_factory.mktemp("bench_lanes")

    def spy(kind, fn, lane_of):
        @wraps(fn)
        def wrapped(*args, **kwargs):
            calls.append((tuple(stack), kind, lane_of(args, kwargs)))
            return fn(*args, **kwargs)
        return wrapped

    def resident(fn):
        @wraps(fn)
        def wrapped(*args, **kwargs):
            fn(*args, **kwargs)
            kernel = _resident_kernel(*args, **kwargs).split(":")[1]
            return RESIDENT_FPS[kernel]
        return wrapped

    def times_ms(fn, device):
        fn()
        return LANE_MS[calls[-1][2]], None

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(bench, "FIXTURE_ROOT", str(root))
        mp.setattr(bench, "N_FRAMES", 3)
        mp.setattr(bench, "N_POINTS", 16384)
        mp.setenv("CAMA_BENCH_CHUNK", "2")
        mp.setenv("OMP_NUM_THREADS", "1")
        for stage in ("CLI", "EVAL"):  # their keys print as null
            mp.setenv(f"CAMA_BENCH_{stage}", "0")
        mp.setattr(bench, "bench_multi_scene", lambda device: (12.5, 7.25))
        mp.setattr(bench, "run_validate", lambda clip, device: {
            "validate_ok": True, "validate_min_agreement": 0.9999884,
            "host_exact_byte_identical_to_reference": None})
        wide_fixture = bench.get_wide_fixture
        mp.setattr(bench, "get_wide_fixture",
                   lambda n_frames=3: wide_fixture(3))
        mp.setattr(tp, "_overlay_chunk_lists", spy(
            "dense", tp._overlay_chunk_lists, lambda a, k: a[0]))
        mp.setattr(tp, "_overlay_chunk_two_stage", spy(
            "dense", tp._overlay_chunk_two_stage, lambda a, k: "two_stage"))
        mp.setattr(tp, "_overlay_chunk", spy(
            "dense", tp._overlay_chunk, lambda a, k: "scatter"))
        mp.setattr(tp, "_project_compact_chunk", spy(
            "sparse", tp._project_compact_chunk,
            lambda a, k: k.get("lane", "compact")))
        mp.setattr(bench, "device_resident_fps", _tagged(
            _resident_kernel, resident(bench.device_resident_fps)))
        for method, stage in (("iter_overlay_rasters", "overlay_stream"),
                              ("iter_frames", "frame_stream"),
                              ("write_videos", "videos")):
            mp.setattr(tp.ClipPipeline, method,
                       _tagged(stage, getattr(tp.ClipPipeline, method)))
        mp.setattr(bench, "bench_wide_scene", _tagged("wide", partial(
            bench.bench_wide_scene, n_frames=3, bench_chunk=2, tile_to=4)))
        mp.setattr(bench, "bench_device_compute", _tagged(
            "device_lane", partial(bench.bench_device_compute, chunk=CHUNK)))
        mp.setattr(bench, "_times_ms", times_ms)
        assert bench.main(["--device", "cpu"]) == 0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        headline = tp.ClipPipeline(clip_path=bench.get_fixture(), chunk=8,
                                   raster_kernel="compact", device="cpu")
        wide = tp.ClipPipeline(clip_path=wide_fixture(3), chunk=8,
                               raster_kernel="compact", device="cpu")
        for pipe in (headline, wide):
            pipe.overlay_mode("cama")  # the counts sidecar: no pass
    return {"line": line, "calls": calls, "headline": headline,
            "wide": wide}


def _programs(run, stage):
    """{(kind, lane)} of the chunk programs run under `stage` (outermost)."""
    return {(kind, lane) for st, kind, lane in run["calls"]
            if st and st[0] == stage}


def test_headline_is_the_single_stage_compact_program(run):
    """value and 6cam_full_scene_reprojection_fps: device_resident_fps at
    kernel 'compact', single-stage even where the split engaged."""
    assert _programs(run, "resident:compact") == {("dense", "compact")}
    assert run["line"]["value"] == RESIDENT_FPS["compact"]
    assert run["line"]["details"]["raster_kernel"] == "compact"


def test_fused_headline_only_under_its_own_key(run):
    assert _programs(run, "resident:fused") == {("dense", "fused")}
    d = run["line"]["details"]
    assert d["device_resident_fps_fused"] == RESIDENT_FPS["fused"]
    assert [k for k, v in d.items() if v == RESIDENT_FPS["fused"]] == [
        "device_resident_fps_fused"]


def test_streams_and_videos_serve_the_compact_lane(run):
    """The overlay stream runs the 'compact' pipeline's dense program
    (two-stage where its counting pass engaged the split, as in the JAX
    package); the frame stream and both videos, cold and warm, its sparse
    program (both fixtures serve sparse)."""
    split = run["headline"].crop_compact_k("cama")
    dense = ("dense", "compact" if split is None else "two_stage")
    assert _programs(run, "overlay_stream") == {dense}
    for stage in ("frame_stream", "videos"):
        got = _programs(run, stage)
        assert ("sparse", "compact") in got, stage
        assert got <= {("sparse", "compact"), dense}, (stage, got)
    d = run["line"]["details"]
    for key in ("overlay_stream_fps", "frame_stream_fps",
                "dual_video_write_fps", "dual_video_write_cold_fps"):
        assert d[key] > 0, key


def test_wide_scene_runs_production_which_is_fused(run):
    assert _programs(run, "wide") == {("dense", "fused")}
    d = run["line"]["details"]
    assert d["wide_scene_fps"] == RESIDENT_FPS["production"]
    pipe = run["wide"]
    h, w = pipe.scene.output_size
    assert bench.fused_serves(pipe._fused_k["cama"], w, h)
    assert pipe.crop_compact_k("cama") is not None  # the split engaged


def test_production_falls_back_as_the_jax_rule_does(run, monkeypatch):
    """Over the fused budget 'production' serves two-stage where the split
    engaged (the wide scene), else single-stage 'compact'."""
    for name, pipe in (("wide", run["wide"]), ("headline", run["headline"])):
        assert bench.dense_program(pipe, "cama", "production")[2] == "fused"
        monkeypatch.setattr(bench, "FUSED_K_LIMIT", 0)
        want = ("compact" if pipe.crop_compact_k("cama") is None
                else "two_stage")
        assert bench.dense_program(pipe, "cama", "production")[2] == want
        monkeypatch.undo()
    with pytest.raises(ValueError, match="unknown kernel"):
        bench.dense_program(run["headline"], "cama", "scatter")


def test_device_ms_per_frame_is_two_stage(run):
    assert _programs(run, "device_lane") == {
        ("dense", lane) for lane in LANE_MS}
    d = run["line"]["details"]
    for lane, ms in LANE_MS.items():
        assert d[f"device_ms_per_frame_{lane}"] == ms / CHUNK, lane
    assert d["device_ms_per_frame"] == LANE_MS["two_stage"] / CHUNK
    P = d["device_lane_points"]
    s = LANE_MS["two_stage"] / CHUNK / 1e3
    assert d["device_pts_per_sec"] == pytest.approx(P / s, rel=1e-12)
    gbps = P * (12 + 1 + 1 + 8) / s / 1e9
    assert d["hbm_gbps_lower_bound"] == pytest.approx(gbps, rel=1e-12)
    assert d["hbm_util_lower_bound"] == pytest.approx(gbps / 3350.0,
                                                      rel=1e-12)
    assert set(d["device_lane_launches"]) == set(LANE_MS)


def _bench_py_details_keys():
    """Every details key bench.py can print: the string keys of the dict
    literals in main, bench_device_compute and run_validate."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in (
                "main", "bench_device_compute", "run_validate"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    keys |= {k.value for k in node.keys
                             if isinstance(k, ast.Constant)
                             and isinstance(k.value, str)}
    return keys - LINE_KEYS


def test_every_bench_py_key_is_in_the_port_line(run):
    keys = _bench_py_details_keys()
    assert {"device_ms_per_frame_compact", "hbm_gbps_lower_bound",
            "hbm_util_lower_bound", "reference_cpu_fps_min",
            "reference_cpu_fps_max", "wide_scene_fps"} <= keys
    d = run["line"]["details"]
    missing = sorted(keys - OUTAGE_ONLY - VALIDATE_ERROR_ONLY - set(d))
    assert missing == []
    assert d["reference_cpu_fps_min"] is None  # no reference checkout
    assert d["failures"] == [] and d["skipped"] == []
