"""The program's phases and spans (cama_tpu_torch/profiling.py): scene
preparation, the counting pass, the video sink's phases, evaluation set-up,
the span log with its parent ids, and the spans written into a device
trace on the trace's clock."""
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from cama_tpu_torch import pipeline as tpipe
from cama_tpu_torch import profiling
from cama_tpu_torch.eval.map_metrics import MapEvaluator
from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.io.video import VideoSink

SINK_PHASES = ("sink_open", "sink_wait", "sink_copy", "sink_close",
               "sink_encode")
NEW_PHASES = ("scene_compile", "count_pass", "eval_gt_refresh",
              "eval_layout") + SINK_PHASES
# VideoSink writes from a feeder thread by default when the host has more
# than one core; on one core the producer encodes, timed as sink_encode
ASYNC = (os.cpu_count() or 1) > 1
OLD_PHASES = ("host_composite", "host_decode", "device_dispatch",
              "sparse_fetch", "raster_fetch", "eval_gt_load", "eval_dispatch",
              "eval_fetch")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    return [make_fixture_clip(root, scene_name=f"scene-{i}", n_frames=4,
                              image_size=(320, 180), with_lidar=False,
                              seed=i)
            for i in range(2)]


@pytest.fixture(scope="module")
def gt_clip(tmp_path_factory):
    clip = make_fixture_clip(tmp_path_factory.mktemp("trace_gt"),
                             n_frames=4, with_images=False, with_lidar=False)
    add_instance_masks(clip, shift_px=2.0)
    return clip


def _forget(clip):
    for name in ("scene_cache.npz", "overlay_counts.json"):
        path = os.path.join(clip, ".cama_tpu", name)
        if os.path.exists(path):
            os.remove(path)


def _videos(tmp_path, tag):
    return {"cama": str(tmp_path / f"{tag}_cama.mp4"),
            "nuscenes": str(tmp_path / f"{tag}_nus.mp4")}


def _check_sinks(timers, sinks, frames):
    """Each sink phase recorded, one backend counter per sink, and
    sink_encode's count equal to the frames written."""
    for name in (SINK_PHASES if ASYNC
                 else ("sink_open", "sink_close", "sink_encode")):
        assert timers.count[name] >= 1, name
    assert timers.count["sink_open"] == timers.count["sink_close"] == sinks
    assert timers.count["sink_encode"] == frames
    backends = {k: n for k, n in timers.count.items()
                if k.startswith("sink_backend.")}
    assert sum(backends.values()) == sinks
    assert all(timers.total[k] == 0.0 for k in backends)


def _ancestry(spans):
    """{span id: [names of its ancestors, innermost first]}."""
    by_id = {s[4]: s for s in spans}
    out = {}
    for s in spans:
        names, parent = [], s[5]
        while parent:
            names.append(by_id[parent][2])
            parent = by_id[parent][5]
        out[s[4]] = names
    return out


def _check_disjoint(spans):
    """No new phase encloses, or sits inside, an existing phase or another
    new phase."""
    ancestry = _ancestry(spans)
    for s in spans:
        above = ancestry[s[4]]
        if s[2] in NEW_PHASES:
            assert not set(above) & set(NEW_PHASES + OLD_PHASES), (s, above)
        elif s[2] in OLD_PHASES:
            assert not set(above) & set(NEW_PHASES), (s, above)


def test_write_videos_times_scene_preparation_and_the_sinks(clips, tmp_path):
    clip = clips[0]
    _forget(clip)
    with profiling.span_log() as log:
        pipe = tpipe.ClipPipeline(clip_path=clip, chunk=2, device="cpu")
        counts = pipe.write_videos(_videos(tmp_path, "first"))
    t = pipe.timers
    assert t.count["scene_compile"] == 1 and t.count["scene_cache_miss"] == 1
    assert t.count["count_pass"] == 2 and t.count["counts_sidecar_miss"] == 2
    assert "scene_cache_hit" not in t.count
    assert "counts_sidecar_hit" not in t.count
    _check_sinks(t, 2, sum(counts.values()))
    backend = VideoSink(str(tmp_path / "b.mp4"), (64, 32)).backend
    assert [k for k in t.count if k.startswith("sink_backend.")] == [
        f"sink_backend.{backend}"]
    names = {s[2] for s in log.spans}
    assert {"scene_compile", "count_pass", "sink_close",
            "host_composite"} <= names
    if ASYNC:  # the feeder thread opens no span
        assert {"sink_wait", "sink_copy"} <= names
        assert "sink_encode" not in names
    _check_disjoint(log.spans)

    again = tpipe.ClipPipeline(clip_path=clip, chunk=2, device="cpu")
    again.write_videos(_videos(tmp_path, "second"))
    t = again.timers
    assert t.count["scene_compile"] == 1 and t.count["scene_cache_hit"] == 1
    assert t.count["counts_sidecar_hit"] == 2
    assert "count_pass" not in t.count and "scene_cache_miss" not in t.count


@pytest.mark.parametrize("async_write", [True, False], ids=["async", "sync"])
def test_sink_phases_on_both_paths(tmp_path, async_write):
    timers = profiling.PhaseTimers()
    frame = np.full((32, 63, 3), 7, np.uint8)
    cams = {cam: np.full((16, 21, 3), i, np.uint8)
            for i, cam in enumerate(c for row in tpipe.CAMERA_GRID
                                    for c in row)}
    with profiling.span_log() as log:
        sink = VideoSink(str(tmp_path / "v.mp4"), output_shape=(63, 32),
                         async_write=async_write, timers=timers)
        for _ in range(5):
            sink.add_frame(frame)
        sink.add_frame_from_dict(cams)
        sink.close()
        sink.close()  # a second close times nothing
    assert timers.count[f"sink_backend.{sink.backend}"] == 1
    assert timers.count["sink_encode"] == 6
    assert timers.count["sink_open"] == timers.count["sink_close"] == 1
    names = [s[2] for s in log.spans]
    if async_write:
        assert timers.count["sink_wait"] == 6
        assert timers.count["sink_copy"] == 7  # six copies and one concat
        assert "sink_encode" not in names  # the feeder opens no span
    else:
        assert "sink_wait" not in timers.count
        assert timers.count["sink_copy"] == 1  # the concat
        assert names.count("sink_encode") == 6
    _check_disjoint(log.spans)


def test_sink_without_timers_times_nothing(tmp_path):
    sink = VideoSink(str(tmp_path / "v.mp4"), output_shape=(64, 32),
                     async_write=True)
    sink.add_frame(np.zeros((32, 64, 3), np.uint8))
    sink.close()
    assert sink._timers is None and sink._encode_n == 1


def test_batched_write_videos_times_the_sinks(clips, tmp_path):
    pipes = [tpipe.ClipPipeline(clip_path=c, chunk=2, device="cpu")
             for c in clips]
    msp = tpipe.MultiScenePipeline(pipes, chunk=2)
    with profiling.span_log() as log:
        counts = msp.write_videos([_videos(tmp_path, f"b{i}")
                                   for i in range(len(pipes))])
    _check_sinks(msp.timers, 4, sum(sum(c.values()) for c in counts))
    _check_disjoint(log.spans)


def test_evaluate_scene_times_its_set_up(gt_clip):
    scene = compile_scene(gt_clip, output_size=(90, 160))
    pipe = tpipe.ClipPipeline(scene=scene, chunk=2, device="cpu")
    assert "scene_compile" not in pipe.timers.count  # a scene given: no lifting
    for frames in (None, [1, 2]):  # the fields kept, and none kept
        ev = MapEvaluator()
        with profiling.span_log() as log:
            out = ev.evaluate_scene(pipe, frames=frames)
        assert out["frames_evaluated"] > 0
        assert ev.timers.count["eval_gt_refresh"] >= 1, frames
        assert ev.timers.count["eval_layout"] == 1, frames
        assert ev.timers.count["eval_gt_load"] >= 1, frames
        _check_disjoint(log.spans)


def test_phase_appends_no_span_without_a_log():
    timers = profiling.PhaseTimers()
    with profiling.span_log() as log:
        with timers.phase("a"):
            pass
    assert profiling._SPAN_LOG is None and len(log.spans) == 1
    with timers.phase("b"):
        pass
    assert len(log.spans) == 1 and timers.count["b"] == 1


def test_span_log_is_bounded_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LOG_CAPACITY", 3)
    timers = profiling.PhaseTimers()
    with profiling.span_log() as log:
        for _ in range(5):
            with timers.phase("x"):
                pass
    assert len(log.spans) == 3 and log.dropped == 2
    assert timers.count["x"] == 5


def test_device_trace_holds_the_spans_with_their_parents(tmp_path):
    outer, inner = profiling.PhaseTimers(), profiling.PhaseTimers()
    sink_timers = profiling.PhaseTimers()
    with profiling.device_trace(tmp_path / "t", device="cpu") as prof:
        with outer.phase("outer"):
            time.sleep(0.002)
            torch.ones(32, 32).matmul(torch.ones(32, 32))
            time.sleep(0.002)
            with inner.phase("inner"):
                with outer.phase("innermost"):
                    pass
            sink = VideoSink(str(tmp_path / "v.mp4"), output_shape=(64, 32),
                             async_write=True, timers=sink_timers)
            sink.add_frame(np.zeros((32, 64, 3), np.uint8))
            sink.close()
    (path,) = glob.glob(str(tmp_path / "t" / "trace_*.json"))
    assert prof.trace_path == path
    with open(path) as f:
        trace = json.load(f)
    spans = {e["name"]: e for e in trace["traceEvents"]
             if e.get("cat") == "cama_span"}
    assert {"outer", "inner", "innermost", "sink_open", "sink_wait",
            "sink_copy", "sink_close"} <= set(spans)
    assert spans["outer"]["args"]["parent"] == 0
    assert spans["inner"]["args"]["parent"] == spans["outer"]["args"]["id"]
    assert (spans["innermost"]["args"]["parent"]
            == spans["inner"]["args"]["id"])
    for name in ("sink_open", "sink_wait", "sink_copy", "sink_close"):
        assert spans[name]["args"]["parent"] == spans["outer"]["args"]["id"]
    # on the trace's clock: the matmul's operator lies inside "outer"
    o = spans["outer"]
    (mm,) = [e for e in trace["traceEvents"]
             if e.get("name") == "aten::matmul"]
    assert o["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= o["ts"] + o["dur"]
    assert spans["outer"]["tid"] == mm["tid"]
    info = trace["cama_spans"]
    assert info == prof.cama_spans
    assert info["spans"] == len(spans) and info["dropped"] == 0
    assert abs(info["clock_drift_us"]) < 1e3
