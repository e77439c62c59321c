"""Whole runs on the CPU at a tiny size: the result line's keys, the
reference against the port, the control failing its limit, and faults
planted under the timed path turning `correct` false.  One test runs a
cell on the card and skips without one."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from camabench import control, loops, run
from camabench.spec import Spec
from camabench.tests.conftest import REPO

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(tiny_root, cache_root, cell, trace=False, seed=5, seconds=0.5):
    result, error = run.execute(Spec(root=tiny_root), cell, seed, seconds, trace, "cpu",
                                0.0, cache_root=cache_root)
    json.dumps(result)
    return result, error


@pytest.mark.parametrize("cell,trace", [("scene_video", False), ("scene_video", True),
                                        ("wide_eval", False), ("release_video", False)])
def test_line_and_reference(tiny_root, cache_root, cell, trace):
    """The last line's keys in order, checks last; on the CPU lane the
    program agrees with the reference within every limit."""
    result, error = _run(tiny_root, cache_root, cell, trace)
    assert error is None
    assert list(result) == LINE_KEYS
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in Spec(root=tiny_root).metrics(cell, trace)}
    cpu_missing = {n for n in names if n.startswith("device_")}  # no card trace here
    assert set(result["metrics"]) == names - cpu_missing
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell,passes", [("scene_video", 1), ("wide_eval", 1)])
def test_control_fails(tiny_root, cache_root, cell, passes):
    """The reference in bfloat16, put in the program's place, exceeds a
    limit; the program on the same inputs does not."""
    spec = Spec(root=tiny_root)
    (r,) = control.readings(spec, cell, [9], {9}, passes, "cpu", cache_root=cache_root)
    assert r["limits"] == {k: spec.limit(k)["limit"] for k in r["program"]}
    assert all(v <= spec.limit(k)["limit"] for k, v in r["program"].items())
    assert any(v > spec.limit(k)["limit"] for k, v in r["control"].items())


def _fault_paint_nothing(mp):
    import cama_tpu_torch.native as native

    mp.setattr(native, "paint_sparse", lambda vals, count, table, width, out: out)


def _fault_half_cameras(mp):
    import cama_tpu_torch.pipeline as pipeline

    real = pipeline._project_compact_chunk

    def half(*a, **k):
        vals, counts, union = real(*a, **k)
        counts = counts.clone()
        counts[:, ::2] = 0
        return vals, counts, union

    mp.setattr(pipeline, "_project_compact_chunk", half)


def _fault_shift_pixels(mp):
    import cama_tpu_torch.native as native

    real = native.paint_sparse

    def shifted(vals, count, table, width, out):
        v = np.asarray(vals).copy()
        v[v >= 0] += 8 * 3  # three pixels to the right
        return real(v, count, table, width, out)

    mp.setattr(native, "paint_sparse", shifted)


def _fault_half_frames(mp):
    from cama_tpu_torch.eval.map_metrics import MapEvaluator

    real = MapEvaluator._chunk_layout

    def every_other(self, pipeline, source):
        for i, item in enumerate(real(self, pipeline, source)):
            if i % 2 == 0:
                yield item

    mp.setattr(MapEvaluator, "_chunk_layout", every_other)


def _fault_sum_altered(mp):
    import cama_tpu_torch.eval.map_metrics as mm

    real = mm.reduce_metrics

    def altered(partials):
        out = real(partials)
        out["SRE"] *= 1.01
        return out

    mp.setattr(mm, "reduce_metrics", altered)


@pytest.mark.parametrize("cell,fault", [
    ("scene_video", _fault_paint_nothing),   # a step that returns its state unchanged
    ("scene_video", _fault_half_cameras),    # half of the batch left out
    ("scene_video", _fault_shift_pixels),    # an answer altered where it is produced
    ("wide_eval", _fault_half_frames),       # half the frames, the sums over the rest
    ("wide_eval", _fault_sum_altered),       # an answer altered where it is produced
])
def test_faults_are_not_correct(tiny_root, cache_root, monkeypatch, cell, fault):
    import cama_tpu_torch.eval.map_metrics as mm

    # the tiny clips are only 4 frames: chunks of 2 frames give the
    # half-frames fault something to leave out
    if fault is _fault_half_frames:
        import cama_tpu_torch.pipeline as pipeline

        real_init = pipeline.ClipPipeline.__init__

        def init(self, *a, **k):
            real_init(self, *a, **k)
            self.chunk = 2

        monkeypatch.setattr(pipeline.ClipPipeline, "__init__", init)
    assert mm  # imported before the fault replaces its functions
    from camabench.taps import Taps

    real_start = Taps.start_window

    def start_window(self):  # the fault comes with the window, after set-up
        real_start(self)
        fault(monkeypatch)

    monkeypatch.setattr(Taps, "start_window", start_window)
    result, _ = _run(tiny_root, cache_root, cell, seed=77)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell through the command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = Spec().bench["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "camabench/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "camabench/run.py", "--workload", "scene_video",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()


def test_video_passes_follow_a_label_fix(tiny_root, cache_root, monkeypatch):
    """Every pass of a video cell lifts its scene's labels anew (no compiled
    scene is reused) and finds the labels of its own draw."""
    import cama_tpu_torch.ops.lift as lift

    lifted = []
    real = lift.lift_cama_instances

    def counting(labels, *a, **k):
        lifted.append(round(float(labels[0]["data"][0][0]), 9))
        return real(labels, *a, **k)

    monkeypatch.setattr(lift, "lift_cama_instances", counting)
    result, error = _run(tiny_root, cache_root, "scene_video", seed=41, seconds=1.0)
    assert error is None and result["correct"], result["checks"]
    passes = result["attempted"] + 1  # the window's and set-up's warm pass
    assert len(lifted) >= passes and len(set(lifted[-passes:])) == passes


@pytest.mark.parametrize("first,second", [("scene_video", "scene_eval"),
                                          ("scene_eval", "scene_video")])
def test_cells_of_one_config_share_a_cache_root(tiny_root, tmp_path, first, second):
    """A cli cell (camera images) and an evaluate_scene cell (ground-truth
    masks) of one configuration and seed, in one cache root, in either
    order: each finds clips that hold its own fixtures, and both read
    correct."""
    cache = str(tmp_path / "cache")
    for cell in (first, second):
        result, error = _run(tiny_root, cache, cell, seed=23)
        assert error is None and result["correct"], (cell, error, result["checks"])
    spec = Spec(root=tiny_root)
    keys = {loops.fixture_set(spec.traffic(spec.cell(c)["traffic"]))[0]
            for c in (first, second)}
    seeds = os.path.join(cache, "nusc_scene", "seeds", "23")
    assert len(keys) == 2 and set(os.listdir(seeds)) == keys
    for key in keys:
        with open(os.path.join(seeds, key, "scene-0000.complete")) as f:
            assert "+".join(json.load(f)["needs"]) == key.split("-")[0]
