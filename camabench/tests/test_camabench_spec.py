"""BENCHMARK.json against the benchmark contract, and every name in it
found as a file: cells, configurations, traffic mixes, metric readers,
entry kinds, limits and device outputs."""
from __future__ import annotations

import filecmp
import json
import os
import re
import shutil

import pytest

from camabench.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_benchmark_follows_the_contract():
    spec = Spec()
    b = spec.bench
    assert set(b) == KEYS
    assert b["command"] == ["python3", "camabench/run.py"] and b["paths"] == ["camabench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("camabench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    assert {w["config"] for w in b["workloads"]} == set(names)
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        got = {m["name"] for m in spec.metrics(w["name"], False)}
        assert "setup_s" in got and len(got) >= 2
        layer = spec.metrics(w["name"], True)
        assert layer
        for m in layer:  # the cell reports the end-to-end metric it moves
            assert m["moves"] in got
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in Spec().bench["workloads"]])
def test_every_name_is_found(cell):
    spec = Spec()
    w = spec.cell(cell)
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"]
    traffic = spec.traffic(w["traffic"])
    kind = spec.entry(traffic["entry"])
    assert isinstance(kind.LOOP, type)
    assert kind.PRODUCES in ("video_frames", "evaluated_frames")
    assert callable(spec.output(traffic["device_output"]).work)
    for trace in (False, True):
        for entry in spec.metrics(cell, trace):
            assert callable(spec.reader(entry).read)


def test_configs_name_what_they_cut():
    spec = Spec()
    for c in spec.bench["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg["published"] and cfg[key] != cfg["published"][key]


def test_a_cell_from_files_alone(tmp_path, tiny_root, cache_root):
    """A new configuration, traffic mix, metric and cell: new files and new
    entries, no file edited."""
    from camabench import run

    here, root = _copies(tmp_path, tiny_root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "nusc_scene.json").read_text())
    cfg.update(name="nusc_short", label_span_m=[-270.0, -230.0], label_sources=["nuscenes"])
    (root / "nusc_short.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "one_scene_videos.json").read_text())
    traffic.update(sample_frames=3)
    (here / "traffic" / "nuscenes_only.json").write_text(json.dumps(traffic))
    (here / "metrics" / "passes.video.py").write_text(
        'LAYER = "cli"\nUNIT, SOURCE, MOVES = "passes", "host_clock", "video_fps"\n\n\n'
        'def read(r):\n    return float(r.passes)\n')
    bench["configs"].append({"name": "nusc_short", "source": "test", "file": "nusc_short.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "short_video", "config": "nusc_short",
                               "traffic": "nuscenes_only", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("short_video")
    bench["per_layer"].append({"name": "passes.video", "unit": "passes", "better": "higher",
                               "source": "host_clock", "layer": "cli", "moves": "video_fps",
                               "workloads": ["short_video"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root=str(root), here=str(here))
    result, error = run.execute(spec, "short_video", 5, 0.5, True, "cpu", 0.0,
                                cache_root=cache_root)
    assert error is None and result["correct"], result
    assert set(result["metrics"]) == {"passes.video"}
    assert result["metrics"]["passes.video"]["value"] >= 1


def _copies(tmp_path, tiny_root):
    """A copy of camabench/ (caches left out) and of the tiny root."""
    here = tmp_path / "camabench"
    shutil.copytree(Spec().here, here, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    return here, root


# limits.json's entries when the limits were one file, moved one to a file
LIMITS = {
    "frames_gap": {
        "limit": 0, "lower": 0, "upper": None,
        "about": "frames a sink wrote in a pass, or a pass evaluated, off the reference's "
                 "count: exact"},
    "overlay_mismatch": {
        "limit": 0.04, "lower": 0.0014446826358467705, "upper": 1.0363662091410784,
        "about": "lower: the largest of 121 sound runs of the video cells on the card (82 "
                 "before every pass followed a label fix, 39 after); upper: the smallest of "
                 "12 control seeds, the reference's projection in bfloat16 (1.036-1.128)"},
    "eval_gap": {
        "limit": 0.005, "lower": 1.3264219032199164e-05, "upper": 0.8736754813506801,
        "about": "lower: the largest of 55 sound runs of wide_eval on the card with the "
                 "final ground-truth draw; upper: the smallest of 3 control seeds of that "
                 "draw (bfloat16 projection)"},
}


@pytest.mark.parametrize("name", list(LIMITS))
def test_limits_carried_over(name):
    assert Spec().limit(name) == LIMITS[name]


STUB_ENTRY = '''"""A video entry kind whose check also compares a number of its own."""
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "stub_cli", os.path.join(os.path.dirname(__file__), "cli.py"))
cli = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cli)


class Checked(cli.LOOP):
    def check(self):
        return {**super().check(), "stub_gap": float(self.traffic["stub_gap"])}


LOOP, PRODUCES = Checked, "video_frames"
'''
STUB_OUTPUT = '''def work(kept, eff, size, steps=0):
    return 8 * sum(eff) + 16 * steps, 3 * len(kept) + 100 * steps
'''


def test_kind_limit_output_from_files_alone(tmp_path, tiny_root, cache_root):
    """An entry kind, a compared number with its limit and a device output,
    each a new file in a copy of camabench/: a cell of the new kind runs,
    reports video_fps through the existing reader, is judged by the new
    limit, and the yardstick counts the new output.  No file of the copy
    was edited."""
    from camabench import check, run, work

    here, root = _copies(tmp_path, tiny_root)
    (here / "entries" / "checked_video.py").write_text(STUB_ENTRY)
    (here / "limits" / "stub_gap.json").write_text(json.dumps(
        {"limit": 0.5, "lower": 0.0, "upper": 1.0, "about": "test"}))
    (here / "outputs" / "stub_lists.py").write_text(STUB_OUTPUT)
    traffic = json.loads((here / "traffic" / "one_scene_videos.json").read_text())
    traffic.update(entry="checked_video", device_output="stub_lists", stub_gap=0.25,
                   sample_frames=3)
    (here / "traffic" / "checked_videos.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "checked_video", "config": "nusc_scene",
                               "traffic": "checked_videos", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "scene_video" in m.get("workloads", []):
            m["workloads"].append("checked_video")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root=str(root), here=str(here))

    result, error = run.execute(spec, "checked_video", 5, 0.5, False, "cpu", 0.0,
                                cache_root=cache_root)
    assert error is None and result["correct"], result
    assert set(result["metrics"]) == {"video_fps", "setup_s"}
    assert result["checks"]["stub_gap"] == {"value": 0.25, "limit": 0.5}
    assert set(result["checks"]) == {"frames_gap", "overlay_mismatch", "stub_gap"}
    assert check.judge({"stub_gap": 0.75}, spec) == (
        False, {"stub_gap": {"value": 0.75, "limit": 0.5}})
    with pytest.raises(KeyError, match="no limit"):
        check.judge({"unknown_gap": 0.0}, spec)

    frame = (100, [10, 20], [5, 7])
    base = work.frame_work(100, *frame, (4, 4), spec.output("lists"))
    lists = (4 * 12 + 4 * 2, 0)
    stub = work.frame_work(100, *frame, (4, 4), spec.output("stub_lists"))
    assert stub == (base[0] - lists[0] + 8 * 12, base[1] - lists[1] + 3 * 2)
    # a field a loop appends to a frame's record reaches its output alone
    stub_steps = work.frame_work(100, *frame, (4, 4), spec.output("stub_lists"), 5)
    assert stub_steps == (stub[0] + 16 * 5, stub[1] + 100 * 5)
    card = "NVIDIA H100 80GB HBM3"
    assert work.least_seconds([("cama", 100, [(*frame, 5)] * 3)], (4, 4),
                              spec.output("stub_lists"), card) == pytest.approx(
        3 * max(stub_steps[0] / 3.35e12, stub_steps[1] / 67e12))

    added = {"entries/checked_video.py", "limits/stub_gap.json", "outputs/stub_lists.py",
             "traffic/checked_videos.json"}
    original = Spec().here
    for d, dirs, files in os.walk(here):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), here)
            if rel in added:
                added.discard(rel)
                continue
            assert filecmp.cmp(os.path.join(d, f), os.path.join(original, rel),
                               shallow=False), rel
    assert not added


def test_unknown_entry_kind_raises(tiny_root, cache_root):
    from camabench import loops

    spec = Spec(root=tiny_root)
    with pytest.raises(ValueError, match="unknown traffic entry"):
        loops.make(spec, "scene_video", spec.config("nusc_scene"), {"entry": "no_such_kind"},
                   1, "cpu", cache_root, cache_root, None)
