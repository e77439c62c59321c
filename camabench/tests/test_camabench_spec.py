"""BENCHMARK.json against the benchmark contract, and every name in it
found as a file: cells, configurations, traffic mixes, metric readers."""
from __future__ import annotations

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
    assert spec.traffic(w["traffic"])["entry"] in ("cli", "evaluate_scene")
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

    here = tmp_path / "camabench"
    shutil.copytree(os.path.join(Spec().here, "traffic"), here / "traffic")
    shutil.copytree(os.path.join(Spec().here, "metrics"), here / "metrics")
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
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
