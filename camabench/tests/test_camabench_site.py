"""The site_video cell: its files found by name, its two readers silent off
the cell, a tiny CPU run with `correct` true, the control failing, and the
site fixture's own check that no pair sits near the dedupe's limit."""
from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from camabench import control, run, site_fixture
from camabench.reference import site as ref_site
from camabench.spec import Spec
from camabench.tests.conftest import write_tiny_root


def cut(cfg):
    """camav2_site cut to a CPU test: 4 members of 2 rows, 40 m windows."""
    cfg = dict(cfg, frames_per_scene=4, speed_m_s=3.0)
    cfg["site"] = dict(cfg["site"], clips=4, rows=2, window_m=40.0, overlap=4)
    return cfg


@pytest.fixture(scope="module")
def site_root(tmp_path_factory):
    root = write_tiny_root(str(tmp_path_factory.mktemp("site_tiny")))
    path = os.path.join(root, "camav2_site.json")
    with open(path) as f:
        cfg = cut(json.load(f))
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


def test_files_found_by_name():
    spec = Spec()
    cell = spec.cell("site_video")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("camav2_site", "site_videos", 1)
    cfg = spec.config("camav2_site")
    assert cfg["reduced"] == ["frames_per_scene"] and cfg["published"]["frames_per_scene"] == 240
    traffic = spec.traffic("site_videos")
    kind = spec.entry(traffic["entry"])
    assert kind.PRODUCES == "video_frames"
    assert traffic["device_output"] == "site_rasters"
    assert spec.output("site_rasters").work([1] * 6, [1] * 6, (540, 960)) == (6 * 540 * 240, 0)
    for name in ("site_frame_gap", "site_refine_gap", "site_map_gap", "site_loss_gap"):
        limit = spec.limit(name)
        assert limit["lower"] < limit["limit"] < limit["upper"]
    traced = {m["name"] for m in spec.metrics("site_video", True)}
    assert traced == {"site_refine_ms.video", "site_merge_ms.video", "device_idle.video",
                      "device_roofline.video"}
    assert {m["name"] for m in spec.metrics("site_video", False)} == {"video_fps", "setup_s"}


def test_chamfer_work_counted_once_a_pass():
    """The pass's chamfer record adds pairs x S^2 x 10 operations a step
    and each pair's points and weights once an evaluation."""
    out = Spec().output("site_rasters")
    base = out.work([1] * 6, [1] * 6, (540, 960))
    nbytes, ops = out.work([1] * 6, [1] * 6, (540, 960), 10, 128, 600, 4, 256)
    assert ops == 10 * 128 * 128 * 10 * 600 + 4 * 256 * 256 * 10
    assert nbytes - base[0] == 10 * 600 * 2 * 128 * 16 + 4 * 2 * 256 * 16


@pytest.mark.parametrize("produces,timers", [
    ("video_frames", {"host_composite": 1.0, "scene_compile": 0.5}),  # scene_video's
    ("evaluated_frames", {"site_refine": 1.0, "site_align": 1.0, "site_dedupe": 1.0}),
])
def test_new_readers_silent_off_the_cell(produces, timers):
    spec = Spec()
    r = SimpleNamespace(produces=produces, frames=100, window_s=51.0, timers=timers,
                        trace=None, least_s=None)
    for name in ("site_refine_ms.video", "site_merge_ms.video"):
        assert spec.reader({"name": name}).read(r) is None


def test_new_readers_on_the_cell():
    spec = Spec()
    r = SimpleNamespace(produces="video_frames", frames=352, window_s=51.0, trace=None,
                        least_s=None, timers={"site_refine": 12.32, "site_align": 0.352,
                                              "site_dedupe": 1.408})
    assert spec.reader({"name": "site_refine_ms.video"}).read(r) == pytest.approx(35.0)
    assert spec.reader({"name": "site_merge_ms.video"}).read(r) == pytest.approx(5.0)


def test_tiny_run_correct(site_root, cache_root):
    result, error = run.execute(Spec(root=site_root), "site_video", 3000000000123, 0.5,
                                False, "cpu", 0.0, cache_root=cache_root)
    assert error is None
    assert result["correct"] and result["failed"] == 0
    assert set(result["checks"]) == {"frames_gap", "overlay_mismatch", "site_frame_gap",
                                     "site_refine_gap", "site_map_gap", "site_loss_gap"}
    assert set(result["metrics"]) == {"video_fps", "setup_s"}


def test_control_fails(site_root, cache_root):
    spec = Spec(root=site_root)
    (r,) = control.readings(spec, "site_video", [3000000000124], {3000000000124}, 1, "cpu",
                            cache_root=cache_root)
    assert all(v <= spec.limit(k)["limit"] for k, v in r["program"].items())
    for name in ("site_frame_gap", "site_refine_gap", "site_map_gap"):
        assert r["control"][name] > spec.limit(name)["limit"]


def test_fixture_keeps_pairs_off_the_dedupe_limit(tmp_path):
    """After the reference's refinement every duplicate pair (one network
    element in two members) is under 0.1 m and every other same-class pair
    over 5 m: no pair sits near the 0.5 m dedupe limit."""
    cfg = cut(Spec().config("camav2_site"))
    seed = 3000000000125
    grid = site_fixture.ensure_grid(str(tmp_path), cfg)
    members, paths = [], []
    for i in range(cfg["site"]["clips"]):
        m = site_fixture.SiteClip(cfg, seed, i)
        images = tmp_path / "images"
        for cam in cfg["cameras"]:
            os.makedirs(images / cam, exist_ok=True)
        paths.append(site_fixture.write_clip(str(tmp_path / "clips"), cfg, seed, m,
                                             str(images), grid))
        members.append(m)
    site = ref_site.build([ref_site.Member(p, cfg) for p in paths], cfg, "cpu")
    element = [e for m in members for e in m.element_ids]
    refined = site["refined"]
    assert len(element) == len(refined)
    pts, w, ii, jj, _, _ = ref_site.candidate_pairs(refined, 256, 7.0)
    P, W = torch.as_tensor(pts), torch.as_tensor(w)
    a, b = torch.as_tensor(ii), torch.as_tensor(jj)
    d = ref_site.chamfer(P[a], P[b], W[a], W[b]).numpy()
    dup = np.asarray([element[i] == element[j] for i, j in zip(ii, jj)])
    assert dup.any() and (~dup).any()
    assert d[dup].max() < 0.1 and d[~dup].min() > 5.0
