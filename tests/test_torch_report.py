"""cama_tpu_torch.report against cama_tpu.report on CPU, on the same fixture
clips (5 frames, the fewest the pose metrics accept, with camera JPEGs and
ground-truth instance masks):
scene_summary's counts and frame lists exact, its map ratios within 1e-4
(the f32 border class: tests/test_torch_eval_scene.py), its pose metrics
within 1e-9 relative, the same keys; thumbnails that decode to the
pipeline's own mosaic; render_html byte-equal to JAX's page; report.main
end to end, and its fleet-batched evaluation path."""
import base64
import json
import math
import time

import cv2
import numpy as np
import pytest
import torch
import yaml

from cama_tpu import report as jreport
from cama_tpu.pipeline import ClipPipeline as JClipPipeline
from cama_tpu_torch import report as treport
from cama_tpu_torch.eval.map_metrics import MapEvaluator
from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
from cama_tpu_torch.io.video import concat_camera_grid
from cama_tpu_torch.pipeline import ClipPipeline

RATIO_ABS_TOL = 1e-4
POSE_REL_TOL = 1e-9
EXACT_KEYS = ("n_points", "gt_pixels", "frames_evaluated")
SCENES = ("scene-r0", "scene-r1")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Two clips of one world (seed 0: a site over them dedupes overlaps)
    and a config naming both."""
    root = tmp_path_factory.mktemp("treport")
    clips = {}
    for name in SCENES:
        clips[name] = make_fixture_clip(root / "converted", scene_name=name,
                                        n_frames=5, seed=0)
        add_instance_masks(clips[name])
    cfg = {"version": "v", "dataroot": str(root / "raw"),
           "converted_dataroot": str(root / "converted"),
           "scene_names": list(SCENES),
           "cama_label_file": str(root / "missing.zip"),
           "output_video_dir": str(root / "videos")}
    return {"root": root, "clips": clips, "cfg": cfg}


def _config(ws, name, **extra):
    path = ws["root"] / f"{name}.yaml"
    path.write_text(yaml.safe_dump({**ws["cfg"], **extra}))
    return str(path)


@pytest.fixture(scope="module")
def summaries(ws):
    """{package: scene_summary of scene-r0 (max_frames=2, thumbnails=2)},
    with the port's pipeline beside."""
    clip = ws["clips"]["scene-r0"]
    kw = dict(thumbnails=2, max_frames=2)
    jax_sum = jreport.scene_summary(JClipPipeline(clip_path=clip), **kw)
    pipe = ClipPipeline(clip_path=clip, device="cpu")
    return {"jax": jax_sum, "port": treport.scene_summary(pipe, **kw),
            "pipe": pipe}


def test_scene_summary_matches_jax(summaries):
    got, want = summaries["port"], summaries["jax"]
    assert set(got) == set(want)
    for key in ("scene", "output_size"):
        assert got[key] == want[key]
    assert set(got["sources"]) == set(want["sources"]) == {"cama", "nuscenes"}
    for source, entry in want["sources"].items():
        mine = got["sources"][source]
        assert set(mine) == set(entry)
        for key in ("frames", "points", "instances"):
            assert mine[key] == entry[key], (source, key)
        m, w = mine["map_metrics"], entry["map_metrics"]
        assert set(m) == set(w) and w["frames_evaluated"] == 2
        for key, v in w.items():
            if key in EXACT_KEYS:
                assert m[key] == v, (source, key)
            else:
                assert abs(m[key] - v) <= RATIO_ABS_TOL, (source, key)
    assert [(t["source"], t["image_idx"]) for t in got["thumbs"]] == [
        (t["source"], t["image_idx"]) for t in want["thumbs"]]
    assert len(got["thumbs"]) == 2
    assert set(got["pose_metrics"]) == set(want["pose_metrics"])
    for key, v in want["pose_metrics"].items():
        assert math.isclose(got["pose_metrics"][key], v,
                            rel_tol=POSE_REL_TOL, abs_tol=1e-12), key


def _decode(b64):
    buf = np.frombuffer(base64.b64decode(b64), np.uint8)
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)


def test_thumbnails_decode_to_the_mosaic(summaries):
    """Each thumbnail is the port's own mosaic of that frame, resized and
    JPEG-coded; it decodes to what JAX's thumbnail decodes to within JPEG
    noise (the rasters may differ in a border pixel or two)."""
    pipe = summaries["pipe"]
    jax_thumbs = {t["image_idx"]: t for t in summaries["jax"]["thumbs"]}
    for t in summaries["port"]["thumbs"]:
        idx, source = t["image_idx"], t["source"]
        raster = pipe._overlay_single(source, idx)
        mosaic = concat_camera_grid(pipe.composite_frame(source, idx, raster))
        size = (720, round(mosaic.shape[0] * 720 / mosaic.shape[1]))
        small = cv2.resize(mosaic, size, interpolation=cv2.INTER_AREA)
        ok, buf = cv2.imencode(".jpg", small, [cv2.IMWRITE_JPEG_QUALITY, 82])
        assert ok
        got = _decode(t["jpeg_b64"])
        np.testing.assert_array_equal(got, cv2.imdecode(buf, cv2.IMREAD_COLOR))
        ref = _decode(jax_thumbs[idx]["jpeg_b64"])
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert got.shape == ref.shape == (270, 720, 3)
        assert (diff > 8).mean() <= 1e-3, float((diff > 8).mean())


def test_render_html_byte_equal_to_jax(summaries, monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-10-17 12:00:00")
    sites = [{"site": "overlap", "members": list(SCENES), "refined": True,
              "instances_raw": 16, "refine_chamfer_before_m": 0.4587,
              "refine_chamfer_after_m": 0.4587, "duplicates_removed": 8,
              "instances_merged": 8, "classes": {"lane_marking": 6,
                                                 "Road_teeth": 2}},
             {"site": "gone", "members": ["x"], "note": "members unavailable"},
             {"site": "bad", "members": [], "error": "ValueError('x')"}]
    failed = {"scene": "scene-x", "error": "RuntimeError('<boom>')"}
    for summ in (summaries["port"], summaries["jax"]):
        args = ([summ, failed, {**summ, "missing_sources": ["nuscenes"]}],)
        for kw in ({}, {"title": "QA & <release>", "sites": sites}):
            got = treport.render_html(*args, **kw)
            assert got == jreport.render_html(*args, **kw)
            assert got.count("data:image/jpeg;base64,") == 4
            assert "<script" not in got


def test_report_main_cpu(ws, capsys):
    """Two scenes (the first named twice) and a two-member site: no
    failure, a section per listed name, thumbnails, pose and site
    sections (metrics without instance votes: test_scene_summary_matches_jax
    covers those)."""
    cfg = _config(ws, "main", scene_names=["scene-r0", "scene-r1", "scene-r0"],
                  sites=[{"name": "overlap", "scenes": list(SCENES)}])
    out = ws["root"] / "report.html"
    rc = treport.main(["-c", cfg, "-o", str(out), "--thumbnails", "1",
                       "--max-frames", "2", "--no-instances", "--device",
                       "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"report": str(out), "scenes": 3, "sites": 1,
                    "failures": 0}
    body = out.read_text()
    assert body.count("<h2>scene-r0</h2>") == 2
    assert body.count("<h2>scene-r1</h2>") == 1
    assert body.count("data:image/jpeg;base64,") == 3
    assert body.count("map quality") == 6 and "SRE" in body
    assert "instance_precision" not in body and "pose metrics" in body
    assert "site: overlap" in body and "merged map elements per class" in body
    assert "duplicates_removed" in body and "instances_merged" in body


def test_report_uses_batched_fleet_eval(ws, capsys, monkeypatch):
    """With two same-size scenes the map metrics come from
    evaluate_scene_batch: the per-scene paths raise."""
    def boom(*a, **k):
        raise AssertionError("per-scene evaluation path used")

    monkeypatch.setattr(MapEvaluator, "evaluate_scene_all", boom)
    monkeypatch.setattr(MapEvaluator, "evaluate_scene", boom)
    out = ws["root"] / "batched.html"
    rc = treport.main(["-c", _config(ws, "batched"), "-o", str(out),
                       "--thumbnails", "0", "--no-instances", "--device",
                       "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["failures"] == 0 and line["scenes"] == 2
    body = out.read_text()
    assert body.count("map quality") == 4  # both scenes x both sources
    assert "unavailable" not in body


def test_report_cuda_without_a_card_fails_loudly(ws):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        treport.main(["-c", _config(ws, "cuda"), "--device", "cuda"])
