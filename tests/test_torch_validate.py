"""The port's validation harness (cama_tpu_torch.validate) on CPU: the whole
report over all eight paths and both sources, the host-exact frames against
the JAX package's byte for byte, each path name forced to run its own
program, and spread_frame_ids against the JAX function."""
import json

import numpy as np
import pytest

from cama_tpu import validate as jvalidate
from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu.pipeline import ClipPipeline as JClipPipeline
from cama_tpu_torch import pipeline as tp
from cama_tpu_torch import validate as tvalidate


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("tval_fixture")
    return make_fixture_clip(root, n_frames=4, with_images=True,
                             with_lidar=False)


def test_validate_reports_every_path_and_source(clip, capsys, tmp_path):
    out_json = str(tmp_path / "VALIDATE.json")
    rc = tvalidate.main(["--clip", clip, "--frames", "2", "--device", "cpu",
                         "--out", out_json])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0, report
    assert tvalidate.DEVICE_PATHS == jvalidate.DEVICE_PATHS
    assert set(report["sources"]) == {"cama", "nuscenes"}
    assert report["ok"] is True
    assert report["exact_lane_min_agreement"] == 1.0
    assert report["device_vs_host_exact_min_agreement"] > 0.999
    for source, rep in report["sources"].items():
        assert len(rep["frames"]) == 2
        assert set(rep["paths"]) == set(tvalidate.DEVICE_PATHS)
        for name, entry in rep["paths"].items():
            assert entry["vs_host_exact_min_agreement"] > 0.999, (source, name)
        assert rep["paths"]["exact"]["vs_host_exact_min_agreement"] == 1.0
    # no checkout of the reference here: its comparison is skipped
    assert "host_exact_byte_identical_to_reference" not in report
    # --out writes the same report
    with open(out_json) as f:
        assert json.load(f) == report


def test_validate_cuda_without_a_card_raises(clip):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        tvalidate.main(["--clip", clip, "--frames", "1"])


@pytest.mark.parametrize("source", ["cama", "nuscenes"])
def test_host_exact_frames_byte_identical_to_jax(clip, source):
    pipe = tp.ClipPipeline(clip_path=clip, device="cpu")
    jpipe = JClipPipeline(clip_path=clip)
    fm = pipe.frame_matrices(source)
    ids = {int(i) for i, v in zip(fm.frame_indices, fm.frame_valid) if v}
    got = tvalidate.host_exact_frames(pipe, source, ids)
    want = jvalidate.host_exact_frames(jpipe, source, ids)
    assert set(got) == set(want) == ids
    painted = 0
    for i in ids:
        assert list(got[i]) == list(want[i])
        for cam in got[i]:
            np.testing.assert_array_equal(got[i][cam], want[i][cam])
            base = pipe.undistorted_image(cam, i)
            painted += int((got[i][cam] != base).any(-1).sum())
    assert painted > 0
    assert tvalidate.agreement(got[i][cam], want[i][cam]) == 1.0


@pytest.mark.parametrize("source", ["cama", "nuscenes"])
def test_host_exact_rasters_are_the_cv2_frames(clip, source):
    """The cv2-free float64 anchor, composited, equals the cv2.circle frames
    byte for byte; the exact lane's rasters equal it."""
    pipe = tp.ClipPipeline(clip_path=clip, device="cpu",
                           raster_kernel="compact")
    fm = pipe.frame_matrices(source)
    ids = {int(i) for i, v in zip(fm.frame_indices, fm.frame_valid) if v}
    rasters = tvalidate.host_exact_rasters(pipe, source, ids)
    frames = tvalidate.host_exact_frames(pipe, source, ids)
    assert set(rasters) == set(frames) == ids
    for i in ids:
        assert rasters[i].dtype == np.uint8 and rasters[i].any()
        painted = pipe.composite_frame(source, i, rasters[i])
        for cam in painted:
            np.testing.assert_array_equal(painted[cam], frames[i][cam])
    exact = dict(pipe.iter_overlay_rasters_exact(source))
    assert set(exact) == ids
    for i in ids:
        np.testing.assert_array_equal(exact[i], rasters[i])
    assert tvalidate.host_exact_rasters(pipe, source, {min(ids)}).keys() \
        == {min(ids)}


def _spy(monkeypatch, name, calls):
    real = getattr(tp, name)

    def spy(*a, **k):
        calls.append((name, a, k))
        return real(*a, **k)

    monkeypatch.setattr(tp, name, spy)


def test_validate_single_kernel_forces_compact(clip, capsys, monkeypatch):
    """--kernel compact runs the single-stage compact program even though
    the serving decision for this clip is sparse."""
    calls = []
    for name in ("_overlay_chunk_lists", "_overlay_chunk_two_stage",
                 "_project_compact_chunk"):
        _spy(monkeypatch, name, calls)
    rc = tvalidate.main(["--clip", clip, "--frames", "2", "--kernel",
                         "compact", "--source", "cama", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0, report
    assert list(report["sources"]["cama"]["paths"]) == ["compact"]
    assert "exact_lane_min_agreement" not in report
    names = [c[0] for c in calls]
    assert names and set(names) == {"_overlay_chunk_lists"}, names
    assert all(c[1][0] == "compact" for c in calls)


@pytest.mark.parametrize("path,program", [
    ("two_stage", "_overlay_chunk_two_stage"),
    ("sparse", "_project_compact_chunk"),
    ("scatter", "_overlay_chunk"),
    ("exact", "_exact_patch_raster_chunk"),
    ("host_lane", "_host_overlay_chunk"),
    ("pallas", "_overlay_chunk_lists"),
    ("fused", "_overlay_chunk_lists"),
])
def test_each_path_name_runs_its_own_program(clip, monkeypatch, path,
                                             program):
    programs = ("_overlay_chunk_lists", "_overlay_chunk_two_stage",
                "_project_compact_chunk", "_overlay_chunk",
                "_exact_patch_raster_chunk", "_host_overlay_chunk")
    calls = []
    for name in programs:
        _spy(monkeypatch, name, calls)
    fallbacks = []
    monkeypatch.setattr(tp.ClipPipeline, "_overlay_single",
                        lambda *a, **k: fallbacks.append(a))
    pipe = tp.ClipPipeline(clip_path=clip, device="cpu")
    fm = pipe.frame_matrices("cama")
    ids = {int(i) for i, v in zip(fm.frame_indices, fm.frame_valid) if v}
    frames = tvalidate.device_frames_for_path(pipe.scene, path, "cama", ids,
                                              chunk=2, device="cpu")
    assert set(frames) == ids
    assert {c[0] for c in calls} == {program}, [c[0] for c in calls]
    assert not fallbacks, "a sparse frame fell back to its dense raster"
    if path in ("pallas", "fused"):
        assert all(c[1][0] == path for c in calls)
    if path == "sparse":
        P = int(pipe.scene.flat["cama"].points.shape[0])
        # k = P: no list can overflow, so no dense fallback can serve it
        assert all(c[1][10] == P and c[2]["lane"] == "compact"
                   for c in calls)


@pytest.mark.parametrize("ids,n", [
    (list(range(100, 160)), 5), ([1, 2], 5), ([], 3), (list(range(7)), 7),
    (list(range(1, 40, 3)), 4), ([5, 9, 11], 2), (list(range(50)), 1)])
def test_spread_frame_ids_matches_jax(ids, n):
    got = tvalidate.spread_frame_ids(ids, n)
    assert got == jvalidate.spread_frame_ids(ids, n)
    assert len(got) == min(len(ids), n)
    if len(ids) > n > 1:
        assert min(got) == ids[0] and max(got) == ids[-1]
