"""Map evaluation over several scenes and over a wide scene:
MapEvaluator.evaluate_scene_batch against per-scene calls, and the
crop-compacted projection (compact='auto') against full-P, inside the port
(dicts equal) and against its host backend (ratios within ABS_TOL).
tests/test_torch_eval_scene.py holds the evaluator against the JAX package.
"""
import os

import pytest
import torch

from cama_tpu_torch.eval import map_metrics as tm
from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.pipeline import ClipPipeline, MultiScenePipeline

ABS_TOL = 1e-4  # ratios, between the device and the host backend
EXACT_KEYS = ("n_points", "gt_pixels", "frames_evaluated")
RATIO_KEYS = ("SRE", "precision", "recall", "f1", "instance_precision",
              "instance_recall", "mean_purity")
# a quarter of the pixels of the default 540 x 960 output: the evaluator's
# work is per pixel
SMALL = (270, 480)
_SCENES = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test suite runs several worker processes at once; one intra-op
    thread in this one keeps torch's CPU ops on whole images from
    oversubscribing the cores (results do not depend on the thread count:
    every compared sum is integer-valued or held to a tolerance)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipe(clip, chunk=2, **kw):
    """A fresh CPU pipeline on the clip's scene compiled at SMALL (scenes
    are compiled once per clip and source set)."""
    key = (clip, kw.get("sources"))
    if key not in _SCENES:
        _SCENES[key] = compile_scene(clip, output_size=SMALL, **kw)
    return ClipPipeline(scene=_SCENES[key], chunk=chunk, device="cpu")


def _assert_close(got, want):
    for key in EXACT_KEYS:
        assert got[key] == want[key], key
    for key in (k for k in RATIO_KEYS if k in want):
        assert abs(got[key] - want[key]) <= ABS_TOL, (key, got[key], want[key])


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{'plain': a 4-frame clip with its own reprojection as ground truth,
    'shifted': a 5-frame one with the masks drawn 12 px lower, 'bare': a
    clip with no ground truth at all}."""
    root = tmp_path_factory.mktemp("tevalbatch")
    out = {}
    for name, n_frames, shift in (("plain", 4, 0.0), ("shifted", 5, 12.0),
                                  ("bare", 3, None)):
        clip = make_fixture_clip(root, scene_name=name, n_frames=n_frames,
                                 with_images=False)
        if shift is not None:
            add_instance_masks(clip, shift_px=shift)
        out[name] = clip
    return out


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """Labels spanning ~500 m while the crop keeps +-50 m: the counting pass
    engages the crop-first split, which evaluation then rides."""
    clip = make_fixture_clip(tmp_path_factory.mktemp("tevalwide"),
                             n_frames=4, with_images=False,
                             label_span=(-295.0, 200.0))
    add_instance_masks(clip, shift_px=4.0)
    return clip


def test_compact_auto_equals_off_on_a_wide_clip(wide, monkeypatch):
    """On the whole scene, whose fields the evaluator keeps, and on a subset
    of its frames, which keeps none."""
    pipe = _pipe(wide, chunk=4)
    assert pipe.crop_compact_k("cama") is None  # not sized yet: stays off
    pipe.overlay_mode("cama")
    k1 = pipe.crop_compact_k("cama")
    assert k1 is not None and 2 * k1 <= pipe.scene.flat["cama"].points.shape[0]
    build = tm._eval_chunk_build
    built = []

    def spy(*a, **k):
        out = build(*a, **k)
        built.append((out[2].shape, out[3]))
        return out

    monkeypatch.setattr(tm, "_eval_chunk_build", spy)
    for frames in (None, [2, 3]):
        results = [tm.MapEvaluator(compact=c).evaluate_scene_all(
            pipe, frames=frames) for c in ("auto", "off")]
        assert results[0] == results[1]
        assert results[0]["frames_evaluated"] == (3 if frames is None else 2)
        assert 0.0 < results[0]["precision"] < 1.0
        host = [tm.MapEvaluator(backend="host", compact=c).evaluate_scene(
            pipe, frames=frames) for c in ("auto", "off")]
        assert host[0] == host[1]
        _assert_close(results[0], host[0])
        # the projection really compacted, and only under 'auto'
        (keep_auto, sel), (keep_off, no_sel) = built[-2:]
        assert keep_auto[2] == k1 and sel.dtype == torch.int32
        assert keep_off[2] > k1 and no_sel is None


@pytest.mark.parametrize("instances", [False, True])
def test_batch_equals_per_scene_calls(clips, wide, instances):
    """evaluate_scene_batch over three scenes of different point counts, one
    of them without the source's ground truth."""
    pipes = [_pipe(clips["shifted"]), _pipe(clips["bare"]), _pipe(wide),
             _pipe(clips["plain"])]
    ev = tm.MapEvaluator(tolerance=3, max_radius=8)
    got = ev.evaluate_scene_batch(pipes, instances=instances)
    assert got[1] is None
    for i in (0, 2, 3):
        solo = (ev.evaluate_scene_all(pipes[i]) if instances
                else ev.evaluate_scene(pipes[i]))
        assert got[i] == solo, i
    if instances:
        return
    again = ev.evaluate_scene_batch(MultiScenePipeline(pipes, chunk=2))
    assert again == got
    host = tm.MapEvaluator(tolerance=3, max_radius=8, backend="host")
    for g, hres in zip(got, host.evaluate_scene_batch(pipes)):
        assert (g is None) == (hres is None)
        if g is not None:
            _assert_close(g, hres)


def test_batch_without_the_source_raises(clips):
    pipes = [_pipe(clips["plain"], sources=("cama",))]
    for backend in ("device", "host"):
        with pytest.raises(ValueError, match="nuscenes"):
            tm.MapEvaluator(backend=backend).evaluate_scene_batch(
                pipes, source="nuscenes")




@pytest.mark.parametrize("entry,case", [
    (entry, case)
    for entry in ("evaluate_scene", "evaluate_scene_instances",
                  "evaluate_scene_all", "evaluate_scene_batch")
    for case in ("whole", "frames", "no_store")
    if (entry, case) != ("evaluate_scene_batch", "frames")])  # no frames arg
def test_every_entry_equals_the_host_backend(clips, monkeypatch, entry,
                                             case):
    """Every entry on the device against the host backend, on the whole
    scene (fields kept), on frames [2, 3] and on a pipeline without a GT
    store (frame_cache off; fields built, none kept): counts exactly,
    ratios within ABS_TOL.  The GT goes to the device as ids, never
    bitpacked on the host."""
    def refused(*a, **k):
        raise AssertionError("np.packbits ran")

    monkeypatch.setattr(tm.np, "packbits", refused)
    configs = {"frame_cache": False} if case == "no_store" else None
    names = ("shifted", "plain") if entry == "evaluate_scene_batch" else (
        "shifted",)
    pipes = [ClipPipeline(configs, scene=_pipe(clips[n]).scene, chunk=2,
                          device="cpu") for n in names]
    assert (pipes[0].gt_mask_cache() is None) == (case == "no_store")
    kw = {"frames": [2, 3]} if case == "frames" else {}
    if entry == "evaluate_scene_batch":
        kw["instances"] = True
        arg = pipes
    else:
        arg = pipes[0]
    got = getattr(tm.MapEvaluator(), entry)(arg, **kw)
    want = getattr(tm.MapEvaluator(backend="host"), entry)(arg, **kw)
    if entry != "evaluate_scene_batch":
        got, want = [got], [want]
    for g, h in zip(got, want):
        assert set(g) == set(h)
        for key, value in h.items():
            if key in EXACT_KEYS or key.startswith("n_"):
                assert g[key] == value, key
            else:
                assert abs(g[key] - value) <= ABS_TOL, (key, g[key], value)
        assert g["frames_evaluated"] == (2 if case == "frames" else
                                         4 if h is want[0] else 3)
