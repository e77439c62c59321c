"""Map evaluation as a whole: cama_tpu_torch.eval.map_metrics.MapEvaluator
on fixture clips, against the JAX package's evaluator (same clip files),
against the port's own host mirror, and against itself across its settings.

The port's f32 (v, u) differ from XLA's by a few thousandths of a pixel, so
a handful of points floor into a neighbouring pixel and scene-level ratios
cannot be bit-equal between the packages: they are held to ABS_TOL, the
counts exactly.  Inside the port every setting must give the same dict.
"""
import filecmp
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from cama_tpu.eval import map_metrics as jm
from cama_tpu.io import fixture as jfixture
from cama_tpu.io.scene import compile_scene as jcompile_scene
from cama_tpu.pipeline import ClipPipeline as JClipPipeline
from cama_tpu_torch import pipeline as tpipeline
from cama_tpu_torch.eval import map_metrics as tm
from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.pipeline import ClipPipeline

ABS_TOL = 1e-4  # ratios, between the packages and between the backends
EXACT_KEYS = ("n_points", "gt_pixels", "frames_evaluated")
RATIO_KEYS = ("SRE", "precision", "recall", "f1", "instance_precision",
              "instance_recall", "mean_purity")
SHIFT_PX = 30.0
# most tests run at a quarter of the pixels of the default 540 x 960 output
# (the evaluator's work is per pixel); one comparison with the JAX package
# runs at the default size
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


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{'plain': a 5-frame clip with its own reprojection as ground truth,
    'shifted': the same scene with the masks drawn 30 px lower, so the
    metrics are not all 1.0}."""
    root = tmp_path_factory.mktemp("teval")
    out = {}
    for name, shift in (("plain", 0.0), ("shifted", SHIFT_PX)):
        clip = make_fixture_clip(root, scene_name=name, n_frames=5,
                                 with_images=False)
        add_instance_masks(clip, shift_px=shift)
        out[name] = clip
    return out


def _pipe(clip, size=SMALL, chunk=4):
    """A fresh CPU pipeline on the clip's scene compiled at `size` (scenes
    are compiled once per clip and size)."""
    if (clip, size) not in _SCENES:
        _SCENES[clip, size] = compile_scene(clip, output_size=size)
    return ClipPipeline(scene=_SCENES[clip, size], chunk=chunk, device="cpu")


def _jpipe(clip, size=SMALL):
    return JClipPipeline(scene=jcompile_scene(clip, output_size=size), chunk=4)


@pytest.fixture(scope="module")
def baseline(clips):
    """The port's evaluate_scene_all per clip at the default settings: the
    dict every other setting must reproduce."""
    return {name: tm.MapEvaluator().evaluate_scene_all(_pipe(clip))
            for name, clip in clips.items()}


def _assert_close(got, want, keys=None):
    for key in EXACT_KEYS:
        assert got[key] == want[key], key
    for key in (keys or [k for k in RATIO_KEYS if k in want]):
        assert abs(got[key] - want[key]) <= ABS_TOL, (key, got[key], want[key])


def test_add_instance_masks_writes_the_jax_packages_bytes(clips, tmp_path):
    clip = jfixture.make_fixture_clip(tmp_path, scene_name="shifted",
                                      n_frames=5, with_images=False,
                                      with_lidar=False)
    jfixture.add_instance_masks(clip, shift_px=SHIFT_PX)
    n = 0
    for cam in jfixture.CAMERA_LIST:
        a = os.path.join(clip, f"lane_ins_{cam}")
        b = os.path.join(clips["shifted"], f"lane_ins_{cam}")
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) and names
        _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
        assert not mismatch and not errors
        n += len(names)
    assert n == 6 * 4  # frame 0 is skipped, like the reference


@pytest.mark.parametrize("case", ["all-plain", "all-shifted", "scene-shifted",
                                  "scene-euclidean-shifted",
                                  "all-fullsize-shifted"])
def test_against_jax_package(clips, baseline, case):
    """Counts exactly; SRE, precision, recall, f1 and the association
    ratios within 1e-4 absolute."""
    method, *rest = case.split("-")
    distance = "euclidean" if "euclidean" in rest else "chebyshev"
    size = (540, 960) if "fullsize" in rest else SMALL
    clip = clips[rest[-1]]
    jev = jm.MapEvaluator(distance=distance)
    jpipe = _jpipe(clip, size)
    if method == "all":
        want = jev.evaluate_scene_all(jpipe)
        got = (tm.MapEvaluator().evaluate_scene_all(_pipe(clip, size))
               if "fullsize" in rest else baseline[rest[-1]])
    else:
        want = jev.evaluate_scene(jpipe)
        got = tm.MapEvaluator(distance=distance).evaluate_scene(_pipe(clip))
    assert set(got) == set(want)
    _assert_close(got, want)
    assert got["frames_evaluated"] == 4 and got["n_points"] > 1000
    if method == "all":
        assert got["n_map_instances"] == want["n_map_instances"]
        assert got["n_gt_instances"] == want["n_gt_instances"] > 0
    if rest[-1] == "shifted":
        assert got["precision"] < 0.95  # the shift shows
    else:
        assert got["precision"] == 1.0 and got["instance_precision"] == 1.0


def test_partials_equal_host_mirror_exactly(clips):
    """The evaluator's device step (_eval_chunk_build) gives Chebyshev
    partials of a chunk equal to the sum of frame_metrics_host over the
    same (vu, keep), frame by frame."""
    from cama_tpu_torch.ops.geometry import project_frames

    pipe = _pipe(clips["shifted"])
    ev = tm.MapEvaluator()
    st = pipe.scene_tensors("cama")
    h, w = pipe.scene.output_size
    geo = (w, h, pipe._crop_lo, pipe._crop_hi)
    n = 0
    for s, idxs in ev._chunk_layout(pipe, "cama"):
        ids_b, fv, evaluated = ev._chunk_gt([pipe] * len(idxs), idxs)
        sl, fvb = slice(s, s + pipe.chunk), torch.from_numpy(fv > 0)
        got, _, keep_c, _, *_fields = tm._eval_chunk_build(
            st.points, st.valid, st.A[sl], st.B[sl], fvb,
            torch.from_numpy(ids_b), *geo, None, 20, 5, "chebyshev",
            "nearest", False)
        vu_c, keep_p = project_frames(st.points, st.valid, st.A[sl],
                                      st.B[sl], fvb, *geo)
        assert torch.equal(keep_c, keep_p)
        want = dict.fromkeys(tm.PARTIAL_KEYS, 0.0)
        for kk, _idx in evaluated:
            row = tm.frame_metrics_host(ids_b[kk] > 0, vu_c[kk].numpy(),
                                        keep_c[kk].numpy(), 20, 5)
            for key in want:
                want[key] += row[key]
        assert {k: float(v) for k, v in got.items()} == want
        n += len(evaluated)
    assert n == 4 and want["n_hit"] < want["n_points"]


def test_resident_off_and_warm_call_give_the_same_dict(clips, baseline):
    name = "shifted"
    pipe = _pipe(clips[name])
    ev = tm.MapEvaluator()
    cold = ev.evaluate_scene_all(pipe)
    store = ev._resident_fields[pipe]
    assert store["bytes"] > 0 and len(store["chunks"]) == 1
    n_dispatch = ev.timers.count["eval_dispatch"]
    warm = ev.evaluate_scene_all(pipe)
    assert ev.timers.count["eval_dispatch"] == n_dispatch + 1
    assert ev.timers.count["eval_gt_load"] == 1  # served from the fields
    fresh = tm.MapEvaluator().evaluate_scene_all(pipe)
    assert cold == warm == fresh == baseline[name]
    # the binary pass reuses the fields the instance pass built
    assert ev.evaluate_scene(pipe) == tm.MapEvaluator().evaluate_scene(pipe)
    assert ev.timers.count["eval_gt_load"] == 1
    # and so does the instance pass; a subset of the frames keeps nothing
    assert ev.evaluate_scene_instances(pipe) == tm.MapEvaluator(
    ).evaluate_scene_instances(pipe)
    assert ev.evaluate_scene_all(pipe, frames=[1, 2, 3, 4]) == cold
    assert ev.timers.count["eval_gt_load"] == 2
    assert len(store["chunks"]) == 1


def test_all_equals_the_two_separate_passes(clips, baseline):
    pipe = _pipe(clips["shifted"])
    ev = tm.MapEvaluator()
    both = {**ev.evaluate_scene(pipe), **ev.evaluate_scene_instances(pipe)}
    assert both == baseline["shifted"]


def test_budget_zero_keeps_nothing_and_changes_nothing(clips, baseline):
    pipe = _pipe(clips["shifted"])
    ev = tm.MapEvaluator()
    ev.RESIDENT_BUDGET_MB = 0
    for _ in range(2):
        assert ev.evaluate_scene_all(pipe) == baseline["shifted"]
    assert ev._resident_fields[pipe] == {"bytes": 0, "chunks": {}}
    assert ev.timers.count["eval_gt_load"] == 2


def test_regenerated_masks_invalidate_store_and_fields(clips, baseline,
                                                       tmp_path):
    clip = shutil.copytree(clips["plain"], tmp_path / "regen")
    shutil.rmtree(os.path.join(clip, ".cama_tpu"), ignore_errors=True)
    clip = str(clip)
    pipe = _pipe(clip)
    ev = tm.MapEvaluator()
    assert ev.evaluate_scene_all(pipe) == baseline["plain"]
    key = pipe.gt_mask_cache().key
    pipe.gt_mask_cache().flush()
    add_instance_masks(clip, shift_px=SHIFT_PX)
    after = ev.evaluate_scene_all(pipe)
    assert pipe.gt_mask_cache().key != key
    assert after == baseline["shifted"] != baseline["plain"]
    assert ev.timers.count["eval_gt_load"] == 2


def test_gt_store_is_shared_with_the_jax_package(clips):
    """One gt_ids store per clip: the same key string, and the ids the other
    package cached are served back."""
    pipe = _pipe(clips["plain"])
    jpipe = _jpipe(clips["plain"])
    assert pipe._gt_cache_key() == jpipe._gt_cache_key()
    tev, jev = tm.MapEvaluator(), jm.MapEvaluator()
    cam = pipe.scene.camera_list[1]
    a = tev.instance_loader(pipe, cam, 2)
    pipe.gt_mask_cache().flush()
    assert jpipe.gt_mask_cache().get(2, 1) is not None
    b = jev.instance_loader(jpipe, cam, 2)
    np.testing.assert_array_equal(a, b)
    assert a.shape == SMALL and a.any()
    np.testing.assert_array_equal(tev.mask_loader(pipe, cam, 2), a > 0)
    assert tev.instance_loader(pipe, cam, 0) is None  # no mask for frame 0


@pytest.mark.parametrize("distance", ["chebyshev", "euclidean"])
def test_host_backend_agrees_with_device(clips, distance):
    pipe = _pipe(clips["shifted"])
    kw = dict(tolerance=4, max_radius=16, distance=distance)
    dev = tm.MapEvaluator(**kw).evaluate_scene_all(pipe)
    host = tm.MapEvaluator(backend="host", **kw).evaluate_scene_all(pipe)
    assert set(dev) == set(host)
    _assert_close(dev, host)
    assert dev["n_map_instances"] == host["n_map_instances"]
    if distance == "euclidean":
        return
    # a frames filter keeps no fields on the device
    sub = tm.MapEvaluator(**kw).evaluate_scene_all(pipe, frames=[2, 3])
    hsub = tm.MapEvaluator(backend="host", **kw).evaluate_scene_all(
        pipe, frames=[2, 3])
    assert sub["frames_evaluated"] == 2 < dev["frames_evaluated"]
    _assert_close(sub, hsub)
    with pytest.raises(ValueError, match="nearest"):
        tm.MapEvaluator(backend="host").evaluate_scene_all(
            pipe, assignment="chebyshev")


def test_chebyshev_assignment_runs_on_device_backend(clips):
    pipe = _pipe(clips["plain"])
    out = tm.MapEvaluator().evaluate_scene_instances(pipe,
                                                     assignment="chebyshev")
    assert out["frames_evaluated"] == 4 and out["instance_precision"] == 1.0


def test_main_prints_one_json_line(clips, capsys, tmp_path):
    """The script's entry point (at the default output size) prints what
    the evaluator returns, rounded to 4 places."""
    tm.main(["--clip", clips["shifted"], "--device", "cpu", "--instances",
             "--tolerance", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    direct = tm.MapEvaluator(tolerance=4).evaluate_scene_all(
        ClipPipeline(clip_path=clips["shifted"], device="cpu"))
    assert got == {k: round(v, 4) if isinstance(v, float) else v
                   for k, v in direct.items()}
    assert got["frames_evaluated"] == 4 and 0 < got["precision"] < 1
    # no ground truth: nothing evaluated, and NaN goes out as null
    bare = make_fixture_clip(tmp_path, scene_name="nogt", n_frames=3,
                             with_images=False)
    tm.main(["--clip", bare, "--device", "cpu", "--backend", "host"])
    out = capsys.readouterr().out.strip()
    assert "NaN" not in out
    res = json.loads(out)
    assert res["SRE"] is None and res["frames_evaluated"] == 0
    assert not math.isfinite(
        tm.MapEvaluator().evaluate_scene(_pipe(bare))["SRE"])
    assert tm.MapEvaluator().evaluate_scene_instances(_pipe(bare)) == dict(
        tm.MapEvaluator._EMPTY_ASSOCIATION, frames_evaluated=0)


def test_sharded_batch_waits_for_its_item(clips):
    """The sharded fleet evaluation is no longer waiting for the port of
    parallel/ (ROADMAP item 11): on a one-rank ('scenes', 'frames') mesh
    in this process it gives evaluate_scene_batch's results, and its step
    cache is keyed by the mesh's layout, so a new mesh object of the same
    layout reuses the step."""
    from cama_tpu_torch.parallel import make_scene_mesh

    pipes = [_pipe(clips["plain"]), _pipe(clips["shifted"])]
    ev = tm.MapEvaluator(tolerance=4, max_radius=16)
    want = ev.evaluate_scene_batch(pipes, "cama")
    for _ in range(2):
        got = ev.evaluate_scene_batch_sharded(
            pipes, make_scene_mesh(1, 1, device="cpu"), "cama")
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert {k: g[k] for k in EXACT_KEYS} == {k: w[k]
                                                     for k in EXACT_KEYS}
            for key in ("SRE", "precision", "recall", "f1"):
                assert abs(g[key] - w[key]) <= ABS_TOL, key
    assert [k[0] for k in ev._sharded_steps] == [
        ((("scenes", 1), ("frames", 1)), (0,), "cpu")]


def test_evaluator_rejects_unknown_settings():
    for kw in ({"compact": "on"}, {"backend": "tpu"}):
        with pytest.raises(ValueError):
            tm.MapEvaluator(**kw)
    with pytest.raises(TypeError):  # the fields are kept whenever they can be
        tm.MapEvaluator(resident="off")


# --- the GT store's signature: the port's reader against the JAX
# package's serial one, which shares the store and so the key's bytes


@pytest.fixture(scope="module")
def gt_clip(tmp_path_factory):
    """A 3-frame clip with masks (frame 0 has none): the pristine copy that
    each signature test copies before it edits."""
    root = tmp_path_factory.mktemp("tgtkey")
    clip = make_fixture_clip(root, scene_name="gtkey", n_frames=3,
                             with_images=False, with_lidar=False)
    add_instance_masks(clip)
    return clip


def _gt_copy(gt_clip, tmp_path):
    clip = str(shutil.copytree(gt_clip, tmp_path / "clip"))
    shutil.rmtree(os.path.join(clip, ".cama_tpu"), ignore_errors=True)
    return clip


def _gt_png(clip, cam="camera_front", frame=1):
    ms = compile_scene(clip, output_size=SMALL).sync_ms[cam][frame]
    return os.path.join(clip, f"lane_ins_{cam}", f"{ms}.png")


def _write_bytes(path, size):
    with open(path, "wb") as f:
        f.write(np.random.default_rng(size).bytes(size))


def _gt_keys(clip, full):
    pipe = ClipPipeline({"gt_cache_full_hash": full}, clip, device="cpu")
    jpipe = JClipPipeline(clip_path=clip,
                          configs={"gt_cache_full_hash": full})
    return pipe._gt_cache_key(), jpipe._gt_cache_key()


@pytest.mark.parametrize("full", [False, True], ids=["windows", "full_hash"])
@pytest.mark.parametrize("case", [
    "as_written", "size_8192", "size_8193", "size_16384", "size_16385",
    "size_2_5_mib", "removed_png", "removed_camera", "directory_for_png",
    "search_only_camera"])
def test_gt_key_equals_the_jax_packages(gt_clip, tmp_path, case, full):
    """Byte for byte, on each edge of the head and tail windows (a file of
    up to 8 KiB, up to 16 KiB, above), a file of several 1 MiB blocks, each
    way a frame signs absent, and a camera directory that may be searched
    but not listed, whose files a path walk still reads."""
    clip = _gt_copy(gt_clip, tmp_path)
    png = _gt_png(clip)
    if case.startswith("size_"):
        size = {"size_2_5_mib": 5 << 19}.get(case) or int(case[5:])
        _write_bytes(png, size)
        assert os.path.getsize(png) == size
    elif case == "removed_png":
        os.remove(png)
    elif case == "removed_camera":
        shutil.rmtree(os.path.dirname(png))
    elif case == "directory_for_png":
        os.remove(png)
        os.mkdir(png)
    elif case == "search_only_camera":
        os.chmod(os.path.dirname(png), 0o111)
    try:
        key, jkey = _gt_keys(clip, full)
    finally:
        if case == "search_only_camera":  # for the clean-up to list it
            os.chmod(os.path.dirname(png), 0o755)
    assert key == jkey
    assert (key == _gt_keys(gt_clip, full)[0]) == (
        case in ("as_written", "search_only_camera"))


def test_short_preads_sign_the_same(gt_clip, tmp_path, monkeypatch):
    """A pread may return fewer bytes than asked before end of file: the
    reader asks again until its window is full."""
    clip = _gt_copy(gt_clip, tmp_path)
    _write_bytes(_gt_png(clip), 40000)
    _write_bytes(_gt_png(clip, "camera_rear", 2), 12000)
    want = [_gt_keys(clip, full)[1] for full in (False, True)]
    pread = os.pread
    calls = []

    def short_pread(fd, n, offset):
        calls.append(n)
        return pread(fd, min(n, 1000), offset)

    monkeypatch.setattr(tpipeline.os, "pread", short_pread)
    got = [ClipPipeline({"gt_cache_full_hash": full}, clip,
                        device="cpu")._gt_cache_key() for full in (False, True)]
    assert got == want
    assert any(n > 1000 for n in calls)


def _remask_head(png):
    """A real re-mask that keeps the file's size: one instance erased, the
    PNG encoded again and padded after its end chunk to the old size (a
    decoder stops at IEND).  Returns the new mask."""
    import cv2

    old = open(png, "rb").read()
    mask = cv2.imread(png, cv2.IMREAD_UNCHANGED)
    mask[mask == mask.max()] = 0
    ok, enc = cv2.imencode(".png", mask)
    enc = enc.tobytes()
    assert ok and len(enc) <= len(old)
    with open(png, "wb") as f:
        f.write(enc + bytes(len(old) - len(enc)))
    assert os.path.getsize(png) == len(old)
    assert open(png, "rb").read(8192) != old[:8192]  # in the head window
    np.testing.assert_array_equal(cv2.imread(png, cv2.IMREAD_UNCHANGED),
                                  mask)
    return mask


def test_remasked_png_drops_the_store_and_rebuilds(gt_clip, tmp_path):
    clip = _gt_copy(gt_clip, tmp_path)
    pipe = _pipe(clip)
    first = tm.MapEvaluator().evaluate_scene(pipe)
    cache = pipe.gt_mask_cache()
    cache.flush()
    n_listed = sum(len(pipe.scene.sync_ms[cam])
                   for cam in pipe.scene.camera_list)
    files = pipe.timers.count["gt_key_files"]
    pipe.refresh_gt_cache()  # unchanged: every listed file signed, kept
    assert pipe.timers.count["gt_key_files"] == files + n_listed
    assert pipe.timers.count["gt_key_stale"] == 0
    assert pipe.gt_mask_cache() is cache

    _remask_head(_gt_png(clip))
    assert pipe._gt_cache_key() != cache.key
    after = tm.MapEvaluator().evaluate_scene(pipe)
    assert pipe.timers.count["gt_key_stale"] == 1
    rebuilt = pipe.gt_mask_cache()
    assert rebuilt is not cache and rebuilt.key != cache.key
    assert after != first
    assert after == tm.MapEvaluator().evaluate_scene(
        ClipPipeline(scene=compile_scene(clip, output_size=SMALL), chunk=4,
                     device="cpu"))


def test_full_hash_catches_middle_rewrite(gt_clip, tmp_path):
    """A same-size rewrite of a large PNG's middle passes the head and tail
    windows (the documented hole) and is caught under gt_cache_full_hash,
    whose refresh drops the store."""
    clip = _gt_copy(gt_clip, tmp_path)
    png = _gt_png(clip)
    _write_bytes(png, 100000)
    windows = ClipPipeline(None, clip, device="cpu")
    full = ClipPipeline({"gt_cache_full_hash": True}, clip, device="cpu")
    key = windows._gt_cache_key()
    cache = full.gt_mask_cache()
    with open(png, "r+b") as f:
        f.seek(50000)
        f.write(b"\xff" * 64)
    assert windows._gt_cache_key() == key
    full.refresh_gt_cache()
    assert full.timers.count["gt_key_stale"] == 1
    assert full.gt_mask_cache().key != cache.key
