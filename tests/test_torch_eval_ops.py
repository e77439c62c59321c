"""The stateless ops of cama_tpu_torch.eval.map_metrics against their JAX
originals (cama_tpu.eval.map_metrics) on identical arrays, made from a seed
with NumPy, at a small size.  Everything integer-valued is held bit for bit;
the one sum with irrational terms (the Euclidean sre_sum) to 1e-6 relative.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from cama_tpu.eval import map_metrics as jm
from cama_tpu.io.scene import compile_scene as jcompile_scene
from cama_tpu.pipeline import ClipPipeline as JClipPipeline
from cama_tpu_torch.eval import map_metrics as tm
from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.pipeline import ClipPipeline

K, C, H, W, P = 2, 3, 40, 64, 500
TOL, RAD = 3, 6
SRE_RTOL = 1e-6  # Euclidean sre_sum: irrational terms, order of summation
KEYS = ("sre_sum", "n_points", "n_hit", "gt_total", "gt_covered")


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


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _id_cases():
    """[K*C images] of instance ids: strokes with several ids, two strokes
    closer than 2*TOL, exact ties (two ids equidistant from the pixels
    between them, along a row and along a column), an empty image, a full
    image, and single pixels at the borders and corners."""
    rng = np.random.default_rng(7)
    ids = np.zeros((K, C, H, W), np.uint16)
    a = ids[0, 0]                      # strokes, some close to each other
    a[5, 3:40] = 1
    a[9, 10:50] = 2                    # 4 rows below id 1: within 2*TOL
    a[20:35, 30] = 40000               # an id above int16's range
    a[20:35, 34] = 7                   # column tie at x = 32
    b = ids[0, 1]                      # exact ties along rows and columns
    b[10, 10], b[10, 14] = 3, 4        # row tie at (10, 12)
    b[20, 20], b[24, 20] = 5, 6        # column tie at (22, 20)
    b[30, 40], b[32, 42] = 9, 8        # diagonal pair
    # ids[0, 2] stays empty
    ids[1, 0][:] = 11                  # full
    c = ids[1, 1]                      # single pixels at borders and corners
    c[0, 0], c[H - 1, W - 1], c[0, W - 1], c[H - 1, 0] = 1, 2, 3, 4
    c[0, W // 2], c[H // 2, 0] = 5, 6
    d = ids[1, 2]                      # random sparse labels
    sel = rng.random((H, W)) < 0.02
    d[sel] = rng.integers(1, 9, sel.sum())
    return ids


IDS = _id_cases()
MASKS = IDS > 0


def _points(seed=3):
    """(vu [K, C, P, 2] f32, keep [K, C, P]): points over and a little
    beyond the image, several to a pixel, about two thirds of those in the
    left 40 columns kept (so some ground truth stays uncovered)."""
    rng = np.random.default_rng(seed)
    vu = np.stack([rng.uniform(-3, H + 3, (K, C, P)),
                   rng.uniform(-3, W + 3, (K, C, P))], -1).astype(np.float32)
    vu[:, :, :50] = vu[:, :, 50:100]   # repeated pixels: counts above one
    inside = ((vu[..., 0] >= 0) & (vu[..., 0] < H)
              & (vu[..., 1] >= 0) & (vu[..., 1] < W))
    keep = inside & (rng.random((K, C, P)) < 0.7) & (vu[..., 1] < 40)
    return vu, keep


VU, KEEP = _points()


def test_dilate3x3():
    got = tm.dilate3x3(T(MASKS))
    np.testing.assert_array_equal(N(got), np.asarray(jm.dilate3x3(MASKS)))


@pytest.mark.parametrize("rounds", [1, 3])
def test_dilate_ids(rounds):
    want = np.asarray(jm.dilate_ids(jnp.asarray(IDS.astype(np.int32)), rounds))
    np.testing.assert_array_equal(
        N(tm.dilate_ids(T(IDS.astype(np.int32)), rounds)), want)
    got16 = tm.dilate_ids(T(IDS), rounds)
    assert got16.dtype == torch.uint16
    np.testing.assert_array_equal(N(got16), want)


def test_nearest_dist_rows():
    """Bit for bit, the empty columns' 1e4 + y + 1 / 1e4 + H - y too."""
    want = np.asarray(jm._nearest_dist_rows(jnp.asarray(MASKS)))
    got = N(tm._nearest_dist_rows(T(MASKS)))
    np.testing.assert_array_equal(got, want)
    y = np.arange(H)
    np.testing.assert_array_equal(
        got[0, 2, :, 0], np.minimum(1e4 + y + 1, 1e4 + H - y))


@pytest.mark.parametrize("radius", [1, 4, W + 3])
def test_squared_edt_within(radius):
    want = np.asarray(jm.squared_edt_within(jnp.asarray(MASKS), radius))
    got = tm.squared_edt_within(T(MASKS), radius)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(N(got), want)


def test_squared_edt_equals_jax_and_scipy():
    got = N(tm.squared_edt(T(MASKS)))
    np.testing.assert_array_equal(got, np.asarray(jm.squared_edt(MASKS)))
    for k, c in ((0, 0), (0, 1), (1, 1), (1, 2)):
        ref = ndimage.distance_transform_edt(~MASKS[k, c]) ** 2
        np.testing.assert_array_equal(got[k, c], ref.astype(np.float32))


def test_nearest_rows_id():
    ids = IDS.astype(np.int32)
    wd, wi = jm._nearest_rows_id(jnp.asarray(ids))
    gd, gi = tm._nearest_rows_id(T(ids))
    np.testing.assert_array_equal(N(gd), np.asarray(wd))
    np.testing.assert_array_equal(N(gi), np.asarray(wi))
    # the column tie goes to the upper neighbour
    assert int(gi[0, 1, 22, 20]) == 5


def test_nearest_id_edt():
    ids = IDS.astype(np.int32)
    wd, wi = jm.nearest_id_edt(jnp.asarray(ids))
    gd, gi = tm.nearest_id_edt(T(ids))
    np.testing.assert_array_equal(N(gd), np.asarray(wd))
    np.testing.assert_array_equal(N(gi), np.asarray(wi))
    # the row tie goes to the smaller source column
    assert int(gi[0, 1, 10, 12]) == 3 and int(gi[0, 0, 25, 32]) == 40000


@pytest.mark.parametrize("radius", [TOL, 9])
def test_nearest_id_within(radius):
    ids = IDS.astype(np.int32)
    wd, wi = jm.nearest_id_within(jnp.asarray(ids), radius)
    gd, gi = tm.nearest_id_within(T(ids), radius)
    np.testing.assert_array_equal(N(gd), np.asarray(wd))
    np.testing.assert_array_equal(N(gi), np.asarray(wi))
    if radius >= 2:
        assert int(gi[0, 1, 10, 12]) == 3


@pytest.mark.parametrize("distance", ["chebyshev", "euclidean"])
def test_dist_field(distance):
    rounds = jm._dist_rounds(RAD, TOL, distance)
    assert rounds == tm._dist_rounds(RAD, TOL, distance)
    want = np.asarray(jm._dist_field(jnp.asarray(MASKS), rounds, distance))
    got = tm._dist_field(T(MASKS), rounds, distance)
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    np.testing.assert_array_equal(N(got), want)


@pytest.mark.parametrize("assignment", ["nearest", "chebyshev"])
def test_vote_field(assignment):
    want = np.asarray(jm._vote_field(jnp.asarray(IDS), TOL, assignment))
    got = tm._vote_field(T(IDS), TOL, assignment)
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(N(got), want)


@pytest.mark.parametrize("width", [W, 61, 8, 3])
def test_packbits_and_unpack_bits(width):
    bits = MASKS[..., :width] ^ (np.arange(width) % 3 == 0)
    packed = tm.packbits(T(bits))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(N(packed), np.packbits(bits, axis=-1))
    np.testing.assert_array_equal(
        N(packed), np.asarray(jnp.packbits(jnp.asarray(bits), axis=-1)))
    back = tm._unpack_bits(packed, width)
    np.testing.assert_array_equal(N(back), bits)
    np.testing.assert_array_equal(
        N(back), np.asarray(jm._unpack_bits(jnp.asarray(N(packed)), width)))


@pytest.mark.parametrize("case", ["coo", "dense", "int32", "empty"])
def test_device_ids(case):
    """Ids the JAX package sends as COO pairs (a sparse stack), a dense
    stack, a wider dtype, no ids: the same uint16 stack on the device as
    the JAX package's."""
    ids = {"coo": np.where(np.arange(K * C * H * W).reshape(IDS.shape) % 97
                           == 0, IDS.max(), 0).astype(np.uint16),
           "dense": IDS[1:, :1], "int32": IDS[0].astype(np.int32),
           "empty": np.zeros((1, C, H, W), np.uint16)}[case]
    got = tm.device_ids(ids, device="cpu")
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(N(got), np.asarray(jm.device_ids(ids)))
    np.testing.assert_array_equal(N(got), ids)


def test_device_ids_rejects_wide_ids():
    with pytest.raises(ValueError, match="uint16"):
        tm.device_ids(np.full((1, 1, 4, 4), 70000, np.int32), device="cpu")


def _stub_gt(frames, cameras):
    """A stub pipeline on `device` and instance_loader for it: frame f,
    camera c reads a read-only [H, W] image (as the GT store's views are),
    uint8 for camera 0 of frame 0 (a first decode of an 8-bit PNG), None
    where frames[f] lacks the camera."""
    rng = np.random.default_rng(11)
    images = {}
    for f, have in frames.items():
        for c, cam in enumerate(cameras):
            if cam not in have:
                continue
            dtype = np.uint8 if (f, c) == (0, 0) else np.uint16
            img = rng.integers(0, 4, (H, W)).astype(dtype)
            img[img == 3] = 65535 if dtype == np.uint16 else 255
            img.setflags(write=False)
            images[f, cam] = img

    def loader(pipeline, camera, image_idx):
        return images.get((image_idx, camera))

    def pipe(device):
        return SimpleNamespace(device=torch.device(device),
                               scene=SimpleNamespace(camera_list=cameras),
                               gt_mask_cache=lambda: None)
    return images, loader, pipe


@pytest.mark.parametrize("device,backend,pinned", [
    ("cpu", "device", False), ("cuda", "device", True),
    ("cuda", "host", False)])
def test_chunk_gt_writes_every_row(monkeypatch, device, backend, pinned):
    """_chunk_gt's stack, built in a buffer first filled with 0xFFFF, equals
    the np.zeros build row by row: rows with GT, a frame missing a camera,
    padding rows.  It asks for page-locked memory only for a device
    evaluator on the card (a stub pipeline names the device: nothing is
    allocated on it)."""
    cams = ("front", "back")
    images, loader, pipe = _stub_gt({0: cams, 2: cams[:1], 3: cams}, cams)
    asked = []

    def filled(shape, pin):
        asked.append(pin)
        return np.full(shape, 0xFFFF, np.uint16)

    monkeypatch.setattr(tm, "_id_stack", filled)
    ev = tm.MapEvaluator(backend=backend)
    monkeypatch.setattr(ev, "instance_loader", loader)
    idxs = [0, None, 2, 3, None]
    ids_b, fv, evaluated = ev._chunk_gt([pipe(device)] * len(idxs), idxs)
    want = np.zeros((len(idxs), len(cams), H, W), np.uint16)
    for kk in (0, 3):
        want[kk] = np.stack([images[idxs[kk], cam] for cam in cams])
    assert asked == [pinned]
    assert ids_b.dtype == np.uint16
    np.testing.assert_array_equal(ids_b, want)
    np.testing.assert_array_equal(fv, [1, 0, 0, 1, 0])
    assert evaluated == [(0, 0), (3, 3)]
    none, fv, evaluated = ev._chunk_gt([pipe(device)] * 2, [None, 2])
    assert none is None and not fv.any() and evaluated == []
    assert asked == [pinned]  # no stack for a chunk without GT


@pytest.fixture(scope="module")
def gt_clip(tmp_path_factory):
    """A 5-frame fixture clip (frames 1-4 valid) with its own reprojection
    as ground truth, less one camera's mask of frame 1, compiled at
    135 x 240.  In chunks of 3 the first chunk has a row without GT and the
    second two padding rows."""
    clip = make_fixture_clip(tmp_path_factory.mktemp("tids"), n_frames=5,
                             with_images=False)
    add_instance_masks(clip)
    scene = compile_scene(clip, output_size=(135, 240))
    cam = scene.camera_list[2]
    os.remove(os.path.join(clip, f"lane_ins_{cam}",
                           f"{scene.sync_ms[cam][1]}.png"))
    return compile_scene(clip, output_size=(135, 240))


@pytest.mark.parametrize("method", ["evaluate_scene", "evaluate_scene_all",
                                    "evaluate_scene_instances"])
def test_gt_transfer_counters_stay_off_the_cpu(gt_clip, method):
    """On the CPU every chunk with GT loads once and nothing is staged or
    pinned: neither transfer counter engages (on the card each such chunk
    counts once, test_staged_ids_on_the_card)."""
    ev = tm.MapEvaluator()
    out = getattr(ev, method)(ClipPipeline(scene=gt_clip, chunk=3,
                                           device="cpu"))
    assert out["frames_evaluated"] == 3
    assert ev.timers.count["eval_gt_load"] == 2
    assert "eval_gt_staged" not in ev.timers.count
    assert "eval_gt_pageable" not in ev.timers.count


@pytest.mark.cuda
def test_staged_ids_on_the_card(gt_clip, monkeypatch):
    """On the card: a chunk's stack is page-locked; it and an unpinned copy
    of it give the same ids there; a pinned block is not handed out again
    while a copy that reads it waits in the stream; evaluate_scene counts
    every chunk with GT as staged, and with the stacks built unpinned gives
    the same dict, every chunk counted pageable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_*.py -m cuda)")
    pipe = ClipPipeline(scene=gt_clip, chunk=3, device="cuda")
    ev = tm.MapEvaluator()
    _s, idxs = next(ev._chunk_layout(pipe, "cama"))
    ids_b, _fv, evaluated = ev._chunk_gt([pipe] * len(idxs), idxs)
    assert evaluated and torch.from_numpy(ids_b).is_pinned()
    staged = tm.device_ids(ids_b, "cuda", ev.timers)
    pageable = tm.device_ids(ids_b.copy(), "cuda", ev.timers)
    assert ev.timers.count["eval_gt_staged"] == 1
    assert ev.timers.count["eval_gt_pageable"] == 1
    want = torch.from_numpy(ids_b).view(torch.int16)
    assert torch.equal(staged.cpu().view(torch.int16), want)
    assert torch.equal(pageable.cpu().view(torch.int16), want)

    torch.cuda._sleep(100_000_000)  # the copy below waits ~50 ms for this
    stack = tm._id_stack(ids_b.shape, True)
    stack[...] = ids_b
    sent = tm.device_ids(stack, "cuda")
    del stack
    again = tm._id_stack(ids_b.shape, True)
    again[...] = 0xFFFF
    torch.cuda.synchronize()
    assert torch.equal(sent.cpu().view(torch.int16), want)

    ev = tm.MapEvaluator()
    got = ev.evaluate_scene(pipe)
    assert got["frames_evaluated"] == 3
    assert ev.timers.count["eval_gt_staged"] == 2
    assert ev.timers.count["eval_gt_pageable"] == 0
    stack_of = tm._id_stack
    monkeypatch.setattr(tm, "_id_stack",
                        lambda shape, pinned: stack_of(shape, False))
    ev = tm.MapEvaluator()
    assert ev.evaluate_scene(pipe) == got
    assert ev.timers.count["eval_gt_pageable"] == 2
    assert ev.timers.count["eval_gt_staged"] == 0


@pytest.fixture(scope="module")
def full_gt_clip(tmp_path_factory):
    """gt_clip's kind of clip with every mask present, drawn 3 px off the
    reprojection (so its ids differ from gt_clip's), compiled at
    135 x 240."""
    clip = make_fixture_clip(tmp_path_factory.mktemp("tids_full"), n_frames=5,
                             with_images=False)
    add_instance_masks(clip, shift_px=3.0)
    return compile_scene(clip, output_size=(135, 240))


def _stored(scene, store_dir, frames=None):
    """A CPU pipeline over `scene` whose GT store lies in `store_dir`, with
    the slots of `frames` (every frame by default) filled by a decode."""
    pipe = ClipPipeline(configs={"frame_cache_dir": str(store_dir)},
                        scene=scene, chunk=3, device="cpu")
    ev = tm.MapEvaluator()
    for i in (range(len(scene.frame_times)) if frames is None else frames):
        ev._camera_ids(pipe, i)
    pipe.gt_mask_cache().flush()
    return pipe


def _per_camera_gt(pipes, idxs):
    """_chunk_gt's three results built row by row from _camera_ids on
    pipelines of the same scenes without a GT store (every mask decoded)."""
    plain = {}
    ev = tm.MapEvaluator()
    ids_b = np.zeros((len(idxs), 6, 135, 240), np.uint16)
    fv = np.zeros((len(idxs),), np.float32)
    evaluated = []
    for kk, (pipe, i) in enumerate(zip(pipes, idxs)):
        if i is None:
            continue
        if id(pipe) not in plain:
            plain[id(pipe)] = ClipPipeline(configs={"frame_cache": False},
                                           scene=pipe.scene, device="cpu")
        ids = ev._camera_ids(plain[id(pipe)], i)
        if ids is not None:
            ids_b[kk] = np.stack(ids)
            fv[kk] = 1.0
            evaluated.append((kk, i))
    return ids_b, fv, evaluated


@pytest.mark.parametrize("case,idxs,counts", [
    ("miss_in_the_middle", [1, 2, 3, 4], (2, 3, 1)),
    ("not_consecutive", [4, 2, 3], (2, 3, 0)),
    ("none_rows", [None, 2, None, 3, 4], (2, 3, 0)),
    ("fleet_of_two", [1, 2, 3, 4], (2, 4, 0)),
    ("no_store", [1, 2, 3], (0, 0, 3)),
    ("frame_lacking_a_mask", [1, 2, 3], (1, 2, 1)),
])
def test_chunk_gt_equals_the_per_camera_path(gt_clip, full_gt_clip, tmp_path,
                                             case, idxs, counts):
    """_chunk_gt's stack, row validity and evaluated rows equal, byte for
    byte, those of _camera_ids row by row with every mask decoded: frames
    complete in the GT store are read in runs (consecutive frames of one
    pipeline in consecutive rows), every other row decodes.  counts are
    the reads, the rows they filled and the rows decoded.  Cases: frame 3
    a miss between hits; rows out of frame order; rows without a frame;
    two pipelines over clips with other masks, their frames consecutive
    across the boundary (two runs); a pipeline without a store; gt_clip,
    whose frame 1 lacks a camera's mask."""
    if case == "miss_in_the_middle":
        pipes = [_stored(full_gt_clip, tmp_path, frames=[1, 2, 4])] * 4
    elif case == "fleet_of_two":
        pipes = ([_stored(full_gt_clip, tmp_path / "a")] * 2
                 + [_stored(gt_clip, tmp_path / "b")] * 2)
    elif case == "no_store":
        pipes = [ClipPipeline(configs={"frame_cache": False},
                              scene=full_gt_clip, device="cpu")] * 3
    elif case == "frame_lacking_a_mask":
        pipes = [_stored(gt_clip, tmp_path)] * 3
    else:
        pipes = [_stored(full_gt_clip, tmp_path)] * len(idxs)
    ev = tm.MapEvaluator()
    ids_b, fv, evaluated = ev._chunk_gt(pipes, idxs)
    want_ids, want_fv, want_evaluated = _per_camera_gt(pipes, idxs)
    assert ids_b.dtype == np.uint16
    np.testing.assert_array_equal(ids_b, want_ids)
    np.testing.assert_array_equal(fv, want_fv)
    assert evaluated == want_evaluated
    got = tuple(ev.timers.count[k] for k in (
        "eval_gt_store_reads", "eval_gt_store_rows", "eval_gt_decoded_rows"))
    assert got == counts


@pytest.mark.parametrize("case,idxs,counts", [
    ("miss_in_the_middle", [1, 2, 3, 4], (2, 3, 1)),
    ("none_rows", [None, 2, None, 3, 4], (2, 3, 0)),
    ("frame_lacking_a_mask", [1, 2, 3], (1, 2, 1)),
])
def test_chunk_gt_equals_the_jax_packages(gt_clip, full_gt_clip, tmp_path,
                                          case, idxs, counts):
    """The port's _chunk_gt, with runs read from the GT store, equals the
    JAX package's _chunk_gt (every row through its instance_loader) on the
    same clip and the one store both packages share (same key, same
    bytes), warmed once by the port: the stack byte for byte, row
    validity and evaluated rows.  Cases: frame 3 a miss between hits; rows
    without a frame; gt_clip, whose frame 1 lacks a camera's mask."""
    scene = gt_clip if case == "frame_lacking_a_mask" else full_gt_clip
    pipe = _stored(scene, tmp_path,
                   frames=[1, 2, 4] if case == "miss_in_the_middle" else None)
    jpipe = JClipPipeline(configs={"frame_cache_dir": str(tmp_path)},
                          scene=jcompile_scene(scene.clip_path,
                                               output_size=(135, 240)),
                          chunk=3)
    assert jpipe._gt_cache_key() == pipe._gt_cache_key()
    ev = tm.MapEvaluator()
    ids_b, fv, evaluated = ev._chunk_gt([pipe] * len(idxs), idxs)
    got = tuple(ev.timers.count[k] for k in (
        "eval_gt_store_reads", "eval_gt_store_rows", "eval_gt_decoded_rows"))
    assert got == counts
    want_ids, want_fv, want_evaluated = jm.MapEvaluator()._chunk_gt(jpipe,
                                                                    idxs)
    assert ids_b.dtype == want_ids.dtype == np.uint16
    np.testing.assert_array_equal(ids_b, want_ids)
    np.testing.assert_array_equal(fv, want_fv)
    assert evaluated == want_evaluated


@pytest.mark.parametrize("which,counts", [("full", (2, 4, 0)),
                                          ("lacking", (2, 3, 1))])
def test_warm_pass_looks_up_no_stored_mask(gt_clip, full_gt_clip, tmp_path,
                                           monkeypatch, which, counts):
    """A warm evaluate_scene (chunk 3: rows [-, 1, 2] and [3, 4, -]) reads
    the GT store in runs and looks up no lane_ins path of a stored frame:
    none on a clip with every mask, only frame 1's on gt_clip, whose
    frame 1 lacks a camera's mask and so never completes in the store.
    The counters read the runs' reads, their rows and the rows decoded,
    and the dict equals the cold pass's."""
    scene = full_gt_clip if which == "full" else gt_clip
    pipe = ClipPipeline(configs={"frame_cache_dir": str(tmp_path)},
                        scene=scene, chunk=3, device="cpu")
    cold = tm.MapEvaluator().evaluate_scene(pipe)
    pipe.gt_mask_cache().flush()
    looked_up = []
    real_exists, real_stat = os.path.exists, os.stat

    def exists(path):
        looked_up.append(str(path))
        return real_exists(path)

    def stat(path, *args, **kwargs):
        looked_up.append(str(path))
        return real_stat(path, *args, **kwargs)

    monkeypatch.setattr(os.path, "exists", exists)
    monkeypatch.setattr(os, "stat", stat)
    ev = tm.MapEvaluator()
    warm = ev.evaluate_scene(pipe)
    monkeypatch.undo()
    assert warm == cold
    lane_ins = [p for p in looked_up if "lane_ins_" in p]
    frame1 = {f"{scene.clip_path}/lane_ins_{cam}/{scene.sync_ms[cam][1]}.png"
              for cam in scene.camera_list}
    if which == "full":
        assert lane_ins == []
    else:
        assert lane_ins and set(lane_ins) <= frame1
    got = tuple(ev.timers.count[k] for k in (
        "eval_gt_store_reads", "eval_gt_store_rows", "eval_gt_decoded_rows"))
    assert got == counts


def test_deleted_mask_leaves_its_frame_unevaluated(tmp_path):
    """A PNG deleted between two evaluations on one pipeline: the second
    drops the frame (the refresh re-signs the PNGs and drops the store the
    first filled), and its dict equals a fresh pipeline's."""
    clip = make_fixture_clip(tmp_path / "clip", n_frames=5, with_images=False)
    add_instance_masks(clip, shift_px=3.0)
    scene = compile_scene(clip, output_size=(135, 240))
    pipe = ClipPipeline(configs={"frame_cache_dir": str(tmp_path / "s1")},
                        scene=scene, chunk=3, device="cpu")
    first = tm.MapEvaluator().evaluate_scene(pipe)
    pipe.gt_mask_cache().flush()
    ev = tm.MapEvaluator()
    assert ev.evaluate_scene(pipe) == first
    assert ev.timers.count["eval_gt_decoded_rows"] == 0
    cam = scene.camera_list[4]
    os.remove(os.path.join(clip, f"lane_ins_{cam}",
                           f"{scene.sync_ms[cam][3]}.png"))
    ev = tm.MapEvaluator()
    after = ev.evaluate_scene(pipe)
    assert after["frames_evaluated"] == first["frames_evaluated"] - 1
    assert ev.timers.count["eval_gt_store_rows"] == 0
    fresh = ClipPipeline(configs={"frame_cache_dir": str(tmp_path / "s2")},
                         scene=scene, chunk=3, device="cpu")
    assert tm.MapEvaluator().evaluate_scene(fresh) == after


def test_clip_pixels_matches_on_finite_values():
    vu = np.array([[[-5.5, -0.5], [0.0, 0.99], [H - 0.01, W - 1.0],
                    [H + 7.0, W + 0.5], [3.7, 1e9], [-1e9, 12.2]]], np.float32)
    wv, wu = jm._clip_pixels(jnp.asarray(vu), H, W)
    gv, gu = tm._clip_pixels(T(vu), H, W)
    np.testing.assert_array_equal(N(gv), np.asarray(wv))
    np.testing.assert_array_equal(N(gu), np.asarray(wu))


def test_point_count_raster():
    wv, wu = jm._clip_pixels(jnp.asarray(VU[0]), H, W)
    want = np.asarray(jm._point_count_raster(wv, wu, jnp.asarray(KEEP[0]), H, W))
    gv, gu = tm._clip_pixels(T(VU[0]), H, W)
    got = tm._point_count_raster(gv, gu, T(KEEP[0]), H, W)
    np.testing.assert_array_equal(N(got), want)
    assert want.max() >= 2 and want.sum() == KEEP[0].sum()
    # any leading shape: the chunk at once equals frame by frame
    gv, gu = tm._clip_pixels(T(VU), H, W)
    both = tm._point_count_raster(gv, gu, T(KEEP), H, W)
    np.testing.assert_array_equal(N(both[0]), want)


@pytest.mark.parametrize("assignment", ["nearest", "chebyshev"])
def test_instance_votes_chunk_under_keep(assignment):
    want = np.asarray(jm.instance_votes_chunk(
        jnp.asarray(IDS), jnp.asarray(VU), jnp.asarray(KEEP), TOL, assignment))
    got = tm.instance_votes_chunk(T(IDS), T(VU), T(KEEP), TOL, assignment)
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(N(got)[KEEP], want[KEEP])
    assert (want[KEEP] > 0).any() and (want[KEEP] == 40000).any()


def _assert_partials(got, want, distance, rows=None):
    for key in KEYS:
        g = np.asarray(N(got[key]), np.float32)
        w = np.asarray(want[key], np.float32)
        if rows is not None:
            assert g.shape == w.shape == (rows,)
        if distance == "euclidean" and key == "sre_sum":
            np.testing.assert_allclose(g, w, rtol=SRE_RTOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("distance", ["chebyshev", "euclidean"])
def test_frame_metrics_forms(distance):
    """frame_metrics, _rows and _chunk, against the JAX forms and against
    the JAX package's two _packed forms, fed the same masks bitpacked on the
    host: every Chebyshev partial exact; Euclidean sre_sum to 1e-6
    relative, the other four exact."""
    fv = np.array([1.0, 0.0], np.float32)
    packed = np.packbits(MASKS, axis=-1)
    j = [jnp.asarray(a) for a in (MASKS, VU, KEEP)]
    t = [T(a) for a in (MASKS, VU, KEEP)]
    _assert_partials(
        tm.frame_metrics(t[0][0], t[1][0], t[2][0], RAD, TOL, distance),
        jm.frame_metrics(j[0][0], j[1][0], j[2][0], RAD, TOL, distance),
        distance)
    want_rows = jm.frame_metrics_rows(*j, RAD, TOL, distance)
    _assert_partials(tm.frame_metrics_rows(*t, RAD, TOL, distance),
                     want_rows, distance, rows=K)
    _assert_partials(
        tm.frame_metrics_rows(*t, RAD, TOL, distance),
        jm.frame_metrics_rows_packed(jnp.asarray(packed), j[1], j[2], W, RAD,
                                     TOL, distance), distance, rows=K)
    want_chunk = jm.frame_metrics_chunk(*j, jnp.asarray(fv), RAD, TOL,
                                        distance)
    _assert_partials(tm.frame_metrics_chunk(*t, T(fv), RAD, TOL, distance),
                     want_chunk, distance)
    _assert_partials(
        tm.frame_metrics_chunk(*t, T(fv), RAD, TOL, distance),
        jm.frame_metrics_chunk_packed(jnp.asarray(packed), j[1], j[2],
                                      jnp.asarray(fv), W, RAD, TOL, distance),
        distance)
    assert float(want_rows["n_hit"][0]) > 0
    assert 0 < float(want_rows["gt_covered"][0]) < float(want_rows["gt_total"][0])


def test_metrics_and_votes_chunk():
    """The evaluator's device step with votes, fields derived from the ids
    (_gt_fields) and sampled per row (_sample_fields), summed over the
    valid rows: JAX's _metrics_and_votes_chunk on the same arrays."""
    fv = np.array([1.0, 0.0], np.float32)
    wp, wv = jm._metrics_and_votes_chunk(
        jnp.asarray(IDS), jnp.asarray(VU), jnp.asarray(KEEP), jnp.asarray(fv),
        RAD, TOL, "chebyshev", "nearest")
    fields = tm._gt_fields(T(IDS), RAD, TOL, "chebyshev", "nearest", True,
                           True)
    rows, gv = tm._sample_fields(*fields, T(VU), T(KEEP), RAD, TOL,
                                 "chebyshev")
    _assert_partials({k: (v * T(fv)).sum() for k, v in rows.items()}, wp,
                     "chebyshev")
    assert gv.dtype == torch.uint16
    np.testing.assert_array_equal(N(gv)[KEEP], np.asarray(wv)[KEEP])
    only_votes = tm._gt_fields(T(IDS), RAD, TOL, "chebyshev", "nearest",
                               False, True)
    assert only_votes[1] is None
    none, votes = tm._sample_fields(*only_votes, T(VU), T(KEEP), RAD, TOL,
                                    "chebyshev")
    assert none is None and torch.equal(votes.view(torch.int16),
                                        gv.view(torch.int16))


@pytest.mark.parametrize("distance", ["chebyshev", "euclidean"])
def test_frame_metrics_host_equals_jax_module(distance):
    for k in range(K):
        want = jm.frame_metrics_host(MASKS[k], VU[k], KEEP[k], RAD, TOL,
                                     distance)
        got = tm.frame_metrics_host(MASKS[k], VU[k], KEEP[k], RAD, TOL,
                                    distance)
        assert got == want
    # and the tensor path's Chebyshev partials equal the host mirror's
    if distance == "chebyshev":
        dev = tm.frame_metrics(T(MASKS[0]), T(VU[0]), T(KEEP[0]), RAD, TOL)
        host = tm.frame_metrics_host(MASKS[0], VU[0], KEEP[0], RAD, TOL)
        assert {k2: float(v) for k2, v in dev.items()} == host


def test_instance_votes_host_equals_jax_module():
    for k in range(K):
        np.testing.assert_array_equal(
            tm.instance_votes_host(IDS[k], VU[k], KEEP[k], TOL),
            jm.instance_votes_host(IDS[k], VU[k], KEEP[k], TOL))


def test_instance_association_and_reduce_metrics():
    rng = np.random.default_rng(5)
    mi = rng.integers(0, 9, 400)
    gi = np.where(rng.random(400) < 0.3, 0, (mi % 4) + 1 + (rng.random(400) < 0.2))
    for vis in (None, {1, 2, 3, 4, 5, 6}):
        assert (tm.instance_association(mi, gi, vis)
                == jm.instance_association(mi, gi, vis))
    assert tm.instance_association([], []) == jm.instance_association([], [])
    parts = [tm.frame_metrics_host(MASKS[k], VU[k], KEEP[k], RAD, TOL)
             for k in range(K)]
    assert tm.reduce_metrics(parts) == jm.reduce_metrics(parts)
    empty = dict.fromkeys(KEYS, 0.0)
    got, want = tm.reduce_metrics([empty]), jm.reduce_metrics([empty])
    assert np.isnan(got.pop("SRE")) and np.isnan(want.pop("SRE"))
    assert got == want


def test_frame_instance_pairs():
    inst = np.arange(P) % 11
    wm, wg = jm.frame_instance_pairs(IDS[0], VU[0], KEEP[0], inst, TOL)
    gm, gg = tm.frame_instance_pairs(IDS[0], VU[0], KEEP[0], inst, TOL,
                                     device="cpu")
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gg, wg)


@pytest.mark.parametrize("distance", ["chebyshev", "euclidean"])
@pytest.mark.parametrize("k1", [None, 256])
def test_eval_chunk_build_then_serve(distance, k1):
    """The fused chunk on a small synthetic scene: build and serve give
    equal outputs, equal to the JAX build's under keep (partials exact but
    the Euclidean sre_sum), and the derived fields are the JAX fields."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2, 6, P)
    valid = rng.random(P) < 0.9
    A = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    B = np.zeros((K, C, 3, 4), np.float32)
    for k in range(K):
        for c in range(C):
            B[k, c] = [[40 + 3 * c, 0, W / 2, k], [0, 40, H / 2, c], [0, 0, 1, 0]]
    fvb = np.array([True, True])
    lo, hi = np.full(3, -0.8, np.float32), np.array([0.8, 0.8, 10], np.float32)
    geo = (W, H, lo, hi, k1, RAD, TOL, distance)
    jargs = [jnp.asarray(a) for a in (pts, valid, A, B, fvb, IDS)]
    targs = [T(a) for a in (pts, valid, A, B, fvb, IDS)]
    want = jm._eval_chunk_build(*jargs, *geo, "nearest", True)
    got = tm._eval_chunk_build(*targs, *geo, "nearest", True)
    keep = N(got[2])
    np.testing.assert_array_equal(keep, np.asarray(want[2]))
    assert keep.sum() > 100
    _assert_partials(got[0], want[0], distance)
    np.testing.assert_array_equal(N(got[1])[keep], np.asarray(want[1])[keep])
    if k1 is not None:
        live = keep.any(1)
        np.testing.assert_array_equal(N(got[3])[live], np.asarray(want[3])[live])
    for i in (4, 5, 6):   # dist field, packed mask, vote field
        np.testing.assert_array_equal(N(got[i]), np.asarray(want[i]))
    served = tm._eval_chunk_serve(*targs[:5], got[4], got[5], got[6], *geo)
    for key in KEYS:
        assert torch.equal(served[0][key], got[0][key])
    assert torch.equal(served[1].view(torch.int16), got[1].view(torch.int16))
    assert torch.equal(served[2], got[2])
    assert (served[3] is None) if k1 is None else torch.equal(served[3], got[3])
