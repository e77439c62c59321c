"""The port's sparse lane and two-stage compaction against the JAX package
on CPU: the host list mirror and sparse paint (exact), the native sparse
paint (byte for byte), the union split of the fused kernel's list against
the JAX package's sparse program (exact where the arithmetic is; else the
f32 border class at >= 0.99999 per frame), crop-first compaction, the
serving decision on both fixtures, and iter_frames / write_videos over the
sparse, dense and fallback paths (byte-identical frames).  The union split
on the card runs with the fused kernel (marked `cuda`, skipped without
one)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cama_tpu import native as jnative
from cama_tpu import pipeline as jpipe
from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu.ops import geometry as jgeo
from cama_tpu.ops import raster as jr
from cama_tpu_torch import native as tnative
from cama_tpu_torch import pipeline as tpipe
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.ops import fused_compact as tfc
from cama_tpu_torch.ops import geometry as tgeo
from cama_tpu_torch.ops import raster as tr
from cama_tpu_torch.ops.geometry import compose_frame_matrices, crop_bounds
from cama_tpu_torch.tools import fused_cases


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test suite runs several worker processes at once; one intra-op
    torch thread in this one keeps torch's CPU ops from oversubscribing the
    cores (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LANES = ("fused", "pallas", "compact", "scatter")
WIDE = dict(n_frames=17, label_span=(-290.0, 210.0))  # bench.py's wide scene


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _projected(seed, C=3, P=257, w=64, h=48):
    """vu [C, P, 2], keep, cls with runs of same-pixel points."""
    rng = np.random.default_rng(seed)
    vu = np.stack([rng.uniform(0, h, (C, P)), rng.uniform(0, w, (C, P))],
                  axis=-1).astype(np.float32)
    vu[:, 40:80] = vu[:, 40:41]
    keep = rng.random((C, P)) < 0.7
    cls = rng.integers(0, 4, P).astype(np.int32)
    return vu, keep, cls


# ---------------- host mirrors and the native paint ----------------


@pytest.mark.parametrize("k", [8, 96, 300])  # overflow, fits, > P
def test_compact_points_host_matches_jax(k):
    vu, keep, cls = _projected(7)
    got = tr.compact_points_host(vu, keep, cls, 64, 48, k)
    want = jr.compact_points_host(vu, keep, cls, 64, 48, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and the port's torch compaction gives the same lists
    vals, counts = tr.compact_points(*_t(vu, keep, cls), 64, 48, k)
    np.testing.assert_array_equal(vals.numpy(), got[0])
    np.testing.assert_array_equal(counts.numpy(), got[1])


def _paint_case(seed, h=37, w=53, n=120):
    """A base image, a list of n encodings (some -1, points at the image
    edges so the stencil clips) and a color table."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    py = rng.integers(0, h, n)
    px = rng.integers(0, w, n)
    py[:6], px[6:12] = 0, w - 1
    vals = ((py * w + px) * tr.MAX_CLS + rng.integers(0, 3, n)).astype(np.int32)
    vals[rng.random(n) < 0.1] = -1
    table = rng.integers(0, 256, (3, 3), dtype=np.uint8)
    return base, vals, table


@pytest.mark.parametrize("count", [0, 57, 120])
def test_paint_sparse_host_matches_jax(count):
    base, vals, table = _paint_case(3)
    w = base.shape[1]
    got = tr.paint_sparse_host(base.copy(), vals, count, table, w)
    want = jr.paint_sparse_host(base.copy(), vals, count, table, w)
    np.testing.assert_array_equal(got, want)
    assert (got != base).any() == (count > 0)


@pytest.mark.parametrize("count", [0, 57, 120])
def test_native_paint_sparse_byte_identical(count):
    """The port's compositor paints the same bytes as cama_tpu.native and as
    the NumPy mirror, into a slot view of a mosaic."""
    assert tnative.available() and jnative.available()
    base, vals, table = _paint_case(4)
    h, w = base.shape[:2]
    outs = []
    for mod in (tnative, jnative):
        mosaic = np.zeros((2 * h, 3 * w, 3), np.uint8)
        slot = mosaic[h:, w:2 * w]
        slot[:] = base
        mod.paint_sparse(vals, count, table, w, slot)
        outs.append(mosaic)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(
        outs[0][h:, w:2 * w],
        tr.paint_sparse_host(base.copy(), vals, count, table, w))


# ---------------- the union split (sparse_from_union) ----------------


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(points, valid, cls, A, B, fv, w, h, lo, hi) of the default fixture's
    cama source, as numpy arrays."""
    clip = make_fixture_clip(tmp_path_factory.mktemp("tsparse"), n_frames=4,
                             with_images=False, with_lidar=False)
    scene = compile_scene(clip)
    fm = compose_frame_matrices(scene.traj["cama"], scene.frame_times,
                                scene.chassis2cam, scene.K_scaled)
    fp = scene.flat["cama"]
    h, w = scene.output_size
    lo, hi = crop_bounds()
    return (fp.points, fp.valid, fp.cls, fm.A.astype(np.float32),
            fm.B.astype(np.float32), fm.frame_valid, w, h, lo, hi)


def _split_cases(frames):
    one = fused_cases.crop_straddle_case(1, groups=200)
    many = fused_cases.crop_straddle_case(16, groups=200)
    return {"fixture": (frames, 4096),
            "tile boundaries": (fused_cases.tile_boundary_case(8192 + 512),
                                4096),
            "crop-straddling F=1": (one, 2048),
            "crop-straddling F=16": (many, 2048),
            "a count above k": (many, 512),
            "k above P": (fused_cases.tile_boundary_case(700), 1024)}


@pytest.mark.parametrize("case", ["fixture", "tile boundaries",
                                  "crop-straddling F=1",
                                  "crop-straddling F=16", "a count above k",
                                  "k above P"])
def test_sparse_from_union_equals_compact_points(frames, case):
    """sparse_from_union over the fused program's union list equals
    compact_points over project_frames, exactly (lists, -1 padding past
    the count or past P, and the true per-camera totals above k)."""
    args, k = _split_cases(frames)[case]
    t = _t(*args[:6])
    geo = args[6:]
    union = tfc.count_union(*t, *geo)
    k_cap = tpipe._pow2_cap(int(union.max()), len(args[0]))
    vals_u, count = tfc.fused_compact_project_ref(*t, *geo, k_cap)
    got, got_n = tfc.sparse_from_union(vals_u, count, k)
    vu, keep = tgeo.project_frames(t[0], t[1], t[3], t[4], t[5], *geo)
    want, want_n = tr.compact_points(vu, keep, t[2], geo[0], geo[1], k)
    assert got.shape == (len(args[5]), args[4].shape[1], k)
    assert torch.equal(got_n, want_n) and torch.equal(got, want)
    np.testing.assert_array_equal(tfc.camera_counts(vals_u, count), want_n)
    if case == "a count above k":
        assert int(want_n.max()) > k
    if case == "k above P":
        assert k > len(args[0]) and (got[..., len(args[0]):] == -1).all()
    # rows past the count are unspecified on the card: garbage there changes
    # nothing
    junk = torch.where(torch.arange(k_cap)[None, :, None] >= count[:, None, None],
                       torch.full_like(vals_u, 12345), vals_u)
    assert torch.equal(tfc.sparse_from_union(junk, count, k)[0], got)


def test_sparse_program_matches_jax_program(frames):
    """The port's 'fused' sparse program against the JAX package's
    _project_compact_chunk on the fixture: the per-camera counts and lists
    agree except on the f32 border class, and the painted frames agree at
    >= 0.99999 per frame."""
    points, valid, cls, A, B, fv, w, h, lo, hi = frames
    k = 4096
    got, got_n, union = tpipe._project_compact_chunk(
        *_t(points, valid, cls, A, B, fv), lo, hi, w, h, k, lane="fused",
        k_cap=8192)
    assert int(union.max()) <= 8192
    want, want_n = (np.asarray(a) for a in jpipe._project_compact_chunk(
        jnp.asarray(points), jnp.asarray(valid), jnp.asarray(cls),
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(fv), lo, hi, w, h, k))
    got, got_n = got.numpy(), got_n.numpy()
    assert np.abs(got_n - want_n).max() <= 2
    table = tr.build_color_table(["lane_marking", "Road_teeth", "x"])
    for f in np.flatnonzero(fv):
        for c in range(B.shape[1]):
            a = tr.paint_sparse_host(np.zeros((h, w, 3), np.uint8), got[f, c],
                                     got_n[f, c], table, w)
            b = tr.paint_sparse_host(np.zeros((h, w, 3), np.uint8),
                                     want[f, c], want_n[f, c], table, w)
            assert a.any() or c > 2
            assert (a == b).all(-1).mean() >= 0.99999, (f, c)


# ---------------- two-stage compaction ----------------


@pytest.fixture(scope="module")
def long_clip(tmp_path_factory):
    """Labels spanning ~500 m while the crop keeps ±50 m: most points cull
    per frame, so the two-stage split engages (tests/test_two_stage.py)."""
    return make_fixture_clip(tmp_path_factory.mktemp("tlong"), n_frames=6,
                             with_images=False, with_lidar=False,
                             label_span=(-295.0, 200.0))


def test_crop_compact_project_exact_on_straddling_case():
    """Exactly representable geometry: the port's crop-first projection
    equals the JAX package's frame by frame (survivor indices, pixels, keep
    bits), and its crop count is the number of survivors."""
    pts, valid, cls, A, B, fv, w, h, lo, hi = fused_cases.crop_straddle_case(
        6, groups=200)
    k1 = 4096
    vu, keep, cls_sel, n_crop = tgeo.crop_compact_project(
        *_t(pts, valid, cls, A, B, fv), w, h, lo, hi, k1)
    for f in range(len(fv)):
        jvu, jkeep, jcls = (np.asarray(a) for a in jgeo.crop_compact_project(
            jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(cls),
            jnp.asarray(A[f]), jnp.asarray(B[f]), jnp.asarray(fv[f]), w, h,
            jnp.asarray(lo), jnp.asarray(hi), k1))
        np.testing.assert_array_equal(keep[f].numpy(), jkeep)
        np.testing.assert_array_equal(cls_sel[f].numpy(), jcls)
        np.testing.assert_array_equal(vu[f].numpy()[jkeep], jvu[jkeep])
        p4 = np.concatenate([pts, np.ones((len(pts), 1))], 1)
        xyz = p4 @ A[f, :3].astype(np.float64).T
        inside = ((xyz >= lo) & (xyz <= hi)).all(-1) & valid & fv[f]
        assert int(n_crop[f]) == int(inside.sum())
    assert keep.any() and not bool(fv[5]) and not keep[5].any()


def test_two_stage_rasters_equal_single_stage(long_clip):
    """Crop-first compaction gives the single-stage rasters exactly, and
    the JAX package's two-stage rasters at >= 0.99999 per frame; its counts
    report (crop count, largest per-camera count)."""
    pipe = tpipe.ClipPipeline(clip_path=long_clip, chunk=4,
                              raster_kernel="compact", device="cpu")
    _, k = pipe.overlay_mode("cama")
    k1 = pipe._two_stage["cama"]
    assert k1 is not None
    st = pipe.scene_tensors("cama")
    h, w = pipe.scene.output_size
    sl = slice(0, 4)
    args = (st.points, st.valid, st.cls, st.A[sl], st.B[sl],
            st.frame_valid[sl], pipe._crop_lo, pipe._crop_hi, w, h)
    single, n1 = tpipe._overlay_chunk_compact(*args, k, False)
    double, n2 = tpipe._overlay_chunk_two_stage(*args, k1, min(k, k1), False)
    assert torch.equal(double, single) and double.any()
    assert n2.shape == (4, 2) and (n2[:, 0] <= k1).all()
    assert (n2[:, 1] <= n1).all()  # the subsequence dedups at least as much
    fp = pipe.scene.flat["cama"]
    _, A, B, fv, _ = pipe._chunked_AB("cama")
    ref = np.asarray(jpipe._overlay_chunk_two_stage(
        jnp.asarray(fp.points), jnp.asarray(fp.valid), jnp.asarray(fp.cls),
        jnp.asarray(A[sl]), jnp.asarray(B[sl]), jnp.asarray(fv[sl]),
        pipe._crop_lo, pipe._crop_hi, w, h, k1, min(k, k1), False))
    for f in range(4):
        assert (double[f].numpy() == ref[f]).mean() >= 0.99999


def test_compact_lane_serves_two_stage(long_clip, monkeypatch):
    """The 'compact' lane switches to two-stage when the split engages and
    streams the same rasters as the fused lane."""
    calls = []
    real = tpipe._overlay_chunk_two_stage

    def spy(*a, **kw):
        calls.append(a[-3:-1])
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "_overlay_chunk_two_stage", spy)
    compact = tpipe.ClipPipeline(clip_path=long_clip, chunk=4,
                                 raster_kernel="compact", device="cpu")
    got = dict(compact.iter_overlay_rasters("cama"))
    k, k1 = compact.overlay_mode("cama")[1], compact._two_stage["cama"]
    assert calls and set(calls) == {(k1, min(k, k1))}
    fused = dict(tpipe.ClipPipeline(clip_path=long_clip, chunk=4,
                                    device="cpu").iter_overlay_rasters("cama"))
    assert set(got) == set(fused)
    for idx in got:
        np.testing.assert_array_equal(got[idx], fused[idx])


# ---------------- the serving decision ----------------


@pytest.fixture(scope="module")
def fixture_clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("tmodes")
    return {"default": make_fixture_clip(root / "d", with_images=False,
                                         with_lidar=False),
            "wide": make_fixture_clip(root / "w", with_images=False,
                                      with_lidar=False, **WIDE)}


# (mode, k), _fused_k, _two_stage of the JAX package on these fixtures
SERVING = {("default", "cama"): (("sparse", 4096), 8192, None),
           ("default", "nuscenes"): (("sparse", 2048), 2048, None),
           ("wide", "cama"): (("sparse", 4096), 8192, 65536),
           ("wide", "nuscenes"): (("sparse", 2048), 4096, 8192)}


@pytest.mark.parametrize("fixture, source", list(SERVING))
def test_serving_decision_matches_jax(fixture_clips, fixture, source):
    clip = fixture_clips[fixture]
    cfg = {"scene_cache": False}
    ref = jpipe.ClipPipeline(cfg, clip_path=clip, raster_kernel="fused")
    want = (ref.overlay_mode(source), ref._fused_k[source],
            ref._two_stage[source])
    assert want == SERVING[(fixture, source)]
    for lane in ("fused", "pallas"):
        port = tpipe.ClipPipeline(cfg, clip_path=clip, raster_kernel=lane,
                                  device="cpu")
        got = (port.overlay_mode(source), port._fused_k[source],
               port._two_stage[source])
        assert got == want, lane
        assert port.serving_mode(source) == want[0]


# ---------------- frames: sparse, dense and fallback ----------------


@pytest.fixture(scope="module")
def image_clip(tmp_path_factory):
    return make_fixture_clip(tmp_path_factory.mktemp("timg"), n_frames=5,
                             with_images=True, with_lidar=False)


@pytest.mark.parametrize("lane", LANES)
def test_iter_frames_sparse_raster_auto_identical(image_clip, lane):
    """Every lane's sparse frames (host paint of the lists) equal its dense
    frames byte for byte, and 'auto' serves the sparse lane."""
    pipe = tpipe.ClipPipeline(clip_path=image_clip, chunk=4,
                              raster_kernel=lane, device="cpu")
    dense = dict(pipe.iter_frames("cama", mode="raster"))
    sparse = dict(pipe.iter_frames("cama", mode="sparse"))
    auto = dict(pipe.iter_frames("cama", mode="auto"))
    assert pipe.serving_mode("cama")[0] == "sparse"
    assert set(dense) == set(sparse) == set(auto) and len(dense) >= 3
    for idx in dense:
        for cam in dense[idx]:
            np.testing.assert_array_equal(sparse[idx][cam], dense[idx][cam])
            np.testing.assert_array_equal(auto[idx][cam], dense[idx][cam])
    assert pipe.timers.count.get("sparse_overflow", 0) == 0


@pytest.mark.parametrize("lane", ["fused", "compact"])
def test_sparse_overflow_falls_back_in_order(image_clip, lane):
    """A list far too small for every frame: each frame is painted from its
    dense raster (the lane's own dense program on one frame), in order."""
    pipe = tpipe.ClipPipeline(clip_path=image_clip, chunk=4,
                              raster_kernel=lane, device="cpu")
    dense = dict(pipe.iter_frames("cama", mode="raster"))
    orig = pipe.iter_sparse_points
    pipe.iter_sparse_points = lambda source, k=None: orig(source, k=64)
    out = list(pipe.iter_frames("cama", mode="sparse"))
    assert [i for i, _ in out] == sorted(dense)
    assert pipe.timers.count["sparse_overflow"] == len(dense)
    for idx, frame in out:
        for cam in frame:
            np.testing.assert_array_equal(frame[cam], dense[idx][cam])


def test_union_overflow_raises(image_clip):
    """The port's rule: an overflowed union list raises at drain."""
    pipe = tpipe.ClipPipeline(clip_path=image_clip, chunk=4, device="cpu")
    pipe.overlay_mode("cama")
    pipe._fused_k["cama"] = 64
    with pytest.raises(RuntimeError, match="over the fused list size k=64"):
        list(pipe.iter_sparse_points("cama"))


def test_frames_match_jax_sparse_frames(image_clip):
    """The port's sparse frames against the JAX package's at the device-lane
    contract (>= 0.99999 of the pixels per frame and camera)."""
    got = dict(tpipe.ClipPipeline(clip_path=image_clip, chunk=4,
                                  device="cpu").iter_frames("nuscenes"))
    ref = dict(jpipe.ClipPipeline(clip_path=image_clip, chunk=4,
                                  raster_kernel="fused")
               .iter_frames("nuscenes", mode="sparse"))
    assert set(got) == set(ref)
    for idx in ref:
        for cam in ref[idx]:
            agree = (got[idx][cam] == ref[idx][cam]).all(-1).mean()
            assert agree >= 0.99999, (idx, cam, agree)


class _CaptureSink:
    """VideoSink stand-in that keeps a copy of every frame."""
    frames = {}

    def __init__(self, path, output_shape, fps=10, preset=None,
                 timers=None):
        self.path = path
        _CaptureSink.frames[path] = []

    def add_frame(self, frame):
        _CaptureSink.frames[self.path].append(np.array(frame, copy=True))

    def add_frame_from_dict(self, frame):
        from cama_tpu_torch.io.video import concat_camera_grid
        self.add_frame(concat_camera_grid(frame))

    def close(self):
        pass


def test_write_videos_serves_sparse_byte_identical(image_clip, monkeypatch):
    """write_videos streams both sources through the sparse lane, and its
    mosaics equal the dense path's byte for byte."""
    monkeypatch.setattr(tpipe, "VideoSink", _CaptureSink)
    _CaptureSink.frames = {}
    pipe = tpipe.ClipPipeline(clip_path=image_clip, chunk=4, device="cpu")
    used = []
    orig = pipe.iter_sparse_points
    pipe.iter_sparse_points = lambda src, k=None: used.append(src) or orig(src, k)
    paths = {"cama": "s_cama", "nuscenes": "s_nus"}
    counts = pipe.write_videos(paths)
    assert sorted(used) == ["cama", "nuscenes"] and counts["cama"] >= 3
    sparse = dict(_CaptureSink.frames)
    _CaptureSink.frames = {}
    dense = tpipe.ClipPipeline(clip_path=image_clip, chunk=4, device="cpu")
    dense.serving_mode = lambda src: ("raster", None)
    dense.write_videos({s: p + "_dense" for s, p in paths.items()})
    for path, frames in sparse.items():
        ref = _CaptureSink.frames[path + "_dense"]
        assert len(frames) == len(ref) == counts[
            "cama" if path == "s_cama" else "nuscenes"]
        for a, b in zip(frames, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_sparse_lane_matches_plain_program(frames):
    """On the card: the 'fused' sparse program (the CUDA kernel, then the
    union split) equals the plain program (fused_compact_project_ref, then
    the union split) exactly, with one kernel launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_*.py -m cuda)")
    points, valid, cls, A, B, fv, w, h, lo, hi = frames
    args = [t.cuda() for t in _t(points, valid, cls, A, B, fv)]
    before = tfc.LAUNCHES["fused_compact_project"]
    got, got_n, union = tpipe._project_compact_chunk(
        *args, lo, hi, w, h, 4096, lane="fused", k_cap=8192)
    assert tfc.LAUNCHES["fused_compact_project"] == before + 1
    ref_u, ref_c = tfc.fused_compact_project_ref(*args, w, h, lo, hi, 8192)
    ref, ref_n = tfc.sparse_from_union(ref_u, ref_c, 4096)
    torch.cuda.synchronize()
    assert torch.equal(union, ref_c)
    assert torch.equal(got_n, ref_n) and torch.equal(got, ref)
