"""cama_tpu_torch's copies of cama_tpu host code give the same bits: SE(3)
algebra and pose seek, clip reader, fixture clip, config schema,
scene-cache key, phase timers, lifting, the native compositor, the frame
cache and the video mosaic."""
import filecmp
import os

import numpy as np
import pytest

from cama_tpu import config as jconfig
from cama_tpu import native as jnative
from cama_tpu import profiling as jprofiling
from cama_tpu.io import clip as jclip
from cama_tpu.io import fixture as jfixture
from cama_tpu.io import frame_cache as jframe_cache
from cama_tpu.io import scene as jscene
from cama_tpu.io import video as jvideo
from cama_tpu.ops import lift as jlift
from cama_tpu.se3 import codec as jcodec
from cama_tpu.se3 import core as jcore
from cama_tpu.se3 import trajectory as jtraj
from cama_tpu_torch import config as tconfig
from cama_tpu_torch import native as tnative
from cama_tpu_torch import profiling as tprofiling
from cama_tpu_torch import se3 as tse3
from cama_tpu_torch.io import clip as tclip
from cama_tpu_torch.io import fixture as tfixture
from cama_tpu_torch.io import frame_cache as tframe_cache
from cama_tpu_torch.io import scene as tscene
from cama_tpu_torch.io import video as tvideo
from cama_tpu_torch.ops import lift as tlift


def _rigid(rng, n):
    q = rng.normal(size=(n, 4))
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = jcore.quat_to_matrix(q)
    T[:, :3, 3] = rng.normal(scale=50.0, size=(n, 3))
    return T


def _inputs(name, rng):
    n = 64
    q0, q1 = rng.normal(size=(n, 4)), rng.normal(size=(n, 4))
    rv = rng.normal(size=(n, 3))
    rv[:8] *= 1e-4  # the small-angle series branch
    return {
        "inv_se3": (_rigid(rng, n),),
        "quat_multiply": (q0, q1),
        "quat_to_matrix": (q0,),
        "matrix_to_quat": (_rigid(rng, n)[:, :3, :3],),
        "rotvec_to_quat": (rv,),
        "quat_to_rotvec": (q0,),
        "quat_slerp": (q0, q1, rng.uniform(size=n)),
        "slerp_transform": (_rigid(rng, n), _rigid(rng, n),
                            rng.uniform(size=n)),
    }[name]


@pytest.mark.parametrize("name", [
    "inv_se3", "quat_multiply", "quat_to_matrix", "matrix_to_quat",
    "rotvec_to_quat", "quat_to_rotvec", "quat_slerp", "slerp_transform"])
def test_se3_functions_bit_identical(name):
    args = _inputs(name, np.random.default_rng(7))
    np.testing.assert_array_equal(getattr(tse3, name)(*args),
                                  getattr(jcore, name)(*args))


@pytest.mark.parametrize("interpolate", [True, False])
def test_pose_seek_bit_identical(interpolate):
    rng = np.random.default_rng(3)
    ts = np.cumsum(rng.uniform(0.05, 0.4, size=40)) + 1.6e9
    q = np.concatenate([rng.uniform(ts[0] - 2.0, ts[-1] + 2.0, size=50),
                        ts[::7], [ts[0] - 5e-10]])
    T = _rigid(rng, len(ts))
    a = tse3.seek_indices(ts, q, 0.3, interpolate)
    b = jtraj.seek_indices(ts, q, 0.3, interpolate)
    assert a.keys() == b.keys() and a["valid"].any() and not a["valid"].all()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tse3.apply_seek(T, a), jtraj.apply_seek(T, b))


def test_trajectory_chain_bit_identical():
    rng = np.random.default_rng(5)
    T = _rigid(rng, 9)
    rows = jcodec.transforms_to_tum(T, np.arange(9) * 0.1 + 1.6e9)
    E = _rigid(rng, 1)[0]
    a, b = tse3.Trajectory(), jtraj.Trajectory()
    a.loadarray(rows)
    b.loadarray(rows)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    a.right_rotate(E)
    b.right_rotate(E)
    np.testing.assert_array_equal(a.as_transform(True), b.as_transform(True))
    a.normalize2center()
    b.normalize2center()
    np.testing.assert_array_equal(a.as_transform(True), b.as_transform(True))
    np.testing.assert_array_equal(tse3.tum_to_transforms(rows)[0],
                                  jcodec.tum_to_transforms(rows)[0])


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """The same fixture clip written by both packages."""
    args = dict(scene_name="s", n_frames=3, with_images=False,
                label_span=(-290.0, 210.0))
    a = tfixture.make_fixture_clip(tmp_path_factory.mktemp("t"), **args)
    b = jfixture.make_fixture_clip(tmp_path_factory.mktemp("j"),
                                   with_lidar=False, **args)
    return a, b


@pytest.mark.parametrize("rel", [
    "attribute.json", "odometry/wigo.txt", "odometry/wigo_offset_clip.txt",
    "odometry/scmv_camera_front.txt", "maps/map_labels.json",
    "maps/map_nuscenes.json", "maps/vision_road_mlp_ft.npy"])
def test_fixture_clip_same_bytes(clip_pair, rel):
    a, b = clip_pair
    assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                       shallow=False), rel


def test_clip_reader_matches(clip_pair):
    path = clip_pair[0]
    a, b = tclip.ClipReader(path), jclip.ClipReader(path)
    for cam in jscene.DEFAULT_CAMA_CONFIGS["camera_list"]:
        for frm, to in (("chassis", cam), (cam, "chassis"), (cam, "lidar_top")):
            np.testing.assert_array_equal(a.extrinsic(frm, to),
                                          b.extrinsic(frm, to))
        ia, ib = a.intrinsics(cam), b.intrinsics(cam)
        assert ia.keys() == ib.keys()
        for k in ia:
            np.testing.assert_array_equal(ia[k], ib[k])
        np.testing.assert_array_equal(a.sensor_timestamps(cam),
                                      b.sensor_timestamps(cam))
    np.testing.assert_array_equal(a.odometry("wigo.txt"), b.odometry("wigo.txt"))


def test_scene_defaults_and_cache_key_match(clip_pair):
    assert tscene.DEFAULT_CAMA_CONFIGS == jscene.DEFAULT_CAMA_CONFIGS
    assert tscene.OUTPUT_SIZE == jscene.OUTPUT_SIZE
    cfg = {**jscene.DEFAULT_CAMA_CONFIGS, "map_size_m": 300.0}
    for sources in (("cama", "nuscenes"), ("nuscenes",)):
        assert (tscene._scene_cache_key(cfg, sources, (540, 960), 1024,
                                        clip_path=clip_pair[0])
                == jscene._scene_cache_key(cfg, sources, (540, 960), 1024,
                                           clip_path=clip_pair[0]))


_BASE = {"converted_dataroot": "c", "scene_names": ["a", "b"],
         "output_video_dir": "v"}


@pytest.mark.parametrize("cfg", [
    _BASE,
    {**_BASE, "cama_configs": {"map_size_m": 300.0, "frame_cache": False}},
    {**_BASE, "sites": [["a", "b"]], "video_preset": "fast"},
    {**_BASE, "sites": [{"name": "x", "scenes": ["a"], "refine": True}]},
    {**_BASE, "cama_configs": {"nope": 1}},
    {**_BASE, "sites": [["zzz"]]},
    {**_BASE, "scene_names": []},
    {"scene_names": ["a"]},
    {**_BASE, "batch_scenes": "yes"},
    [1, 2],
])
def test_config_schema_matches(cfg):
    try:
        want = jconfig.validate_config(cfg)
    except jconfig.ConfigError as e:
        with pytest.raises(tconfig.ConfigError) as got:
            tconfig.validate_config(cfg)
        assert str(got.value) == str(e)
    else:
        assert tconfig.validate_config(cfg) == want


def test_config_device_key(tmp_path):
    import yaml

    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(
        {**_BASE, "cama_configs": {"device": "cpu", "map_size_m": 300.0}}))
    configs, device = tconfig.load_config(str(path))
    assert device == "cpu" and "device" not in configs["cama_configs"]
    assert configs["cama_configs"]["map_size_m"] == 300.0
    with pytest.raises(tconfig.ConfigError, match="not found"):
        tconfig.load_config(str(tmp_path / "missing.yaml"))


def _timers_record(mod, monkeypatch):
    """Drive one package's PhaseTimers on a fake clock; what it
    accumulates."""
    ticks = iter([10.0, 10.25, 11.0, 11.5, 12.0, 12.125, 13.0, 13.0625])
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
    t = mod.PhaseTimers()
    for name in ("device_dispatch", "host_composite", "device_dispatch"):
        with t.phase(name):
            pass
    with pytest.raises(KeyError):
        with t.phase("failed"):
            raise KeyError("x")
    return dict(t.total), dict(t.count)


def test_phase_timers_match(monkeypatch):
    a = _timers_record(tprofiling, monkeypatch)
    assert a == _timers_record(jprofiling, monkeypatch)
    assert a == ({"device_dispatch": 0.375, "host_composite": 0.5,
                  "failed": 0.0625},
                 {"device_dispatch": 2, "host_composite": 1, "failed": 1})


@pytest.mark.parametrize("name", [
    "SOLUTION", "MAP_WIDTH", "MAP_HEIGHT", "CENTER_X", "CENTER_Y", "CROP_BOX",
    "COLOR_MAPS", "DEFAULT_CLASS_NAMES", "_SCALAR_DIV_PROMOTES_F64"])
def test_lift_constants_match(name):
    a, b = getattr(tlift, name), getattr(jlift, name)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("source", ["cama", "nuscenes"])
def test_lift_instances_bit_identical(clip_pair, source):
    """Both packages lift the fixture's labels to the same polylines, and
    flatten them to the same FlatPoints."""
    reader = tclip.ClipReader(clip_pair[0])
    cfg = jscene.DEFAULT_CAMA_CONFIGS
    if source == "cama":
        labels = reader.map_json(cfg["result_dir"], cfg["cama_map_file"])
        grid = reader.height_grid(cfg["result_dir"], cfg["height_mlp"])
        a = tlift.lift_cama_instances(labels, grid, map_width=300.0,
                                      map_height=300.0)
        b = jlift.lift_cama_instances(labels, grid, map_width=300.0,
                                      map_height=300.0)
    else:
        labels = reader.map_json(cfg["result_dir"], cfg["nuscenes_map_file"])
        a = tlift.lift_nuscenes_instances(labels)
        b = jlift.lift_nuscenes_instances(labels)
    assert len(a) == len(b) > 0
    for (ca, pa), (cb, pb) in zip(a, b):
        assert ca == cb and pa.dtype == pb.dtype
        np.testing.assert_array_equal(pa, pb)
    fa = tscene.flatten_instances(a, pad_multiple=256)
    fb = jlift.flatten_instances(b, pad_multiple=256)
    assert isinstance(fa, tlift.FlatPoints) and fa.num_valid == fb.num_valid
    assert fa.class_names == fb.class_names
    for field in ("points", "cls", "inst", "valid"):
        np.testing.assert_array_equal(getattr(fa, field), getattr(fb, field))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("with_base", [True, False])
def test_native_composite_byte_identical(packed, with_base):
    """The port's compositor, built from its own copy of compositor.cpp
    into build/cama_tpu_torch/, writes the same bytes as cama_tpu.native,
    into a mosaic slot view, from class rasters or 2-bit packed ones."""
    assert tnative.available() and jnative.available()
    assert os.path.dirname(tnative.library_path()) == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
        "cama_tpu_torch")
    rng = np.random.default_rng(11)
    h, w = 37, 53  # odd sizes: the 8-pixel skip loop's and the packing's tails
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    raster = np.where(rng.random((h, w)) < 0.3,
                      rng.integers(1, 4, (h, w)), 0).astype(np.uint8)
    table = rng.integers(0, 256, (3, 3), dtype=np.uint8)
    outs = []
    for mod in (tnative, jnative):
        mosaic = np.zeros((2 * h, 3 * w, 3), np.uint8)
        slot = mosaic[h:, w:2 * w]
        if not with_base:
            slot[:] = base
        src = base if with_base else None
        if packed:
            p4 = np.pad(raster, ((0, 0), (0, -w % 4))).reshape(h, -1, 4)
            packed2 = (p4[..., 0] | p4[..., 1] << 2 | p4[..., 2] << 4
                       | p4[..., 3] << 6).astype(np.uint8)
            mod.composite_packed2(src, packed2, table, slot, w)
        else:
            mod.composite(src, raster, table, slot)
        outs.append(mosaic)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[0][h:, w:2 * w] != base).any()


def test_frame_cache_key_and_shared_store(tmp_path):
    """Same key, and one on-disk store: what one package writes, the other
    reads back."""
    key = (["camera_front", "camera_rear"], (4, 8), np.eye(3)[None].repeat(2, 0),
           np.zeros((2, 8)), 2 * np.eye(3)[None].repeat(2, 0),
           {"camera_front": [1, 2, 3], "camera_rear": [1, 2, 4]})
    k = tframe_cache.frame_cache_key(*key)
    assert k == jframe_cache.frame_cache_key(*key)
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 4, 8, 3), dtype=np.uint8)
    writer = tframe_cache.FrameCache(tmp_path, 3, 2, (4, 8), k,
                                     async_writes=False)
    writer.put(1, 0, imgs[0])
    writer.put(2, 1, imgs[1])
    writer.flush()
    reader = jframe_cache.FrameCache(tmp_path, 3, 2, (4, 8), k,
                                     async_writes=False)
    np.testing.assert_array_equal(reader.get(1, 0), imgs[0])
    np.testing.assert_array_equal(reader.get(2, 1), imgs[1])
    assert reader.get(0, 0) is None and reader.hit_rate() == 2 / 6
    reader.put(0, 1, imgs[1])
    reader.flush()
    again = tframe_cache.FrameCache(tmp_path, 3, 2, (4, 8), k,
                                    async_writes=False)
    np.testing.assert_array_equal(again.get(0, 1), imgs[1])
    # another key invalidates the store for both
    assert tframe_cache.FrameCache(tmp_path, 3, 2, (4, 8), "other",
                                   async_writes=False).get(1, 0) is None


def test_concat_camera_grid_matches():
    assert tvideo.CAMERA_GRID == jvideo.CAMERA_GRID
    imgs = {cam: np.full((2, 3, 3), i, np.uint8)
            for i, cam in enumerate(jscene.DEFAULT_CAMA_CONFIGS["camera_list"])}
    np.testing.assert_array_equal(tvideo.concat_camera_grid(imgs),
                                  jvideo.concat_camera_grid(imgs))
    out = np.empty((4, 9, 3), np.uint8)
    assert tvideo.concat_camera_grid(imgs, out=out) is out


def test_frame_cache_survives_short_pwrites(tmp_path, monkeypatch):
    """os.pwrite may land fewer bytes than it was given; the store writes on
    until the whole slot is on disk, and only then marks it valid."""
    real = os.pwrite
    calls = []

    def short(fd, buf, offset):
        view = memoryview(buf)
        calls.append(len(view))
        return real(fd, view[:max(1, len(view) // 3)], offset)

    monkeypatch.setattr(tframe_cache.os, "pwrite", short)
    cache = tframe_cache.FrameCache(tmp_path, 2, 2, (5, 7), "k",
                                    async_writes=False, name="gt_ids",
                                    dtype=np.uint16, channels=0)
    img = np.arange(35, dtype=np.uint16).reshape(5, 7) * 1000
    cache.put(1, 1, img)
    assert len(calls) > 2 and cache.writable
    monkeypatch.undo()
    reader = tframe_cache.FrameCache(tmp_path, 2, 2, (5, 7), "k",
                                     async_writes=False, name="gt_ids",
                                     dtype=np.uint16, channels=0)
    np.testing.assert_array_equal(reader.get(1, 1), img)
    assert reader.get(0, 0) is None


def test_frame_cache_closes_each_fd_once(tmp_path, monkeypatch):
    """A reopen closes the write descriptors; the finalizer must not close
    the same numbers again, which by then may name another open file."""
    import gc

    closed = []
    real = os.close

    def close(fd):
        closed.append(fd)
        real(fd)

    cache = tframe_cache.FrameCache(tmp_path, 2, 1, (4, 8), "k",
                                    async_writes=False)
    cache.put(0, 0, np.ones((4, 8, 3), np.uint8))
    fds = [cache._data_fd, cache._valid_fd]
    assert all(fd is not None for fd in fds)
    monkeypatch.setattr(tframe_cache.os, "close", close)
    cache._open()
    assert sorted(closed) == sorted(fds)
    cache.put(1, 0, np.ones((4, 8, 3), np.uint8))
    fds2 = [cache._data_fd, cache._valid_fd]
    del cache
    gc.collect()
    assert sorted(closed) == sorted(fds + fds2)


def test_build_dir_falls_back_to_user_cache(tmp_path, monkeypatch):
    """Where build/ beside the package cannot be created (an installed,
    read-only copy), the kernels' library and the compositor go to the
    per-user cache directory, and the compositor builds there; with no
    writable directory at all the kernels' build raises."""
    from cama_tpu_torch import _build

    blocker = tmp_path / "file"
    blocker.write_text("")  # a file where a directory would go
    monkeypatch.setattr(_build, "BUILD_DIR", str(blocker / "build"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    want = str(tmp_path / "cache" / "cama_tpu_torch")
    assert _build.build_dir() == want
    assert os.path.dirname(_build.library_path()) == want
    assert os.path.dirname(tnative.library_path()) == want
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    assert tnative.available() and os.path.exists(tnative.library_path())
    monkeypatch.setenv("XDG_CACHE_HOME", str(blocker / "cache"))
    with pytest.raises(RuntimeError, match="no writable build directory"):
        _build.library_path()


def test_build_color_table_takes_color_maps():
    from cama_tpu.ops import raster as jraster
    from cama_tpu_torch.ops import raster as traster

    names = ["lane_marking", "Road_teeth", "Crosswalk_Line", "Stop_Line"]
    custom = {"lane_marking": np.array([1, 2, 3]),
              "Crosswalk_Line": np.array([250, 5, 6])}
    np.testing.assert_array_equal(traster.build_color_table(names, custom),
                                  jraster.build_color_table(names, custom))
    np.testing.assert_array_equal(traster.build_color_table(names, custom)[0],
                                  [3, 2, 1])
    np.testing.assert_array_equal(traster.build_color_table(names),
                                  jraster.build_color_table(names))
