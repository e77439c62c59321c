"""cama_tpu_torch's jax-free copies of cama_tpu host code give the same bits:
SE(3) algebra and pose seek, clip reader, fixture clip, config schema,
scene-cache key, and the reused frame-cache / video modules."""
import filecmp
import os

import numpy as np
import pytest

from cama_tpu import config as jconfig
from cama_tpu.io import clip as jclip
from cama_tpu.io import fixture as jfixture
from cama_tpu.io import frame_cache as jframe_cache
from cama_tpu.io import scene as jscene
from cama_tpu.io import video as jvideo
from cama_tpu.se3 import codec as jcodec
from cama_tpu.se3 import core as jcore
from cama_tpu.se3 import trajectory as jtraj
from cama_tpu_torch import config as tconfig
from cama_tpu_torch import se3 as tse3
from cama_tpu_torch.io import clip as tclip
from cama_tpu_torch.io import fixture as tfixture
from cama_tpu_torch.io import frame_cache as tframe_cache
from cama_tpu_torch.io import scene as tscene
from cama_tpu_torch.io import video as tvideo


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


def test_reused_host_modules_are_cama_tpus():
    """The frame cache and video sink are cama_tpu's files, loaded without
    running cama_tpu/io/__init__.py."""
    assert tframe_cache._frame_cache.__file__ == jframe_cache.__file__
    assert tvideo._video.__file__ == jvideo.__file__
    assert tvideo.CAMERA_GRID == jvideo.CAMERA_GRID
    key = (["camera_front"], (4, 8), np.eye(3)[None], np.zeros((1, 8)),
           np.eye(3)[None], {"camera_front": [1, 2]})
    assert tframe_cache.frame_cache_key(*key) == jframe_cache.frame_cache_key(*key)
    imgs = {cam: np.full((2, 3, 3), i, np.uint8)
            for i, cam in enumerate(jscene.DEFAULT_CAMA_CONFIGS["camera_list"])}
    np.testing.assert_array_equal(tvideo.concat_camera_grid(imgs),
                                  jvideo.concat_camera_grid(imgs))
