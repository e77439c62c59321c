"""cama_tpu_torch's LiDAR aggregation, fixture clips and instance-map
writers against the JAX package on CPU: the fixture writes the same files
byte for byte; the transform agrees with JAX's jitted one within 1e-6
relative; aggregate_lidar on both backends keeps the same points within
1e-4 m; voxel_downsample and the PCD / xyz writers give the same text;
unflatten_to_instances inverts the port's flatten_instances."""
import filecmp
import os

import numpy as np
import pytest
import torch

from cama_tpu.aggregate import lidar as jlidar
from cama_tpu.io import fixture as jfixture
from cama_tpu.io import scene as jscene
from cama_tpu.ops import lift as jlift
from cama_tpu_torch.aggregate import lidar as tlidar
from cama_tpu_torch.io import fixture as tfixture
from cama_tpu_torch.io import scene as tscene
from cama_tpu_torch.ops import lift as tlift

SITE_CLIP_ARGS = dict(n_frames=6, with_images=False, flat_height=True,
                      traj_t_offset=0.7, t0_ms=1600000100000,
                      world_sim3={"yaw_deg": 8.0, "tx": 15.0, "ty": -7.0},
                      with_aux_sensors=True, drop_scmv_rows=(2,), seed=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("args", [{}, SITE_CLIP_ARGS], ids=["default", "site"])
def test_fixture_clip_same_bytes(tmp_path, args):
    """The default arguments (12 frames, JPEGs and LiDAR) and the site-clip
    arguments (misaligned SfM frame, auxiliary sensors, a dropped pose)."""
    a = tfixture.make_fixture_clip(tmp_path / "t", **args)
    b = jfixture.make_fixture_clip(tmp_path / "j", **args)
    fa, fb = _files(a), _files(b)
    assert fa == fb and "lidar_top" in {f.split(os.sep)[0] for f in fa}
    for rel in fa:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return tfixture.make_fixture_clip(tmp_path_factory.mktemp("tagg"),
                                      n_frames=8, with_images=False)


def test_transform_points_matches_jax():
    rng = np.random.default_rng(0)
    F, N = 5, 3001
    T = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    ang = rng.uniform(-np.pi, np.pi, F)
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = (
        np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang))
    T[:, :3, 3] = rng.normal(scale=30.0, size=(F, 3))
    pts = rng.normal(scale=40.0, size=(F, N, 3)).astype(np.float32)
    valid = rng.random((F, N)) < 0.8
    ref = np.asarray(jlidar._transform_points(T, pts, valid))
    got = tlidar._transform_points(torch.from_numpy(T), torch.from_numpy(pts),
                                   torch.from_numpy(valid)).numpy()
    host = tlidar._transform_points_host(T, pts, valid)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * 40)
    np.testing.assert_array_equal(host, jlidar._transform_points_host(T, pts, valid))


@pytest.mark.parametrize("kw", [
    dict(pose_source="cama", every=1),
    dict(pose_source="wigo", every=2, with_intensity=True),
    dict(pose_source="wigo_offset", every=3, max_frames=4),
])
def test_aggregate_lidar_matches_jax(clip, kw):
    """Both backends of the port against the JAX package's host lane: the
    same point count (the validity mask is exact), coordinates within
    1e-4 m; the host backends give the same bits."""
    ref = jlidar.aggregate_lidar(clip, backend="host", **kw)
    host = tlidar.aggregate_lidar(clip, backend="host", **kw)
    dev = tlidar.aggregate_lidar(clip, device="cpu", **kw)
    np.testing.assert_array_equal(host, ref)
    assert dev.shape == ref.shape and len(ref) > 4000
    np.testing.assert_allclose(dev, ref, rtol=0, atol=1e-4)


def test_aggregate_lidar_voxel_and_options(clip):
    """Voxel keys floor the coordinates, and the fixture's ground sits on a
    voxel boundary (z = 0), so the voxel test runs on the host backends,
    which give the same bits."""
    ref = jlidar.aggregate_lidar(clip, every=2, voxel=0.5, backend="host")
    got = tlidar.aggregate_lidar(clip, every=2, voxel=0.5, backend="host")
    assert len(got) > 0
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tlidar.aggregate_lidar(clip, backend="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tlidar.aggregate_lidar(clip)  # the default device is the card


def test_voxel_downsample_and_writers_same_text(clip, tmp_path):
    offset = np.array([3.6e5, 4.69e6, 12.0])
    pts = offset + np.random.default_rng(1).uniform(0, 3, (500, 3))
    np.testing.assert_array_equal(tlidar.voxel_downsample(pts, 0.2),
                                  jlidar.voxel_downsample(pts, 0.2))
    cloud = tlidar.aggregate_lidar(clip, every=4, voxel=1.0, backend="host")
    colors = np.random.default_rng(2).integers(0, 256, (len(cloud), 3))
    for name, points, cols in (("f64", cloud, None), ("rgb", cloud, colors),
                               ("f32", cloud.astype(np.float32), None)):
        a = tlidar.save_pcd(str(tmp_path / f"t_{name}.pcd"), points, cols)
        b = jlidar.save_pcd(str(tmp_path / f"j_{name}.pcd"), points, cols)
        assert filecmp.cmp(a, b, shallow=False), name
    a = tlidar.save_xyz(str(tmp_path / "t.xyz"), cloud)
    b = jlidar.save_xyz(str(tmp_path / "j.xyz"), cloud)
    assert filecmp.cmp(a, b, shallow=False)


def test_lidar_main_same_file_as_jax(clip, tmp_path, capsys):
    """cama-tpu-torch-lidar with --backend host writes the JAX script's
    file; with --device cpu, the same point count."""
    args = ["--clip", clip, "--every", "2"]
    tlidar.main(args + ["--out", str(tmp_path / "t.pcd"), "--backend", "host"])
    jlidar.main(args + ["--out", str(tmp_path / "j.pcd"), "--backend", "host"])
    assert filecmp.cmp(tmp_path / "t.pcd", tmp_path / "j.pcd", shallow=False)
    tlidar.main(args + ["--out", str(tmp_path / "d.xyz"), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[0] == out[1].split()[0] == out[2].split()[0]


def test_unflatten_round_trip_and_instance_writers(clip, tmp_path):
    scene = tscene.compile_scene(clip, sources=("cama", "nuscenes"))
    for src in ("cama", "nuscenes"):
        flat = scene.flat[src]
        inst = tlift.unflatten_to_instances(flat)
        assert len(inst) == len(np.unique(flat.inst[flat.valid]))
        again = tscene.flatten_instances(
            [(i["class"], i["points"]) for i in inst],
            class_names=flat.class_names, pad_multiple=len(flat.points))
        for field in ("points", "cls", "inst", "valid"):
            np.testing.assert_array_equal(getattr(again, field),
                                          getattr(flat, field))
        ref = jlift.unflatten_to_instances(flat)
        assert [i["class"] for i in inst] == [i["class"] for i in ref]
        for a, b in zip(inst, ref):
            np.testing.assert_array_equal(a["points"], b["points"])
    flat = scene.flat["cama"]
    keep = np.random.default_rng(3).random(len(flat.points)) < 0.7
    moved = flat.points + np.float32(2.5)
    for kw in ({}, {"keep_mask": keep, "points_override": moved}):
        pairs = ((tlift.save_instances_pcd, jlift.save_instances_pcd, "pcd"),
                 (tlift.save_instances_xyz, jlift.save_instances_xyz, "xyz"))
        for tf, jf, ext in pairs:
            a = tf(flat, str(tmp_path / f"t.{ext}"), **kw)
            b = jf(flat, str(tmp_path / f"j.{ext}"), **kw)
            assert filecmp.cmp(a, b, shallow=False), (ext, kw.keys())
    empty = jscene.compile_scene(clip, sources=("cama",)).flat["cama"]
    none = np.zeros(len(empty.points), bool)
    assert tlift.unflatten_to_instances(empty, keep_mask=none) == []
    path = tlift.save_instances_pcd(empty, str(tmp_path / "e.pcd"), keep_mask=none)
    assert "POINTS 0" in open(path).read()
