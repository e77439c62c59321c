"""The port's nuScenes -> clip converter (cama_tpu_torch/convert: geom,
vecmap, nuscenes) against the JAX package's, tolerance 0: every geom
function on seeded polygons, the vector map extraction on the fake map
source, the whole conversion of the fake devkit DB of tests/test_convert.py
(the clip's files byte for byte), and the port's CLI on CPU converting an
unconverted scene and writing its nuScenes video."""
import filecmp
import os

import numpy as np
import pytest

from test_convert import FakeDB, FakeMapSource

from cama_tpu.convert import geom as jgeom
from cama_tpu.convert import nuscenes as jnuscenes
from cama_tpu.convert import vecmap as jvecmap
from cama_tpu_torch import cli as tcli
from cama_tpu_torch.convert import geom as tgeom
from cama_tpu_torch.convert import nuscenes as tnuscenes
from cama_tpu_torch.convert import vecmap as tvecmap


def _same(a, b):
    """Exact equality through nested lists / tuples / arrays / scalars."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None or isinstance(a, (bool, str)):
        assert a == b and type(a) is type(b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _rect(rng, lo=0.0, hi=6.0):
    x0, y0 = rng.uniform(lo, hi - 2.0, 2)
    w, h = rng.uniform(0.8, 2.5, 2)
    ang = rng.uniform(0, np.pi)
    c, s = np.cos(ang), np.sin(ang)
    ring = np.array([[0, 0], [w, 0], [w, h], [0, h]], float)
    return ring @ np.array([[c, -s], [s, c]]).T + [x0, y0]


def _polys(rng, n=5):
    out = []
    for i in range(n):
        ring = _rect(rng)
        holes = []
        if i % 2 == 0:
            centre = ring.mean(axis=0)
            holes.append(((ring - centre) * 0.3 + centre)[::-1])
        out.append((ring, holes))
    return out


def _geom_cases(rng):
    line = np.cumsum(rng.normal(scale=1.5, size=(40, 2)), axis=0)
    ring = _rect(rng)
    closed = np.concatenate([ring, ring[:1], ring[:1]])
    pts = rng.uniform(-1, 7, size=(200, 2))
    polys = _polys(rng)
    tiles = [(np.array([[i, 0], [i + 1, 0], [i + 1, 1], [i, 1]], float), [])
             for i in range(3)]
    segs = [line[i:i + 4] for i in range(0, 36, 3)]
    segs = [s[::-1] if i % 2 else s for i, s in enumerate(segs)]
    return {
        "rotate_points": (pts, 33.5, (1.5, -2.0)),
        "translate_points": (pts, 0.25, -7.5),
        "signed_area": (ring,),
        "is_ccw": (ring[::-1],),
        "clip_polyline_to_box": (line, -2.0, -2.0, 3.0, 2.5),
        "clip_polygon_to_box": (ring, 1.0, 1.0, 4.0, 4.5),
        "_dedupe_ring": (closed,),
        "_points_in_ring": (pts, ring),
        "_covered": (pts, polys),
        "union_polygons": (polys,),
        "_interior_probe": (ring,),
        "union_tiling_polygons": (tiles,),
        "_point_in_ring": (pts[3], ring),
        "linemerge": (segs,),
    }


@pytest.mark.parametrize("name", [
    "rotate_points", "translate_points", "signed_area", "is_ccw",
    "clip_polyline_to_box", "clip_polygon_to_box", "_dedupe_ring",
    "_points_in_ring", "_covered", "union_polygons", "_interior_probe",
    "union_tiling_polygons", "_point_in_ring", "linemerge"])
@pytest.mark.parametrize("seed", [3, 17])
def test_geom_functions_identical(name, seed):
    args = _geom_cases(np.random.default_rng(seed))[name]
    _same(getattr(tgeom, name)(*args), getattr(jgeom, name)(*args))
    assert tgeom.HAVE_SHAPELY == jgeom.HAVE_SHAPELY


@pytest.mark.parametrize("yaw", [-2.5, 0.0, 0.3, 3.0])
def test_vecmap_extraction_identical(yaw):
    from scipy.spatial.transform import Rotation as R

    q = R.from_euler("z", yaw).as_quat()
    wxyz = [q[3], q[0], q[1], q[2]]
    assert tvecmap.quaternion_yaw(wxyz) == jvecmap.quaternion_yaw(wxyz)
    args = ("nowhere", [100.0, 50.0, 0.0], wxyz, (60.0, 100.0), (100.0, 50.0))
    got = tvecmap.VectorizedLocalMap(
        FakeMapSource(), patch_size=(60.0, 100.0)).gen_vectorized_samples(*args)
    want = jvecmap.VectorizedLocalMap(
        FakeMapSource(), patch_size=(60.0, 100.0)).gen_vectorized_samples(*args)
    assert got.keys() == want.keys() and len(got["gt_vecs_label"]) >= 3
    for k in got:
        _same(got[k], want[k])


def _configs(root, out):
    return {"version": "v1.0-test", "dataroot": str(root / "raw"),
            "converted_dataroot": str(root / out),
            "map_classes": ["lane_marking", "Road_teeth", "Crosswalk_Line"],
            "cama_configs": {"result_dir": "maps"}}


def _files(clip):
    out = []
    for d, _, names in os.walk(clip):
        out += [os.path.relpath(os.path.join(d, n), clip) for n in names]
    return sorted(out)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(root, the JAX converter's clip, the port's clip) of one fake DB."""
    root = tmp_path_factory.mktemp("tconv")
    db = FakeDB(root / "raw")
    jclip = jnuscenes.NuScenesConverter(_configs(root, "jax"),
                                        db=db).convert("scene-fake1")
    tclip = tnuscenes.NuScenesConverter(_configs(root, "torch"),
                                        db=db).convert("scene-fake1")
    return root, jclip, tclip


def test_converter_constants_identical():
    assert tnuscenes.CLIP_SENSOR_NAMES == jnuscenes.CLIP_SENSOR_NAMES
    assert tnuscenes.SCENE_SENSOR_NAMES == jnuscenes.SCENE_SENSOR_NAMES
    assert tvecmap.CLASS2LABEL == jvecmap.CLASS2LABEL


@pytest.mark.parametrize("rel", [
    "attribute.json", "maps/map_nuscenes.json", "odometry/wigo.txt",
    "odometry/wigo_offset_clip.txt"])
def test_converted_clip_files_byte_identical(converted, rel):
    _, jclip, tclip = converted
    assert os.path.getsize(os.path.join(tclip, rel)) > 0
    assert filecmp.cmp(os.path.join(jclip, rel), os.path.join(tclip, rel),
                       shallow=False)


def test_converted_clip_trees_byte_identical(converted):
    _, jclip, tclip = converted
    names = _files(tclip)
    assert names == _files(jclip) and len(names) > 100
    _, mismatch, errors = filecmp.cmpfiles(jclip, tclip, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    assert any(n.startswith("lidar_top/") for n in names)
    assert any(n.startswith("camera_rear_left/") for n in names)


def test_cli_converts_an_unconverted_scene_and_writes_its_video(
        converted, tmp_path, monkeypatch, capsys):
    import yaml

    root, jclip, _ = converted
    built = []

    def fake_db(version, dataroot):
        built.append((version, dataroot))
        return FakeDB(dataroot)

    monkeypatch.setattr(tnuscenes, "NuScenesDB", fake_db)
    cfg = {**_configs(root, "cli"), "scene_names": ["scene-fake1"],
           "output_video_dir": str(tmp_path / "videos")}
    cfg_path = tmp_path / "config.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    assert tcli.main(["--config", str(cfg_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "no cama labels; skipping video" in out
    assert built == [("v1.0-test", str(root / "raw"))]
    clip = os.path.join(root, "cli", "scene-fake1")
    names = [n for n in _files(clip) if not n.startswith(".cama_tpu")]
    assert names == _files(jclip)
    assert not filecmp.cmpfiles(jclip, clip, names, shallow=False)[1]
    video = tmp_path / "videos" / "scene-fake1_nuScenes.mp4"
    assert os.listdir(tmp_path / "videos") == [video.name]
    assert video.stat().st_size > 1000
    # converted now: a second run builds no converter
    assert tcli.main(["--config", str(cfg_path), "--device", "cpu"]) == 0
    assert len(built) == 1
