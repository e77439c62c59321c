"""cama_tpu_torch's pipeline against cama_tpu's on the same fixture clip
(CPU): overlay rasters of the fused lane, the float64 host lane, the frame
matrices, the jax-free scene compiler, and the CLI writing both videos."""
import os

import numpy as np
import pytest
import torch
import yaml

from cama_tpu import pipeline as jpipe
from cama_tpu.io import scene as jscene
from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu.ops import geometry as jgeo
from cama_tpu.ops import lift
from cama_tpu_torch import pipeline as tpipe
from cama_tpu_torch.io import scene as tscene
from cama_tpu_torch.ops import geometry as tgeo
from cama_tpu_torch.ops.fused_compact import LAUNCHES


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test suite runs several worker processes at once; one intra-op
    torch thread in this one keeps torch's CPU ops from oversubscribing the
    cores (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_fixture_clip(tmp_path_factory.mktemp("tpipe"), n_frames=4,
                             with_images=False, with_lidar=False)


@pytest.fixture(scope="module")
def port(clip):
    return tpipe.ClipPipeline(clip_path=clip, chunk=2, device="cpu")


@pytest.mark.parametrize("source", ["cama", "nuscenes"])
def test_overlay_rasters_match_jax_fused_lane(clip, port, source):
    """Per-frame raster agreement with cama_tpu's raster_kernel='fused'
    pipeline (its Pallas kernel in interpret mode) is >= 0.99999, the
    device-lane contract; the residual class is the f32 dot-vs-elementwise
    border flip (tests/test_torch_fused_compact.py)."""
    ref_pipe = jpipe.ClipPipeline(clip_path=clip, chunk=2,
                                  raster_kernel="fused")
    ref = dict(ref_pipe.iter_overlay_rasters(source))
    got = dict(port.iter_overlay_rasters(source))
    assert set(got) == set(ref) and len(got) >= 2
    for idx in ref:
        assert got[idx].shape == ref[idx].shape and got[idx].dtype == np.uint8
        assert got[idx].any(), "frame painted nothing — test is vacuous"
        agree = (got[idx] == ref[idx]).mean()
        assert agree >= 0.99999, f"{source} frame {idx}: agreement {agree}"


def test_overlay_rasters_match_host_lane_and_stay_packed(port):
    """The device lane against the port's float64 host lane at the
    contract; unpack=False hands the 2-bit format through unchanged."""
    host = dict(port.iter_overlay_rasters_host("cama"))
    got = dict(port.iter_overlay_rasters("cama"))
    assert set(got) == set(host)
    for idx in host:
        assert (got[idx] == host[idx]).mean() >= 0.99999
    packed = dict(port.iter_overlay_rasters("cama", unpack=False))
    w = port.scene.output_size[1]
    for idx in host:
        assert packed[idx].shape[-1] == -(-w // 4)
        np.testing.assert_array_equal(
            tpipe.unpack_cls_2bit(packed[idx], w), got[idx])


def test_host_overlay_chunk_bit_identical(port):
    fm, A, B, fv, F = port._chunked_AB("cama")
    fp = port.scene.flat["cama"]
    h, w = port.scene.output_size
    lo, hi = tgeo.crop_bounds()
    args = (fp.points, fp.valid, fp.cls, A[:2], B[:2], fv[:2], lo, hi, w, h)
    got = tpipe._host_overlay_chunk(*args)
    assert got.any()
    np.testing.assert_array_equal(got, jpipe._host_overlay_chunk(*args))


def test_frame_matrices_and_padding_bit_identical(port):
    scene = port.scene
    for source in ("cama", "nuscenes"):
        a = tgeo.compose_frame_matrices(scene.traj[source], scene.frame_times,
                                        scene.chassis2cam, scene.K_scaled)
        b = jgeo.compose_frame_matrices(scene.traj[source], scene.frame_times,
                                        scene.chassis2cam, scene.K_scaled)
        for name in ("A", "B", "frame_valid", "frame_indices",
                     "chassis2world_f32"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for x, y in zip(tgeo.crop_bounds(), jgeo.crop_bounds()):
        np.testing.assert_array_equal(x, y)
    jp = jpipe.ClipPipeline(scene=scene, chunk=3, raster_kernel="fused")
    tp = tpipe.ClipPipeline(scene=scene, chunk=3, device="cpu")
    for x, y in zip(tp._chunked_AB("cama"), jp._chunked_AB("cama")):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)


def test_scene_compiler_matches_and_shares_cache(tmp_path):
    """The jax-free compiler gives cama_tpu's scene, and each package reads
    the scene cache the other wrote."""
    clip = make_fixture_clip(tmp_path, n_frames=3, with_images=False,
                             with_lidar=False)
    cache = os.path.join(str(tmp_path), "scene_cache.npz")
    a = tscene.compile_scene(clip, cache=cache)
    b = jscene.compile_scene(clip)
    assert not a.from_cache and jscene.compile_scene(clip, cache=cache).from_cache
    for src in ("cama", "nuscenes"):
        for name in ("points", "cls", "inst", "valid"):
            np.testing.assert_array_equal(getattr(a.flat[src], name),
                                          getattr(b.flat[src], name))
        assert a.flat[src].class_names == b.flat[src].class_names
        np.testing.assert_array_equal(a.traj[src].as_transform(True),
                                      b.traj[src].as_transform(True))
    for name in ("K_orig", "K_scaled", "d", "chassis2cam", "frame_times"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert tscene.compile_scene(clip, cache=cache).from_cache


def test_flatten_instances_matches_lift():
    rng = np.random.default_rng(0)
    inst = [(name, rng.normal(size=(n, 3)))
            for name, n in (("lane_marking", 5), ("Road_teeth", 3),
                            ("new_cls", 4))]
    a = tscene.flatten_instances(inst, pad_multiple=16)
    b = lift.flatten_instances(inst, pad_multiple=16)
    for name in ("points", "cls", "inst", "valid"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.class_names == b.class_names
    many = [(f"c{i}", np.zeros((1, 3))) for i in range(9)]
    with pytest.raises(ValueError, match="map classes"):
        tscene.flatten_instances(many)


def test_scene_tensors_are_the_device_points(port):
    st = port.scene_tensors("cama")
    fp = port.scene.flat["cama"]
    assert st.points.dtype == torch.float32 and st.cls.dtype == torch.int32
    assert st.valid.dtype == torch.bool and st.frame_valid.dtype == torch.bool
    np.testing.assert_array_equal(st.points.numpy(), fp.points)
    np.testing.assert_array_equal(st.cls.numpy(), fp.cls)
    _, A, B, fv, _ = port._chunked_AB("cama")
    np.testing.assert_array_equal(st.A.numpy(), A)
    np.testing.assert_array_equal(st.B.numpy(), B)
    np.testing.assert_array_equal(st.frame_valid.numpy(), fv)


def test_k_cap_from_own_count_and_overflow_raises(clip):
    pipe = tpipe.ClipPipeline(clip_path=clip, chunk=2, device="cpu")
    mode, k = pipe.overlay_mode("cama")
    P = pipe.scene.flat["cama"].points.shape[0]
    # the JAX package's decision: a sparse scene, and the fused lane's dense
    # list sized by the union count
    assert mode == "sparse" and 1024 <= k <= P and (k & (k - 1)) == 0
    assert pipe._k["cama"] == pipe._fused_k["cama"] >= k
    pipe._k["cama"] = 64  # a list far too small for the scene
    with pytest.raises(RuntimeError, match="over the fused list size"):
        list(pipe.iter_overlay_rasters("cama"))
    assert LAUNCHES == {"fused_compact_project": 0, "count_union": 0}


def test_cuda_device_without_card_raises(clip):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.ClipPipeline(clip_path=clip, chunk=2)
    with pytest.raises(ValueError, match="raster_kernel"):
        tpipe.ClipPipeline(clip_path=clip, raster_kernel="two_stage",
                           device="cpu")


@pytest.mark.parametrize("ctor, config, lane", [
    (None, None, "fused"),          # library default
    (None, "pallas", "pallas"),     # config key
    ("scatter", "pallas", "scatter"),  # constructor beats the config key
    ("compact", None, "compact"),
    ("auto", None, "fused"),        # 'auto' serves the fused lane
    (None, "auto", "fused"),
])
def test_raster_kernel_precedence(port, ctor, config, lane):
    pipe = tpipe.ClipPipeline({"raster_kernel": config}, scene=port.scene,
                              raster_kernel=ctor, device="cpu")
    assert pipe.raster_kernel == lane


def test_cli_writes_both_videos(tmp_path, capsys):
    from cama_tpu_torch.cli import main

    make_fixture_clip(tmp_path / "converted", scene_name="scene-t",
                      n_frames=3, with_lidar=False)
    cfg = {"converted_dataroot": str(tmp_path / "converted"),
           "scene_names": ["scene-t"],
           "output_video_dir": str(tmp_path / "videos"),
           "cama_configs": {"device": "cuda"}}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out
    for name in ("scene-t_cama.mp4", "scene-t_nuScenes.mp4"):
        f = tmp_path / "videos" / name
        assert f.exists() and f.stat().st_size > 0, name
    assert "2 frames ->" in out


def test_cli_honours_raster_kernel(tmp_path, capsys):
    """cama_configs.raster_kernel selects the lane in the CLI."""
    from cama_tpu_torch.cli import main

    make_fixture_clip(tmp_path / "converted", scene_name="scene-p",
                      n_frames=3, with_lidar=False)
    cfg = {"converted_dataroot": str(tmp_path / "converted"),
           "scene_names": ["scene-p"],
           "output_video_dir": str(tmp_path / "videos"),
           "cama_configs": {"raster_kernel": "pallas"}}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "on cpu, raster_kernel 'pallas'" in out
    for name in ("scene-p_cama.mp4", "scene-p_nuScenes.mp4"):
        f = tmp_path / "videos" / name
        assert f.exists() and f.stat().st_size > 0, name
