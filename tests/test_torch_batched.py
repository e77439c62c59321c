"""The port's MultiScenePipeline and the CLI's scene-batched writer against
the port's solo pipelines and the JAX package on CPU: batched rasters equal
each scene's solo rasters exactly in every lane (scenes of different
lengths), agree with the JAX package's batched rasters at the device-lane
contract, and the CLI batches two scenes of one output size, or writes
them one after another when asked."""
import os

import numpy as np
import pytest
import torch
import yaml

from cama_tpu import pipeline as jpipe
from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu_torch import pipeline as tpipe


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


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two scenes of different lengths (5 and 3 frames, so the shorter one
    pads with invalid frames) and different maps and point counts."""
    root = tmp_path_factory.mktemp("tbatch")
    return [make_fixture_clip(root / "converted", scene_name=name,
                              n_frames=n, with_lidar=False, seed=seed,
                              label_span=span)
            for name, n, seed, span in (
                ("scene-a", 5, 0, (-278.0, -202.0)),
                ("scene-b", 3, 1, (-290.0, -190.0)))]


def _batched(pipes, sources, chunk=2):
    """{(scene, source): {image_idx: raster}} from iter_frame_groups."""
    out = {}
    msp = tpipe.MultiScenePipeline(pipes, chunk=chunk)
    for si, idx, by_src in msp.iter_frame_groups(sources):
        for src, raster in by_src.items():
            out.setdefault((si, src), {})[idx] = raster
    return out


@pytest.mark.parametrize("lane", LANES)
def test_batched_rasters_equal_solo(clips, lane):
    pipes = [tpipe.ClipPipeline(clip_path=c, chunk=2, raster_kernel=lane,
                                device="cpu") for c in clips]
    got = _batched(pipes, ["cama", "nuscenes"])
    for si, pipe in enumerate(pipes):
        for src in ("cama", "nuscenes"):
            want = dict(pipe.iter_overlay_rasters(src))
            assert set(got[(si, src)]) == set(want) and len(want) >= 2
            for idx in want:
                np.testing.assert_array_equal(got[(si, src)][idx], want[idx])
    # the one-source stream yields the same rasters
    msp = tpipe.MultiScenePipeline(pipes, chunk=2)
    for si, idx, raster in msp.iter_overlay_rasters():
        np.testing.assert_array_equal(raster, got[(si, "cama")][idx])


def test_batched_rasters_match_jax(clips):
    """Against the JAX package's MultiScenePipeline at >= 0.99999 per frame
    (the f32 border class between the packages)."""
    got = _batched([tpipe.ClipPipeline(clip_path=c, chunk=2, device="cpu")
                    for c in clips], ["cama"])
    jpipes = [jpipe.ClipPipeline(clip_path=c, chunk=2, raster_kernel="compact")
              for c in clips]
    ref = {}
    for si, idx, raster in jpipe.MultiScenePipeline(
            jpipes, chunk=2).iter_overlay_rasters():
        ref.setdefault(si, {})[idx] = raster
    for si in range(len(clips)):
        assert set(got[(si, "cama")]) == set(ref[si])
        for idx, raster in ref[si].items():
            assert (got[(si, "cama")][idx] == raster).mean() >= 0.99999


def test_batched_list_overflow_raises(clips):
    pipes = [tpipe.ClipPipeline(clip_path=c, chunk=2, device="cpu")
             for c in clips]
    for p in pipes:  # the shared list size is the members' largest
        p.overlay_mode("cama")
        p._k["cama"] = 64
    msp = tpipe.MultiScenePipeline(pipes, chunk=2)
    with pytest.raises(RuntimeError, match="over the fused list size"):
        list(msp.iter_overlay_rasters())


def test_members_must_share_lane_and_size(clips):
    a = tpipe.ClipPipeline(clip_path=clips[0], chunk=2, device="cpu")
    b = tpipe.ClipPipeline(clip_path=clips[1], chunk=2, raster_kernel="pallas",
                           device="cpu")
    with pytest.raises(ValueError, match="raster_kernel"):
        tpipe.MultiScenePipeline([a, b])
    with pytest.raises(ValueError, match="at least one"):
        tpipe.MultiScenePipeline([])


def test_batched_write_videos_equal_solo(clips, monkeypatch):
    """MultiScenePipeline.write_videos hands the encoders the same mosaics,
    byte for byte, as each scene's own write_videos (which serves the
    sparse lane)."""
    frames = {}

    class Capture:
        def __init__(self, path, output_shape, fps=10, preset=None):
            self.path = path
            frames[path] = []

        def add_frame(self, frame):
            frames[self.path].append(np.array(frame, copy=True))

        def close(self):
            pass

    monkeypatch.setattr(tpipe, "VideoSink", Capture)
    pipes = [tpipe.ClipPipeline(clip_path=c, chunk=2, device="cpu")
             for c in clips]
    paths = [{"cama": f"b{i}_cama", "nuscenes": f"b{i}_nus"}
             for i in range(len(pipes))]
    counts = tpipe.MultiScenePipeline(pipes, chunk=2).write_videos(paths)
    for i, pipe in enumerate(pipes):
        assert pipe.serving_mode("cama")[0] == "sparse"
        solo = pipe.write_videos({s: p + "_solo" for s, p in paths[i].items()})
        assert solo == counts[i] and counts[i]["cama"] >= 2
        for path in paths[i].values():
            assert len(frames[path]) == len(frames[path + "_solo"])
            for a, b in zip(frames[path], frames[path + "_solo"]):
                np.testing.assert_array_equal(a, b)


def _config(root, clips, **extra):
    cfg = {"converted_dataroot": os.path.dirname(clips[0]),
           "scene_names": [os.path.basename(c) for c in clips],
           "output_video_dir": str(root / "videos"), **extra}
    path = root / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("batch", [True, False])
def test_cli_batches_two_scenes(clips, tmp_path, capsys, batch):
    """Two scenes of one output size: the CLI writes them through
    MultiScenePipeline (the default), or one after another with
    batch_scenes false; four videos either way."""
    from cama_tpu_torch.cli import main

    extra = {} if batch else {"batch_scenes": False}
    assert main(["--config", _config(tmp_path, clips, **extra),
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("Batching 2 scenes at 960x540" in out) == batch
    assert ("scene-batched" in out) == batch
    assert out.count("generating reprojection videos") == (0 if batch else 2)
    videos = sorted(os.listdir(tmp_path / "videos"))
    assert videos == ["scene-a_cama.mp4", "scene-a_nuScenes.mp4",
                      "scene-b_cama.mp4", "scene-b_nuScenes.mp4"]
    for v in videos:
        assert (tmp_path / "videos" / v).stat().st_size > 0


def test_cli_batched_group_failure_counts_each_member(clips, tmp_path,
                                                      monkeypatch, capsys):
    """A batched group that fails is one failure per member scene, labelled
    by scene name as the JAX CLI does (cama_tpu/cli.py:_isolated), and the
    exit code reports it."""
    from cama_tpu_torch import cli

    def boom(self, *args, **kwargs):
        raise RuntimeError("encoder lost")

    monkeypatch.setattr(tpipe.MultiScenePipeline, "write_videos", boom)
    configs, _ = cli.load_config(_config(tmp_path, clips))
    failures = cli.run(configs, device="cpu")
    assert [label for label, _ in failures] == ["scene-a", "scene-b"]
    assert all("encoder lost" in err for _, err in failures)
    assert "2 scene(s) failed" in capsys.readouterr().out
    assert cli.main(["--config", _config(tmp_path, clips),
                     "--device", "cpu"]) == 1
