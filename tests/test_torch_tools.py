"""The port's operations tools on CPU: doctor (one JSON line, the card
reported as unreachable here, scene checks equal to the JAX package's),
warmup (the frame store filled byte-exactly, the counts sidecar written,
a loud failure for 'cuda' without a card), the device trace, and the
PhaseTimers counters against cama_tpu's."""
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from cama_tpu import doctor as jdoctor
from cama_tpu import profiling as jprofiling
from cama_tpu.config import load_config as jload_config
from cama_tpu_torch import doctor, profiling, warmup
from cama_tpu_torch.config import load_config
from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
from cama_tpu_torch.pipeline import ClipPipeline

CUDA = torch.cuda.is_available()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ws(tmp_path):
    """A 3-frame clip with camera JPEGs (small) and GT masks, a clip not
    yet converted, and a config naming both."""
    clip = make_fixture_clip(tmp_path / "converted", scene_name="scene-t",
                             n_frames=3, image_size=(320, 180),
                             with_lidar=False)
    add_instance_masks(clip)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({
        "version": "v", "dataroot": str(tmp_path / "raw"),
        "converted_dataroot": str(tmp_path / "converted"),
        "scene_names": ["scene-t", "scene-missing", "scene-t"],
        "cama_label_file": str(tmp_path / "missing.zip"),
        "output_video_dir": str(tmp_path / "videos")}))
    return {"clip": clip, "config": str(cfg)}


def _json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), lines


@pytest.mark.skipif(CUDA, reason="checks the report of a machine without a "
                                 "card")
def test_doctor_reports_no_card_and_jax_scene_checks(ws, capsys):
    assert doctor.main(["-c", ws["config"], "--timeout", "20"]) == 0
    report, lines = _json_line(capsys)
    assert len(lines) == 1
    backend = report["backend"]
    assert backend["reachable"] is False and "is_available" in backend["note"]
    assert report["toolchain"]["kernels"]["library"].endswith(".so")
    assert isinstance(report["native_compositor"], bool)
    assert set(report["scenes"]) == {"scene-t", "scene-missing"}
    jconfigs = jload_config(ws["config"])
    configs, _ = load_config(ws["config"])
    for name in ("scene-t", "scene-missing"):
        assert report["scenes"][name] == jdoctor.check_scene(jconfigs, name)
        assert doctor.check_scene(configs, name) == report["scenes"][name]
    assert report["scenes"]["scene-t"]["gt_masks"] is True
    assert report["nuscenes_converter"] == jdoctor.check_converter_readiness()


def test_warmup_frames_fills_the_store_byte_exactly(ws):
    pipe = ClipPipeline(clip_path=ws["clip"], device="cpu")
    cold = {(cam, i): pipe.undistorted_image(cam, i)
            for i in range(len(pipe.scene.frame_times))
            for cam in pipe.scene.camera_list}
    pipe.frame_cache().flush()
    warm_pipe = ClipPipeline(clip_path=ws["clip"], device="cpu")
    out = warmup.warmup_frames(warm_pipe, n_threads=2)
    assert out["images_cached"] == len(cold) and out["hit_rate"] == 1.0
    again = ClipPipeline(clip_path=ws["clip"], device="cpu")
    fc = again.frame_cache()
    for (cam, i), img in cold.items():
        cached = fc.get(i, again.scene.camera_list.index(cam))
        assert cached is not None
        np.testing.assert_array_equal(cached, img)
        np.testing.assert_array_equal(again.undistorted_image(cam, i), img)


def test_warmup_main_cpu_writes_the_counts_sidecar(ws, capsys):
    sidecar = os.path.join(ws["clip"], ".cama_tpu", "overlay_counts.json")
    assert not os.path.exists(sidecar)
    assert warmup.main(["-c", ws["config"], "--device", "cpu",
                        "--frames"]) == 0
    report, lines = _json_line(capsys)
    assert len(lines) == 1 and report["device"] == "cpu"
    entry = report["scenes"]["scene-t"]
    assert report["scenes"]["scene-missing"] == {"skipped": "clip not converted"}
    kern = entry["kernels"]
    assert kern["build_seconds"] is None
    for source in ("cama", "nuscenes"):
        assert kern[source]["mode"] in ("sparse", "raster")
    assert entry["frames"]["images_cached"] == 18
    assert report["first_frame_latency_seconds"] >= 0
    with open(sidecar) as f:
        assert len(json.load(f)) == 2  # one entry per source
    # a second pipeline decides from the sidecar
    pipe = ClipPipeline(clip_path=ws["clip"], device="cpu")
    assert pipe.overlay_mode("cama") == (kern["cama"]["mode"],
                                         kern["cama"]["k"])


@pytest.mark.skipif(CUDA, reason="a card is present")
def test_warmup_main_cuda_without_a_card_fails_loudly(ws, capsys):
    assert warmup.main(["-c", ws["config"], "--device", "cuda"]) == 1
    report, lines = _json_line(capsys)
    assert len(lines) == 1 and "is_available" in report["error"]
    assert not os.path.exists(os.path.join(ws["clip"], ".cama_tpu",
                                           "overlay_counts.json"))


def test_device_trace_cpu_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace", device="cpu"):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    if not CUDA:
        with pytest.raises(RuntimeError, match="is_available"):
            with profiling.device_trace(tmp_path / "none"):
                pass
        assert not (tmp_path / "none").exists()


def _runtime(name, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": 1.0,
            "args": {"correlation": corr}}


def _device(cat, corr):
    return {"ph": "X", "cat": cat, "name": "k", "ts": 2.0,
            "args": {"correlation": corr}}


@pytest.mark.parametrize("events, expected", [
    # a launch, a memset and a copy, each with its device event
    ([_runtime("cudaLaunchKernel", 1), _device("kernel", 1),
      _runtime("cudaMemsetAsync", 2), _device("gpu_memset", 2),
      _runtime("cudaMemcpyAsync", 3), _device("gpu_memcpy", 3),
      _runtime("cudaStreamSynchronize", 4)], (3, 0)),
    # the kernel's and the memset's device events lost, a driver launch kept
    ([_runtime("cudaLaunchKernel", 1), _runtime("cudaMemsetAsync", 2),
      {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 1.0,
       "args": {"correlation": 5}}, _device("kernel", 5)], (3, 2)),
    # a host-only trace
    ([{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1.0,
       "args": {}}], (0, 0)),
], ids=["complete", "lost", "host_only"])
def test_untraced_launches_counts_lost_device_events(tmp_path, events,
                                                     expected):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling.untraced_launches(str(path)) == expected


def test_device_trace_cpu_is_not_checked_for_device_events(tmp_path,
                                                           recwarn):
    with profiling.device_trace(tmp_path / "t", device="cpu"):
        torch.ones(8).sum()
    calls, lost = profiling.untraced_launches(
        glob.glob(str(tmp_path / "t" / "trace_*.json"))[0])
    assert (calls, lost) == (0, 0)
    assert not [w for w in recwarn if "device event" in str(w.message)]


def test_phase_timers_match_jax():
    mine, ref = profiling.PhaseTimers(), jprofiling.PhaseTimers()
    for timers in (mine, ref):
        timers.add("decode", 0.5, n=10)
        timers.add("decode", 0.25, n=5)
        timers.add("encode", 0.0, n=3)
        timers.add("idle", 0.0, n=0)
    for name in ("decode", "encode", "idle", "never"):
        a, b = mine.fps(name), ref.fps(name)
        assert a == b or (np.isnan(a) and np.isnan(b)), name
    assert mine.as_dict() == ref.as_dict()
    assert mine.report() == ref.report()
    assert isinstance(profiling.GLOBAL_TIMERS, profiling.PhaseTimers)
