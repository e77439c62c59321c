"""cama_tpu_torch.bench on CPU: its fixtures byte-equal to bench.py's, every
stage at a small depth through main() (one JSON line of the right shape,
no kernel launched and no failure on the plain versions), the outage line
without a card, and the multi-scene program and the validation stage
against bench.py's own functions on the same inputs."""
import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from cama_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA = torch.cuda.is_available()


def _import_jax_bench():
    """bench.py, imported without keeping the compile-cache directory it
    sets in the environment."""
    had = "JAX_COMPILATION_CACHE_DIR" in os.environ
    sys.path.insert(0, REPO)
    import bench as jbench

    if not had:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return jbench


jbench = _import_jax_bench()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Both benches' fixture roots under tmp_path, 3-frame headline clips,
    and bench.py's VALIDATE.json kept out of the checkout."""
    port, jax_root = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setattr(bench, "FIXTURE_ROOT", str(port))
    monkeypatch.setattr(bench, "N_FRAMES", 3)
    monkeypatch.setattr(jbench, "FIXTURE_ROOT", str(jax_root))
    monkeypatch.setattr(jbench, "N_FRAMES", 3)
    monkeypatch.setattr(jbench, "REPO", str(jax_root))
    jax_root.mkdir()
    return port, jax_root


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_fixtures_byte_equal_to_bench_py(roots):
    port, jax_root = roots
    for get in ("get_fixture", "get_wide_fixture"):
        args = () if get == "get_fixture" else (3,)
        ours = getattr(bench, get)(*args)
        theirs = getattr(jbench, get)(*args)
        assert os.path.relpath(ours, port) == os.path.relpath(theirs, jax_root)
        a, b = _files(ours), _files(theirs)
        assert a.keys() == b.keys() and len(a) > 5, get
        assert [k for k in a if a[k] != b[k]] == [], get


def test_main_runs_every_stage_on_cpu(roots, monkeypatch, capsys):
    """main --device cpu with each stage at a small depth: one JSON line
    last, every stage's numbers present, no failure, and no kernel launch
    (the CPU runs the kernels' plain versions).  The multi-scene and
    validation stages, each run against bench.py below, stand in here by
    their results."""
    monkeypatch.setattr(bench, "N_POINTS", 16384)
    monkeypatch.setattr(bench, "bench_multi_scene",
                        lambda device: (12.5, 7.25))
    monkeypatch.setattr(bench, "run_validate", lambda clip, device: {
        "validate_ok": True, "validate_min_agreement": 0.9999884,
        "host_exact_byte_identical_to_reference": None})
    monkeypatch.setenv("CAMA_BENCH_CHUNK", "2")
    orig_wide_fixture = bench.get_wide_fixture
    monkeypatch.setattr(bench, "get_wide_fixture",
                        lambda n_frames=3: orig_wide_fixture(3))
    for name, kw in (("bench_wide_scene", dict(n_frames=3, bench_chunk=2,
                                               tile_to=4)),
                     ("bench_device_compute", dict(chunk=2)),
                     ("bench_cli_first_frame", dict(n_frames=3))):
        monkeypatch.setattr(bench, name, partial(getattr(bench, name), **kw))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the CLI's child process
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "details"}
    assert line["metric"] == "6cam_full_scene_reprojection_fps"
    assert line["unit"] == "frames/sec" and line["value"] > 0
    assert line["vs_baseline"] is None  # no reference checkout named
    d = line["details"]
    for key in ("overlay_stream_fps", "frame_stream_fps",
                "dual_video_write_fps", "dual_video_write_cold_fps",
                "map_eval_fps",
                "wide_scene_fps", "wide_scene_eval_fps",
                "device_ms_per_frame", "device_ms_per_frame_fused",
                "device_ms_per_frame_pallas", "device_ms_per_frame_two_stage",
                "device_ms_per_frame_compact", "device_resident_fps_fused",
                "hbm_gbps_lower_bound", "hbm_util_lower_bound",
                "cli_time_to_first_video_s", "cli_wall_s"):
        assert d[key] > 0, key
    assert d["frames"] == 2 and d["wide_scene_points"] > 200_000
    assert d["device_lane_points"] == 16384 and d["device_lane_chunk"] == 2
    assert d["device_card_ms_per_frame_fused"] is None  # no card alone
    assert d["device_lane_launches"] == {
        lane: {"fused_compact_project": 0, "count_union": 0,
               "project_frame_pallas": 0}
        for lane in ("two_stage", "compact", "fused", "pallas")}
    assert (d["multi_scene_stream_fps_batched"],
            d["multi_scene_stream_fps_sequential"]) == (12.5, 7.25)
    assert d["validate_ok"] is True and d["validate_min_agreement"] == 0.9999884
    assert d["failures"] == [] and d["skipped"] == []
    assert d["backend"] == "cpu" and d["card"] is None
    assert d["reference_cpu_fps"] is None and d["reference_repeats"] == 0
    assert d["device_ms_per_frame"] == d["device_ms_per_frame_two_stage"]
    assert d["raster_kernel"] == "compact" and d["bench_def"] == 2


@pytest.mark.skipif(CUDA, reason="the outage line needs a machine without a "
                                 "card")
@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_outage_line_without_a_card(tmp_path, argv):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "CAMA_BENCH_DIR": str(tmp_path), "CAMA_BENCH_FRAMES": "3"}
    proc = subprocess.run([sys.executable, "-m", "cama_tpu_torch.bench",
                           *argv], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["vs_baseline"] is None
    d = line["details"]
    assert d["backend"] == "unavailable" and "no measurement" in d["error"]
    assert not [k for k in d if k.endswith(("_fps", "_ms_per_frame"))]
    # the float64 host lane's evidence, run on the CPU by name
    assert d["validate_host_lane_ok"] is True
    assert d["validate_host_lane_min_agreement"] >= 0.99999
    assert d["failures"] == []
    assert (tmp_path / "VALIDATE_torch_outage.json").exists()
    assert "host-lane validation (device cpu)" in proc.stderr


def test_multi_scene_rasters_equal_bench_py(roots):
    """The port's batched and sequential programs give, frame for frame,
    the rasters of bench.py's batched program (_overlay_chunk_batched) on
    the same scenes."""
    import jax.numpy as jnp

    from cama_tpu.pipeline import ClipPipeline as JaxPipeline
    from cama_tpu.pipeline import MultiScenePipeline as JaxMulti
    from cama_tpu.pipeline import _overlay_chunk_batched

    port, jax_root = roots
    rasters = {}
    fps = bench.bench_multi_scene(2, 3, "cpu", rasters)
    assert all(v > 0 for v in fps)
    assert all(v > 0 for v in jbench.bench_multi_scene(2, 3))
    clips = [os.path.join(jax_root, f"scene-ms-{i}") for i in range(2)]
    pipes = [JaxPipeline(clip_path=c, chunk=8, raster_kernel="compact")
             for c in clips]
    st = JaxMulti(pipes, chunk=8, adaptive=False)._source_state("cama")
    pts, cls, valid = st["dev"]
    A, B, fv = st["host_AB"]
    lo, hi = pipes[0]._crop_lo, pipes[0]._crop_hi
    h, w = pipes[0].scene.output_size
    want = {}
    for s in range(0, fv.shape[1], 8):
        r = np.asarray(_overlay_chunk_batched(
            pts, valid, cls, jnp.asarray(A[:, s:s + 8]),
            jnp.asarray(B[:, s:s + 8]), jnp.asarray(fv[:, s:s + 8]),
            lo, hi, w, h, st["k"], False))
        for i, fm in enumerate(st["fms"]):
            for j in range(r.shape[1]):
                if s + j < len(fm.frame_valid) and fm.frame_valid[s + j]:
                    want[(i, int(fm.frame_indices[s + j]))] = r[i, j]
    assert len(want) == 4
    for name in ("batched", "sequential"):
        got = rasters[name]
        assert got.keys() == want.keys(), name
        apart = sum(int((got[k] != want[k]).sum()) for k in want)
        assert apart == 0, name
    assert all(r.any() for r in want.values())


def test_run_validate_agrees_with_bench_py(roots):
    """The validation stage on the same clip: both reports ok, the least
    agreement with the float64 host lane equal (on this 3-frame clip both
    read 0.9999884, one pixel in the smallest camera image), and each
    path's agreement equal wherever both packages project with the same
    arithmetic.  The port's 'pallas' and 'fused' paths project as its
    'compact' path does, bit for bit (their plain versions,
    test_torch_pallas_project), so they read the port's 'compact' number;
    the JAX package's Pallas kernels may keep a border point differently
    (held to the port in test_torch_pallas_project and
    test_torch_fused_compact).  The port's report is written beside its
    fixtures, never over the committed VALIDATE.json."""
    port, jax_root = roots
    with open(os.path.join(REPO, "VALIDATE.json"), "rb") as f:
        committed = f.read()
    ours = bench.run_validate(bench.get_fixture(), "cpu")
    theirs = jbench.run_validate(jbench.get_fixture())
    assert ours["validate_ok"] and theirs["validate_ok"]
    assert abs(ours["validate_min_agreement"]
               - theirs["validate_min_agreement"]) <= 1e-9
    assert round(ours["validate_min_agreement"], 7) == 0.9999884
    assert ours["host_exact_byte_identical_to_reference"] is None
    reports = []
    for path in (port / "VALIDATE_torch.json", jax_root / "VALIDATE.json"):
        with open(path) as f:
            reports.append(json.load(f)["sources"])
    assert reports[0].keys() == reports[1].keys() == {"cama", "nuscenes"}
    for source, rep in reports[1].items():
        got = {k: v["vs_host_exact_min_agreement"]
               for k, v in reports[0][source]["paths"].items()}
        want = {k: v["vs_host_exact_min_agreement"]
                for k, v in rep["paths"].items()}
        assert got.keys() == want.keys()
        for name in want:
            same_as = want[name]
            if name in ("pallas", "fused"):
                same_as = got["compact"]
            assert abs(got[name] - same_as) <= 1e-9, (source, name,
                                                      got[name], same_as)
        assert got["exact"] == 1.0
    with open(os.path.join(REPO, "VALIDATE.json"), "rb") as f:
        assert f.read() == committed

