"""cama_tpu_torch runs with jax unimportable, never loads jax where it is
installed, and imports nothing of the JAX package cama_tpu.  These run in
subprocesses: tests/conftest.py imports jax into every test process."""
import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import sys, tempfile
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import numpy as np
    import cama_tpu_torch.cli
    import cama_tpu_torch.ops.paint
    import cama_tpu_torch.parallel
    import cama_tpu_torch.parallel.cluster
    import cama_tpu_torch.parallel.multihost
    import cama_tpu_torch.pipeline as tp
    import cama_tpu_torch.tools.bench_kernels
    import cama_tpu_torch.tools.mesh_child
    from cama_tpu_torch.io.fixture import make_fixture_clip

    clip = make_fixture_clip(tempfile.mkdtemp(), n_frames=3,
                             with_images=False)
    for lane in tp.RASTER_KERNELS:
        pipe = tp.ClipPipeline(clip_path=clip, chunk=2, raster_kernel=lane,
                               device="cpu")
        rasters = dict(pipe.iter_overlay_rasters("cama"))
        assert len(rasters) >= 2 and all(r.any() for r in rasters.values())
    # the sharded fused step on a one-rank mesh, no process group
    st = pipe.scene_tensors("cama")
    h, w = pipe.scene.output_size
    step = cama_tpu_torch.parallel.sharded_overlay_step(
        cama_tpu_torch.parallel.make_mesh(1, 1, device="cpu"), w, h, "fused")
    sharded, _ = step(st.points, st.valid, st.cls, st.A, st.B,
                      st.frame_valid, pipe._crop_lo, pipe._crop_hi)
    assert sharded.any()
    # the driver-contract entry on the plain versions (its dryrun spawns
    # clusters of its own and is not run here)
    from cama_tpu_torch import graft_entry
    fn, args = graft_entry.entry(device="cpu")
    assert fn(*args).shape == (8, 6, 96, 128)
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert all(sys.modules[m] is None for m in loaded), loaded
    try:
        import jax  # noqa: F401
    except ImportError:
        print("NO_JAX_OK", len(rasters))
""")


# jax is installed here and nothing blocks it: the whole CLI path (config,
# scene compile, device lane, frame cache, native mosaic, video encode)
# must leave it unloaded, along with every cama_tpu module that needs it
_CHILD_INSTALLED = textwrap.dedent("""
    import importlib.util, os, sys, tempfile
    import yaml
    assert importlib.util.find_spec("jax") is not None
    from cama_tpu_torch.cli import main
    from cama_tpu_torch.io.fixture import make_fixture_clip

    root = tempfile.mkdtemp()
    make_fixture_clip(os.path.join(root, "c"), scene_name="s", n_frames=3)
    for lane in (None, "pallas"):  # the default, then a named lane
        cfg = os.path.join(root, "config.yaml")
        out = os.path.join(root, f"v_{lane}")
        with open(cfg, "w") as f:
            yaml.safe_dump({"converted_dataroot": os.path.join(root, "c"),
                            "scene_names": ["s"], "output_video_dir": out,
                            "cama_configs": {"raster_kernel": lane}}, f)
        assert main(["--config", cfg, "--device", "cpu"]) == 0
        assert sorted(os.listdir(out)) == ["s_cama.mp4", "s_nuScenes.mp4"]
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "cama_tpu"))
    assert not loaded, loaded
    print("JAX_NEVER_LOADED")
""")


# the JAX package unimportable: every lane and the CLI, with the native
# compositor, the frame cache and the video sink, run on the port's copies
_CHILD_NO_CAMA_TPU = textwrap.dedent("""
    import os, sys, tempfile
    sys.modules["cama_tpu"] = None  # any `import cama_tpu...` now raises
    import yaml
    import cama_tpu_torch.parallel.cluster
    import cama_tpu_torch.parallel.multihost
    import cama_tpu_torch.pipeline as tp
    import cama_tpu_torch.tools.mesh_child
    from cama_tpu_torch import native
    from cama_tpu_torch.cli import main
    from cama_tpu_torch.io.fixture import make_fixture_clip

    root = tempfile.mkdtemp()
    clip = make_fixture_clip(os.path.join(root, "c"), scene_name="s",
                             n_frames=3)
    for lane in tp.RASTER_KERNELS:
        pipe = tp.ClipPipeline(clip_path=clip, chunk=2, raster_kernel=lane,
                               device="cpu")
        rasters = dict(pipe.iter_overlay_rasters("cama"))
        assert len(rasters) >= 2 and all(r.any() for r in rasters.values())
    assert native.available()
    cfg = os.path.join(root, "config.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"converted_dataroot": os.path.join(root, "c"),
                        "scene_names": ["s"],
                        "output_video_dir": os.path.join(root, "v")}, f)
    assert main(["--config", cfg, "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(root, "v"))) == [
        "s_cama.mp4", "s_nuScenes.mp4"]
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "cama_tpu"
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("NO_CAMA_TPU_OK")
""")


# jax and the JAX package both unimportable: every lane's sparse lane
# (lists, host paint, the overflow fallback) and the two-scene CLI, which
# writes through MultiScenePipeline
_CHILD_SPARSE_BATCHED = textwrap.dedent("""
    import os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["cama_tpu"] = None
    import yaml
    import cama_tpu_torch.pipeline as tp
    from cama_tpu_torch.cli import main
    from cama_tpu_torch.io.fixture import make_fixture_clip

    root = tempfile.mkdtemp()
    conv = os.path.join(root, "c")
    clips = [make_fixture_clip(conv, scene_name=n, n_frames=3)
             for n in ("s1", "s2")]
    for lane in tp.RASTER_KERNELS:
        pipe = tp.ClipPipeline(clip_path=clips[0], chunk=2,
                               raster_kernel=lane, device="cpu")
        assert pipe.serving_mode("cama")[0] == "sparse"
        sparse = dict(pipe.iter_frames("cama", mode="sparse"))
        dense = dict(pipe.iter_frames("cama", mode="raster"))
        assert len(sparse) >= 2 and sparse.keys() == dense.keys()
        assert all((sparse[i][c] == dense[i][c]).all()
                   for i in dense for c in dense[i])
    pipes = [tp.ClipPipeline(clip_path=c, chunk=2, device="cpu")
             for c in clips]
    batched = list(tp.MultiScenePipeline(pipes, chunk=2).iter_overlay_rasters())
    assert {si for si, _, _ in batched} == {0, 1}
    cfg = os.path.join(root, "config.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"converted_dataroot": conv, "scene_names": ["s1", "s2"],
                        "output_video_dir": os.path.join(root, "v")}, f)
    assert main(["--config", cfg, "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(root, "v"))) == [
        "s1_cama.mp4", "s1_nuScenes.mp4", "s2_cama.mp4", "s2_nuScenes.mp4"]
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "cama_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("SPARSE_BATCHED_OK")
""")


# jax and the JAX package both unimportable: the validation harness over
# every path on CPU, and the CLI converting a nuScenes scene first.  The
# devkit is replaced by tables the parent test wrote (sys.argv[1]): the
# fake DB of tests/test_convert.py, whose module imports cama_tpu
_CHILD_VALIDATE_CONVERT = textwrap.dedent("""
    import json, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["cama_tpu"] = None
    import numpy as np
    import yaml
    from cama_tpu_torch import validate
    from cama_tpu_torch.cli import main
    from cama_tpu_torch.convert import nuscenes
    from cama_tpu_torch.io.fixture import make_fixture_clip

    root = tempfile.mkdtemp()
    clip = make_fixture_clip(os.path.join(root, "c"), scene_name="s",
                             n_frames=3)
    report = os.path.join(root, "VALIDATE.json")
    assert validate.main(["--clip", clip, "--frames", "2", "--device", "cpu",
                          "--out", report]) == 0
    with open(report) as f:
        rep = json.load(f)
    assert rep["ok"] and rep["exact_lane_min_agreement"] == 1.0
    assert all(set(r["paths"]) == set(validate.DEVICE_PATHS)
               for r in rep["sources"].values()) and len(rep["sources"]) == 2

    class Maps:
        def line_layer(self, location, layer):
            y = 1598 if layer == "road_divider" else 1602
            return [np.array([[590, y], [620, y]], float)]

        def polygon_layer(self, location, layer):
            if layer == "ped_crossing":
                return [(np.array([[604, 1595], [606, 1595], [606, 1605],
                                   [604, 1605]], float), [])]
            if layer == "road_segment":
                return [(np.array([[585, 1590], [625, 1590], [625, 1610],
                                   [585, 1610]], float), [])]
            return []

    class TableDB:
        def __init__(self, version, dataroot):
            self.root = dataroot
            with open(os.path.join(dataroot, "tables.json")) as f:
                self.tables = json.load(f)
        samples = property(lambda self: list(self.tables["sample"].values()))
        scenes = property(lambda self: list(self.tables["scene"].values()))
        def get(self, table, token):
            return self.tables[table][token]
        def cam_intrinsic(self, cam_token):
            return np.array([[1266.4, 0, 816.3], [0, 1266.4, 491.5],
                             [0, 0, 1.0]])
        def file_path(self, filename):
            return os.path.join(self.root, filename)
        def map_source(self):
            return Maps()

    nuscenes.NuScenesDB = TableDB
    cfg = os.path.join(root, "config.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"version": "v1.0-test", "dataroot": sys.argv[1],
                        "converted_dataroot": os.path.join(root, "conv"),
                        "scene_names": ["scene-fake1"],
                        "output_video_dir": os.path.join(root, "v"),
                        "cama_configs": {"result_dir": "maps"}}, f)
    assert main(["--config", cfg, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(root, "conv", "scene-fake1",
                                       "attribute.json"))
    assert os.listdir(os.path.join(root, "v")) == ["scene-fake1_nuScenes.mp4"]
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "cama_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("VALIDATE_CONVERT_OK")
""")


# jax and the JAX package both unimportable: ground-truth masks from the
# port's fixture, then map evaluation through the script's entry point (the
# resident device path on CPU tensors, then the host backend) and through
# the batch evaluator
_CHILD_MAP_EVAL = textwrap.dedent("""
    import io, json, os, sys, tempfile
    from contextlib import redirect_stdout
    sys.modules["jax"] = None
    sys.modules["cama_tpu"] = None
    import tomllib
    from importlib import import_module
    from cama_tpu_torch.eval import map_metrics
    from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
    from cama_tpu_torch.pipeline import ClipPipeline

    with open(os.path.join(sys.argv[1], "pyproject.toml"), "rb") as f:
        entry = tomllib.load(f)["project"]["scripts"]["cama-tpu-torch-map-eval"]
    mod, fn = entry.split(":")
    main = getattr(import_module(mod), fn)
    assert main is map_metrics.main

    clip = make_fixture_clip(tempfile.mkdtemp(), n_frames=3,
                             with_images=False)
    add_instance_masks(clip)
    outs = []
    for extra in ([], ["--backend", "host"]):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(["--clip", clip, "--device", "cpu", "--instances", *extra])
        outs.append(json.loads(buf.getvalue()))
    assert outs[0]["frames_evaluated"] == 2 and outs[0]["precision"] == 1.0
    assert all(abs(outs[0][k] - outs[1][k]) <= 1e-4 for k in outs[0])
    pipes = [ClipPipeline(clip_path=clip, chunk=2, device="cpu")]
    batch = map_metrics.MapEvaluator().evaluate_scene_batch(pipes)
    assert batch[0]["frames_evaluated"] == 2
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "cama_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("MAP_EVAL_OK")
""")



# jax and the JAX package both unimportable: a site from two overlapping
# clips (Sim(3) estimate, refinement, dedupe, member reprojection), LiDAR
# aggregation on both backends, and the three scripts the pyproject names
_CHILD_SITE_LIDAR = textwrap.dedent("""
    import io, os, sys, tempfile
    from contextlib import redirect_stdout
    sys.modules["jax"] = None
    sys.modules["cama_tpu"] = None
    import numpy as np
    import tomllib
    from importlib import import_module
    from cama_tpu_torch.aggregate import Site, aggregate_lidar
    from cama_tpu_torch.io.fixture import make_fixture_clip

    root = tempfile.mkdtemp()
    common = dict(n_frames=14, with_images=False, flat_height=True)
    a = make_fixture_clip(root, scene_name="a", **common)
    b = make_fixture_clip(root, scene_name="b", traj_t_offset=0.7,
                          t0_ms=1600000100000, world_sim3={"yaw_deg": 8.0},
                          **common)
    site = Site.from_clips([a, b], refine=True, device="cpu")
    assert [ci for _, _, ci in site.instances] == [0] * 8
    rasters = list(site.member_overlay_rasters(chunk=4))
    assert {ci for ci, _, _ in rasters} == {0, 1}
    cloud = site.aggregate_lidar(voxel=0.5, every=4)
    assert len(cloud) > 1000 and cloud[:, 0].min() > -285
    host = aggregate_lidar(a, backend="host")
    dev = aggregate_lidar(a, device="cpu")
    assert host.shape == dev.shape and np.abs(host - dev).max() < 1e-4
    with open(os.path.join(sys.argv[1], "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    gt = os.path.join(a, "odometry", "wigo.txt")
    runs = {
        "cama-tpu-torch-site": ["--clips", a, b, "--out-dir", root,
                                "--device", "cpu", "--lidar"],
        "cama-tpu-torch-lidar": ["--clip", a, "--out", os.path.join(root, "a.xyz"),
                                 "--device", "cpu"],
        "cama-tpu-torch-pose-eval": ["--gt", gt, "--pred", gt],
    }
    for name, argv in runs.items():
        mod, fn = scripts[name].split(":")
        buf = io.StringIO()
        with redirect_stdout(buf):
            getattr(import_module(mod), fn)(argv)
        assert buf.getvalue(), name
    assert sorted(os.listdir(root)) == ["a", "a.xyz", "b", "site_labels.json",
                                        "site_lidar.pcd", "site_map.pcd"]
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "cama_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("SITE_LIDAR_OK")
""")

# one of jax / the JAX package unimportable (sys.argv[2]): the QA report
# (thumbnails, metrics, a site), the doctor and the warmup through the
# scripts the pyproject names, on CPU; then the device mosaic and the
# device trace
_CHILD_QA_TOOLS = textwrap.dedent("""
    import io, json, os, sys, tempfile
    from contextlib import redirect_stdout
    sys.modules[sys.argv[2]] = None
    import numpy as np
    import tomllib
    import yaml
    from importlib import import_module
    from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
    from cama_tpu_torch.io.video import concat_camera_grid
    from cama_tpu_torch.pipeline import ClipPipeline
    from cama_tpu_torch.profiling import device_trace

    root = tempfile.mkdtemp()
    conv = os.path.join(root, "c")
    for name in ("s1", "s2"):
        clip = make_fixture_clip(conv, scene_name=name, n_frames=3,
                                 image_size=(320, 180), with_lidar=False)
        add_instance_masks(clip)
    cfg = os.path.join(root, "config.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"converted_dataroot": conv, "scene_names": ["s1", "s2"],
                        "output_video_dir": os.path.join(root, "v"),
                        "sites": [{"name": "both", "scenes": ["s1", "s2"]}]}, f)
    with open(os.path.join(sys.argv[1], "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    runs = {"cama-tpu-torch-report": ["-c", cfg, "--device", "cpu",
                                      "--thumbnails", "1", "--max-frames", "1",
                                      "--no-instances"],
            "cama-tpu-torch-doctor": ["-c", cfg, "--timeout", "20"],
            "cama-tpu-torch-warmup": ["-c", cfg, "--device", "cpu", "--frames"]}
    lines = {}
    for name, argv in runs.items():
        mod, fn = scripts[name].split(":")
        buf = io.StringIO()
        with redirect_stdout(buf):
            try:
                getattr(import_module(mod), fn)(argv)
            except SystemExit as e:
                assert e.code == 0, (name, e.code)
        lines[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert lines["cama-tpu-torch-report"]["failures"] == 0
    assert lines["cama-tpu-torch-report"]["sites"] == 1
    with open(os.path.join(root, "v", "report.html")) as f:
        assert f.read().count("data:image/jpeg;base64,") == 2
    assert lines["cama-tpu-torch-doctor"]["scenes"]["s1"]["converted"]
    assert lines["cama-tpu-torch-warmup"]["scenes"]["s2"]["frames"][
        "images_cached"] == 18
    pipe = ClipPipeline(clip_path=os.path.join(conv, "s1"), device="cpu")
    with device_trace(os.path.join(root, "trace"), device="cpu"):
        got = pipe.mosaics_device(["cama", "nuscenes"], 1)
    for source, mosaic in got.items():
        want = concat_camera_grid(pipe.composite_frame(
            source, 1, pipe._overlay_single(source, 1)))
        assert (mosaic == want).all(), source
    assert len(os.listdir(os.path.join(root, "trace"))) == 1
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "cama_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("QA_TOOLS_OK")
""")


# jax and the JAX package both unimportable: the benchmark (its outage
# line without a card, or one CPU stage), the profiling, fuzz, golden and
# converter-validation tools, the demos' modules and `python -m
# cama_tpu_torch`'s entry
_CHILD_SCRIPTS = textwrap.dedent("""
    import io, json, os, sys, tempfile
    from contextlib import redirect_stdout
    sys.modules["jax"] = None
    sys.modules["cama_tpu"] = None
    import torch
    import cama_tpu_torch.__main__
    import cama_tpu_torch.examples.demo
    import cama_tpu_torch.examples.demo_device_compositing
    import cama_tpu_torch.examples.demo_multihost
    from cama_tpu_torch import bench, cli
    from cama_tpu_torch.examples import demo_adaptive
    from cama_tpu_torch.io.fixture import make_fixture_clip
    from cama_tpu_torch.tools import (fuzz_sweep, gen_golden,
                                      profile_pipeline, validate_convert_real)

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    bench.FIXTURE_ROOT = root
    bench.N_FRAMES, bench.N_POINTS = 3, 16384
    for stage in ("VALIDATE", "MULTI", "WIDE", "DEVICE", "CLI"):
        os.environ[f"CAMA_BENCH_{stage}"] = "0"
    os.environ["CAMA_BENCH_CHUNK"] = "2"
    buf = io.StringIO()
    with redirect_stdout(buf):
        if torch.cuda.is_available():  # the core and evaluation stages
            assert bench.main(["--device", "cpu"]) == 0
        else:
            assert bench.main([]) == 2
        assert fuzz_sweep.main(["--trials", "2", "--device", "cpu"]) == 0
        assert gen_golden.main([os.path.join(root, "golden")]) == 0
        assert validate_convert_real.main(["--work-dir", root]) == 2
        clip = make_fixture_clip(root, n_frames=3, with_images=False,
                                 with_lidar=False)
        assert demo_adaptive.main([clip, "--device", "cpu"]) == 0
        assert profile_pipeline.main(["--clip", clip, "--device", "cpu"]) == 0
    out = buf.getvalue()
    assert "polygon-union: 2/2 passed" in out and "warm pass: 2 frames" in out
    try:
        cli.exit_after(0)
    except SystemExit as e:
        assert e.code == 0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "cama_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    tmp.cleanup()
    print("SCRIPTS_OK")
""")


def _run_child(code, cwd, *argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    # one intra-op torch thread: the test suite runs several workers at once
    env["OMP_NUM_THREADS"] = "1"
    # the children's temporary directories inside the test's own
    env["TMPDIR"] = str(cwd)
    return subprocess.run([sys.executable, "-c", code, *argv], cwd=str(cwd),
                          env=env, capture_output=True, text=True, timeout=300)


def test_port_runs_without_jax(tmp_path):
    proc = _run_child(_CHILD, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_port_never_loads_installed_jax(tmp_path):
    proc = _run_child(_CHILD_INSTALLED, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_NEVER_LOADED" in proc.stdout


def test_port_runs_without_cama_tpu(tmp_path):
    proc = _run_child(_CHILD_NO_CAMA_TPU, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "NO_CAMA_TPU_OK" in proc.stdout


def test_sparse_lane_and_batched_cli_without_jax_or_cama_tpu(tmp_path):
    proc = _run_child(_CHILD_SPARSE_BATCHED, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "Batching 2 scenes" in proc.stdout
    assert "SPARSE_BATCHED_OK" in proc.stdout


def test_validate_and_converting_cli_without_jax_or_cama_tpu(tmp_path):
    import json

    from test_convert import FakeDB

    raw = tmp_path / "raw"
    db = FakeDB(raw)  # writes the sensor files under raw/files
    with open(raw / "tables.json", "w") as f:
        json.dump(db.tables, f)
    proc = _run_child(_CHILD_VALIDATE_CONVERT, tmp_path, str(raw))
    assert proc.returncode == 0, proc.stderr
    assert "VALIDATE_CONVERT_OK" in proc.stdout


def test_map_eval_without_jax_or_cama_tpu(tmp_path):
    proc = _run_child(_CHILD_MAP_EVAL, tmp_path, REPO)
    assert proc.returncode == 0, proc.stderr
    assert "MAP_EVAL_OK" in proc.stdout


def test_site_lidar_and_scripts_without_jax_or_cama_tpu(tmp_path):
    proc = _run_child(_CHILD_SITE_LIDAR, tmp_path, REPO)
    assert proc.returncode == 0, proc.stderr
    assert "SITE_LIDAR_OK" in proc.stdout


@pytest.mark.parametrize("blocked", ["jax", "cama_tpu"])
def test_report_doctor_warmup_without_jax_or_cama_tpu(tmp_path, blocked):
    proc = _run_child(_CHILD_QA_TOOLS, tmp_path, REPO, blocked)
    assert proc.returncode == 0, proc.stderr
    assert "QA_TOOLS_OK" in proc.stdout


def test_bench_tools_and_demos_without_jax_or_cama_tpu(tmp_path):
    proc = _run_child(_CHILD_SCRIPTS, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "SCRIPTS_OK" in proc.stdout


def _port_sources():
    """Every Python file of the port and chip_smoke.py, by path."""
    pkg = os.path.join(REPO, "cama_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    return sorted(paths)


def test_port_sources_never_load_cama_tpu():
    """No import of the JAX package, and no loading of its files by path,
    in the port or in chip_smoke.py."""
    imports = re.compile(r"^\s*(from\s+cama_tpu(\.\S+)?\s+import|"
                         r"import\s+cama_tpu(\.|\s|$|,))")
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if imports.match(line) or "spec_from_file_location" in line:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{n}: "
                                     f"{line.strip()}")
    assert not offenders, offenders
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"chip_smoke.py", "cama_tpu_torch/validate.py",
            "cama_tpu_torch/convert/nuscenes.py",
            "cama_tpu_torch/eval/__init__.py",
            "cama_tpu_torch/eval/map_metrics.py",
            "cama_tpu_torch/eval/pose_metrics.py",
            "cama_tpu_torch/aggregate/lidar.py",
            "cama_tpu_torch/aggregate/site.py",
            "cama_tpu_torch/se3/trajectory.py",
            "cama_tpu_torch/report.py", "cama_tpu_torch/doctor.py",
            "cama_tpu_torch/warmup.py", "cama_tpu_torch/profiling.py",
            "cama_tpu_torch/ops/undistort.py",
            "cama_tpu_torch/tools/profiler_loss.py",
            "cama_tpu_torch/parallel/__init__.py",
            "cama_tpu_torch/parallel/sharding.py",
            "cama_tpu_torch/parallel/multihost.py",
            "cama_tpu_torch/parallel/cluster.py",
            "cama_tpu_torch/tools/mesh_child.py",
            "cama_tpu_torch/__main__.py", "cama_tpu_torch/bench.py",
            "cama_tpu_torch/tools/profile_pipeline.py",
            "cama_tpu_torch/tools/fuzz_sweep.py",
            "cama_tpu_torch/tools/gen_golden.py",
            "cama_tpu_torch/tools/validate_convert_real.py",
            "cama_tpu_torch/examples/demo.py",
            "cama_tpu_torch/examples/demo_adaptive.py",
            "cama_tpu_torch/examples/demo_device_compositing.py",
            "cama_tpu_torch/examples/demo_multihost.py",
            "cama_tpu_torch/graft_entry.py"} <= scanned
    assert imports.match("from cama_tpu.ops import lift")
    assert imports.match("import cama_tpu")
    assert not imports.match("from cama_tpu_torch.ops import lift")


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "cama_tpu_torch")
    offenders, scanned = [], set()
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                scanned.add(os.path.relpath(path, pkg))
                with open(path) as f:
                    for line in f:
                        s = line.strip()
                        if s.startswith(("import jax", "from jax")):
                            offenders.append(path)
    assert not offenders, offenders
    assert {"pipeline.py", "ops/pallas_project.py", "ops/paint.py",
            "tools/bench_kernels.py", "validate.py", "convert/geom.py",
            "convert/vecmap.py", "convert/nuscenes.py", "eval/__init__.py",
            "eval/map_metrics.py", "eval/pose_metrics.py",
            "aggregate/__init__.py", "aggregate/lidar.py", "aggregate/site.py",
            "se3/core.py", "se3/codec.py", "se3/trajectory.py", "report.py",
            "doctor.py", "warmup.py", "profiling.py", "ops/raster.py",
            "ops/undistort.py", "tools/profiler_loss.py",
            "parallel/__init__.py", "parallel/sharding.py",
            "parallel/multihost.py", "parallel/cluster.py",
            "tools/mesh_child.py", "__main__.py", "bench.py",
            "tools/profile_pipeline.py", "tools/fuzz_sweep.py",
            "tools/gen_golden.py", "tools/validate_convert_real.py",
            "examples/demo.py", "examples/demo_adaptive.py",
            "examples/demo_device_compositing.py",
            "examples/demo_multihost.py", "graft_entry.py"} <= scanned, \
        sorted(scanned)
