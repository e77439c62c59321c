"""cama_tpu_torch runs with jax unimportable, never loads jax where it is
installed, and imports nothing of the JAX package cama_tpu.  These run in
subprocesses: tests/conftest.py imports jax into every test process."""
import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import sys, tempfile
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import numpy as np
    import cama_tpu_torch.cli
    import cama_tpu_torch.ops.paint
    import cama_tpu_torch.pipeline as tp
    import cama_tpu_torch.tools.bench_kernels
    from cama_tpu_torch.io.fixture import make_fixture_clip

    clip = make_fixture_clip(tempfile.mkdtemp(), n_frames=3,
                             with_images=False)
    for lane in tp.RASTER_KERNELS:
        pipe = tp.ClipPipeline(clip_path=clip, chunk=2, raster_kernel=lane,
                               device="cpu")
        rasters = dict(pipe.iter_overlay_rasters("cama"))
        assert len(rasters) >= 2 and all(r.any() for r in rasters.values())
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
    import cama_tpu_torch.pipeline as tp
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


def _run_child(code, cwd, *argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
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
            "cama_tpu_torch/convert/nuscenes.py"} <= scanned
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
            "convert/vecmap.py", "convert/nuscenes.py"} <= scanned, \
        sorted(scanned)
