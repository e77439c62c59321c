"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: cama_tpu_torch is not cama_tpu), the
root bench.py, the root tools/ or cama_tpu_torch.bench; the reference
imports nothing of the port."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from camabench.tests.conftest import REPO

HERE = os.path.join(REPO, "camabench")
BLOCKED = ("jax", "jaxlib", "flax", "cama_tpu", "bench", "tools")

CHILD = r"""
import sys, json, importlib.abc
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in BLOCKED or name == "cama_tpu_torch.bench":
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
from camabench import run
from camabench.spec import Spec
from camabench.tests.conftest import write_tiny_root
spec = Spec(root=write_tiny_root({root!r}))
for cell in ("scene_video", "wide_eval"):
    result, error = run.execute(spec, cell, 3, 0.3, False, "cpu", 0.0, cache_root={cache!r})
    assert error is None and result["correct"], (cell, error, result)
bad = run.forbidden_modules() + [m for m in sys.modules if m == "cama_tpu_torch.bench"]
print(json.dumps({{"bad": bad}}))
"""


def test_run_loads_no_jax(tmp_path):
    code = CHILD.format(blocked=BLOCKED, repo=REPO, root=str(tmp_path),
                        cache=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path), env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == '{"bad": []}'


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_sources_import_nothing_forbidden():
    for path in _sources(HERE):
        for name in _imports(path):
            assert name.split(".")[0] not in BLOCKED, (path, name)
            assert not name.startswith("cama_tpu_torch.bench"), (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(HERE, "reference")):
        for name in _imports(path):
            assert name.split(".")[0] != "cama_tpu_torch", (path, name)
