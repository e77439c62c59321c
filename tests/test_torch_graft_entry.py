"""cama_tpu_torch.graft_entry against the JAX package's __graft_entry__ on
CPU: the tiny inputs byte for byte, entry()'s rasters against JAX's entry()
under jax.jit, and dryrun_multichip(4) on one module-scoped cluster of four
gloo ranks: the ten checks in the JAX dryrun's order (its checks.append
calls, read from the source: the JAX dryrun spawns a cluster of its own and
is not run), the meshes, the raster shape and the painted count of JAX's
scatter step on a (2, 2) mesh of the conftest's virtual CPU devices.  The
checks' pure function raises on a corrupted payload."""
import ast
import contextlib
import copy
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cama_tpu import parallel as jpar
from cama_tpu_torch import graft_entry as g

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as jg  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """dryrun_multichip(4, 'cpu') once: its printed line, its result, and
    what its clusters gathered (got, want) for run_checks."""
    gathered = {}
    gather = g._gather

    def spy(*args, **kwargs):
        gathered["out"] = gather(*args, **kwargs)
        return gathered["out"]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(g, "_gather", spy)
        mp.setenv("OMP_NUM_THREADS", "1")
        result = g.dryrun_multichip(
            4, "cpu", workdir=str(tmp_path_factory.mktemp("dryrun")))
    got, want, _, _ = gathered["out"]
    return {"line": out.getvalue().strip().splitlines()[-1],
            "result": result, "got": got, "want": want}


def _jax_check_names():
    """The check names of __graft_entry__._dryrun_impl, in source order."""
    with open(os.path.join(REPO, "__graft_entry__.py")) as f:
        tree = ast.parse(f.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "append"
             and isinstance(n.func.value, ast.Name)
             and n.func.value.id == "checks"]
    return [c.args[0].value for c in sorted(calls, key=lambda c: c.lineno)]


@pytest.mark.parametrize("kwargs", [{}, {"F": 4, "P": 512, "seed": 11}],
                         ids=["defaults", "F4-P512-seed11"])
def test_tiny_inputs_byte_equal(kwargs):
    ours, theirs = g._tiny_inputs(**kwargs), jg._tiny_inputs(**kwargs)
    assert len(ours) == len(theirs) == 10
    for a, b in zip(ours, theirs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_entry_rasters_equal_jax():
    """entry(device='cpu')'s rasters equal the JAX entry()'s under jax.jit
    on the CPU, all 589,824 bytes; its union lists fit k_cap (106-114 rows
    a frame)."""
    fn, args = g.entry("cpu")
    assert [a.device.type for a in args] == ["cpu"] * 8
    got = fn(*args)
    assert got.shape == (8, 6, 96, 128) and got.dtype == torch.uint8
    jfn, jargs = jg.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert want.size == 589_824 and want.any()
    np.testing.assert_array_equal(got.numpy(), want)
    from cama_tpu_torch.ops.fused_compact import count_union

    counts = count_union(*args[:6], 128, 96, args[6], args[7])
    assert 100 <= int(counts.min()) and int(counts.max()) <= g.K_CAP


def test_entry_raises_on_an_overflowing_list():
    """fn holds every frame's union count against k_cap: the JAX entry's
    program at 2,048 points would clamp, the port's raises."""
    fn, _ = g.entry("cpu")
    points, valid, cls, A, B, fv, lo, hi, _, _ = g._tiny_inputs(P=2048)
    args = [torch.from_numpy(a) for a in (points, valid, cls, A, B, fv, lo,
                                          hi)]
    with pytest.raises(RuntimeError, match="over the fused list size k=256"):
        fn(*args)


def test_entry_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry('cuda') runs the kernel")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        g.entry("cuda")


def test_dryrun_checks_in_jax_order(dryrun):
    names = _jax_check_names()
    assert len(names) == 10 and names[0] == "compact==scatter"
    assert dryrun["result"]["checks"] == names
    line = dryrun["line"]
    assert line.startswith(
        "dryrun_multichip ok: mesh {'frames': 2, 'points': 2}, rasters "
        "(4, 6, 96, 128), painted=")
    assert line.endswith(", hosts mesh {'hosts': 2, 'local': 2}, checks: "
                         + ", ".join(names))
    assert dryrun["result"]["clusters"] == [(4, "gloo")]


def test_dryrun_painted_equals_jax(dryrun):
    """The scatter kernel's painted count and rasters equal JAX's sharded
    step on a (2, 2) ('frames', 'points') mesh over the same inputs."""
    points, valid, cls, A, B, fv, lo, hi, w, h = jg._tiny_inputs(F=4, P=512)
    mesh = jpar.make_mesh(n_frames_axis=2, n_points_axis=2)
    rasters, counts = jpar.sharded_overlay_step(mesh, w, h)(*(
        jnp.asarray(a) for a in (points, valid, cls, A, B, fv, lo, hi)))
    painted = int(np.asarray(counts).sum())
    assert painted > 0 and dryrun["result"]["painted"] == painted
    assert f"painted={painted}," in dryrun["line"]
    np.testing.assert_array_equal(dryrun["got"]["rasters"]["fast"],
                                  np.asarray(rasters))


def _flip_raster_byte(got):
    r = got["rasters"]["compact"]
    f, c, y, x = np.argwhere(r > 0)[0]
    r[f, c, y, x] = 0
    return "compact==scatter"


def _shift_metric(got):
    got["metric_compact"]["sre_sum"] *= 1.001
    return "metric-compact ok"


def _change_a_ranks_totals(got):
    got["multihost"][1]["totals"]["n_hit"] += 1.0
    return "dcn-2proc ok"


@pytest.mark.parametrize("corrupt", [_flip_raster_byte, _shift_metric,
                                     _change_a_ranks_totals],
                         ids=["raster-byte", "metric", "multihost"])
def test_run_checks_raises_on_a_corrupted_payload(dryrun, corrupt):
    assert g.run_checks(dryrun["got"], dryrun["want"]) == _jax_check_names()
    got = copy.deepcopy(dryrun["got"])
    name = corrupt(got)
    with pytest.raises(RuntimeError, match=f"{name} failed"):
        g.run_checks(got, dryrun["want"])


@pytest.mark.parametrize("n, clusters", [(1, [(1, "gloo"), (2, "gloo")]),
                                         (3, [(3, "gloo"), (2, "gloo")])])
def test_dryrun_one_and_odd_ranks(tmp_path, monkeypatch, capsys, n, clusters):
    """One rank: a world of one, and the multihost job on two ranks, as the
    JAX dryrun's two processes; three: the ('frames', 'points') mesh (3, 1)
    on three ranks, the scene and hosts meshes (2, 1) on a cluster of
    two.  The JAX layouts, the same ten checks."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    result = g.dryrun_multichip(n, "cpu", workdir=str(tmp_path))
    assert result["clusters"] == clusters
    assert result["checks"] == _jax_check_names()
    assert result["mesh"] == {"frames": n, "points": 1}
    assert result["hosts"] == ({"hosts": 1, "local": 1} if n == 1
                               else {"hosts": 2, "local": 1})
    assert result["rasters"] == (2 * n, 6, 96, 128)
    assert capsys.readouterr().out.startswith("dryrun_multichip ok: mesh ")
