"""The port's cross-host tier (cama_tpu_torch.parallel.multihost) and its
local cluster launcher (cama_tpu_torch.parallel.cluster) on CPU.

The single-process pieces run in this process, as the JAX package's
tests/test_multihost.py runs them.  The real multi-process tier runs in 2-
and 3-rank gloo clusters (cama_tpu_torch.tools.mesh_child's 'multihost'
job, the port's form of tests/dcn_child.py): scene assignment with failure
isolation, the cross-rank reductions, and the scene-batched overlay and
metric steps with each scene's frames on different ranks.  The launcher's
hazards (teardown chatter, hung children, nonzero exits, inherited
rendezvous settings, chatty pipes) are pinned with cheap `python -c`
children that do not import torch, as tests/test_cluster.py pins the JAX
package's."""
import json
import os
import socket
import sys
import time

import numpy as np
import pytest

from cama_tpu_torch.parallel.cluster import (_last_json_line, free_port,
                                             run_local_cluster)
from cama_tpu_torch.parallel.multihost import (allgather_host_results,
                                               assign_scenes,
                                               cross_host_metric_sum,
                                               global_mesh, initialize,
                                               reduce_metric_partials,
                                               run_local_scenes,
                                               virtual_hosts_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable


def test_initialize_single_process_noop():
    assert initialize() is False
    assert initialize(num_processes=1) is False


def test_assign_scenes_round_robin():
    scenes = [f"s{i}" for i in range(7)]
    shards = [assign_scenes(scenes, process_index=i, process_count=3)
              for i in range(3)]
    assert shards[0] == ["s0", "s3", "s6"]
    assert shards[1] == ["s1", "s4"]
    assert shards[2] == ["s2", "s5"]
    assert sorted(sum(shards, [])) == sorted(scenes)
    # one process without a process group is the whole world
    assert assign_scenes(scenes) == scenes


def test_run_local_scenes_failure_isolation():
    def process(scene):
        if scene == "bad":
            raise RuntimeError("boom")
        return len(scene)

    results, failures = run_local_scenes(
        ["a", "bad", "ccc"], process, process_index=0, process_count=1)
    assert results == {"a": 1, "ccc": 3}
    assert len(failures) == 1 and failures[0][0] == "bad"


def test_global_mesh_single_process():
    mesh = global_mesh(device="cpu")
    assert mesh.shape == {"hosts": 1, "local": 1}
    assert mesh.ranks == (0,) and mesh.coord("hosts") == 0
    with pytest.raises(ValueError, match="need 4 ranks, have 1"):
        virtual_hosts_mesh(2, per_host=2, device="cpu")


def test_cross_host_metric_sum_single_host():
    mesh = virtual_hosts_mesh(1, device="cpu")
    reducer = cross_host_metric_sum(mesh, ["sre_sum", "n_points"])
    assert reducer([{"sre_sum": 1.5, "n_points": 100.0}]) == {
        "n_points": 100.0, "sre_sum": 1.5}
    with pytest.raises(ValueError, match="2 partials for 1 hosts"):
        reducer([{}, {}])


def test_allgather_single_process_identity():
    out = allgather_host_results(np.array([1.0, 2.0]))
    assert out.shape == (1, 2)
    np.testing.assert_array_equal(out[0], [1.0, 2.0])


def test_reduce_metric_partials_single_process():
    out = reduce_metric_partials({"sre_sum": 3.5, "n_points": 10.0},
                                 ["sre_sum", "n_points", "n_hit"])
    assert out == {"n_hit": 0.0, "n_points": 10.0, "sre_sum": 3.5}


@pytest.mark.parametrize("n_procs", [2, 3])
def test_multi_process_cluster(tmp_path, n_procs):
    """n gloo ranks, one per host: every rank converges on the same global
    totals, exactly one host isolates the failing scene, and the
    scene-batched overlay and metric steps whose frames all_reduce crosses
    processes match the same programs run whole on each rank."""
    plan = {"world": n_procs, "port": free_port(), "backend": "gloo",
            "device": "cpu", "out": str(tmp_path),
            "jobs": [{"kind": "multihost", "name": "mh"}]}
    with open(tmp_path / "plan.json", "w") as f:
        json.dump(plan, f)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    outs = run_local_cluster(
        [[PY, "-m", "cama_tpu_torch.tools.mesh_child",
          str(tmp_path / "plan.json"), str(r)] for r in range(n_procs)],
        env=env, timeout=300)
    jobs = [o["jobs"]["mh"] for o in outs]
    assert [j["pid"] for j in jobs] == list(range(n_procs))
    want_hit = float(sum(ord(s) for s in "abde"))
    for j in jobs:
        assert j["totals"] == {"n_hit": want_hit, "n_points": 8.0}
        assert j["hosts_sum"] == {
            "x": sum(1.5 * (i + 1) for i in range(n_procs)),
            "y": sum(100.0 * (i + 1) for i in range(n_procs))}
        assert j["gathered"] == [[10.0 * i + c for c in range(3)]
                                 for i in range(n_procs)]
        assert j["scene_rasters_ok"] and j["scene_metrics_ok"], j
    assert sorted(sum((j["failed_scenes"] for j in jobs), [])) == ["c"]
    assert all(o["modules"] == [] and o["backend"] == "gloo" for o in outs)


# ---- the launcher (children are plain `python -c`, no torch) ----


def test_free_port_is_bindable():
    port = free_port()
    s = socket.socket()
    s.bind(("localhost", port))  # would raise if the port were taken
    s.close()


def test_last_json_line_takes_last_valid_object():
    out = '{"first": 1}\nnot json\n{"second": 2}\nGloo teardown chatter\n'
    assert _last_json_line(out) == {"second": 2}


def test_last_json_line_skips_unparseable_braces():
    # a line starting with '{' that is NOT valid JSON must not shadow the
    # real payload above it
    out = '{"payload": true}\n{broken brace line\n'
    assert _last_json_line(out) == {"payload": True}


def test_last_json_line_none_when_no_json():
    assert _last_json_line("hello\nworld\n") is None


def test_run_local_cluster_collects_payloads_in_order():
    cmds = [[PY, "-c", f'print("noise"); print(\'{{"rank": {i}}}\')']
            for i in range(3)]
    outs = run_local_cluster(cmds)
    assert [o["rank"] for o in outs] == [0, 1, 2]


def test_child_env_drops_rendezvous_settings():
    """A child takes its rank, world and device from its argv: the
    rendezvous variables a launcher may have set in the parent are
    dropped, everything else is kept."""
    dropped = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
               "LOCAL_RANK", "LOCAL_WORLD_SIZE")
    env = {**os.environ, **{k: "7" for k in dropped},
           "CAMA_TEST_MARKER": "kept", "CUDA_VISIBLE_DEVICES": "0"}
    code = ("import os, json; print(json.dumps({k: os.environ.get(k) for k "
            f"in {dropped + ('CAMA_TEST_MARKER', 'CUDA_VISIBLE_DEVICES')}}}))")
    (out,) = run_local_cluster([[PY, "-c", code]], env=env)
    assert out == {**dict.fromkeys(dropped), "CAMA_TEST_MARKER": "kept",
                   "CUDA_VISIBLE_DEVICES": "0"}


def test_nonzero_exit_raises_with_streams_and_kills_siblings():
    # child 0 fails fast; child 1 would sleep well past the test budget:
    # the launcher must kill it rather than wait out its sleep
    fail = [PY, "-c", "import sys; print('partial'); "
            "sys.stderr.write('boom\\n'); sys.exit(3)"]
    sleeper = [PY, "-c", "import time; time.sleep(600)"]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        run_local_cluster([fail, sleeper], timeout=120)
    assert time.monotonic() - t0 < 60, "sleeper sibling was not killed"
    msg = str(e.value)
    assert "exited 3" in msg and "partial" in msg and "boom" in msg


def test_timeout_kills_whole_cluster():
    sleeper = [PY, "-c", "import time; time.sleep(600)"]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="hung past"):
        run_local_cluster([sleeper, sleeper], timeout=2)
    # both children killed: well under the 600 s sleep
    assert time.monotonic() - t0 < 60


def test_missing_payload_raises():
    quiet = [PY, "-c", "print('no json here')"]
    with pytest.raises(RuntimeError, match="no JSON payload"):
        run_local_cluster([quiet])


def test_chatty_child_does_not_deadlock():
    """A child that writes far more than the OS pipe buffer (~64 KB) to
    stderr must not stall the cluster: pipes drain concurrently."""
    chatty = [PY, "-c",
              "import sys, json; sys.stderr.write('x' * 300_000); "
              "print(json.dumps({'ok': 1}))"]
    quiet = [PY, "-c", "import json; print(json.dumps({'ok': 2}))"]
    t0 = time.monotonic()
    outs = run_local_cluster([chatty, quiet], timeout=60)
    assert time.monotonic() - t0 < 30, "chatty child stalled the drain"
    assert [o["ok"] for o in outs] == [1, 2]
