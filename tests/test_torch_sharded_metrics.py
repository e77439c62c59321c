"""The port's sharded metric steps and
MapEvaluator.evaluate_scene_batch_sharded against the JAX package's on CPU.
One module-scoped cluster of four gloo ranks
(cama_tpu_torch.tools.mesh_child) runs the port's steps on the same
global host arrays the JAX steps get on four of the conftest's virtual CPU
devices; the sharded fleet evaluation runs in the same cluster, every rank
loading only its own shard's ground truth.  Integer-valued partials (point,
hit and pixel counts) match exactly, sre_sum within 1e-6 relative (the
partial sums add in another order); the fleet results match the port's
single-device evaluate_scene_batch and the JAX package's sharded evaluator
within 1e-4, with equal counts."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cama_tpu.eval.map_metrics import MapEvaluator as JMapEvaluator
from cama_tpu.io.scene import compile_scene as jcompile_scene
from cama_tpu.parallel import make_mesh as jmake_mesh
from cama_tpu.parallel import make_scene_mesh as jmake_scene_mesh
from cama_tpu.parallel.sharding import sharded_map_metrics as jmap_metrics
from cama_tpu.parallel.sharding import (
    sharded_scene_batch_metrics as jscene_metrics)
from cama_tpu.pipeline import ClipPipeline as JClipPipeline
from cama_tpu_torch.eval.map_metrics import PARTIAL_KEYS, MapEvaluator
from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.parallel import make_scene_mesh
from cama_tpu_torch.parallel.cluster import free_port, run_local_cluster
from cama_tpu_torch.pipeline import ClipPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (270, 480)  # output size of the fleets' scenes
TOL, RAD = 4, 16
RANKS = 4
RESULT_KEYS = ("SRE", "precision", "recall", "f1")
COUNT_KEYS = ("n_points", "gt_pixels", "frames_evaluated")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test suite runs several worker processes at once; one intra-op
    torch thread in this one keeps torch's CPU ops from oversubscribing the
    cores (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic(seed, S=None):
    """Small seeded metric inputs (the JAX package's own test shapes): F=4
    frames, C=2 cameras of 16 x 24, P=128 points; with S, a scene axis."""
    F, C, H, W, P = 4, 2, 16, 24, 128
    rng = np.random.default_rng(seed)
    points = rng.uniform(-8, 8, (P, 3)).astype(np.float32)
    valid = rng.random(P) > 0.1
    A = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    A[:, :3, 3] = rng.normal(0, 2, (F, 3)).astype(np.float32)
    B = rng.uniform(-1, 1, (F, C, 3, 4)).astype(np.float32)
    a = {"points": points, "valid": valid, "A": A, "B": B,
         "gt": rng.random((F, C, H, W)) < 0.1, "fv": np.ones(F, bool),
         "lo": np.full(3, -4.0, np.float32), "hi": np.full(3, 4.0, np.float32),
         "width": W, "height": H}
    if S is None:
        return a
    return {**a, "points": np.stack([points + 0.5 * s for s in range(S)]),
            "valid": np.stack([valid] * S), "A": np.stack([A] * S),
            "B": np.stack([B] * S),
            "gt": rng.random((S, F, C, H, W)) < 0.1,
            "fv": np.ones((S, F), bool)}


MAP_CASES = [("chebyshev", None), ("chebyshev", 64), ("euclidean", None),
             ("euclidean", 64)]


def _fleet(root, name, n, **kw):
    clips = []
    for i in range(n):
        c = make_fixture_clip(root, scene_name=f"{name}{i}", with_images=False,
                              with_lidar=False, seed=i, **kw)
        add_instance_masks(c)
        clips.append(c)
    return clips


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tshmet")
    single = _synthetic(3)
    scenes = _synthetic(5, S=2)
    np.savez(root / "map.npz", **single)
    np.savez(root / "scenes.npz", **scenes)
    fleet = _fleet(root, "scene-fl", 3, n_frames=5)
    wide = _fleet(root, "sw-", 2, n_frames=4, label_span=(-290.0, 210.0))

    # the port's single-device references, computed first: they also write
    # each clip's ground-truth store and counts sidecar, which the ranks
    # then only read
    def pipes(clips, chunk):
        return [ClipPipeline(clip_path=c, chunk=chunk, device="cpu",
                             scene=compile_scene(c, output_size=SIZE))
                for c in clips]

    ref_fleet = MapEvaluator(TOL, RAD).evaluate_scene_batch(
        pipes(fleet, 4), "cama")
    wide_pipes = pipes(wide, 2)
    for p in wide_pipes:
        p.overlay_mode("cama")  # sizes the crop compaction
        assert p.crop_compact_k("cama") is not None
    ref_wide = MapEvaluator(TOL, RAD, compact="off").evaluate_scene_batch(
        wide_pipes, "cama")

    jobs = [{"kind": "map_metrics", "name": f"map_{d}_{k1}",
             "inputs": str(root / "map.npz"), "shape": [4, 1],
             "max_radius": 8, "tolerance": 3, "distance": d, "k1": k1}
            for d, k1 in MAP_CASES]
    jobs += [{"kind": "scene_metrics", "name": f"scenes_{k1}",
              "inputs": str(root / "scenes.npz"), "shape": [2, 2],
              "max_radius": 8, "tolerance": 3, "k1": k1}
             for k1 in (None, 64)]
    # both scenes on every rank: one scene shard, the frames over four
    jobs += [{"kind": "scene_metrics", "name": "scenes_64_1x4",
              "inputs": str(root / "scenes.npz"), "shape": [1, 4],
              "max_radius": 8, "tolerance": 3, "k1": 64}]
    jobs += [{"kind": "evaluate", "name": "fleet", "clips": fleet,
              "shape": [2, 2], "chunk": 4, "tolerance": TOL,
              "max_radius": RAD, "output_size": list(SIZE)},
             {"kind": "evaluate", "name": "wide", "clips": wide,
              "shape": [2, 2], "chunk": 2, "tolerance": TOL,
              "max_radius": RAD, "output_size": list(SIZE), "size": True}]
    plan = {"world": RANKS, "port": free_port(), "backend": "gloo",
            "device": "cpu", "out": str(root), "jobs": jobs}
    with open(root / "plan.json", "w") as f:
        json.dump(plan, f)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    payloads = run_local_cluster(
        [[sys.executable, "-m", "cama_tpu_torch.tools.mesh_child",
          str(root / "plan.json"), str(r)] for r in range(RANKS)],
        env=env, timeout=400)
    return {"single": single, "scenes": scenes, "fleet": fleet,
            "wide": wide, "wide_pipes": wide_pipes, "ref_fleet": ref_fleet,
            "ref_wide": ref_wide,
            "payloads": payloads}


def _args(a):
    return [jnp.asarray(a[k]) for k in ("points", "valid", "gt", "A", "B",
                                         "fv", "lo", "hi")]


def _assert_partials(got, want):
    """sre_sum within 1e-6 relative, the integer-valued partials exact."""
    for key in PARTIAL_KEYS:
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key],
                                                            np.float64)
        if key == "sre_sum":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _same_on_every_rank(run, name, field):
    values = [p["jobs"][name][field] for p in run["payloads"]]
    assert all(v == values[0] for v in values[1:]), values
    return values[0]


@pytest.mark.parametrize("distance,k1", MAP_CASES)
def test_sharded_map_metrics_match_jax(run, distance, k1):
    """sharded_map_metrics on a (4, 1) ('frames', 'points') mesh, full-P
    and crop-compacted to k1: the same totals on every rank, equal to the
    JAX package's step on the same arrays."""
    a = run["single"]
    got = _same_on_every_rank(run, f"map_{distance}_{k1}", "sums")
    want = jmap_metrics(jmake_mesh(4, 1), a["width"], a["height"], 8, 3,
                        distance=distance, k1=k1)(*_args(a))
    _assert_partials(got, {k: float(v) for k, v in want.items()})
    assert got["n_points"] > 0 and got["gt_total"] > 0


@pytest.mark.parametrize("shape,k1", [
    pytest.param((2, 2), None, id="None"), pytest.param((2, 2), 64, id="64"),
    pytest.param((1, 4), 64, id="64-1x4")])
def test_sharded_scene_batch_metrics_match_jax(run, shape, k1):
    """sharded_scene_batch_metrics on a ('scenes', 'frames') mesh:
    per-scene partials gathered over 'scenes', equal to the JAX package's
    step; the compacted step equals the full one.  On the (1, 4) mesh each
    rank holds both scenes, whose crop counts meet in one check."""
    a = run["scenes"]
    name = f"scenes_{k1}" + ("" if shape == (2, 2) else "_1x4")
    got = _same_on_every_rank(run, name, "sums")
    want = jscene_metrics(jmake_scene_mesh(*shape), a["width"], a["height"],
                          8, 3, k1=k1)(*_args(a))
    _assert_partials(got, {k: np.asarray(v) for k, v in want.items()})
    _assert_partials(got, run["payloads"][0]["jobs"]["scenes_None"]["sums"])
    assert len(got["n_points"]) == 2


def _assert_results(got, want, tol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        for key in COUNT_KEYS:
            assert g[key] == w[key], key
        for key in RESULT_KEYS:
            np.testing.assert_allclose(g[key], w[key], atol=tol, err_msg=key)


def _jax_sharded(clips, chunk, **kw):
    jpipes = [JClipPipeline(clip_path=c, chunk=chunk,
                            scene=jcompile_scene(c, output_size=SIZE))
              for c in clips]
    return jpipes, JMapEvaluator(TOL, RAD, **kw)


def test_evaluate_scene_batch_sharded_matches_batch(run):
    """Three scenes over a (2, 2) mesh (the scene axis padded to four):
    the same list on every rank, equal to the port's single-device
    evaluate_scene_batch and to the JAX package's sharded evaluator; the
    step cache is keyed by the mesh's layout, never by id()."""
    got = _same_on_every_rank(run, "fleet", "results")
    assert all(g is not None and g["frames_evaluated"] > 0 for g in got)
    _assert_results(got, run["ref_fleet"])
    jpipes, jev = _jax_sharded(run["fleet"], 4)
    _assert_results(got, jev.evaluate_scene_batch_sharded(
        jpipes, jmake_scene_mesh(2, 2), "cama"))
    keys = run["payloads"][0]["jobs"]["fleet"]["step_keys"]
    assert keys == ["((('scenes', 2), ('frames', 2)), (0, 1, 2, 3), 'cpu')"]


def test_evaluate_scene_batch_sharded_compacted(run):
    """A wide fleet whose counting passes engaged the crop compaction: the
    sharded evaluator compacts (k1 set) and still matches the full-P
    single-device fleet evaluation and the JAX package's sharded one."""
    assert all(k is not None for k in run["payloads"][0]["jobs"]["wide"]["k1"])
    got = _same_on_every_rank(run, "wide", "results")
    _assert_results(got, run["ref_wide"])
    jpipes, jev = _jax_sharded(run["wide"], 2)
    for p in jpipes:
        p.overlay_mode("cama")
    _assert_results(got, jev.evaluate_scene_batch_sharded(
        jpipes, jmake_scene_mesh(2, 2), "cama"))


def test_evaluate_scene_batch_sharded_one_rank(run):
    """Without a process group, a 1 x 1 mesh runs the same program in this
    process (its collectives are identities), and the host backend, which
    has no mesh to shard over, refuses."""
    pipes = [ClipPipeline(clip_path=c, chunk=4, device="cpu",
                          scene=compile_scene(c, output_size=SIZE))
             for c in run["fleet"][:2]]
    mesh = make_scene_mesh(1, 1, device="cpu")
    got = MapEvaluator(TOL, RAD).evaluate_scene_batch_sharded(pipes, mesh)
    _assert_results(got, run["ref_fleet"][:2])
    with pytest.raises(ValueError, match="backend='host'"):
        MapEvaluator(TOL, RAD, backend="host").evaluate_scene_batch_sharded(
            pipes, mesh)


def test_evaluate_scene_batch_sharded_compacted_one_rank(run):
    """The counted wide fleet on a 1 x 1 mesh in this process: both scenes
    on the one rank with the crop compaction engaged (k1 set), equal to
    the full-P single-device fleet evaluation."""
    ev = MapEvaluator(TOL, RAD)
    got = ev.evaluate_scene_batch_sharded(
        run["wide_pipes"], make_scene_mesh(1, 1, device="cpu"), "cama")
    assert [key[-1] is not None for key in ev._sharded_steps] == [True]
    _assert_results(got, run["ref_wide"])


def test_sharded_step_cache_follows_process_groups(run):
    """A cached fleet step runs its collectives on the groups of the mesh
    it was built with: a later mesh of the same layout reuses it while the
    process group lives, and gets a step of its own once the group has
    been destroyed and started again."""
    import torch.distributed as dist

    pipes = [ClipPipeline(clip_path=c, chunk=4, device="cpu",
                          scene=compile_scene(c, output_size=SIZE))
             for c in run["fleet"][:2]]
    ev = MapEvaluator(TOL, RAD)
    built = []
    for _ in range(2):
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1)
        try:
            for _ in range(2):
                mesh = make_scene_mesh(1, 1, device="cpu")
                got = ev.evaluate_scene_batch_sharded(pipes, mesh)
                _assert_results(got, run["ref_fleet"][:2])
                (groups, step), = ev._sharded_steps.values()
                assert groups == (mesh.group("scenes"), mesh.group("frames"))
                built.append(step)
        finally:
            dist.destroy_process_group()
    assert built[0] is built[1] and built[2] is built[3]
    assert built[1] is not built[2]
