"""One rank of a local multi-rank run of cama_tpu_torch.parallel.

    python -m cama_tpu_torch.tools.mesh_child PLAN.json RANK

PLAN.json holds {"world": N, "port": P, "backend": "gloo", "nccl" or
null, "device": "cpu", "cuda" or "cuda:I" (or a list of these, one per
rank), "out": DIR, "jobs": [...]}.  Every rank joins the world through
multihost.initialize (a world of one rank starts a process group of its own
when the plan names a backend), then runs the same jobs in the same order,
so their collectives pair up.  Each job builds its
mesh and step, runs it on the global host arrays of an .npz file, and
rank 0 writes what the job gathered to DIR/<name>.npz.  Every rank prints
one JSON line last: per job, its times (CUDA events on a card, the host
clock on the CPU), the kernels' launch counts, a raised error's message
or the job's small results, and, for the whole run, the modules of jax or
of the JAX package cama_tpu it loaded (none is expected).

Job kinds (the fields each reads beside "kind" and "name"):
  overlay      inputs, shape [f, p], kernel, k, k1, reps: a
               sharded_overlay_step; saves rasters [F, C, H, W], counts;
               with "collective": true also times a bare all_reduce(MAX)
               of the step's packed raster shape over the points group
  overflow     inputs, shape, kernel, k: the same step with a list that
               overflows on some rank; records whether this rank raised
  multi_scene  inputs, shape [s, f], k: sharded_multi_scene_step; saves
               rasters [S, F, C, H, W]
  map_metrics  inputs (with gt), shape [f, p], max_radius, tolerance,
               distance, k1: sharded_map_metrics' totals
  scene_metrics  the same over a scene mesh: sharded_scene_batch_metrics,
               per-scene sums gathered over 'scenes'
  evaluate     clips, shape [s, f], chunk, tolerance, max_radius, size,
               output_size: MapEvaluator.evaluate_scene_batch_sharded
               (size: run each pipeline's counting pass first, which sizes
               the crop compaction; output_size: compile the scenes at
               that (h, w) instead of the default)
  cross_host_sum  hosts [h, l], sums_of (an earlier job's name) or sums:
               that job's metric sums (or the sums given), split evenly
               over h hosts with a scene counter, through
               cross_host_metric_sum on virtual_hosts_mesh(h, l); returns
               the per-host partials and the summed totals
  multihost    the cross-host pieces: assign_scenes, run_local_scenes with
               a failing scene, reduce_metric_partials,
               cross_host_metric_sum and allgather_host_results on
               global_mesh, and the scene-batched overlay and metric steps
               with each scene's frames on different ranks, against the
               same programs run whole on this rank

Launched by cama_tpu_torch.parallel.cluster.run_local_cluster.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time


def _timed(fn, dev):
    """(fn(), ms): CUDA events on a card, the host clock on the CPU."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end)


class _Run:
    """A rank's state across jobs: its device, rank, output directory and
    one mesh per layout (building a mesh creates process groups, which
    every rank must do alike)."""

    def __init__(self, plan, rank):
        from cama_tpu_torch.parallel.sharding import rank_device

        self.rank = rank
        self.out = plan["out"]
        device = plan.get("device", "cuda")
        self.device_arg = device[rank] if isinstance(device, list) else device
        self.dev = rank_device(self.device_arg)
        self._meshes = {}
        self._inputs = {}
        self.results = {}  # job name -> what the job returned, in order

    def mesh(self, axes, shape):
        from cama_tpu_torch.parallel.sharding import Mesh

        key = (tuple(axes), tuple(shape))
        if key not in self._meshes:
            self._meshes[key] = Mesh(axes, shape, self.device_arg)
        return self._meshes[key]

    def inputs(self, path):
        import numpy as np

        if path not in self._inputs:
            with np.load(path) as z:
                self._inputs[path] = {k: z[k] for k in z.files}
        return self._inputs[path]

    def save(self, name, **arrays):
        import numpy as np

        if self.rank == 0:
            np.savez(os.path.join(self.out, f"{name}.npz"),
                     **{k: v.cpu().numpy() for k, v in arrays.items()})


def _overlay_args(a):
    return (a["points"], a["valid"], a["cls"], a["A"], a["B"], a["fv"],
            a["lo"], a["hi"])


def _launches():
    from cama_tpu_torch.ops import fused_compact, paint, pallas_project

    return {**fused_compact.LAUNCHES, **pallas_project.LAUNCHES,
            **paint.LAUNCHES}


def _reset_launches():
    from cama_tpu_torch.ops import fused_compact, paint, pallas_project

    for mod in (fused_compact, pallas_project, paint):
        mod.reset_launches()


def job_overlay(run, job):
    import torch
    import torch.distributed as dist

    from cama_tpu_torch.parallel.sharding import sharded_overlay_step

    a = run.inputs(job["inputs"])
    mesh = run.mesh(("frames", "points"), job["shape"])
    w, h = int(a["width"]), int(a["height"])
    step = sharded_overlay_step(mesh, w, h, job["kernel"], k=job.get("k"),
                                k1=job.get("k1"))
    args = _overlay_args(a)
    _reset_launches()
    ms = []
    for _ in range(job.get("reps", 1)):
        (rasters, counts), t = _timed(lambda: step(*args), run.dev)
        ms.append(t)
    out = {"ms": ms, "launches": _launches()}
    run.save(job["name"], rasters=mesh.gather(rasters, "frames"),
             counts=counts)
    if job.get("collective"):
        packed = torch.zeros(rasters.shape, dtype=torch.int32,
                             device=run.dev)
        times = [_timed(lambda: mesh.all_reduce(
            packed, dist.ReduceOp.MAX, ("points",)), run.dev)[1]
            for _ in range(job.get("reps", 1))]
        out["allreduce_ms"] = statistics.median(times)
        out["allreduce_bytes"] = packed.numel() * 4
    return out


def job_overflow(run, job):
    import torch

    from cama_tpu_torch.ops.fused_compact import count_union
    from cama_tpu_torch.parallel.sharding import _shard, sharded_overlay_step

    a = run.inputs(job["inputs"])
    mesh = run.mesh(("frames", "points"), job["shape"])
    w, h = int(a["width"]), int(a["height"])
    pts, valid, cls, A, B, fv, lo, hi = _overlay_args(a)
    local = [_shard(mesh, x, spec, dt) for x, spec, dt in (
        (pts, ("points", None), torch.float32),
        (valid, ("points",), torch.bool), (cls, ("points",), torch.int32),
        (A, ("frames",), torch.float32), (B, ("frames",), torch.float32),
        (fv, ("frames",), torch.bool))]
    local_max = int(count_union(*local, w, h, lo, hi).max())
    step = sharded_overlay_step(mesh, w, h, job["kernel"], k=job["k"])
    try:
        step(pts, valid, cls, A, B, fv, lo, hi)
    except RuntimeError as e:
        return {"raised": True, "message": str(e), "local_max": local_max}
    return {"raised": False, "message": "", "local_max": local_max}


def job_multi_scene(run, job):
    from cama_tpu_torch.parallel.sharding import sharded_multi_scene_step

    a = run.inputs(job["inputs"])
    mesh = run.mesh(("scenes", "frames"), job["shape"])
    step = sharded_multi_scene_step(mesh, int(a["width"]), int(a["height"]),
                                    job["k"])
    _reset_launches()
    out, ms = _timed(lambda: step(*_overlay_args(a)), run.dev)
    by_frames = mesh.gather(out.transpose(0, 1).contiguous(), "frames")
    run.save(job["name"], rasters=mesh.gather(
        by_frames.transpose(0, 1).contiguous(), "scenes"))
    return {"ms": [ms], "launches": _launches()}


def _metric_args(a):
    return (a["points"], a["valid"], a["gt"], a["A"], a["B"], a["fv"],
            a["lo"], a["hi"])


def job_map_metrics(run, job):
    from cama_tpu_torch.parallel.sharding import sharded_map_metrics

    a = run.inputs(job["inputs"])
    mesh = run.mesh(("frames", "points"), job["shape"])
    step = sharded_map_metrics(mesh, int(a["width"]), int(a["height"]),
                               job["max_radius"], job["tolerance"],
                               job.get("distance", "chebyshev"),
                               k1=job.get("k1"))
    sums, ms = _timed(lambda: step(*_metric_args(a)), run.dev)
    return {"ms": [ms], "sums": {k: float(v) for k, v in sums.items()}}


def job_scene_metrics(run, job):
    from cama_tpu_torch.parallel.sharding import sharded_scene_batch_metrics

    a = run.inputs(job["inputs"])
    mesh = run.mesh(("scenes", "frames"), job["shape"])
    step = sharded_scene_batch_metrics(
        mesh, int(a["width"]), int(a["height"]), job["max_radius"],
        job["tolerance"], job.get("distance", "chebyshev"), k1=job.get("k1"))
    sums, ms = _timed(lambda: step(*_metric_args(a)), run.dev)
    return {"ms": [ms], "sums": {k: mesh.gather(v, "scenes").tolist()
                                 for k, v in sums.items()}}


def job_evaluate(run, job):
    from cama_tpu_torch.eval.map_metrics import MapEvaluator
    from cama_tpu_torch.io.scene import compile_scene
    from cama_tpu_torch.pipeline import ClipPipeline

    source = job.get("source", "cama")
    size = job.get("output_size")
    pipes = [ClipPipeline(
        clip_path=c, chunk=job.get("chunk", 8), device=run.dev,
        scene=size and compile_scene(c, output_size=tuple(size)))
        for c in job["clips"]]
    if job.get("size"):
        for p in pipes:
            p.overlay_mode(source)
    ev = MapEvaluator(tolerance=job["tolerance"],
                      max_radius=job["max_radius"])
    mesh = run.mesh(("scenes", "frames"), job["shape"])
    results, ms = _timed(
        lambda: ev.evaluate_scene_batch_sharded(pipes, mesh, source),
        run.dev)
    return {"ms": [ms], "results": results,
            "step_keys": [repr(k[0]) for k in ev._sharded_steps],
            "k1": [k[-1] for k in ev._sharded_steps]}


def job_cross_host_sum(run, job):
    """cross_host_metric_sum over a ('hosts', 'local') mesh of the sizes
    given, on partials made as the JAX package's dryrun makes them: each
    host holds an even share of an earlier job's metric sums, plus one
    scene."""
    from cama_tpu_torch.parallel import multihost

    n_hosts, per_host = job["hosts"]
    sums = job.get("sums") or run.results[job["sums_of"]]["sums"]
    mesh = multihost.virtual_hosts_mesh(n_hosts, per_host, run.device_arg)
    partials = [{**{k: v / n_hosts for k, v in sums.items()},
                 "n_scenes": 1.0} for _ in range(n_hosts)]
    summed, ms = _timed(lambda: multihost.cross_host_metric_sum(
        mesh, list(partials[0]))(partials), run.dev)
    return {"ms": [ms], "partials": partials, "summed": summed}


def job_multihost(run, job):
    """The cross-host tier across this world's ranks, one rank per host
    (the port's form of the JAX package's two-process check)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cama_tpu_torch.eval.map_metrics import PARTIAL_KEYS
    from cama_tpu_torch.parallel import multihost
    from cama_tpu_torch.parallel.sharding import (
        _metric_projection, sharded_multi_scene_step,
        sharded_scene_batch_metrics)
    from cama_tpu_torch.pipeline import _overlay_chunk_compact

    n, pid = dist.get_world_size(), dist.get_rank()
    mesh = multihost.global_mesh(run.device_arg)
    if mesh.shape != {"hosts": n, "local": 1}:
        raise RuntimeError(f"global mesh {mesh.shape}")

    # host-level scene sharding with failure isolation: scene 'c' fails on
    # whichever host owns it, the batch keeps going
    scenes = ["a", "b", "c", "d", "e"]
    mine = multihost.assign_scenes(scenes)
    if mine != scenes[pid::n]:
        raise RuntimeError(f"assign_scenes gave {mine}")

    def process(scene):
        if scene == "c":
            raise RuntimeError("boom")
        return {"n_hit": float(ord(scene)), "n_points": 2.0}

    results, failures = multihost.run_local_scenes(scenes, process)
    local = {"n_hit": sum(r["n_hit"] for r in results.values()),
             "n_points": sum(r["n_points"] for r in results.values())}
    totals = multihost.reduce_metric_partials(local, ["n_hit", "n_points"])
    hosts_sum = multihost.cross_host_metric_sum(mesh, ["x", "y"])(
        [{"x": 1.5 * (i + 1), "y": 100.0 * (i + 1)} for i in range(n)])
    gathered = multihost.allgather_host_results(
        np.arange(3, dtype=np.float32) + 10 * pid)

    # the scene-batched overlay and metric steps with each scene's frames
    # on different ranks (the frames all_reduce crosses processes),
    # against the same programs run whole on this rank; every rank draws
    # the same inputs from one seed
    S, F, C, P, H, W = 2, n, 2, 256, 24, 32
    sc_mesh = run.mesh(("scenes", "frames"), (1, n))
    rng = np.random.default_rng(7)
    pts = rng.uniform(-8, 8, (S, P, 3)).astype(np.float32)
    pvalid = rng.random((S, P)) < 0.9
    cls_ids = rng.integers(0, 3, (S, P)).astype(np.int32)
    A = np.tile(np.eye(4, dtype=np.float32), (S, F, 1, 1))
    A[..., :3, 3] = rng.uniform(-1, 1, (S, F, 3)).astype(np.float32)
    Bm = rng.normal(size=(S, F, C, 3, 4)).astype(np.float32)
    Bm[..., 2, :3] = 0.0
    Bm[..., 2, 3] = 1.0  # z row -> constant positive depth
    fvs = np.ones((S, F), bool)
    lo = np.full(3, -50.0, np.float32)
    hi = np.full(3, 50.0, np.float32)
    gt = rng.random((S, F, C, H, W)) < 0.05
    k = 256
    dev = run.dev

    def t(x, dtype):
        return torch.as_tensor(x).to(dev, dtype)

    rasters = sharded_multi_scene_step(sc_mesh, W, H, k)(
        pts, pvalid, cls_ids, A, Bm, fvs, lo, hi)  # [S, 1, C, H, W]
    rasters_ok = all(
        torch.equal(rasters[s, 0], _overlay_chunk_compact(
            t(pts[s], torch.float32), t(pvalid[s], torch.bool),
            t(cls_ids[s], torch.int32), t(A[s, pid:pid + 1], torch.float32),
            t(Bm[s, pid:pid + 1], torch.float32),
            t(fvs[s, pid:pid + 1], torch.bool), lo, hi, W, H, k,
            False)[0][0])
        for s in range(S))
    got = sharded_scene_batch_metrics(sc_mesh, W, H, 3, 1)(
        pts, pvalid, gt, A, Bm, fvs, lo, hi)
    from cama_tpu_torch.eval.map_metrics import frame_metrics

    metrics_ok = True
    for s in range(S):
        want = dict.fromkeys(PARTIAL_KEYS, 0.0)
        for f in range(F):
            vu, keep, _ = _metric_projection(
                t(pts[s], torch.float32), t(pvalid[s], torch.bool),
                t(A[s, f:f + 1], torch.float32),
                t(Bm[s, f:f + 1], torch.float32),
                t(fvs[s, f:f + 1], torch.bool), W, H, lo, hi, None)
            m = frame_metrics(t(gt[s, f], torch.bool), vu[0], keep[0], 3, 1)
            for key in PARTIAL_KEYS:
                want[key] += float(m[key])
        for key in PARTIAL_KEYS:
            metrics_ok &= bool(np.isclose(float(got[key][s]), want[key],
                                          rtol=1e-6))
    return {"pid": pid, "totals": totals, "hosts_sum": hosts_sum,
            "gathered": gathered.tolist(),
            "failed_scenes": [f[0] for f in failures],
            "scene_rasters_ok": bool(rasters_ok),
            "scene_metrics_ok": bool(metrics_ok)}


JOBS = {"overlay": job_overlay, "overflow": job_overflow,
        "multi_scene": job_multi_scene, "map_metrics": job_map_metrics,
        "scene_metrics": job_scene_metrics, "evaluate": job_evaluate,
        "cross_host_sum": job_cross_host_sum, "multihost": job_multihost}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    plan_path, rank = argv[0], int(argv[1])
    with open(plan_path) as f:
        plan = json.load(f)

    import torch
    import torch.distributed as dist

    from cama_tpu_torch.parallel import multihost

    address = f"localhost:{plan['port']}"
    started = multihost.initialize(address, plan["world"], rank,
                                   backend=plan.get("backend"))
    run = _Run(plan, rank)
    if plan["world"] == 1 and plan.get("backend"):
        # multihost.initialize starts no group for one process: this one
        # runs the steps' single-rank path under the backend named
        if run.dev.type == "cuda":
            torch.cuda.set_device(run.dev)
        dist.init_process_group(plan["backend"],
                                init_method=f"tcp://{address}",
                                world_size=1, rank=0)
        started = True
    payload = {"rank": rank, "world": plan["world"],
               "backend": dist.get_backend() if started else None,
               "device": str(run.dev), "jobs": run.results}
    t0 = time.perf_counter()
    for job in plan["jobs"]:
        run.results[job["name"]] = JOBS[job["kind"]](run, job)
    payload["seconds"] = time.perf_counter() - t0
    payload["modules"] = sorted(
        m for m in sys.modules if sys.modules[m] is not None
        and m.split(".")[0] in ("jax", "jaxlib", "cama_tpu"))
    if started:
        dist.barrier()
        dist.destroy_process_group()
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
