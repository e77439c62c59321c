"""Scene sharding across processes, with real processes: the counterpart
of examples/demo_multihost.py.

Spawns an N-process torch.distributed cluster over gloo
(cama_tpu_torch.parallel.cluster): each process owns a shard of the scene
list, compiles its scenes, runs the map evaluator on them on its device,
and the per-scene metric partials are summed across processes
(parallel.multihost.reduce_metric_partials), so every process ends with
the same totals.  Scenes never cross processes; only O(#metrics) floats do.
gloo carries the collective because several ranks may share one card,
which NCCL refuses.

    python -m cama_tpu_torch.examples.demo_multihost [n_processes]
        [--device cuda|cpu] [--workdir DIR]

Three fixture scenes are built anew under --workdir (default
build/demo_multihost in the checkout).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCENES = [f"scene-{i}" for i in range(3)]  # over n ranks: an uneven shard
KEYS = ["sre_sum", "n_hit", "n_points", "gt_covered", "gt_total"]


def child(pid, n, port, workdir, device):
    """One rank: its scenes' metric partials, summed over the cluster."""
    import torch

    from cama_tpu_torch.eval.map_metrics import MapEvaluator, reduce_metrics
    from cama_tpu_torch.parallel import multihost
    from cama_tpu_torch.pipeline import ClipPipeline

    multihost.initialize(f"localhost:{port}", n, pid, backend="gloo")

    def process(scene):
        """Per-scene metric partials (plain sums: they add up across
        processes as across frames), the totals behind the scene's
        evaluate_scene ratios."""
        pipe = ClipPipeline(clip_path=os.path.join(workdir, scene), chunk=4,
                            device=device)
        r = MapEvaluator(tolerance=4).evaluate_scene(pipe, "cama")
        if not r["frames_evaluated"]:
            return {}
        return {"sre_sum": r["SRE"] * r["n_points"],
                "n_hit": r["precision"] * r["n_points"],
                "n_points": r["n_points"], "gt_total": r["gt_pixels"],
                "gt_covered": r["recall"] * r["gt_pixels"]}

    results, failures = multihost.run_local_scenes(SCENES, process)
    local = {}
    for part in results.values():
        for k, v in part.items():
            local[k] = local.get(k, 0.0) + v
    final = reduce_metrics([multihost.reduce_metric_partials(local, KEYS)])
    print(json.dumps({
        "process": pid, "my_scenes": sorted(results), "failures": failures,
        "global": {k: round(float(v), 6) for k, v in final.items()},
    }), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", nargs="?", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--workdir", default=os.path.join(
        REPO, "build", "demo_multihost"))
    parser.add_argument("--child", nargs=4, default=None,
                        metavar=("RANK", "WORLD", "PORT", "WORKDIR"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        pid, n, port, workdir = args.child
        child(int(pid), int(n), port, workdir, args.device)
        return 0

    from cama_tpu_torch.io.fixture import add_instance_masks, make_fixture_clip
    from cama_tpu_torch.parallel.cluster import free_port, run_local_cluster
    from cama_tpu_torch.pipeline import resolve_device

    resolve_device(args.device)  # a loud error before any child starts
    workdir = args.workdir
    shutil.rmtree(workdir, ignore_errors=True)
    for i, name in enumerate(SCENES):
        add_instance_masks(make_fixture_clip(
            workdir, scene_name=name, n_frames=4, with_images=False,
            with_lidar=False, seed=i))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    port = str(free_port())
    try:
        outs = run_local_cluster(
            [[sys.executable, "-m", "cama_tpu_torch.examples.demo_multihost",
              "--device", args.device, "--child", str(i), str(args.n), port,
              workdir] for i in range(args.n)], env=env, timeout=600)
    except RuntimeError as e:
        print(e)
        return 1
    for o in outs:
        print(f"process {o['process']}: scenes {o['my_scenes']} -> "
              f"global {o['global']}")
    agree = all(o["global"] == outs[0]["global"] for o in outs)
    covered = sorted(sum((o["my_scenes"] for o in outs), []))
    print(f"all {args.n} processes agree on the global metrics: {agree}; "
          f"scenes covered: {covered}")
    return 0 if agree and covered == SCENES else 1


if __name__ == "__main__":
    raise SystemExit(main())
