"""The driver-contract entry points on PyTorch.

Counterpart of the repository root's __graft_entry__.py, which drives the
JAX package:

    entry(device="cuda") -> (fn, args): fn is the single-device forward
        step of the dense overlay program, one launch of the fused CUDA
        kernel per chunk (project + crop + dedup + stable compaction), then
        the raster stage, on a chunk of tiny frames; args are its eight
        tensors on `device`.  fn(*args) -> class rasters [8, 6, 96, 128]
        uint8.
    dryrun_multichip(n_devices, device="cuda"): the ten sharded-program
        checks of the JAX dryrun, over torch.distributed ranks.

    python -m cama_tpu_torch.graft_entry [N] [--device cuda|cpu]

The JAX dryrun runs single-controller over a virtual device mesh; the port
is SPMD, so each check's program runs in a local cluster of N processes
(parallel.cluster.run_local_cluster over tools/mesh_child.py), one rank
per device, and this process compares what the ranks gathered with the
single-device programs.  Nothing here imports jax or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_CAP = 256  # the fused kernel's union list rows in entry()
KERNELS = ("fast", "compact", "two_stage", "fused")
MAX_RADIUS, TOLERANCE = 3, 1  # the metric steps' caps, as in the JAX dryrun


def _tiny_inputs(F=8, C=6, P=256, width=128, height=96, seed=0):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-20, 20, (P, 3)).astype(np.float32)
    valid = np.ones(P, bool)
    cls = rng.integers(0, 3, P).astype(np.int32)
    A = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    A[:, :3, 3] = rng.uniform(-2, 2, (F, 3)).astype(np.float32)
    # simple forward-looking pinhole per camera
    B = np.zeros((F, C, 3, 4), dtype=np.float32)
    K = np.array([[80.0, 0, width / 2], [0, 80.0, height / 2], [0, 0, 1.0]])
    for c in range(C):
        yaw = 2 * np.pi * c / C
        R = np.array(
            [[np.cos(yaw), -np.sin(yaw), 0], [0, 0, -1], [np.sin(yaw), np.cos(yaw), 0]]
        )
        E = np.eye(4)
        E[:3, :3] = R
        for f in range(F):
            B[f, c] = (K @ E[:3] @ A[f]).astype(np.float32)
    fv = np.ones(F, bool)
    lo = np.array([-50, -100, -200], np.float32)
    hi = np.array([50, 100, 200], np.float32)
    return points, valid, cls, A, B, fv, lo, hi, width, height


def entry(device="cuda"):
    """(fn, args): the dense overlay program on the fused kernel at width
    128, height 96 and k_cap 256, and its eight input tensors on `device`
    ('cuda' runs the CUDA kernel and raises without a card; 'cpu' the
    plain versions).  fn raises when a frame's union list needs more than
    k_cap rows (the JAX entry clamps such a list silently)."""
    from cama_tpu_torch.pipeline import (_check_lists, _overlay_chunk_fused,
                                         resolve_device)

    dev = resolve_device(device)
    points, valid, cls, A, B, fv, lo, hi, width, height = _tiny_inputs()

    def fn(points, valid, cls, A, B, fv, lo, hi):
        rasters, count = _overlay_chunk_fused(points, valid, cls, A, B, fv,
                                              lo, hi, width, height, K_CAP,
                                              False)
        _check_lists("entry", "fused", 0, count.cpu().numpy(), K_CAP)
        return rasters

    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (points, valid, cls, A, B, fv, lo, hi))
    return fn, args


def _layout(n_devices):
    """The JAX dryrun's meshes and sizes for n devices."""
    n_pts = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_sc = 2 if n_devices >= 2 else 1
    n_hosts = 2 if n_devices >= 2 else 1
    return {"mesh": (n_devices // n_pts, n_pts), "F": 2 * (n_devices // n_pts),
            "P": 256 * n_pts, "scene_mesh": (n_sc, n_devices // n_sc),
            "Fs": 2 * (n_devices // n_sc),
            "hosts": (n_hosts, n_devices // n_hosts)}


def _crop_k1(points, valid, A, lo, hi):
    """The crop compaction's k1, sized by the largest per-frame crop count
    as the JAX dryrun sizes it (the counting pass's rule)."""
    p4 = np.concatenate([points, np.ones((len(points), 1), np.float32)], 1)
    xyz = np.einsum("fij,pj->fpi", A[:, :3, :], p4)
    crop_max = int((((xyz >= lo) & (xyz <= hi)).all(-1)
                    & valid[None, :]).sum(axis=1).max())
    k1 = 8
    while k1 < crop_max:
        k1 *= 2
    return min(k1, points.shape[0])


def _inputs(n_devices):
    """The JAX dryrun's inputs, by its seeds: the overlay arrays, the
    ground truth of the metric step, the stacked scenes and their ground
    truth."""
    lay = _layout(n_devices)
    points, valid, cls, A, B, fv, lo, hi, width, height = _tiny_inputs(
        F=lay["F"], P=lay["P"])
    overlay = {"points": points, "valid": valid, "cls": cls, "A": A, "B": B,
               "fv": fv, "lo": lo, "hi": hi, "width": width,
               "height": height}
    S = lay["scene_mesh"][0]
    per_scene = [_tiny_inputs(F=lay["Fs"], P=256, seed=10 + i)
                 for i in range(S)]
    scenes = {key: np.stack([t[i] for t in per_scene]) for i, key in
              enumerate(("points", "valid", "cls", "A", "B", "fv"))}
    scenes.update(lo=lo, hi=hi, width=width, height=height)
    rng = np.random.default_rng(1)
    gt = rng.random((lay["F"], 6, height, width)) < 0.05
    gt_s = rng.random((S, lay["Fs"], 6, height, width)) < 0.05
    return overlay, {**overlay, "gt": gt}, scenes, {**scenes, "gt": gt_s}


def _metric_sums(points, valid, gt, A, B, fv, lo, hi, width, height, dev):
    """{key: float} of the metric partials summed frame by frame on one
    device: the single-device reference of the sharded metric steps."""
    from cama_tpu_torch.eval.map_metrics import PARTIAL_KEYS, frame_metrics
    from cama_tpu_torch.ops.geometry import project_frames

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(dev)

    vu, keep = project_frames(t(points), t(valid), t(A), t(B), t(fv), width,
                              height, lo, hi)
    gt = t(gt)
    want = dict.fromkeys(PARTIAL_KEYS, 0.0)
    for f in range(len(fv)):
        m = frame_metrics(gt[f], vu[f], keep[f], MAX_RADIUS, TOLERANCE)
        for key in PARTIAL_KEYS:
            want[key] += float(m[key])
    return want


def _references(scenes, scene_gt, overlay_gt, dev):
    """What the checks hold the ranks' results against, computed in this
    process on `dev`: the single-device batched program's rasters (each
    scene's 'compact' chunk program) and the metric sums per frame."""
    from cama_tpu_torch.pipeline import _check_lists, _overlay_chunk_compact

    w, h = int(scenes["width"]), int(scenes["height"])
    rasters = []
    for s in range(len(scenes["points"])):
        r, count = _overlay_chunk_compact(*(
            torch.as_tensor(scenes[key][s]).to(dev) for key in (
                "points", "valid", "cls", "A", "B", "fv")),
            scenes["lo"], scenes["hi"], w, h, K_CAP, False)
        _check_lists("scenes reference", "compact", 0, count.cpu().numpy(),
                     K_CAP)
        rasters.append(r.cpu().numpy())
    a = overlay_gt
    return {
        "scenes": np.stack(rasters),
        "metric": _metric_sums(a["points"], a["valid"], a["gt"], a["A"],
                               a["B"], a["fv"], a["lo"], a["hi"], w, h, dev),
        "scene_metrics": [_metric_sums(
            scene_gt["points"][s], scene_gt["valid"][s], scene_gt["gt"][s],
            scene_gt["A"][s], scene_gt["B"][s], scene_gt["fv"][s],
            scene_gt["lo"], scene_gt["hi"], w, h, dev)
            for s in range(len(scene_gt["points"]))],
    }


def _close(got, want, rtol):
    return bool(np.isclose(float(got), float(want), rtol=rtol, atol=0.0))


def run_checks(got, want):
    """The ten checks of the JAX dryrun, in its order, on what the ranks
    gathered; returns their names, and raises RuntimeError at the first
    that fails.

    got: {"rasters": {kernel: [F, C, H, W] uint8} for the four sharded
    overlay kernels, "scenes": [S, F, C, H, W] the scene-sharded batched
    rasters, "metric" / "metric_compact": {key: float} the sharded metric
    totals without and with the crop compaction, "scene_metrics": {key:
    [S]} the scene-sharded sums, "cross_host": {"partials": [...],
    "summed": {...}}, "multihost": [payload of the multihost job, per
    rank]}; want: _references' {"scenes", "metric", "scene_metrics"}."""
    checks = []

    def check(name, ok, detail):
        if not ok:
            raise RuntimeError(f"dryrun_multichip: {name} failed: {detail}")
        checks.append(name)

    scatter = got["rasters"]["fast"]
    for kernel in ("compact", "two_stage", "fused"):
        other = got["rasters"][kernel]
        apart = (int((scatter != other).sum())
                 if scatter.shape == other.shape else other.shape)
        check(f"{kernel}==scatter", np.array_equal(scatter, other),
              f"the sharded {kernel} kernel's rasters are {apart} bytes "
              "(or of another shape) apart from the scatter kernel's")
    check("scenes-dp ok", np.array_equal(got["scenes"], want["scenes"]),
          "the scenes-axis sharded batched rasters differ from the "
          "single-device batched program's")
    for name, key in (("metric-psum==single-device", "metric"),
                      ("metric-compact ok", "metric_compact")):
        bad = {k: (got[key][k], v) for k, v in want["metric"].items()
               if not _close(got[key][k], v, 1e-5)}
        check(name, not bad, f"(sharded, single-device) {bad}")
    bad = {(k, s): (got["scene_metrics"][k][s], v)
           for s, w in enumerate(want["scene_metrics"]) for k, v in w.items()
           if not _close(got["scene_metrics"][k][s], v, 1e-5)}
    check("scenes-eval ok", not bad, f"(sharded, single-device) {bad}")
    partials = got["cross_host"]["partials"]
    summed = got["cross_host"]["summed"]
    bad = {k: summed[k] for k in partials[0]
           if not _close(summed[k], sum(p[k] for p in partials), 1e-6)}
    check("cross-host-psum ok", not bad, f"summed {bad}")
    # the multihost job's hosts process scenes 'a'-'e', 'c' failing, each
    # scene worth (ord, 2) points, and rank i adds (1.5, 100) * (i + 1)
    outs, n = got["multihost"], len(got["multihost"])
    totals = {"n_hit": float(sum(map(ord, "abde"))), "n_points": 8.0}
    hosts_sum = {"x": 1.5 * n * (n + 1) / 2, "y": 100.0 * n * (n + 1) / 2}
    failed = sorted(s for o in outs for s in o["failed_scenes"])
    check("dcn-2proc ok", failed == ["c"] and all(
        o["totals"] == totals and o["hosts_sum"] == hosts_sum for o in outs),
          f"want totals {totals}, sums {hosts_sum} and one failed scene "
          f"'c' on every rank: {outs}")
    check("dcn-scenes ok", all(o["scene_rasters_ok"] and o["scene_metrics_ok"]
                               for o in outs),
          f"the scene programs across ranks disagree: {outs}")
    return checks


def _ranks(world, device):
    """(backend, device per rank) of a local cluster of `world` ranks: NCCL
    with one rank a card where the cards suffice, else gloo ranks sharing
    the first card (NCCL refuses two ranks on one device); gloo on the
    CPU."""
    if device.type == "cpu":
        return "gloo", ["cpu"] * world
    if torch.cuda.device_count() >= world:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", ["cuda:0"] * world


def _cluster(work, name, world, jobs, device):
    """Run `jobs` on a local cluster of `world` mesh_child ranks; every
    rank's payload.  Raises when a rank fails or loaded jax or the JAX
    package."""
    from cama_tpu_torch.parallel.cluster import free_port, run_local_cluster

    backend, devices = _ranks(world, device)
    plan = {"world": world, "port": free_port(), "backend": backend,
            "device": devices, "out": work, "jobs": jobs}
    path = os.path.join(work, f"{name}.json")
    with open(path, "w") as f:
        json.dump(plan, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    outs = run_local_cluster(
        [[sys.executable, "-m", "cama_tpu_torch.tools.mesh_child", path,
          str(r)] for r in range(world)], env=env, timeout=600)
    loaded = sorted({m for o in outs for m in o["modules"]})
    if loaded:
        raise RuntimeError(f"dryrun_multichip: a rank loaded {loaded[:5]}")
    return outs


def _load(work, name):
    with np.load(os.path.join(work, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _gather(n, dev, workdir=None):
    """Run every check's program on its cluster; (got, want, painted,
    clusters) for run_checks, the painted pixels of the scatter kernel
    and [(world, backend), ...] of the clusters in order."""
    lay = _layout(n)
    overlay, metric_in, scenes, scene_gt = _inputs(n)
    k1 = _crop_k1(overlay["points"], overlay["valid"], overlay["A"],
                  overlay["lo"], overlay["hi"])
    with tempfile.TemporaryDirectory(dir=workdir) as work:
        files = {}
        for name, arrays in (("overlay", overlay), ("metric_in", metric_in),
                             ("scenes", scenes), ("scene_gt", scene_gt)):
            files[name] = os.path.join(work, f"{name}.npz")
            np.savez(files[name], **arrays)
        mesh = list(lay["mesh"])
        main = [{"kind": "overlay", "name": kernel, "inputs": files["overlay"],
                 "shape": mesh, "kernel": kernel,
                 "k": None if kernel == "fast" else K_CAP,
                 "k1": K_CAP if kernel == "two_stage" else None}
                for kernel in KERNELS]
        main += [{"kind": "map_metrics", "name": name,
                  "inputs": files["metric_in"], "shape": mesh,
                  "max_radius": MAX_RADIUS, "tolerance": TOLERANCE,
                  "k1": size}
                 for name, size in (("metric", None),
                                    ("metric_compact", k1))]
        sub = [{"kind": "multi_scene", "name": "scenes",
                "inputs": files["scenes"], "shape": list(lay["scene_mesh"]),
                "k": K_CAP},
               {"kind": "scene_metrics", "name": "scene_metrics",
                "inputs": files["scene_gt"],
                "shape": list(lay["scene_mesh"]),
                "max_radius": MAX_RADIUS, "tolerance": TOLERANCE},
               {"kind": "cross_host_sum", "name": "cross_host",
                "hosts": list(lay["hosts"]), "sums_of": "metric"}]
        sub_world = lay["hosts"][0] * lay["hosts"][1]
        multihost = [{"kind": "multihost", "name": "multihost"}]
        if sub_world == n:
            main += sub
        if n >= 2:
            main += multihost
        outs = {n: _cluster(work, "main", n, main, dev)}
        runs = [(n, main)]  # (world, jobs), in order
        if sub_world != n:  # odd n > 1: the sub-meshes' own cluster
            sub[-1] = {**sub[-1], "sums_of": None,
                       "sums": outs[n][0]["jobs"]["metric"]["sums"]}
            outs[sub_world] = _cluster(work, "sub", sub_world, sub, dev)
            runs.append((sub_world, sub))
        if n < 2:
            outs[2] = _cluster(work, "multihost", 2, multihost, dev)
            runs.append((2, multihost))
        results = {job["name"]: [o["jobs"][job["name"]] for o in outs[world]]
                   for world, jobs in runs for job in jobs}
        got = {"rasters": {kernel: _load(work, kernel)["rasters"]
                           for kernel in KERNELS},
               "scenes": _load(work, "scenes")["rasters"],
               "metric": results["metric"][0]["sums"],
               "metric_compact": results["metric_compact"][0]["sums"],
               "scene_metrics": results["scene_metrics"][0]["sums"],
               "cross_host": results["cross_host"][0],
               "multihost": results["multihost"]}
        painted = int(_load(work, "fast")["counts"].sum())
    want = _references(scenes, scene_gt, metric_in, dev)
    return got, want, painted, [(world, outs[world][0]["backend"])
                                for world, _ in runs]


def dryrun_multichip(n_devices, device="cuda", workdir=None):
    """The JAX dryrun's ten checks on n_devices ranks: the four sharded
    overlay kernels on a ('frames', 'points') mesh, the scene-sharded
    batched step, the sharded map metrics without and with the crop
    compaction, the scene-sharded fleet metrics, the cross-host sum on a
    ('hosts', 'local') mesh, and the multihost tier.  Same meshes, shapes
    and seeds as the JAX dryrun.

    Ranks run in local clusters of mesh_child processes: NCCL with one
    rank a card when torch.cuda.device_count() >= the cluster's size, else
    gloo ranks sharing the card; device='cpu' runs gloo ranks on the CPU
    (the kernels' plain versions).  One cluster of n_devices ranks runs
    every check whose mesh spans n_devices; for an odd n_devices > 1 the
    scene and hosts meshes span n_devices - 1, and a cluster of that size
    runs their checks.  The multihost job (dcn-2proc, dcn-scenes) runs on
    the n-rank cluster, one rank a host, or on a 2-rank cluster when
    n_devices < 2, as the JAX dryrun's two processes.  No retry in a
    subprocess: the JAX dryrun retries to escape a JAX backend already up
    in its process, and torch starts none.  workdir: where the clusters'
    plans and arrays go (a temporary directory, removed after).

    Prints `dryrun_multichip ok: ...` in the JAX format; raises on a failed
    check and on any rank's failure.  Returns {"mesh", "rasters",
    "painted", "hosts", "checks", "clusters": [(world, backend), ...]}."""
    from cama_tpu_torch.pipeline import resolve_device

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices!r}")
    lay = _layout(n)
    got, want, painted, clusters = _gather(n, resolve_device(device), workdir)
    checks = run_checks(got, want)
    mesh = dict(zip(("frames", "points"), lay["mesh"]))
    hosts = dict(zip(("hosts", "local"), lay["hosts"]))
    shape = tuple(got["rasters"]["fast"].shape)
    print(f"dryrun_multichip ok: mesh {mesh}, rasters {shape}, "
          f"painted={painted}, hosts mesh {hosts}, checks: "
          f"{', '.join(checks)}", flush=True)
    return {"mesh": mesh, "rasters": shape, "painted": painted,
            "hosts": hosts, "checks": checks, "clusters": clusters}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="The driver-contract entry points on the port: entry() "
                    "once, then dryrun_multichip(N).")
    parser.add_argument("n_devices", nargs="?", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu' (gloo ranks, the plain versions)")
    args = parser.parse_args(argv)
    fn, fargs = entry(args.device)
    rasters = fn(*fargs)
    print(f"entry: rasters {tuple(rasters.shape)} {rasters.dtype} on "
          f"{rasters.device}, {int((rasters > 0).sum())} painted pixels",
          flush=True)
    t0 = time.perf_counter()
    dryrun_multichip(args.n_devices, args.device)
    print(f"dryrun_multichip({args.n_devices}) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
