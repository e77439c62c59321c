"""The port's sharded overlay steps (cama_tpu_torch.parallel) against the
JAX package's shard_map steps on CPU.  The port runs SPMD: one module-scoped
cluster of four gloo ranks (cama_tpu_torch.tools.mesh_child, launched by the
port's run_local_cluster) runs every step on the same global host arrays and
writes the gathered rasters; the JAX package runs each step on a mesh of the
same shape over four of the conftest's eight virtual CPU devices.  Rasters
must match byte for byte and the painted counts exactly, for every kernel on
the ('frames', 'points') meshes (4, 1), (2, 2) and (1, 4) (the 'fused'
kernel against JAX's at the device-lane contract, and byte for byte against
the port's single-device pipeline: see test_sharded_overlay_matches_jax),
and for the scene-batched step on a ('scenes', 'frames') mesh; an
overflowing union list
must raise on every rank, the ranks that fit included, with no hang; and the
sharded rasters composite to the single-device pipeline's video frames."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cama_tpu import parallel as jpar
from cama_tpu.ops import fused_compact as jfc
from cama_tpu.ops import raster as jraster
from cama_tpu_torch.io.fixture import make_fixture_clip
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.io.video import concat_camera_grid
from cama_tpu_torch.ops import fused_compact as tfc
from cama_tpu_torch.ops import raster as traster
from cama_tpu_torch.ops.geometry import compose_frame_matrices, crop_bounds
from cama_tpu_torch.parallel import pad_to_multiple
from cama_tpu_torch.parallel.cluster import free_port, run_local_cluster
from cama_tpu_torch.pipeline import ClipPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4, 1), (2, 2), (1, 4)]
KERNELS = ["fast", "compact", "two_stage", "fused"]
SIZE = (270, 480)  # output size: the sharding, not the width, is the point
K = 4096           # list size of the 'compact' and 'two_stage' kernels
RANKS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test suite runs several worker processes at once; one intra-op
    torch thread in this one keeps torch's CPU ops from oversubscribing the
    cores (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overlay_inputs(scene, multiple_f, multiple_p=RANKS):
    fm = compose_frame_matrices(scene.traj["cama"], scene.frame_times,
                                scene.chassis2cam, scene.K_scaled)
    fp = scene.flat["cama"]
    lo, hi = crop_bounds()
    h, w = scene.output_size
    return fm, {
        "points": pad_to_multiple(fp.points.astype(np.float32), multiple_p),
        "valid": pad_to_multiple(fp.valid, multiple_p),
        "cls": pad_to_multiple(fp.cls.astype(np.int32), multiple_p),
        "A": pad_to_multiple(fm.A.astype(np.float32), multiple_f),
        "B": pad_to_multiple(fm.B.astype(np.float32), multiple_f),
        "fv": pad_to_multiple(fm.frame_valid, multiple_f),
        "lo": lo, "hi": hi, "width": w, "height": h}


def _stack_scenes(inputs, multiple_f):
    """Two scenes' inputs stacked [S, ...]: points padded to a common P
    (invalid), frames to a common multiple of multiple_f (identity A,
    frame_valid False)."""
    P = max(len(a["points"]) for a in inputs)
    F = max(len(a["fv"]) for a in inputs)
    F = -(-F // multiple_f) * multiple_f
    out = {"points": np.zeros((len(inputs), P, 3), np.float32),
           "valid": np.zeros((len(inputs), P), bool),
           "cls": np.zeros((len(inputs), P), np.int32),
           "A": np.tile(np.eye(4, dtype=np.float32), (len(inputs), F, 1, 1)),
           "B": np.zeros((len(inputs), F) + inputs[0]["B"].shape[1:],
                         np.float32),
           "fv": np.zeros((len(inputs), F), bool)}
    for s, a in enumerate(inputs):
        for key in ("points", "valid", "cls"):
            out[key][s, :len(a[key])] = a[key]
        for key in ("A", "B", "fv"):
            out[key][s, :len(a[key])] = a[key]
    return {**out, **{k: inputs[0][k] for k in ("lo", "hi", "width",
                                                "height")}}


def _job_name(shape, kernel):
    return f"{kernel}_{shape[0]}x{shape[1]}"


def _job_k(kernel, n_points, shape):
    """(k, k1) of a kernel's port job: 'fused' sizes its union list from
    count_union (k None); the JAX fused kernel gets the whole point count,
    which cannot overflow."""
    if kernel in ("compact", "two_stage"):
        return K, (n_points // shape[1] if kernel == "two_stage" else None)
    return None, None


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpar")
    clip = make_fixture_clip(root, n_frames=8, with_lidar=False)
    clip_b = make_fixture_clip(root, scene_name="scene-b", n_frames=5,
                               with_images=False, with_lidar=False, seed=1,
                               label_span=(-290.0, -190.0))
    scene = compile_scene(clip, output_size=SIZE)
    fm, inputs = _overlay_inputs(scene, RANKS)
    _, inputs_b = _overlay_inputs(compile_scene(clip_b, output_size=SIZE), 1)
    _, inputs_a = _overlay_inputs(scene, 1)
    scenes = _stack_scenes([inputs_a, inputs_b], 2)
    np.savez(root / "overlay.npz", **inputs)
    np.savez(root / "scenes.npz", **scenes)

    # an overflowing union list: some point shards of the (1, 4) mesh fit
    # in k, others do not, so the ranks that fit raise only by agreement
    P = len(inputs["points"])
    t = {key: torch.from_numpy(np.asarray(inputs[key]))
         for key in ("points", "valid", "cls", "A", "B", "fv")}
    maxima = sorted(int(tfc.count_union_ref(
        t["points"][i * P // 4:(i + 1) * P // 4],
        t["valid"][i * P // 4:(i + 1) * P // 4],
        t["cls"][i * P // 4:(i + 1) * P // 4], t["A"], t["B"], t["fv"],
        SIZE[1], SIZE[0], inputs["lo"], inputs["hi"]).max())
        for i in range(4))
    assert maxima[0] < maxima[-1]
    k_over = (maxima[0] + maxima[-1]) // 2

    jobs = []
    for shape in SHAPES:
        for kernel in KERNELS:
            k, k1 = _job_k(kernel, P, shape)
            jobs.append({"kind": "overlay", "name": _job_name(shape, kernel),
                         "inputs": str(root / "overlay.npz"),
                         "shape": list(shape), "kernel": kernel, "k": k,
                         "k1": k1})
    jobs += [{"kind": "overflow", "name": "overflow",
              "inputs": str(root / "overlay.npz"), "shape": [1, 4],
              "kernel": "fused", "k": k_over},
             {"kind": "multi_scene", "name": "scenes",
              "inputs": str(root / "scenes.npz"), "shape": [2, 2], "k": K}]
    plan = {"world": RANKS, "port": free_port(), "backend": "gloo",
            "device": "cpu", "out": str(root), "jobs": jobs}
    with open(root / "plan.json", "w") as f:
        json.dump(plan, f)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    payloads = run_local_cluster(
        [[sys.executable, "-m", "cama_tpu_torch.tools.mesh_child",
          str(root / "plan.json"), str(r)] for r in range(RANKS)],
        env=env, timeout=400)
    pipe = ClipPipeline(clip_path=clip, scene=scene, chunk=4,
                        raster_kernel="fused", device="cpu")
    return {"root": root, "inputs": inputs, "scenes": scenes, "fm": fm,
            "pipe": pipe, "single": dict(pipe.iter_overlay_rasters("cama")),
            "payloads": payloads, "k_over": k_over, "maxima": maxima}


def _port(run, name):
    with np.load(run["root"] / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def _jax_overlay(inputs, shape, kernel):
    mesh = jpar.make_mesh(n_frames_axis=shape[0], n_points_axis=shape[1])
    P = len(inputs["points"])
    k, k1 = _job_k(kernel, P, shape)
    step = jpar.sharded_overlay_step(mesh, int(inputs["width"]),
                                     int(inputs["height"]), kernel=kernel,
                                     k=P if kernel == "fused" else k or 2048,
                                     k1=k1)
    rasters, counts = step(*(jnp.asarray(inputs[key]) for key in (
        "points", "valid", "cls", "A", "B", "fv", "lo", "hi")))
    return np.asarray(rasters), np.asarray(counts)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_overlay_matches_jax(run, shape, kernel):
    """Rasters and painted counts against the JAX package's sharded step,
    and byte-equal to the port's single-device 'fused' pipeline on every
    valid frame.

    'fast', 'compact' and 'two_stage' project with XLA's elementwise
    program in JAX and must match byte for byte.  JAX's 'fused' kernel
    projects with lax.dot, which XLA's CPU backend evaluates as a fused
    multiply-add chain, where the port keeps project_frames' elementwise
    order; a border point can then land on another pixel
    (tests/test_torch_fused_compact.py).  So 'fused' is held to the
    repository's device-lane contract against JAX, >= 0.99999 per frame,
    with the counts apart by no more than the differing pixels."""
    got = _port(run, _job_name(shape, kernel))
    want_r, want_c = _jax_overlay(run["inputs"], shape, kernel)
    if kernel == "fused":
        assert got["rasters"].shape == want_r.shape
        for f in range(len(want_r)):
            agree = (got["rasters"][f] == want_r[f]).mean()
            assert agree >= 0.99999, f"frame {f}: agreement {agree}"
        apart = int((got["rasters"] != want_r).sum())
        assert np.abs(got["counts"] - want_c).sum() <= apart
    else:
        np.testing.assert_array_equal(got["rasters"], want_r)
        np.testing.assert_array_equal(got["counts"], want_c)
    fm, single = run["fm"], run["single"]
    n = 0
    for f, idx in enumerate(fm.frame_indices):
        if fm.frame_valid[f]:
            np.testing.assert_array_equal(got["rasters"][f],
                                          single[int(idx)])
            n += 1
    assert n >= 4
    assert int(got["counts"].sum()) == sum(int((r > 0).sum())
                                           for r in single.values())


def test_scenes_axis_step_matches_jax(run):
    """sharded_multi_scene_step over a (2, 2) ('scenes', 'frames') mesh
    equals the JAX package's over the same mesh shape, byte for byte."""
    s = run["scenes"]
    mesh = jpar.make_scene_mesh(n_scenes_axis=2, n_frames_axis=2)
    step = jpar.sharded_multi_scene_step(mesh, int(s["width"]),
                                         int(s["height"]), k=K)
    want = np.asarray(step(*(jnp.asarray(s[key]) for key in (
        "points", "valid", "cls", "A", "B", "fv", "lo", "hi"))))
    got = _port(run, "scenes")["rasters"]
    assert got.shape == want.shape and got.any()
    np.testing.assert_array_equal(got, want)


def test_overflow_raises_on_every_rank(run):
    """A fused step whose union list overflows on some point shards raises
    on every rank, the ranks whose own list fits included; the cluster
    finishes (no rank is left waiting in a collective), and no child
    loaded jax or the JAX package."""
    jobs = [p["jobs"]["overflow"] for p in run["payloads"]]
    assert all(j["raised"] for j in jobs), jobs
    assert all(f"over its size {run['k_over']}" in j["message"]
               for j in jobs)
    assert sorted(j["local_max"] for j in jobs) == run["maxima"]
    assert any(j["local_max"] <= run["k_over"] for j in jobs)
    for p in run["payloads"]:
        assert p["modules"] == [] and p["backend"] == "gloo"
        assert p["device"] == "cpu"


def test_sharded_rasters_composite_to_pipeline_frames(run):
    """Sharded rasters (the 'compact' kernel on the (2, 2) mesh) driven
    through the port's host compositor reproduce the single-device
    pipeline's video frames exactly."""
    pipe, fm = run["pipe"], run["fm"]
    rasters = _port(run, _job_name((2, 2), "compact"))["rasters"]
    expected = {idx: concat_camera_grid(frame)
                for idx, frame in pipe.iter_frames("cama", mode="raster")}
    n = 0
    for f, idx in enumerate(fm.frame_indices):
        if not fm.frame_valid[f]:
            continue
        frame = pipe.composite_frame("cama", int(idx), rasters[f])
        np.testing.assert_array_equal(concat_camera_grid(frame),
                                      expected[int(idx)])
        n += 1
    assert n >= 4


@pytest.mark.parametrize("fn", ["rasterize_from_compact",
                                "rasterize_from_union"])
def test_prio_offset_matches_jax(fn):
    """Both raster functions with a non-zero prio_offset: packed rasters
    equal to the JAX package's, priorities included."""
    rng = np.random.default_rng(3)
    H, W, C, Kr, offset = 20, 28, 3, 64, 5 * 64
    enc = (rng.integers(0, H * W, (C, Kr)) * traster.MAX_CLS
           + rng.integers(0, 3, (C, Kr))).astype(np.int32)
    if fn == "rasterize_from_compact":
        vals = np.where(rng.random((C, Kr)) < 0.8, enc, -1).astype(np.int32)
        got = traster.rasterize_from_compact(torch.from_numpy(vals), W, H,
                                             prio_offset=offset)
        want = jraster.rasterize_from_compact(jnp.asarray(vals), W, H,
                                              prio_offset=offset)
    else:
        union = np.where(rng.random((Kr, C)) < 0.6, enc.T + 1, 0)
        union = union.astype(np.int32)
        count = 50
        got = tfc.rasterize_from_union(torch.from_numpy(union),
                                       torch.tensor(count, dtype=torch.int32),
                                       W, H, prio_offset=offset)
        want = jfc.rasterize_from_union(jnp.asarray(union),
                                        jnp.asarray(count, jnp.int32), C, W,
                                        H, prio_offset=offset)
    want = np.asarray(want)
    assert (want >= offset * traster.MAX_CLS).any()
    np.testing.assert_array_equal(got.numpy(), want)
    # the offset shifts every painted priority and moves no pixel
    base = (traster.rasterize_from_compact(torch.from_numpy(vals), W, H)
            if fn == "rasterize_from_compact" else
            tfc.rasterize_from_union(torch.from_numpy(union),
                                     torch.tensor(count, dtype=torch.int32),
                                     W, H)).numpy()
    np.testing.assert_array_equal(
        np.where(base >= 0, base + offset * traster.MAX_CLS, -1),
        got.numpy())
