"""The port's raster_kernel lanes ('pallas', 'compact', 'scatter') and the
ops they run, against the JAX package on CPU: compaction, counting and the
scatter rasterizer on identical numpy inputs (exact), the max-paint probe
against a transcription of the TPU probe (exact), each lane against the JAX
ClipPipeline of the same name, and the port's lanes against each other.
The paint kernel against its plain version runs on the card (marked `cuda`,
skipped without one)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cama_tpu import pipeline as jpipe
from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu.ops import raster as jr
from cama_tpu_torch import pipeline as tpipe
from cama_tpu_torch.ops import paint as tpaint
from cama_tpu_torch.ops import raster as tr
from cama_tpu_torch.ops.pallas_project import LAUNCHES as PP_LAUNCHES


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test suite runs several worker processes at once; one intra-op
    torch thread in this one keeps torch's CPU ops from oversubscribing the
    cores (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 40, 24
LANES = ("pallas", "compact", "scatter")


def _points(seed, F=2, C=3, P=600):
    """vu [F, C, P, 2], keep, cls [P]: pixel-centred runs of near-duplicate
    points, some off-image (kept anyway where `guard` matters), some
    dropped, so suppression, clipping and paint order all matter."""
    rng = np.random.default_rng(seed)
    base = rng.uniform([-3.0, -3.0], [H + 3.0, W + 3.0], size=(F, C, P // 3, 2))
    vu = (np.repeat(base, 3, axis=2)
          + rng.uniform(0, 0.4, (F, C, P, 2))).astype(np.float32)
    inside = ((vu[..., 0] >= 0) & (vu[..., 0] < H) & (vu[..., 1] >= 0)
              & (vu[..., 1] < W))
    keep = inside & (rng.uniform(size=(F, C, P)) > 0.1)
    cls = rng.integers(0, 3, size=P).astype(np.int32)
    return vu, keep, cls


def _jt(vu, keep, cls):
    return jnp.asarray(vu), jnp.asarray(keep), jnp.asarray(cls)


def _tt(vu, keep, cls):
    return torch.from_numpy(vu), torch.from_numpy(keep), torch.from_numpy(cls)


@pytest.mark.parametrize("k", [64, 1024, 4096])  # < counts, >= counts, > P
def test_compact_points_and_counts_match_jax(k):
    vu, keep, cls = _points(0)
    vals_t, cnt_t = tr.compact_points(*_tt(vu, keep, cls), W, H, k)
    vals_j, cnt_j = jr.compact_points(*_jt(vu, keep, cls), W, H, k)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    assert vals_t.shape == (2, 3, k) and vals_t.dtype == torch.int32
    np.testing.assert_array_equal(
        tr.effective_counts(*_tt(vu, keep, cls), W, H).numpy(),
        np.asarray(jr.effective_counts(*_jt(vu, keep, cls), W, H)))
    n = cnt_t.numpy()
    assert 0 < n.min() and n.max() < keep.sum(-1).max() < 600
    if k < n.max():
        assert (vals_t >= 0).all(), "truncated lists are full"
    else:
        assert (vals_t[..., -1] == -1).all(), "padding past the count"


@pytest.mark.parametrize("prio_offset", [0, 5000])
def test_rasterize_packed_fast_matches_jax(prio_offset):
    """Including kept points whose centre is off-image (the in-image
    guard)."""
    vu, keep, cls = _points(1)
    keep = keep | (np.random.default_rng(2).uniform(size=keep.shape) > 0.97)
    got = tr.rasterize_packed_fast(*_tt(vu, keep, cls), W, H,
                                   prio_offset=prio_offset).numpy()
    ref = np.asarray(jr.rasterize_packed_fast(*_jt(vu, keep, cls), W, H,
                                              prio_offset=prio_offset))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (2, 3, H, W) and (got >= 0).any() and (got < 0).any()


# ---------------- the max-paint probe (tools/bench_pallas.py) ----------------

PH, WPAD, WIMG = 540, 1024, 960


def _probe_loop(py, px, prio):
    """NumPy transcription of probe_kernel's loop (tools/bench_pallas.py
    :153-167): per point with prio >= 0, an (8, 128)-tile read-modify-write
    of a one-hot max; tiles are clipped at the raster's edge."""
    out = np.full((PH, WPAD), -1, np.int32)
    row, lane = np.mgrid[0:8, 0:128]
    for y, x, pr in zip(py, px, prio):
        if pr < 0:
            continue
        ya, xa = (y // 8) * 8, (x // 128) * 128
        tile = out[ya:ya + 8, xa:xa + 128]
        oh = np.where((row == y % 8) & (lane == x % 128), pr, -1)
        out[ya:ya + 8, xa:xa + 128] = np.maximum(tile, oh[:tile.shape[0]])
    return out


def _probe_inputs(seed, n=4096):
    """The probe's points: in range, half of them crowded into a small box
    so pixels collide, one in ten with a negative priority."""
    rng = np.random.default_rng(seed)
    py = rng.integers(0, PH, n).astype(np.int32)
    px = rng.integers(0, WIMG, n).astype(np.int32)
    py[::2] = rng.integers(530, PH, n // 2)
    px[::2] = rng.integers(0, 6, n // 2)
    prio = rng.integers(0, 1 << 20, n).astype(np.int32)
    prio[::10] = -rng.integers(1, 50, len(prio[::10]))
    return py, px, prio


def test_paint_max_ref_matches_probe_and_jnp():
    py, px, prio = _probe_inputs(0)
    got = tpaint.paint_max_ref(*(torch.from_numpy(a) for a in (py, px, prio)),
                               PH, WPAD).numpy()
    np.testing.assert_array_equal(got, _probe_loop(py, px, prio))
    ref = (jnp.full(PH * WPAD, -1, jnp.int32)
           .at[jnp.asarray(py * WPAD + px)].max(jnp.asarray(prio))
           .reshape(PH, WPAD))
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (got >= 0).sum() > 1000


def test_paint_max_batch_skips_out_of_range():
    """The batch form paints each row into its own raster and skips points
    outside it; CPU tensors take the plain version with no launch."""
    rows = [_probe_inputs(s, n=512) for s in (1, 2, 3)]
    py, px, prio = (np.stack(a) for a in zip(*rows))
    py[:, :40] += PH          # below the raster
    px[:, 40:80] = -1 - px[:, 40:80]
    px[:, 80:120] += WPAD     # right of the raster
    tpaint.reset_launches()
    got = tpaint.paint_max(*(torch.from_numpy(a) for a in (py, px, prio)),
                           PH, WPAD).numpy()
    assert tpaint.LAUNCHES == {"paint_max": 0}
    assert got.shape == (3, PH, WPAD)
    for r in range(3):
        ok = slice(120, None)
        np.testing.assert_array_equal(
            got[r], _probe_loop(py[r, ok], px[r, ok], prio[r, ok]))
    with pytest.raises(ValueError, match="int32"):
        tpaint.paint_max(*(torch.from_numpy(a).long() for a in (py, px, prio)),
                         PH, WPAD)
    with pytest.raises(ValueError, match="no paint_max implementation"):
        tpaint.paint_max(*(torch.from_numpy(a).to("meta")
                           for a in (py, px, prio)), PH, WPAD)


@pytest.mark.cuda
def test_cuda_paint_matches_plain_version():
    """On the card: the atomicMax kernel equals scatter_reduce_ exactly, at
    the probe's shape and in the batch form with out-of-range points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_*.py -m cuda)")
    probe = _probe_inputs(0)
    rows = [_probe_inputs(s, n=512) for s in (1, 2, 3)]
    batch = [np.stack(a) for a in zip(*rows)]
    batch[0][:, :40] += PH
    batch[1][:, 40:80] = -1 - batch[1][:, 40:80]
    for case in (probe, batch):
        args = [torch.from_numpy(a).cuda() for a in case]
        before = tpaint.LAUNCHES["paint_max"]
        got = tpaint.paint_max(*args, PH, WPAD)
        assert tpaint.LAUNCHES["paint_max"] == before + 1
        ref = tpaint.paint_max_ref(*args, PH, WPAD)
        torch.cuda.synchronize()
        assert (ref >= 0).any() and torch.equal(got, ref)


# ---------------- the lanes end to end ----------------


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_fixture_clip(tmp_path_factory.mktemp("tlanes"), n_frames=4,
                             with_images=False, with_lidar=False)


@pytest.fixture(scope="module")
def port_rasters(clip):
    """{lane: {source: {image_idx: raster}}} of the port on CPU, with the
    projection kernel's launch count checked to stay 0 on CPU."""
    PP_LAUNCHES["project_frame_pallas"] = 0
    out = {}
    for lane in ("fused",) + LANES:
        pipe = tpipe.ClipPipeline(clip_path=clip, chunk=2, raster_kernel=lane,
                                  device="cpu")
        out[lane] = {src: dict(pipe.iter_overlay_rasters(src))
                     for src in ("cama", "nuscenes")}
    assert PP_LAUNCHES["project_frame_pallas"] == 0
    return out


@pytest.mark.parametrize("source", ["cama", "nuscenes"])
@pytest.mark.parametrize("lane", LANES)
def test_lane_matches_jax_lane(clip, port_rasters, lane, source):
    """Per-frame agreement with cama_tpu's ClipPipeline of the same
    raster_kernel is >= 0.99999, the device-lane contract; the residual is
    the f32 dot-vs-elementwise border class."""
    ref = dict(jpipe.ClipPipeline(clip_path=clip, chunk=2, raster_kernel=lane)
               .iter_overlay_rasters(source))
    got = port_rasters[lane][source]
    assert set(got) == set(ref) and len(got) >= 2
    for idx in ref:
        assert got[idx].shape == ref[idx].shape and got[idx].dtype == np.uint8
        assert got[idx].any(), "frame painted nothing — test is vacuous"
        agree = (got[idx] == ref[idx]).mean()
        assert agree >= 0.99999, f"{lane} {source} frame {idx}: {agree}"


@pytest.mark.parametrize("source", ["cama", "nuscenes"])
@pytest.mark.parametrize("lane", LANES)
def test_lanes_are_pixel_identical(port_rasters, lane, source):
    """Every lane keeps the same points and paints them in the same order,
    so its rasters equal the fused lane's exactly."""
    ref = port_rasters["fused"][source]
    got = port_rasters[lane][source]
    assert set(got) == set(ref)
    for idx in ref:
        assert int((got[idx] != ref[idx]).sum()) == 0, (lane, idx)


@pytest.mark.parametrize("lane", LANES)
def test_lane_k_from_own_count_and_overflow_raises(clip, lane):
    pipe = tpipe.ClipPipeline(clip_path=clip, chunk=2, raster_kernel=lane,
                              device="cpu")
    _, k = pipe.overlay_mode("cama")
    P = pipe.scene.flat["cama"].points.shape[0]
    assert 1024 <= k <= P and (k & (k - 1)) == 0
    # the dense list size: 'scatter' has no list and is held against P
    assert pipe._k["cama"] == (P if lane == "scatter" else k)
    pipe._k["cama"] = 64  # a list far too small for the scene
    with pytest.raises(RuntimeError, match=f"over the {lane} list size k=64"):
        list(pipe.iter_overlay_rasters("cama"))
