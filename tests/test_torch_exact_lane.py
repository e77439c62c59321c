"""The port's bit-exact lane as a whole against the JAX package on CPU, with
tolerance 0: the patch step (_exact_patch_raster_chunk),
iter_overlay_rasters_exact against both the port's host-exact frames and the
JAX package's exact-lane frames, its flag statistics and overflow errors,
and project_source.  The arithmetic and the ambiguity flags under the lane
are held in tests/test_torch_exact.py."""
import numpy as np
import pytest
import torch

from cama_tpu import validate as jvalidate
from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu.pipeline import ClipPipeline as JClipPipeline
from cama_tpu_torch import validate as tvalidate
from cama_tpu_torch.ops import geometry as tg
from cama_tpu_torch.ops import raster as tr
from cama_tpu_torch.pipeline import ClipPipeline, _exact_patch_raster_chunk


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test suite runs several worker processes at once; one intra-op
    torch thread in this one keeps torch's CPU ops from oversubscribing the
    cores (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the input triple that exposed a compiler's rewrite of the error-free
# transforms (cama_tpu/ops/geometry.py:_eft_jit_faithful)
PROBE_ROW = np.array([[612.9723510742188, -664.3383178710938,
                       -0.1483260989189148, 5025.9521484375],
                      [1.0, 2.0, 3.0, 4.0],
                      [0.1, 0.2, 0.3, 0.4]], np.float32)
PROBE_P4 = np.array([-257.9800109863281, -243.37962341308594,
                     0.07289975136518478, 1.0], np.float32)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_fixture_clip(tmp_path_factory.mktemp("texactlane"), n_frames=6)


@pytest.fixture(scope="module")
def pipe(clip):
    return ClipPipeline(clip_path=clip, chunk=4, device="cpu",
                        raster_kernel="compact")


def _sources(p):
    return [s for s in ("cama", "nuscenes") if s in p.scene.flat]


def test_exact_patch_drops_invalid_rows():
    """Slots with corr_valid false carry the id P and change nothing; valid
    slots replace their point's pixel and keep bit in every camera."""
    rng = np.random.default_rng(2)
    F, C, P, M, W, H = 2, 3, 300, 8, 40, 24
    vu = rng.uniform(0, [H, W], size=(F, C, P, 2)).astype(np.float32)
    keep = rng.uniform(size=(F, C, P)) > 0.3
    cls = rng.integers(0, 3, size=P).astype(np.int32)
    ids = np.full((F, M), P, np.int64)
    ids[0, :3] = [5, 17, 299]
    cvalid = np.zeros((F, M), bool)
    cvalid[0, :3] = True
    cvu = np.full((F, C, M, 2), 0.5, np.float32)
    cvu[0, :, :3] = [[3.5, 4.5], [7.5, 8.5], [20.5, 30.5]]
    ckeep = np.zeros((F, C, M), bool)
    ckeep[0, :, :3] = [True, False, True]
    rasters, cnt = _exact_patch_raster_chunk(
        *(torch.from_numpy(a) for a in (vu, keep, cls, ids, cvu, ckeep,
                                        cvalid)), W, H, 512)
    vu_w, keep_w = vu.copy(), keep.copy()
    vu_w[0][:, [5, 17, 299]] = cvu[0, :, :3]
    keep_w[0][:, [5, 17, 299]] = ckeep[0, :, :3]
    vals, counts = tr.compact_points(
        torch.from_numpy(vu_w), torch.from_numpy(keep_w),
        torch.from_numpy(cls), W, H, 512)
    want = tr.packed_to_cls(tr.rasterize_from_compact(vals, W, H))
    assert torch.equal(rasters, want) and int(cnt) == int(counts.max())
    assert rasters[0, 0, 20, 30] == cls[299] + 1


@pytest.fixture(scope="module")
def jax_exact_frames(clip):
    """{source: {image_idx: {camera: image}}} of the JAX package's exact
    lane (cama_tpu.validate.device_frames_for_path 'exact'), chunk 4."""
    jp = JClipPipeline(clip_path=clip, chunk=4)
    out = {}
    for source in _sources(jp):
        fm = jp.frame_matrices(source)
        ids = {int(i) for i, v in zip(fm.frame_indices, fm.frame_valid) if v}
        out[source] = jvalidate.device_frames_for_path(
            jp.scene, "exact", source, ids, chunk=4)
    return out


@pytest.mark.parametrize("source", ["cama", "nuscenes"])
def test_exact_lane_bitwise_equals_host_exact_and_jax(pipe, jax_exact_frames,
                                                      source):
    fm = pipe.frame_matrices(source)
    ids = {int(i) for i, v in zip(fm.frame_indices, fm.frame_valid) if v}
    exact = tvalidate.host_exact_frames(pipe, source, ids)
    dev = tvalidate.device_frames_for_path(pipe.scene, "exact", source, ids,
                                           chunk=4, device="cpu")
    assert set(dev) == set(exact) == set(jax_exact_frames[source]) == ids
    for i in sorted(ids):
        for cam in dev[i]:
            np.testing.assert_array_equal(
                dev[i][cam], exact[i][cam],
                err_msg=f"{source} frame {i} {cam}: exact lane diverged "
                        "from the f64 host-exact path")
            np.testing.assert_array_equal(dev[i][cam],
                                          jax_exact_frames[source][i][cam])


def test_exact_lane_records_flags_and_raises_on_overflow(clip):
    p = ClipPipeline(clip_path=clip, chunk=4, device="cpu",
                     raster_kernel="compact",
                     configs={"scene_cache": False})
    rasters = dict(p.iter_overlay_rasters_exact("cama"))
    assert len(rasters) == 5 and all(r.any() for r in rasters.values())
    assert [s["M"] for s in p.exact_stats] == [512, 512]
    assert sum(len(s["flagged"]) for s in p.exact_stats) == 5
    assert 0 < max(max(s["flagged"]) for s in p.exact_stats) <= 512
    # a list too small for the kept points raises instead of dropping rows
    p._mode["cama"] = ("raster", -400)
    with pytest.raises(RuntimeError, match="exact lane"):
        list(p.iter_overlay_rasters_exact("cama"))
    # and so does a patch larger than the point count
    P = int(p.scene.flat["cama"].points.shape[0])
    with pytest.raises(RuntimeError, match="over the point count"):
        list(p.iter_overlay_rasters_exact("cama", patch_cap_min=2 * P))


def test_project_source_matches_jax(clip, pipe):
    jp = JClipPipeline(clip_path=clip, chunk=4)
    fm_t, vu_t, keep_t = pipe.project_source("cama")
    fm_j, vu_j, keep_j = jp.project_source("cama")
    assert vu_t.shape == tuple(vu_j.shape) and len(fm_t.frame_indices) == 5
    np.testing.assert_array_equal(fm_t.frame_indices, fm_j.frame_indices)
    kt, kj = keep_t.numpy(), np.asarray(keep_j)
    assert (kt == kj).mean() > 0.9999
    both = kt & kj
    # two f32 projections that round differently: the 2e-2 px of
    # tests/test_torch_pallas_project.py (VU_TOL_PX)
    np.testing.assert_allclose(vu_t.numpy()[both], np.asarray(vu_j)[both],
                               rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_exact_lane_on_the_card_equals_the_float64_anchor(clip):
    """On the card: the error-free transforms stay exact (eager kernels
    contract nothing), the flags equal the CPU's, and the exact lane's
    rasters equal the float64 anchor byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_*.py -m cuda)")
    s, e = tg._df_dot4(torch.from_numpy(PROBE_ROW).cuda(),
                       torch.from_numpy(PROBE_P4).cuda())
    s_c, e_c = tg._df_dot4(torch.from_numpy(PROBE_ROW),
                           torch.from_numpy(PROBE_P4))
    assert torch.equal(s.cpu(), s_c) and torch.equal(e.cpu(), e_c)
    card = ClipPipeline(clip_path=clip, chunk=4, device="cuda",
                        raster_kernel="compact")
    for source in _sources(card):
        fm = card.frame_matrices(source)
        ids = {int(i) for i, v in zip(fm.frame_indices, fm.frame_valid) if v}
        anchor = tvalidate.host_exact_rasters(card, source, ids)
        got = dict(card.iter_overlay_rasters_exact(source))
        assert set(got) == ids
        for i in ids:
            np.testing.assert_array_equal(got[i], anchor[i])
