"""Device compositing and undistort of cama_tpu_torch against cama_tpu on
CPU: rasterize_packed, composite_overlay and composite_mosaic_device exact
on seeded inputs (unpainted pixels and out-of-table classes beside a 3-row
color table); remap_bilinear within 1 on at most 1e-5 of the uint8 entries
and within 1e-6 in float32, taps off every border included; the device
mosaic of ClipPipeline byte-equal to the host compositors and to JAX's."""
import sys

import numpy as np
import pytest
import torch

from cama_tpu.io.scene import compile_scene as jcompile_scene
from cama_tpu.ops import raster as jr
from cama_tpu.ops import undistort as ju
from cama_tpu.pipeline import ClipPipeline as JClipPipeline
from cama_tpu_torch.io.fixture import make_fixture_clip
from cama_tpu_torch.io.scene import DEFAULT_CAMA_CONFIGS, compile_scene
from cama_tpu_torch.io.video import CAMERA_GRID, concat_camera_grid
from cama_tpu_torch.ops import raster as tr
from cama_tpu_torch.ops import undistort as tu
from cama_tpu_torch.pipeline import ClipPipeline

U8_FRACTION_MAX = 1e-5  # uint8 remap: entries 1 apart, of all entries
F32_ABS_MAX = 1e-6      # float32 remap
SMALL = (270, 480)
TABLE = jr.build_color_table(["lane_marking", "Road_teeth", "Crosswalk_Line"])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("batch,prio_offset", [((), 0), ((2, 6), 0),
                                               ((3,), 4096)])
def test_rasterize_packed_matches_jax(batch, prio_offset):
    """The 13-sample stamp, with centres and stencils off every border."""
    rng = np.random.default_rng(11)
    h, w, P = 24, 40, 80
    vu = rng.uniform(-4, [h + 4, w + 4], batch + (P, 2)).astype(np.float32)
    keep = rng.random(batch + (P,)) < 0.8
    cls = rng.integers(0, 3, P).astype(np.int32)
    want = np.asarray(jr.rasterize_packed(vu, keep, cls, w, h,
                                          prio_offset=prio_offset))
    got = tr.rasterize_packed(_t(vu), _t(keep), _t(cls), w, h,
                              prio_offset=prio_offset).numpy()
    assert (want >= 0).any() and (want < 0).any()
    np.testing.assert_array_equal(got, want)


def test_composite_overlay_matches_jax():
    rng = np.random.default_rng(12)
    h, w, P = 24, 40, 60
    vu = rng.uniform(0, [h, w], (2, P, 2)).astype(np.float32)
    cls = rng.integers(0, 3, P).astype(np.int32)
    packed = np.array(jr.rasterize_packed(vu, np.ones((2, P), bool), cls,
                                          w, h))
    packed[0, 0, :5] = 6 * 8 + 5  # a class past the table's 3 rows
    img = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    want = np.asarray(jr.composite_overlay(img, packed, TABLE))
    got = tr.composite_overlay(_t(img), _t(packed), _t(TABLE)).numpy()
    np.testing.assert_array_equal(got, want)


def _mosaic_inputs(seed):
    rng = np.random.default_rng(seed)
    h, w = 24, 40
    base = rng.integers(0, 256, (6, h, w, 3), dtype=np.uint8)
    cls = ((rng.random((6, h, w)) < 0.3)
           * rng.integers(1, 4, (6, h, w))).astype(np.uint8)
    return base, cls, rng.permutation(6).astype(np.int32)


def test_composite_mosaic_device_matches_jax_and_host_paint():
    """Exact against JAX's program and against per-camera host painting
    placed by the grid; unpainted pixels (class 0) beside a 3-row table."""
    base, cls, grid = _mosaic_inputs(13)
    want = np.asarray(jr.composite_mosaic_device(base, cls, TABLE, grid))
    got = tr.composite_mosaic_device(_t(base), _t(cls), _t(TABLE),
                                     _t(grid)).numpy()
    assert (cls == 0).any() and (cls > 0).any()
    np.testing.assert_array_equal(got, want)
    h, w = base.shape[1:3]
    host = np.empty_like(want)
    for c in range(6):
        img = base[c].copy()
        nz = cls[c] > 0
        img[nz] = TABLE[(cls[c][nz].astype(np.int32) - 1) % tr.MAX_CLS]
        r, col = divmod(int(grid[c]), 3)
        host[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    np.testing.assert_array_equal(got, host)


def test_composite_mosaic_device_clamps_classes_past_the_table():
    """Unpainted pixels index row (0 - 1) % MAX_CLS = 7 of a 3-row table
    before the select drops them: an unguarded gather raises in torch (and
    asserts on the card), while XLA clamps.  The port clamps as XLA does,
    so even painted classes past the table agree with JAX."""
    base, cls, grid = _mosaic_inputs(14)
    with pytest.raises(IndexError):
        _t(TABLE)[(_t(cls).long() - 1) % tr.MAX_CLS]
    cls[0, :3, :3] = 8  # painted, class row 7: past the table
    want = np.asarray(jr.composite_mosaic_device(base, cls, TABLE, grid))
    got = tr.composite_mosaic_device(_t(base), _t(cls), _t(TABLE),
                                     _t(grid)).numpy()
    np.testing.assert_array_equal(got, want)


def _remap_case(kind):
    """(image [H, W, 3] uint8, mapx, mapy): kind 'undistort' is an undistort
    grid of a nuScenes-like camera, 1600x900 -> 960x540; 'borders' samples up to 3 px
    off every border of a 160x90 image."""
    rng = np.random.default_rng(15)
    if kind == "undistort":
        K = np.array([[1266.4, 0, 816.3], [0, 1266.4, 491.5], [0, 0, 1.0]])
        d = np.array([-0.12, 0.08, 0.001, -0.0005, -0.02])
        K_new = K.copy()
        K_new[:2] *= 0.6
        mapx, mapy = tu.compute_remap(K, d, K_new, (540, 960))
        yy, xx = np.mgrid[0:900, 0:1600].astype(np.float32)
        img = np.stack([(xx * 0.13 + yy * 0.05) % 256, (xx * yy) % 251,
                        rng.integers(0, 256, (900, 1600))],
                       -1).astype(np.uint8)
        return img, mapx, mapy
    H, W = 90, 160
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    mapx = rng.uniform(-3, W + 3, (60, 100)).astype(np.float32)
    mapy = rng.uniform(-3, H + 3, (60, 100)).astype(np.float32)
    mapx[0, :4] = [-1.0, -0.5, W - 1, W - 0.25]  # taps straddling borders
    mapy[0, :4] = [-0.5, H - 1, -1.0, H - 0.25]
    return img, mapx, mapy


@pytest.mark.parametrize("kind", ["undistort", "borders"])
def test_remap_bilinear_uint8_matches_jax(kind):
    img, mapx, mapy = _remap_case(kind)
    want = np.asarray(ju.remap_bilinear(img, mapx, mapy)).astype(np.int32)
    got = tu.remap_bilinear(_t(img), _t(mapx), _t(mapy))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= U8_FRACTION_MAX, int((diff > 0).sum())
    if kind == "borders":
        off = ((mapx < -1) | (mapx > img.shape[1]) | (mapy < -1)
               | (mapy > img.shape[0]))
        assert off.any() and (got.numpy()[off] == 0).all()


@pytest.mark.parametrize("kind", ["undistort", "borders"])
def test_remap_bilinear_float32_matches_jax(kind):
    img, mapx, mapy = _remap_case(kind)
    imgf = img.astype(np.float32) / 255.0
    want = np.asarray(ju.remap_bilinear(imgf, mapx, mapy))
    got = tu.remap_bilinear(_t(imgf), _t(mapx), _t(mapy))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= F32_ABS_MAX


def test_remap_cache_get_device_and_host_fallback(monkeypatch):
    """get_device uploads the host grids once per device; without cv2
    remap_host is remap_bilinear on CPU tensors."""
    img, _, _ = _remap_case("borders")
    K = np.array([[100.0, 0, 80], [0, 100.0, 45], [0, 0, 1]])
    cache = tu.RemapCache()
    args = ("cam", K, np.array([-0.1, 0.01]), K, (45, 80))
    mx, my = cache.get_device(*args, "cpu")
    assert cache.get_device(*args, torch.device("cpu"))[0] is mx
    hx, hy = cache.get(*args)
    np.testing.assert_array_equal(mx.numpy(), hx)
    np.testing.assert_array_equal(my.numpy(), hy)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tu.remap_host(img, hx, hy)
    want = tu.remap_bilinear(_t(img), mx, my).numpy()
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def mosaic_clip(tmp_path_factory):
    return make_fixture_clip(tmp_path_factory.mktemp("tcomp"), n_frames=4,
                             image_size=(800, 450), with_lidar=False)


@pytest.fixture(scope="module")
def pipes(mosaic_clip):
    """(port pipeline, JAX pipeline) on the clip compiled at 270x480."""
    port = ClipPipeline(scene=compile_scene(mosaic_clip, output_size=SMALL),
                        chunk=2, device="cpu")
    jax_pipe = JClipPipeline(scene=jcompile_scene(mosaic_clip,
                                                  output_size=SMALL), chunk=2)
    return port, jax_pipe


def _valid(pipe, source):
    fm = pipe.frame_matrices(source)
    return [int(i) for i in fm.frame_indices[fm.frame_valid]]


@pytest.mark.parametrize("source", ["cama", "nuscenes"])
def test_mosaics_device_match_host_compositors_and_jax(pipes, source):
    """Every valid frame: the device mosaic (its own raster, left on the
    device) == composite_frame + concat_camera_grid == the native
    composite_mosaic_frame == JAX's mosaic_device given the same raster."""
    port, jax_pipe = pipes
    idxs = _valid(port, source)
    assert len(idxs) >= 2
    h, w = SMALL
    for idx in idxs:
        raster = port._overlay_single(source, idx)
        assert raster.any()
        got = port.mosaics_device([source], idx)[source]
        assert got.shape == (2 * h, 3 * w, 3) and got.dtype == np.uint8
        host = concat_camera_grid(port.composite_frame(source, idx, raster))
        np.testing.assert_array_equal(got, host)
        native = np.empty_like(got)
        assert port.composite_mosaic_frame(source, idx, raster, "raster",
                                           None, native)
        np.testing.assert_array_equal(got, native)
        np.testing.assert_array_equal(
            got, jax_pipe.mosaic_device(source, idx, cls_raster=raster))


def test_mosaics_device_one_upload_for_both_sources(pipes):
    """Both sources of one frame in one call, rasters given as a host array
    and as a tensor, equal to mosaic_device source by source."""
    port, _ = pipes
    idx = _valid(port, "cama")[1]
    rasters = {"cama": port._overlay_single("cama", idx),
               "nuscenes": torch.from_numpy(
                   port._overlay_single("nuscenes", idx))}
    got = port.mosaics_device(["cama", "nuscenes"], idx, rasters)
    assert set(got) == {"cama", "nuscenes"}
    assert not np.array_equal(got["cama"], got["nuscenes"])
    for source in got:
        np.testing.assert_array_equal(got[source],
                                      port.mosaic_device(source, idx))


def test_mosaic_device_value_errors(pipes, mosaic_clip):
    port, _ = pipes
    idx = _valid(port, "cama")[0]
    with pytest.raises(ValueError, match="no labels for source"):
        port.mosaic_device("no-such-source", idx)
    five = [c for row in CAMERA_GRID for c in row][:5]
    cfg = {**DEFAULT_CAMA_CONFIGS, "camera_list": five}
    partial = ClipPipeline(cfg, scene=compile_scene(
        mosaic_clip, cfg, sources=("cama",), output_size=SMALL),
        chunk=2, device="cpu")
    with pytest.raises(ValueError, match="3x2 camera set"):
        partial.mosaics_device(["cama"], idx)
