"""cama_tpu_torch.ops.raster against cama_tpu.ops.raster on identical numpy
inputs (CPU).  Every output is an integer raster, so the two packages must
agree exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cama_tpu.ops import raster as jr
from cama_tpu_torch.ops import raster as tr

W, H = 40, 24


def _points(seed, P=600, C=3):
    rng = np.random.default_rng(seed)
    # pixel-centred runs of near-duplicate points, some off-image, some
    # dropped, so suppression, clipping and paint order all matter
    base = rng.uniform([-3.0, -3.0], [H + 3.0, W + 3.0], size=(C, P // 3, 2))
    vu = np.repeat(base, 3, axis=1) + rng.uniform(0, 0.4, (C, P, 2))
    vu = vu.astype(np.float32)
    keep = ((vu[..., 0] >= 0) & (vu[..., 0] < H) & (vu[..., 1] >= 0)
            & (vu[..., 1] < W) & (rng.uniform(size=(C, P)) > 0.1))
    cls = rng.integers(0, 3, size=(C, P)).astype(np.int32)
    return vu, keep, cls


def test_constants_match():
    assert tr.MAX_CLS == jr.MAX_CLS
    np.testing.assert_array_equal(tr.CIRCLE_R2_OFFSETS, jr.CIRCLE_R2_OFFSETS)


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_effective_matches(seed):
    vu, keep, cls = _points(seed)
    enc_j, eff_j = jr._encode_effective(jnp.asarray(vu), jnp.asarray(keep),
                                        jnp.asarray(cls), W, H)
    enc_t, eff_t = tr._encode_effective(torch.from_numpy(vu),
                                        torch.from_numpy(keep),
                                        torch.from_numpy(cls), W, H)
    np.testing.assert_array_equal(enc_t.numpy(), np.asarray(enc_j))
    np.testing.assert_array_equal(eff_t.numpy(), np.asarray(eff_j))
    assert 0 < eff_t.sum() < keep.sum(), "suppression is not exercised"


def test_rasterize_from_compact_matches():
    vu, keep, cls = _points(2)
    enc, _ = jr._encode_effective(jnp.asarray(vu), jnp.asarray(keep),
                                  jnp.asarray(cls), W, H)
    vals = np.array(enc)  # -1 holes inside the list exercise the mask
    got = tr.rasterize_from_compact(torch.from_numpy(vals), W, H).numpy()
    ref = np.asarray(jr.rasterize_from_compact(jnp.asarray(vals), W, H))
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).any() and (got < 0).any()


def test_plus_dilate_matches():
    rng = np.random.default_rng(4)
    img = np.where(rng.uniform(size=(2, H, W)) > 0.95,
                   rng.integers(0, 1000, size=(2, H, W)), -1).astype(np.int32)
    np.testing.assert_array_equal(
        tr._plus_dilate(torch.from_numpy(img)).numpy(),
        np.asarray(jr._plus_dilate(jnp.asarray(img))))


@pytest.mark.parametrize("width", [W, W + 3])
def test_cls_and_2bit_packing_match(width):
    rng = np.random.default_rng(5)
    packed = np.where(rng.uniform(size=(2, 3, H, width)) > 0.6,
                      rng.integers(0, 4000, size=(2, 3, H, width)) * 8
                      + rng.integers(0, 3, size=(2, 3, H, width)),
                      -1).astype(np.int32)
    cls_t = tr.packed_to_cls(torch.from_numpy(packed))
    cls_j = jr.packed_to_cls(jnp.asarray(packed))
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_j))
    p2_t = tr.pack_cls_2bit(cls_t)
    p2_j = jr.pack_cls_2bit(cls_j)
    np.testing.assert_array_equal(p2_t.numpy(), np.asarray(p2_j))
    np.testing.assert_array_equal(tr.unpack_cls_2bit(p2_t.numpy(), width),
                                  jr.unpack_cls_2bit(np.asarray(p2_j), width))
    np.testing.assert_array_equal(tr.unpack_cls_2bit(p2_t.numpy(), width),
                                  cls_t.numpy())


def test_color_table_matches():
    names = ["lane_marking", "Road_teeth", "Crosswalk_Line", "other"]
    np.testing.assert_array_equal(tr.build_color_table(names),
                                  jr.build_color_table(names))
