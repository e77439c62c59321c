"""Overlay rasterization with deterministic paint order, in PyTorch.

Counterpart of cama_tpu/ops/raster.py.  A point's paint priority is its
index in the compacted survivor list (ascending = later drawn), packed with
its class id as ``priority * MAX_CLS + cls``; a per-pixel scatter-max at the
point centres followed by two rounds of plus-stencil max-dilation paints
cv2's radius-2 disk (the L1 ball of radius 2) with "last drawn wins"
semantics; rasterize_packed scatters the 13 stencil samples directly.
Outputs are integers and match the JAX functions exactly
(tests/test_torch_raster.py, tests/test_torch_composite.py).  The device
compositors (composite_overlay, composite_mosaic_device) are plain tensor
ops, as their JAX counterparts are XLA programs.
"""
from __future__ import annotations

import numpy as np
import torch

from cama_tpu_torch.ops.lift import COLOR_MAPS

# cv2.circle(radius=2, thickness=-1) footprint: (dy, dx) offsets
CIRCLE_R2_OFFSETS = np.array(
    [(-2, 0)]
    + [(-1, dx) for dx in (-1, 0, 1)]
    + [(0, dx) for dx in (-2, -1, 0, 1, 2)]
    + [(1, dx) for dx in (-1, 0, 1)]
    + [(2, 0)],
    dtype=np.int32,
)  # [13, 2]

MAX_CLS = 8  # packing stride; class ids must stay below this


def _plus_dilate(img):
    """One round of max-dilation with the 3x3 plus stencil over [N, H, W];
    out-of-image contributions are -1 (no paint), matching cv2's border
    clipping."""
    n = torch.nn.functional.pad(img, (1, 1, 1, 1), value=-1)
    return torch.maximum(
        img,
        torch.maximum(
            torch.maximum(n[..., :-2, 1:-1], n[..., 2:, 1:-1]),
            torch.maximum(n[..., 1:-1, :-2], n[..., 1:-1, 2:]),
        ),
    )


def _encode_effective(vu, keep, cls, width, height):
    """Per-point pixel+class encoding and the consecutive-duplicate
    suppression mask (a kept successor on the same pixel repaints the same
    stencil later, so the point is dropped).

    vu [..., P, 2] float32 (v, u), keep [..., P] bool, cls [..., P] int32.
    Returns (enc [..., P] int32 with -1 at suppressed/dropped points,
    eff [..., P] bool)."""
    vi = vu[..., 0].to(torch.int32)
    ui = vu[..., 1].to(torch.int32)
    enc = (vi * width + ui) * MAX_CLS + cls
    enc = torch.where(keep, enc, -1)
    pix = torch.div(enc, MAX_CLS, rounding_mode="floor")
    dup = torch.cat(
        [keep[..., 1:] & keep[..., :-1] & (pix[..., 1:] == pix[..., :-1]),
         torch.zeros_like(keep[..., :1])],
        dim=-1,
    )
    eff = keep & ~dup
    return torch.where(eff, enc, -1), eff


def scatter_max(pix, prio, hw):
    """Per-row scatter-max of priorities into rasters that start at -1.

    pix [N, K] int (flat pixel index; `hw` = dropped), prio [N, K] int32.
    Returns [N, hw] int32."""
    buf = torch.full((pix.shape[0], hw + 1), -1, dtype=torch.int32,
                     device=pix.device)
    buf.scatter_reduce_(1, pix.to(torch.int64), prio, "amax")
    return buf[:, :hw]


def rasterize_packed(vu, keep, cls, width, height, prio_offset=0):
    """Dense packed raster with the full 13-sample circle stamp: every kept
    point scatters ``(prio_offset + index) * MAX_CLS + cls`` at each of its
    stencil pixels inside the image (samples off the image are dropped one
    by one, as cv2 clips a circle).

    vu [..., P, 2] f32 (v, u), keep [..., P] bool, cls [P] int32.  Returns
    packed [..., H, W] int32: -1 where unpainted."""
    P = vu.shape[-2]
    vi = vu[..., 0].to(torch.int32)
    ui = vu[..., 1].to(torch.int32)
    order = torch.arange(P, dtype=torch.int32, device=vu.device)
    prio = torch.broadcast_to((prio_offset + order) * MAX_CLS + cls,
                              vu.shape[:-1])
    offs = torch.from_numpy(CIRCLE_R2_OFFSETS).to(vu.device)  # [13, 2]
    yy = vi[..., None] + offs[:, 0]  # [..., P, 13]
    xx = ui[..., None] + offs[:, 1]
    inside = ((yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
              & keep[..., None])
    pix = torch.where(inside, yy * width + xx, height * width)
    n = len(CIRCLE_R2_OFFSETS)
    prio13 = torch.broadcast_to(prio[..., None], pix.shape)
    out = scatter_max(pix.reshape(-1, P * n), prio13.reshape(-1, P * n),
                      height * width)
    return out.reshape(vu.shape[:-2] + (height, width))


def _scatter_dilate(pix, prio, width, height, batch):
    """scatter_max at the centres, then the two plus-stencil dilations that
    paint cv2's radius-2 disk: packed [*batch, H, W] int32."""
    out = scatter_max(pix, prio, height * width).reshape(-1, height, width)
    return _plus_dilate(_plus_dilate(out)).reshape(batch + (height, width))


def rasterize_packed_fast(vu, keep, cls, width, height, prio_offset=0):
    """Dense packed raster straight from a projection, with no compaction
    (the 'scatter' lane): every kept point scatters
    ``(prio_offset + index) * MAX_CLS + cls`` at its centre pixel, then the
    two dilations.

    vu [..., P, 2] f32 (v, u), keep [..., P] bool, cls [P] int32.  Returns
    packed [..., H, W] int32: -1 where unpainted."""
    P = vu.shape[-2]
    vi = vu[..., 0].to(torch.int32)
    ui = vu[..., 1].to(torch.int32)
    order = torch.arange(P, dtype=torch.int32, device=vu.device)
    prio = torch.broadcast_to((prio_offset + order) * MAX_CLS + cls,
                              vu.shape[:-1])
    # in-image guard: a kept point with an out-of-image centre would alias
    # vi * width + ui onto a wrong in-image pixel
    inside = (vi >= 0) & (vi < height) & (ui >= 0) & (ui < width)
    pix = torch.where(keep & inside, vi * width + ui, height * width)
    return _scatter_dilate(pix.reshape(-1, P), prio.reshape(-1, P), width,
                           height, vu.shape[:-2])


def effective_counts(vu, keep, cls, width, height):
    """Effective (deduped) kept-point counts [...] int32: compact_points'
    counts without the compaction, for the counting pass that sizes k."""
    _, eff = _encode_effective(vu, keep, cls, width, height)
    return eff.sum(dim=-1, dtype=torch.int32)


def compact_points(vu, keep, cls, width, height, k):
    """Stable compaction of the deduped kept points into a fixed-size list
    per (frame, camera), in original point order (= paint order).

    vu [..., P, 2] f32, keep [..., P] bool, cls [P] int32.  Returns
    vals [..., k] int32 (encodings ``pix * MAX_CLS + cls``, -1 past the
    count; the first k survivors when count > k) and counts [...] int32,
    the true survivor totals.  Equals the JAX sort_key_val compaction:
    each survivor's rank is the running count of survivors before it."""
    P = vu.shape[-2]
    enc, eff = _encode_effective(vu, keep, cls, width, height)
    eff = eff.reshape(-1, P)
    vals = compact_rows(enc.reshape(-1, P), eff, k)
    batch = vu.shape[:-2]
    return (vals.reshape(batch + (k,)),
            eff.sum(dim=-1, dtype=torch.int32).reshape(batch))


def compact_rows(enc, sel, k):
    """Stable compaction of each row's selected entries to its front.

    enc [N, P] int32, sel [N, P] bool.  Returns [N, k] int32: the first k
    selected entries of each row in order, -1 past them.  A selected entry's
    slot is the running count of selected entries before it."""
    rank = torch.cumsum(sel, dim=-1, dtype=torch.int32) - 1
    slot = torch.where(sel & (rank < k), rank, k)  # k = dropped
    out = torch.full((enc.shape[0], k + 1), -1, dtype=torch.int32,
                     device=enc.device)
    out.scatter_(1, slot.to(torch.int64), enc)
    return out[:, :k]


def rasterize_from_compact(vals, width, height, prio_offset=0):
    """Dense packed raster from a compacted survivor list.

    vals: [..., K] int32 encodings ``pix * MAX_CLS + cls`` (-1 = empty), in
    ascending paint order.  Returns packed [..., H, W] int32: -1 where
    unpainted, else ``(prio_offset + index) * MAX_CLS + cls`` of the
    topmost point covering the pixel.  prio_offset: the base paint
    priority; a point-sharded caller passes shard_index * K, so the partial
    rasters of contiguous point slices combine by elementwise max in the
    global paint order."""
    K = vals.shape[-1]
    flat = vals.reshape(-1, K)
    ok = flat >= 0
    pix = torch.where(ok, torch.div(flat, MAX_CLS, rounding_mode="floor"),
                      height * width)
    order = torch.arange(K, dtype=torch.int32, device=vals.device)
    prio = ((prio_offset + order) * MAX_CLS
            + torch.where(ok, flat % MAX_CLS, 0))
    prio = torch.where(ok, prio, -1).to(torch.int32)
    return _scatter_dilate(pix, prio, width, height, vals.shape[:-1])


def compact_points_host(vu, keep, cls, width, height, k):
    """NumPy mirror of compact_points (a copy of
    cama_tpu/ops/raster.py:compact_points_host): the same encoding,
    consecutive-duplicate suppression and paint order, so paint_sparse_host
    draws identical overlays from either producer.

    vu [..., P, 2] float32, keep [..., P] bool, cls [P] ->
    (vals [..., k] int32 with -1 padding, counts [...] int32; counts > k
    signals overflow exactly like compact_points)."""
    vu = np.asarray(vu)
    keep = np.asarray(keep, bool)
    cls = np.asarray(cls)
    vi = vu[..., 0].astype(np.int32)
    ui = vu[..., 1].astype(np.int32)
    enc = (vi * width + ui) * MAX_CLS + cls
    enc = np.where(keep, enc, -1)
    pix = enc // MAX_CLS
    dup = np.concatenate(
        [keep[..., 1:] & keep[..., :-1] & (pix[..., 1:] == pix[..., :-1]),
         np.zeros_like(keep[..., :1])],
        axis=-1,
    )
    eff = keep & ~dup
    counts = eff.sum(axis=-1).astype(np.int32)
    batch = keep.shape[:-1]
    P = keep.shape[-1]
    vals = np.full(batch + (k,), -1, np.int32)
    flat_eff = eff.reshape(-1, P)
    flat_enc = enc.reshape(-1, P)
    flat_vals = vals.reshape(-1, k)
    for r in range(flat_eff.shape[0]):
        kept = flat_enc[r][flat_eff[r]]
        n = min(len(kept), k)
        flat_vals[r, :n] = kept[:n]
    return vals, counts


def paint_sparse_host(image_bgr, vals, count, color_table, width):
    """Paint a sparse list (compact_points' encodings, in paint order) onto
    a host image with cv2.circle(radius=2)'s footprint, last drawn wins:
    the stencil indices are laid out point-major, so NumPy's sequential
    fancy assignment reproduces draw order (a copy of
    cama_tpu/ops/raster.py:paint_sparse_host)."""
    n = int(count)
    if n <= 0:
        return image_bgr
    v = np.asarray(vals[:n])
    enc = v[v >= 0]
    if len(enc) == 0:
        return image_bgr
    cls = enc % MAX_CLS
    pix = enc // MAX_CLS
    py = pix // width
    px = pix % width
    h, w = image_bgr.shape[:2]
    offs = CIRCLE_R2_OFFSETS
    yy = py[:, None] + offs[None, :, 0]  # [n, 13] point-major
    xx = px[:, None] + offs[None, :, 1]
    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    flat = (yy * w + xx)[ok]
    colors = np.broadcast_to(color_table[cls][:, None, :],
                             (len(enc), len(offs), 3))[ok]
    image_bgr.reshape(-1, 3)[flat] = colors
    return image_bgr


def packed_to_cls(packed):
    """Packed raster -> uint8 class raster (0 = unpainted, else class_id +
    1): the format that crosses device -> host for compositing."""
    painted = packed >= 0
    return torch.where(painted, packed % MAX_CLS + 1, 0).to(torch.uint8)


def pack_cls_2bit(cls_raster):
    """uint8 class raster (values 0..3) -> 2-bit packed [..., ceil(W/4)]
    uint8; widths that are not a multiple of 4 are zero-padded
    (unpack_cls_2bit slices back to the true width)."""
    x = cls_raster.to(torch.uint8)
    pad = (-x.shape[-1]) % 4
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return (x[..., 0::4] | (x[..., 1::4] << 2) | (x[..., 2::4] << 4)
            | (x[..., 3::4] << 6))


def unpack_cls_2bit(packed2, width):
    """Host-side inverse of pack_cls_2bit (NumPy)."""
    p = np.asarray(packed2)
    out = np.empty(p.shape[:-1] + (p.shape[-1] * 4,), np.uint8)
    out[..., 0::4] = p & 3
    out[..., 1::4] = (p >> 2) & 3
    out[..., 2::4] = (p >> 4) & 3
    out[..., 3::4] = (p >> 6) & 3
    return out[..., :width]


def build_color_table(class_names, color_maps=None):
    """Per-class BGR color rows from `color_maps` (class name -> RGB,
    default lift.COLOR_MAPS); any class other than "lane_marking" takes the
    "Crosswalk_Line" color, as the reference renderer does."""
    color_maps = color_maps or COLOR_MAPS
    rows = []
    for name in class_names:
        eff = name if name == "lane_marking" else "Crosswalk_Line"
        rows.append(color_maps[eff][::-1])  # BGR, as cv2 draws on BGR images
    return np.asarray(rows, dtype=np.uint8)


def _color_rows(color_table, idx):
    """color_table[idx] with idx clamped into the table's rows, as XLA
    clamps an out-of-range gather: the unpainted pixels' index (row 7 of
    MAX_CLS for class 0) stays a valid read of a K-row table."""
    return color_table[idx.clamp(0, color_table.shape[0] - 1)]


def composite_overlay(image_bgr, packed, color_table):
    """Paint a packed raster onto an image on the device: image[painted] =
    color[cls] (cama_tpu/ops/raster.py:composite_overlay).

    image_bgr [..., H, W, 3] uint8, packed [..., H, W] int32 (-1 =
    unpainted), color_table [K, 3] uint8."""
    painted = packed >= 0
    cls = torch.where(painted, packed % MAX_CLS, 0).long()
    return torch.where(painted[..., None], _color_rows(color_table, cls),
                       image_bgr)


def composite_mosaic_device(base, cls_raster, color_table, grid, rows=2,
                            cols=3):
    """Paint and 3x2 mosaic placement on the device, so the host receives
    one [rows * h, cols * w, 3] frame
    (cama_tpu/ops/raster.py:composite_mosaic_device).

    base [C, h, w, 3] uint8 undistorted camera images; cls_raster [C, h, w]
    uint8 class rasters (0 = unpainted, else class + 1); color_table
    [K, 3] uint8 BGR rows; grid [C] integer mosaic slot per camera (row *
    cols + col).  Painted pixels take color_table[(cls - 1) % MAX_CLS],
    the rest keep the base pixel: byte-identical to the host
    compositor."""
    painted = cls_raster > 0
    colors = _color_rows(color_table, (cls_raster.long() - 1) % MAX_CLS)
    imgs = torch.where(painted[..., None], colors, base)
    _C, h, w, _3 = base.shape
    slots = torch.zeros((rows * cols, h, w, 3), dtype=imgs.dtype,
                        device=imgs.device)
    slots[grid.long()] = imgs
    return (slots.view(rows, cols, h, w, 3).permute(0, 2, 1, 3, 4)
            .reshape(rows * h, cols * w, 3))


def composite_overlay_host(image_bgr, packed, color_table):
    """NumPy composite of a packed raster (-1 = unpainted) onto a host
    image (a copy of cama_tpu/ops/raster.py:composite_overlay_host)."""
    packed = np.asarray(packed)
    painted = packed >= 0
    out = np.array(image_bgr, copy=True)
    out[painted] = color_table[packed[painted] % MAX_CLS]
    return out


def rasterize_exact_host(image_bgr, vu_list, class_names, color_table=None):
    """Reference-exact host rasterization via cv2: draws circles in order
    with cv2.circle (a copy of cama_tpu/ops/raster.py:rasterize_exact_host;
    the anchor every lane is validated against).

    vu_list: [(class_name, vu [P, 2] float)] per instance, already masked.
    """
    import cv2

    img = np.array(image_bgr, copy=True)
    for cls_name, vu in vu_list:
        pts = np.asarray(vu).astype(np.int32)
        eff = cls_name if cls_name == "lane_marking" else "Crosswalk_Line"
        color = tuple(COLOR_MAPS[eff][::-1].tolist())
        for v, u in pts:
            cv2.circle(img, (int(u), int(v)), 2, color, -1)
    return img
