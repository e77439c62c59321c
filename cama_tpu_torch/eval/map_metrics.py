"""Map-annotation quality metrics on PyTorch: SRE + precision / recall / F1,
and instance association.

Counterpart of cama_tpu/eval/map_metrics.py, function for function.  The 3-D
map annotation is reprojected into every camera image and compared with 2-D
ground-truth lane segmentation masks (the clip format's
`lane_ins_{camera}/<ms>.png` instance images):

  * SRE (semantic reprojection error): mean distance in pixels from each
    reprojected map point to the nearest ground-truth mask pixel, capped at
    `max_radius` (points farther than the cap contribute the cap).
  * precision: fraction of reprojected points within `tolerance` px of the
    mask.
  * recall: fraction of ground-truth mask pixels within `tolerance` px of a
    reprojected point.
  * F1 = 2PR / (P + R).

No distance transform over the whole image is materialized for the default
metric.  Distance to a mask is computed by iterated 3x3 max-dilation:

    dist(p) = sum_{d=0}^{D-1} [ p not in dilate^d(mask) ]

which is the Chebyshev (chessboard) distance capped at D.  Reductions over
frames are plain sums.

Everything here is plain tensor work (dilations, cumulative maxima along
image rows, index_add_ and gather), on whatever device its inputs lie on;
no hand-written kernel belongs to this module.  MapEvaluator runs on its
pipeline's device: the card unless the pipeline was built with
device='cpu'.

Instance-id images are uint16, on the host and on the device.  PyTorch
computes little on uint16, so the functions here reinterpret such a tensor
as int16 (the same bits) where they only move ids around, and widen it to
int32 where they compare them.

MapEvaluator's entries on one device (evaluate_scene, _instances, _all and
_batch) share one chunk loop, MapEvaluator._evaluate: _chunk_layout lays
out the chunks, _chunk_gt fills a chunk's GT ids into one stack (one read
of the GT store per run of frames that hit it; on the card the stack lies
in page-locked host memory, _id_stack), device_ids sends it as it stands
in one copy, and the GT fields derived there (_gt_fields) are
sampled at the projected points (_eval_core, or _sample_fields per row for
a batch of scenes).  A whole-scene evaluation keeps each chunk's fields on
the device for the next one.  The JAX package sends sparse stacks as COO
pairs instead, and the ids on the device are the same.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from cama_tpu_torch.ops.geometry import (
    crop_compact_project_idx,
    project_frames,
)

_EDT_INF = 1e4  # farther than any image diagonal; squared stays finite in f32

PARTIAL_KEYS = ("sre_sum", "n_points", "n_hit", "gt_total", "gt_covered")


def _bits16(t):
    """A uint16 tensor reinterpreted as int16 (no copy); others unchanged."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _wide(ids):
    """Instance ids as int32 values (a uint16 image widens without sign)."""
    return ids.to(torch.int32)


def _foreground(ids):
    """[...] integer ids -> bool, id != 0."""
    return _bits16(ids) != 0


def _upload(arr, device):
    """A NumPy array as a tensor on `device`.  To the card it goes through a
    pinned staging buffer with a non-blocking copy, so the host does not
    wait for the work already queued there."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def dilate3x3(mask):
    """One round of 8-neighborhood binary dilation ([..., H, W] bool).  The
    3x3 box separates: a 3-tap OR along the rows, then along the columns;
    outside the image counts as False."""
    h = mask.clone()
    h[..., :, 1:] |= mask[..., :, :-1]
    h[..., :, :-1] |= mask[..., :, 1:]
    out = h.clone()
    out[..., 1:, :] |= h[..., :-1, :]
    out[..., :-1, :] |= h[..., 1:, :]
    return out


def _row_index(t):
    """[H, 1] int32 row numbers of the image t [..., H, W]."""
    return torch.arange(t.shape[-2], dtype=torch.int32,
                        device=t.device)[:, None]


def _nearest_rows(fg):
    """For a foreground image fg [..., H, W] bool: (above, below) int32, the
    row of the nearest foreground pixel at or above / at or below each pixel
    in its column; -1 / H where there is none.  One cumulative maximum (and
    one minimum) along the rows takes the place of a scan over them."""
    H = fg.shape[-2]
    row = _row_index(fg)
    above = _cum_rows(torch.where(fg, row, -1), torch.cummax)
    below = _cum_rows(torch.where(fg, row, H).flip(-2), torch.cummin).flip(-2)
    return above, below


def _cum_rows(x, op):
    """torch.cummax / torch.cummin of x [..., H, W] along the rows.  On the
    CPU the scan runs several times faster along the innermost axis, so x
    is transposed for it; the card scans along the rows directly."""
    if x.device.type == "cpu":
        return op(x.transpose(-1, -2).contiguous(), dim=-1).values.transpose(-1, -2)
    return op(x, dim=-2).values


def _rows_dist(above, below, H, row):
    """Float32 distances along the column to `above` and `below`.  A column
    with nothing above holds 1e4 + y + 1 (a count that starts at 1e4 at the
    top edge and grows by one per row), one with nothing below 1e4 + H - y:
    the values the JAX scan carries, which later get squared and compared."""
    fd = torch.where(above >= 0, row - above, row + int(_EDT_INF + 1))
    bd = torch.where(below < H, below - row, (H + int(_EDT_INF)) - row)
    return fd.to(torch.float32), bd.to(torch.float32)


def _nearest_dist_rows(mask):
    """[..., H, W] bool -> float32 distance along axis -2 to the nearest True
    in the same column (at least 1e4 where the column is empty)."""
    above, below = _nearest_rows(mask)
    fd, bd = _rows_dist(above, below, mask.shape[-2], _row_index(mask))
    return torch.minimum(fd, bd)


def _shift_cols(a, dx, fill):
    """a[..., x] -> a[..., x + dx], vacated columns filled with `fill`."""
    if dx == 0:
        return a
    pad = torch.full_like(a[..., :abs(dx)], fill)
    if dx > 0:
        return torch.cat([a[..., dx:], pad], dim=-1)
    return torch.cat([pad, a[..., :dx]], dim=-1)


def squared_edt_within(mask, radius):
    """Squared Euclidean distance transform, exact wherever the true distance
    is <= radius (farther pixels carry overestimates >= radius^2, so
    `min(sqrt(d2), radius)` equals the capped exact distance everywhere).

    Same column pass as squared_edt, but the row reduction only considers
    source columns within +-radius: O(H*W*radius) instead of O(H*W^2).
    Every consumer of the transform caps at max_radius/tolerance, which is
    tens of pixels while W is ~10^3.  The 2*radius shifted candidates are
    folded into the result one at a time, in place."""
    W = mask.shape[-1]
    D0 = _nearest_dist_rows(mask) ** 2
    best = D0.clone()
    inf2 = np.float32(_EDT_INF ** 2)
    for dx in range(1, radius + 1):
        c = float(dx * dx)
        n = min(dx, W)
        if dx < W:
            left, right = best[..., :W - dx], best[..., dx:]
            left.copy_(torch.minimum(left, D0[..., dx:] + c))
            right.copy_(torch.minimum(right, D0[..., :W - dx] + c))
        # the columns a shift vacates hold 1e8 + dx^2, rounded to float32
        fill = float(inf2 + np.float32(c))
        best[..., W - n:].clamp_(max=fill)
        best[..., :n].clamp_(max=fill)
    return best


def _column_table(W, device):
    x = torch.arange(W, dtype=torch.float32, device=device)
    return (x[:, None] - x[None, :]) ** 2  # [W(out), W(src)]


def squared_edt(mask, block=8):
    """Exact squared Euclidean distance transform ([..., H, W] bool -> f32).

    Two separable passes: (1) the nearest True along each column (exact,
    because min_y' (y-y')^2 is attained at the nearest y'), (2) a min-plus
    reduction along rows, D[y,x] = min_x' ((x-x')^2 + d_col[y,x']^2),
    evaluated `block` rows at a time so the [W, W] parabola table broadcasts
    in bounded memory.  Matches scipy.ndimage.distance_transform_edt**2 of
    ~mask."""
    W = mask.shape[-1]
    flat = (_nearest_dist_rows(mask) ** 2).reshape(-1, W)
    d2 = _column_table(W, mask.device)
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], block):
        rows = flat[s:s + block]
        out[s:s + block] = (rows[:, None, :] + d2[None]).amin(dim=-1)
    return out.reshape(mask.shape)


def frame_metrics(gt_mask, vu, keep, max_radius, tolerance,
                  distance="chebyshev"):
    """Per-(frame-)camera metric partials.

    Args:
        gt_mask: [C, H, W] bool ground-truth mask (already at output size)
        vu:      [C, P, 2] float32 projected (v, u)
        keep:    [C, P] bool
        max_radius: int, the SRE distance cap (dilation rounds)
        tolerance:  int, the precision/recall hit radius
        distance: 'chebyshev' (iterated 8-neighborhood dilation) or
            'euclidean' (exact separable squared-EDT, the papers' pixel
            distance; quantifies the Chebyshev approximation)

    Returns a dict of 0-d float32 tensors: sre_sum, n_points, n_hit
    (precision numerator), gt_total, gt_covered (recall terms)."""
    return _frame_metrics_impl(gt_mask, vu, keep, max_radius, tolerance,
                               distance)


def frame_metrics_chunk(gt_mask, vu, keep, fv, max_radius, tolerance,
                        distance="chebyshev"):
    """frame_metrics over a whole projection chunk at once.

    Args mirror frame_metrics with a leading frame axis plus a validity
    weight:
        gt_mask: [K, C, H, W] bool (zeros for rows without GT)
        vu/keep: [K, C, P, 2] / [K, C, P]
        fv:      [K] float32 (or bool): 1.0 where the row is a real
                 evaluated frame, 0.0 padding (invalid frame / GT absent)

    Returns frame_metrics' dict with each entry summed over the valid
    rows."""
    p = frame_metrics_rows(gt_mask, vu, keep, max_radius, tolerance, distance)
    z = fv.to(torch.float32)
    return {k2: torch.sum(v * z) for k2, v in p.items()}


def frame_metrics_rows(gt_mask, vu, keep, max_radius, tolerance,
                       distance="chebyshev"):
    """Per-row frame_metrics over a batch: [K, ...] inputs -> dict of [K]
    partials (no reduction).  The multi-scene batch path groups rows by
    scene on the host, so it needs the per-row values; frame_metrics_chunk
    is this plus an fv-weighted sum."""
    return _frame_metrics_impl(gt_mask, vu, keep, max_radius, tolerance,
                               distance)


def _unpack_bits(packed, width):
    """np.packbits' inverse on tensors: [..., Wp] uint8 (big-endian bit
    order) -> [..., width] bool, slicing off packbits' zero padding."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :width].to(torch.bool)


def packbits(bits):
    """np.packbits(bits, axis=-1) on tensors: [..., W] bool -> [..., ceil(W/8)]
    uint8, big-endian bit order, the last byte zero-padded."""
    W = bits.shape[-1]
    b = torch.nn.functional.pad(bits.to(torch.uint8), (0, (-W) % 8))
    b = b.reshape(bits.shape[:-1] + (-1, 8))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=bits.device)
    return (b * weights).sum(dim=-1, dtype=torch.uint8)


def _project_compact_chunk_eval(points, valid, A, B, fv, width, height,
                                lo, hi, k1):
    """Chunked projection with crop-first compaction (the overlay two-stage
    lane's stages 1 and 2, ops/geometry.crop_compact_project_idx): per
    frame, points inside the camera-independent crop box compact to k1
    survivors before the per-camera projections, so the downstream
    per-point metric work (count scatters, vote gathers, all O(points))
    runs over k1 instead of P.  keep requires the crop box, so the
    kept-point set, and therefore every metric, is that of the full-P
    projection.

    Returns (vu [K, C, k1, 2], keep [K, C, k1], sel [K, k1] int32); sel
    indexes the original point axis so callers compact any per-point array
    (e.g. instance ids for association votes) with one gather."""
    vu, keep, sel, _ = crop_compact_project_idx(
        points, valid, A, B, fv, width, height, lo, hi, k1)
    return vu, keep, sel.to(torch.int32)


def _project_compact_scenes(points, valid, A, B, fv, width, height,
                            lo, hi, k1):
    """Scene-batched _project_compact_chunk_eval: [S, ...] stacked tensors
    -> (vu [S, K, C, k1, 2], keep [S, K, C, k1], sel [S, K, k1]).  k1 is
    the fleet-wide maximum of the members' crop-survivor sizings (each
    member's own k1 bounds its survivors, so the maximum is safe for every
    scene; padding points are invalid and never selected)."""
    outs = [_project_compact_chunk_eval(points[s], valid[s], A[s], B[s],
                                        fv[s], width, height, lo, hi, k1)
            for s in range(points.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def _project_scenes(points, valid, A, B, fv, width, height, lo, hi):
    """Scene-batched projection: [S, ...] stacked tensors -> vu [S, K, C, P,
    2], keep [S, K, C, P]."""
    outs = [project_frames(points[s], valid[s], A[s], B[s], fv[s], width,
                           height, lo, hi)
            for s in range(points.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def _id_stack(shape, pinned):
    """An uninitialised uint16 stack for a chunk's GT instance ids: the NumPy
    face of a page-locked tensor when `pinned` (bound for the card), else a
    plain array.  The caller writes or zeroes every row."""
    if not pinned:
        return np.empty(shape, np.uint16)
    # A fresh block for every chunk, dropped once device_ids has queued its
    # copy: the caching host allocator hands a pinned block out again only
    # after the copies that read it have finished (it finds the block by
    # its address, which the NumPy face starts at), so the host fills the
    # next chunk's stack while this one is still in flight.
    return torch.empty(shape, dtype=torch.uint16, pin_memory=True).numpy()


def device_ids(ids_b, device="cuda", timers=None):
    """A chunk's GT instance-id stack as the same uint16 stack on `device`.

    A stack in page-locked memory (_id_stack's) goes to the card as it
    stands, with one non-blocking copy; any other array is first copied
    into page-locked memory.  On the card, `timers` (a PhaseTimers) counts each
    stack as eval_gt_staged or eval_gt_pageable.  The JAX package sends a
    sparse stack as COO pairs to spare its host link; here the host's scan
    for the nonzero ids cost more than the dense copy it saved, so the port
    always sends the stack dense.  The values on the device are the same."""
    ids_b = np.ascontiguousarray(ids_b)
    if ids_b.dtype != np.uint16:
        if ids_b.max(initial=0) >= 65536:  # not an assert: -O must not let
            # out-of-range ids wrap into other instances' votes silently
            raise ValueError("instance ids exceed uint16")
        ids_b = ids_b.astype(np.uint16)
    t = torch.from_numpy(ids_b)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    staged = t.is_pinned()
    if timers is not None:
        timers.add("eval_gt_staged" if staged else "eval_gt_pageable", 0.0)
    return (t if staged else t.pin_memory()).to(device, non_blocking=True)


def _dist_rounds(max_radius, tolerance, distance):
    """Radius the GT distance field must be exact within, per metric family
    (chebyshev runs tolerance+1 rounds so the dilation geometry serves both
    the capped distance sum and the hit test; euclidean's squared-EDT only
    needs exactness to the larger of the two caps)."""
    if distance == "euclidean":
        return max(max_radius, tolerance)
    return max(max_radius, tolerance + 1)


def _dist_field(gt_mask, rounds, distance):
    """GT distance field the per-point metric sums sample: a pure function
    of the masks and the caps, so an evaluator computes it once per chunk
    and may keep it on the device across evaluations (MapEvaluator._retain).

    chebyshev: per-pixel not-covered count over `rounds` dilation passes
    (dist[p] = min(chessboard distance to mask, rounds)), as uint8:
    rounds < 256 holds for any sane pixel cap and quarters the resident
    bytes of an f32 field.
    euclidean: squared_edt_within's output (f32; overestimates beyond
    `rounds` never change a capped consumer)."""
    if distance == "euclidean":
        return squared_edt_within(gt_mask, rounds)
    assert rounds < 256, "distance cap exceeds the uint8 resident field"
    dist_map = torch.zeros(gt_mask.shape, dtype=torch.uint8,
                           device=gt_mask.device)
    m = gt_mask
    for _ in range(rounds):
        dist_map += ~m
        m = dilate3x3(m)
    return dist_map


def _vote_field(gt_ids, tolerance, assignment):
    """Per-pixel GT instance vote map (0 = no instance within tolerance):
    instance_votes_chunk's state before the gather, split out so an
    evaluator can keep it on the device (it too is a pure function of the
    GT ids and the tolerance)."""
    ids = _wide(gt_ids)
    if assignment == "nearest":
        d2, nid = nearest_id_within(ids, int(tolerance))
        vm = torch.where(d2 <= float(tolerance) ** 2, nid, 0)
    else:
        vm = dilate_ids(ids, tolerance)
    return vm.to(gt_ids.dtype)


def _frame_metrics_from_field(gt_mask, dist_field, vu, keep, max_radius,
                              tolerance, distance):
    """Metric partials given a precomputed GT distance field (chebyshev
    uint8 count or euclidean f32 squared-EDT, see _dist_field).  Inputs are
    one frame's [C, ...] (0-d results) or a chunk's [K, C, ...] ([K]
    results): every sum runs over the last three axes (C, H, W).

    Point sums go through an index_add_ count raster, not per-point
    gathers: sre_sum == sum over pixels of count * dist, because every kept
    point at a pixel contributes that pixel's field value, and the count
    raster doubles as the recall point raster.  For chebyshev every sum is
    integer-valued (counts times integer capped distances, far below 2^24),
    so f32 accumulation is exact in any order, atomics included.  For
    euclidean, sre_sum terms are irrational (sqrt) and the order shows in
    the last bits."""
    H, W = gt_mask.shape[-2], gt_mask.shape[-1]
    vi, ui = _clip_pixels(vu, H, W)
    cnt = _point_count_raster(vi, ui, keep, H, W)  # [..., C, H, W] f32
    pr = cnt > 0
    if distance == "euclidean":
        dist = torch.sqrt(dist_field).clamp_(max=float(max_radius))
        hit = dist_field <= float(tolerance) ** 2
        radius = max(max_radius, tolerance)
        covered = gt_mask & (squared_edt_within(pr, radius)
                             <= float(tolerance) ** 2)
    else:
        # the uint8 field caps at rounds >= tolerance+1, so the <= tolerance
        # hit test is unaffected by the cap
        dist = dist_field.clamp(max=max_radius).to(torch.float32)
        hit = dist_field <= tolerance
        # recall: dilate the projected point raster by `tolerance`,
        # intersect gt
        for _ in range(tolerance):
            pr = dilate3x3(pr)
        covered = gt_mask & pr
    dims = (-3, -2, -1)
    return {
        "sre_sum": torch.sum(cnt * dist, dim=dims),
        "n_points": torch.sum(cnt, dim=dims),
        "n_hit": torch.sum(cnt * hit, dim=dims),
        "gt_total": torch.sum(gt_mask, dim=dims).to(torch.float32),
        "gt_covered": torch.sum(covered, dim=dims).to(torch.float32),
    }


def _frame_metrics_impl(gt_mask, vu, keep, max_radius, tolerance, distance):
    rounds = _dist_rounds(max_radius, tolerance, distance)
    field = _dist_field(gt_mask, rounds, distance)
    return _frame_metrics_from_field(gt_mask, field, vu, keep, max_radius,
                                     tolerance, distance)


def _clip_pixels(vu, H, W):
    """[..., P, 2] float (v, u) -> int64 pixel indices clipped into the
    image.  The clamp comes before the cast: for every finite value that
    equals casting first (truncation) and clipping after, and it keeps the
    cast in range, where a float-to-integer cast is defined on both
    devices.  Points that are not kept carry arbitrary (v, u); whatever
    consumes the indices masks by keep."""
    vi = vu[..., 0].clamp(0, H - 1).to(torch.int64)
    ui = vu[..., 1].clamp(0, W - 1).to(torch.int64)
    return vi, ui


def _gather_at(img, vi, ui):
    """Per-camera gather: img [..., C, H, W] at (vi, ui) [..., C, P] ->
    [..., C, P]."""
    W = img.shape[-1]
    return torch.gather(img.flatten(-2), -1, vi * W + ui)


def _point_count_raster(vi, ui, keep, H, W):
    """Add kept points into a [..., C, H, W] f32 count raster (vi, ui, keep
    [..., C, P]).  f32 is exact for any realistic count (< 2^24 points per
    pixel), in any order; one index_add_ feeds every point-weighted metric
    sum and (count > 0) the recall raster.  A point that is not kept adds
    0.0 at its clipped pixel."""
    lead = keep.shape[:-1]
    n = int(np.prod(lead, dtype=np.int64))
    base = torch.arange(n, dtype=torch.int64,
                        device=keep.device).reshape(lead + (1,)) * (H * W)
    idx = (base + vi * W + ui).reshape(-1)
    buf = torch.zeros((n * H * W,), dtype=torch.float32, device=keep.device)
    buf.index_add_(0, idx, keep.reshape(-1).to(torch.float32))
    return buf.reshape(lead + (H, W))


def frame_metrics_host(gt_mask, vu, keep, max_radius, tolerance,
                       distance="chebyshev"):
    """NumPy/SciPy mirror of frame_metrics, the evaluation host backend.

    Same semantics as the tensor implementation: 'chebyshev' uses the exact
    chessboard distance transform (scipy distance_transform_cdt == the
    iterated 8-neighborhood dilation count, integer-exact) capped at
    rounds=max(max_radius, tolerance+1); 'euclidean' uses the exact EDT.
    Exists so evaluation runs with no torch device work at all
    (MapEvaluator(backend='host')), and as the independent version the
    tensor path is held against."""
    from scipy import ndimage

    gt_mask = np.asarray(gt_mask, bool)
    C, H, W = gt_mask.shape
    vi = np.clip(np.asarray(vu)[..., 0].astype(np.int32), 0, H - 1)
    ui = np.clip(np.asarray(vu)[..., 1].astype(np.int32), 0, W - 1)
    keep = np.asarray(keep, bool)
    kf = keep.astype(np.float32)

    # projected-point raster per camera (for recall)
    pr = np.zeros((C, H, W), bool)
    for c in range(C):
        pr[c, vi[c][keep[c]], ui[c][keep[c]]] = True

    if distance == "euclidean":
        def dist_to(mask_c):  # float distance to nearest True, inf if none
            if not mask_c.any():
                return np.full((H, W), np.inf, np.float32)
            return ndimage.distance_transform_edt(~mask_c).astype(np.float32)

        sre_sum = n_hit = 0.0
        gt_covered = 0.0
        for c in range(C):
            d = dist_to(gt_mask[c])
            d_pts = d[vi[c], ui[c]]
            sre_sum += float(np.sum(np.minimum(d_pts, float(max_radius)) * kf[c]))
            n_hit += float(np.sum((d_pts <= float(tolerance)) * kf[c]))
            dp = dist_to(pr[c])
            gt_covered += float(np.sum(gt_mask[c] & (dp <= float(tolerance))))
    else:
        rounds = max(max_radius, tolerance + 1)

        def cheb_to(mask_c, cap):  # capped chessboard distance to True
            if not mask_c.any():
                return np.full((H, W), cap, np.int32)
            d = ndimage.distance_transform_cdt(~mask_c, metric="chessboard")
            return np.minimum(d, cap).astype(np.int32)

        sre_sum = n_hit = 0.0
        gt_covered = 0.0
        for c in range(C):
            d = cheb_to(gt_mask[c], rounds)
            d_pts = d[vi[c], ui[c]]
            sre_sum += float(np.sum(np.minimum(d_pts, max_radius) * kf[c]))
            n_hit += float(np.sum((d_pts <= tolerance) * kf[c]))
            dp = cheb_to(pr[c], tolerance + 1)
            gt_covered += float(np.sum(gt_mask[c] & (dp <= tolerance)))

    return {
        "sre_sum": sre_sum,
        "n_points": float(kf.sum()),
        "n_hit": n_hit,
        "gt_total": float(gt_mask.sum()),
        "gt_covered": gt_covered,
    }


def instance_votes_host(gt_ids, vu, keep, tolerance):
    """Host mirror of instance_votes_chunk for one frame with the 'nearest'
    assignment: [C, H, W] instance ids -> [C, P] vote ids (0 = no instance
    within tolerance).  scipy's exact Euclidean feature transform
    (return_indices) is the nearest-instance assignment; tie-breaking
    between exactly equidistant instances may pick a different (still
    deterministic) winner than the tensor path on the tie set itself.
    Association is a majority vote per map instance, so aggregate metrics
    agree."""
    from scipy import ndimage

    ids = np.asarray(gt_ids)
    C, H, W = ids.shape
    vi = np.clip(np.asarray(vu)[..., 0].astype(np.int32), 0, H - 1)
    ui = np.clip(np.asarray(vu)[..., 1].astype(np.int32), 0, W - 1)
    votes = np.zeros(vi.shape, np.int32)
    for c in range(C):
        if not (ids[c] > 0).any():
            continue
        d, (iy, ix) = ndimage.distance_transform_edt(
            ids[c] == 0, return_indices=True)
        vote_map = np.where(d <= float(tolerance), ids[c][iy, ix], 0)
        votes[c] = vote_map[vi[c], ui[c]].astype(np.int32)
    return votes


# ---------------------------------------------------------------------------
# instance-level association metrics (lane_ins ids, not just binary masks)
# ---------------------------------------------------------------------------


def _nearest_rows_id(ids):
    """[..., H, W] int instance image -> (dist f32, id) of the nearest
    nonzero pixel along axis -2 in the same column (dist at least 1e4 / id 0
    where the column is empty).  Ties between the upper and lower neighbor
    go to the upper one."""
    H = ids.shape[-2]
    above, below = _nearest_rows(ids > 0)
    fd, bd = _rows_dist(above, below, H, _row_index(ids))
    zero = torch.zeros((), dtype=ids.dtype, device=ids.device)
    fi = torch.where(above >= 0,
                     torch.gather(ids, -2, above.clamp(min=0).to(torch.int64)),
                     zero)
    bi = torch.where(below < H,
                     torch.gather(ids, -2, below.clamp(max=H - 1).to(torch.int64)),
                     zero)
    take_f = fd <= bd
    return torch.where(take_f, fd, bd), torch.where(take_f, fi, bi)


def nearest_id_edt(ids, block=8):
    """Exact Euclidean feature transform of an instance-id image:
    ([..., H, W] int, 0 = background) -> (d2 [..., H, W] f32 squared distance
    to the nearest labeled pixel, id [..., H, W] of that pixel).

    Same separable construction as squared_edt, but the row-blocked min-plus
    reduction takes an argmin and gathers the column pass's ids through it,
    so every pixel knows which instance is nearest, not just how far.  Ties
    resolve deterministically (smaller source column, because argmin returns
    the first minimum; upper row within a column)."""
    W = ids.shape[-1]
    D0, I0 = _nearest_rows_id(ids)
    flat_d = (D0 ** 2).reshape(-1, W)
    flat_i = I0.reshape(-1, W)
    d2 = _column_table(W, ids.device)
    out_d = torch.empty_like(flat_d)
    out_i = torch.empty_like(flat_i)
    for s in range(0, flat_d.shape[0], block):
        tot = flat_d[s:s + block, None, :] + d2[None]  # [b, W(out), W(src)]
        src = torch.argmin(tot, dim=-1)
        out_d[s:s + block] = torch.gather(tot, -1, src[..., None])[..., 0]
        out_i[s:s + block] = torch.gather(flat_i[s:s + block], -1, src)
    return out_d.reshape(ids.shape), out_i.reshape(ids.shape)


def nearest_id_within(ids, radius):
    """(d2, id) of the nearest labeled pixel, exact for every pixel whose
    true distance is <= radius; farther pixels may carry overestimates.

    Same column pass as nearest_id_edt, but the row reduction only scans
    source columns within +-radius: any candidate with total d2 <= radius^2
    necessarily has |dx| <= radius, so inside the tolerance mask the result
    (including the smaller-source-column tie-break, enforced by strict-<
    updates in ascending dx order) is that of the full transform.
    O(H*W*radius) instead of the full EDT's O(H*W^2) row reduction."""
    D0, I0 = _nearest_rows_id(ids)
    D0 = D0 ** 2
    best_d, best_i = None, None
    for dx in range(-radius, radius + 1):
        cand_d = _shift_cols(D0, dx, _EDT_INF ** 2) + float(dx * dx)
        cand_i = _shift_cols(I0, dx, 0)
        if best_d is None:
            best_d, best_i = cand_d, cand_i
        else:
            take = cand_d < best_d  # strict: smaller source column wins ties
            best_d = torch.where(take, cand_d, best_d)
            best_i = torch.where(take, cand_i, best_i)
    return best_d, best_i


def dilate_ids(ids, rounds):
    """Max-dilate an instance-id image (0 = background) with the same
    8-neighborhood dilate3x3 uses, so instance voting and the binary
    precision/recall metrics share one tolerance geometry (Chebyshev disc).
    Where two instances are within 2*rounds px of each other the larger id
    wins in the overlap; kept for the 'chebyshev' association mode."""
    out = _wide(ids) if ids.dtype == torch.uint16 else ids
    for _ in range(rounds):
        h = out.clone()
        h[..., :, 1:] = torch.maximum(h[..., :, 1:], out[..., :, :-1])
        h[..., :, :-1] = torch.maximum(h[..., :, :-1], out[..., :, 1:])
        out = h.clone()
        out[..., 1:, :] = torch.maximum(out[..., 1:, :], h[..., :-1, :])
        out[..., :-1, :] = torch.maximum(out[..., :-1, :], h[..., 1:, :])
    return out.to(ids.dtype)


def instance_votes_chunk(gt_ids, vu, keep, tolerance, assignment="nearest"):
    """The tensor half of association voting, over a projection chunk: for
    each projected point, the GT instance id it votes for (0 = no GT
    instance within `tolerance` px).

    gt_ids: [K, C, H, W] int (0 = background); vu/keep: [K, C, P, 2]/[K, C, P]
    Returns [K, C, P] vote ids in gt_ids' dtype (votes are ids drawn from
    gt_ids, so they fit it; the host filters by keep and row validity).
    """
    H, W = gt_ids.shape[-2], gt_ids.shape[-1]
    vi, ui = _clip_pixels(vu, H, W)
    gt_d = _vote_field(gt_ids, tolerance, assignment)
    return _gather_at(_bits16(gt_d), vi, ui).view(gt_ids.dtype)


# ---------------------------------------------------------------------------
# the device chunk step: GT fields derived from a chunk's ids on the card,
# sampled at the projected points; the fields are pure functions of the GT
# masks and the caps, so an evaluator may keep them on the device
# ---------------------------------------------------------------------------


def _gt_fields(gt_ids, max_radius, tolerance, distance, assignment, metrics,
               votes):
    """A chunk's GT fields, derived from its ids [..., C, H, W] where they
    lie: (the foreground mask, the distance field when `metrics`, the vote
    field when `votes`; None for a field not asked for)."""
    gt_mask = _foreground(gt_ids)
    dist_fd = (_dist_field(gt_mask, _dist_rounds(max_radius, tolerance,
                                                 distance), distance)
               if metrics else None)
    vote_fd = _vote_field(gt_ids, tolerance, assignment) if votes else None
    return gt_mask, dist_fd, vote_fd


def _sample_fields(gt_mask, dist_field, vote_field, vu, keep, max_radius,
                   tolerance, distance):
    """The GT fields sampled at the projected points vu/keep [..., C, P', 2]
    / [..., C, P']: (per-row metric partials, a dict of [...] tensors, or
    None without a distance field; votes [..., C, P'] in the vote field's
    dtype, or None without a vote field)."""
    rows = votes = None
    if dist_field is not None:
        rows = _frame_metrics_from_field(gt_mask, dist_field, vu, keep,
                                         max_radius, tolerance, distance)
    if vote_field is not None:
        vi, ui = _clip_pixels(vu, *vote_field.shape[-2:])
        votes = _gather_at(_bits16(vote_field), vi, ui).view(vote_field.dtype)
    return rows, votes


def _eval_core(points, valid, A, B, fvb, dist_field, gt_mask, vote_field,
               width, height, lo, hi, k1, max_radius, tolerance, distance):
    """One scene's chunk: project (crop-compacted to k1 when engaged), then
    sample the GT fields.  fvb [K] bool gates both the projection's
    frame_valid and the metric row weights: a row is live only when its
    frame is valid and its GT masks exist.

    Returns (partials dict of 0-d tensors, or None without a distance
    field; votes [K, C, P'] or None; keep [K, C, P']; sel [K, P'] int32 or
    None)."""
    if k1 is not None:
        vu, keep, sel = _project_compact_chunk_eval(
            points, valid, A, B, fvb, width, height, lo, hi, k1)
    else:
        vu, keep = project_frames(points, valid, A, B, fvb, width, height,
                                  lo, hi)
        sel = None
    rows, votes = _sample_fields(gt_mask, dist_field, vote_field, vu, keep,
                                 max_radius, tolerance, distance)
    partials = None
    if rows is not None:
        z = fvb.to(torch.float32)
        partials = {k2: torch.sum(v * z) for k2, v in rows.items()}
    return partials, votes, keep, sel


def _eval_chunk_build(points, valid, A, B, fvb, gt_ids, width, height, lo, hi,
                      k1, max_radius, tolerance, distance, assignment,
                      want_votes, want_metrics=True):
    """A chunk whose fields are not kept: derive them from the ids on the
    device (_gt_fields) and evaluate.  Returns the evaluation outputs plus
    the fields (distance field, the GT mask bitpacked, vote field; None
    where not asked for), which the caller may keep."""
    gt_mask, dist_fd, vote_fd = _gt_fields(gt_ids, max_radius, tolerance,
                                           distance, assignment,
                                           want_metrics, want_votes)
    partials, votes, keep, sel = _eval_core(
        points, valid, A, B, fvb, dist_fd, gt_mask, vote_fd,
        width, height, lo, hi, k1, max_radius, tolerance, distance)
    gtp = packbits(gt_mask) if want_metrics else None
    return partials, votes, keep, sel, dist_fd, gtp, vote_fd


def _eval_chunk_serve(points, valid, A, B, fvb, dist_field, gtp, vote_field,
                      width, height, lo, hi, k1, max_radius, tolerance,
                      distance):
    """A chunk whose fields are kept: the points, the frame matrices and the
    fields already lie on the device, and nothing is uploaded."""
    gt_mask = None if gtp is None else _unpack_bits(gtp, width)
    return _eval_core(points, valid, A, B, fvb, dist_field, gt_mask,
                      vote_field, width, height, lo, hi, k1, max_radius,
                      tolerance, distance)


def frame_instance_pairs(gt_ids, vu, keep, point_inst, tolerance,
                         assignment="nearest", device="cuda"):
    """Per-frame (map_instance_id, gt_instance_id) pairs for every kept
    projected point: the raw material for association voting.

    gt_ids: [C, H, W] integer GT instance image (0 = background)
    vu/keep: [C, P, 2] / [C, P] projections;  point_inst: [P] map instance ids
    assignment: 'nearest' (exact: each point votes for the Euclidean-nearest
        GT instance within `tolerance` px) or 'chebyshev' (id max-dilation;
        larger id wins where instances overlap).
    Inputs are NumPy arrays; the work runs on `device`.
    Returns (mi [N], gi [N]) numpy arrays (gi = 0 where no GT instance is
    within tolerance).
    """
    keep_np = np.asarray(keep)
    g_at = instance_votes_chunk(
        device_ids(np.asarray(gt_ids), device)[None],
        _upload(np.asarray(vu, np.float32), device)[None],
        _upload(keep_np, device)[None], tolerance, assignment)[0].cpu().numpy()
    mi = np.broadcast_to(np.asarray(point_inst)[None, :], keep_np.shape)[keep_np]
    return mi.astype(np.int64), g_at[keep_np].astype(np.int64)


def instance_association(pairs_mi, pairs_gi, gt_ids_visible=None):
    """Majority-vote association + quality metrics over accumulated pairs.

    gt_ids_visible: optional set of GT instance ids actually present in the
    (undilated) masks, the recall denominator.  Defaults to the ids seen in
    the gathered votes (an underestimate of the denominator when a GT
    instance's map twin was culled before projection).

    Returns dict:
      instance_precision: fraction of visible map instances whose majority
        vote lands on a real GT instance (not background)
      instance_recall: fraction of GT instance ids claimed by >=1 map
        instance's majority vote
      mean_purity: mean over map instances of (votes for the winner /
        total votes), background included in the denominator
      n_map_instances / n_gt_instances
    """
    mi = np.asarray(pairs_mi)
    gi = np.asarray(pairs_gi)
    if len(mi) == 0:
        return {"instance_precision": 0.0, "instance_recall": 0.0,
                "mean_purity": 0.0, "n_map_instances": 0, "n_gt_instances": 0}
    gt_total = (set(gt_ids_visible) if gt_ids_visible is not None
                else set(np.unique(gi[gi > 0]).tolist()))
    matched_gt = set()
    purities = []
    n_matched = 0
    for m in np.unique(mi):
        votes = gi[mi == m]
        ids, counts = np.unique(votes, return_counts=True)
        # majority among non-background; ties resolve to the smaller id
        fg = ids > 0
        if fg.any():
            k = np.argmax(counts[fg])
            winner, wcount = int(ids[fg][k]), int(counts[fg][k])
        else:
            winner, wcount = 0, 0
        purities.append(wcount / len(votes))
        if winner > 0:
            n_matched += 1
            matched_gt.add(winner)
    n_map = len(np.unique(mi))
    return {
        "instance_precision": n_matched / n_map if n_map else 0.0,
        "instance_recall": len(matched_gt) / len(gt_total) if gt_total else 0.0,
        "mean_purity": float(np.mean(purities)) if purities else 0.0,
        "n_map_instances": n_map,
        "n_gt_instances": len(gt_total),
    }


def reduce_metrics(partials):
    """Sum per-frame partial dicts -> final metric dict."""
    total = {}
    for p in partials:
        for k, v in p.items():
            total[k] = total.get(k, 0.0) + float(v)
    n_pts = total.get("n_points", 0.0)
    gt_tot = total.get("gt_total", 0.0)
    precision = total["n_hit"] / n_pts if n_pts else 0.0
    recall = total["gt_covered"] / gt_tot if gt_tot else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {
        "SRE": total.get("sre_sum", 0.0) / n_pts if n_pts else float("nan"),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "n_points": n_pts,
        "gt_pixels": gt_tot,
    }


def _fetch_partials(partials):
    """A list of partial dicts of tensors (0-d, or [R] per-row) -> the same
    dicts of NumPy values, through one stack and one copy to the host."""
    if not partials:
        return []
    stacked = torch.stack([torch.stack([p[k] for k in PARTIAL_KEYS])
                           for p in partials]).cpu().numpy()
    return [dict(zip(PARTIAL_KEYS, row)) for row in stacked]


def _fetch_optional(tensors, on_card):
    """pipeline._fetch_async over a tuple that may hold None entries:
    (host tensors with None kept in place, event or None)."""
    from cama_tpu_torch.pipeline import _fetch_async

    present = [t for t in tensors if t is not None]
    hosts, done = _fetch_async(present, on_card)
    it = iter(hosts)
    return tuple(None if t is None else next(it) for t in tensors), done


def _fold_votes(sink, inst, votes, keep):
    """One evaluated row's (map instance, GT instance) vote pairs into an
    association sink: inst [P'] the map instance id of each of the row's
    points, votes / keep [C, P']."""
    sink["mi"].append(
        np.broadcast_to(inst[None, :], keep.shape)[keep].astype(np.int64))
    sink["gi"].append(votes[keep].astype(np.int64))


class MapEvaluator:
    """Scene-level SRE/precision/recall/F1 over reprojected map elements.
    The device work runs on the evaluated pipeline's device.  Every entry
    on one device (evaluate_scene, evaluate_scene_instances,
    evaluate_scene_all, evaluate_scene_batch) runs one chunk loop,
    _evaluate."""

    # device memory the GT fields one evaluator keeps may take: beyond it,
    # later chunks are evaluated and not kept (long scenes do not crowd out
    # the overlay pipeline)
    RESIDENT_BUDGET_MB = 2048.0
    # device-vote backlog bound (chunks): enough in flight to overlap host GT
    # loading with device work, small enough that vote buffers stay O(1) in
    # scene length (a [K, C, P] uint16 + bool pair per chunk can be tens of
    # MB at production point counts)
    MAX_PENDING_CHUNKS = 4

    _EMPTY_ASSOCIATION = {"instance_precision": 0.0, "instance_recall": 0.0,
                          "mean_purity": 0.0, "n_map_instances": 0,
                          "n_gt_instances": 0}

    def __init__(self, tolerance=5, max_radius=20, distance="chebyshev",
                 backend="device", compact="auto"):
        import weakref

        from cama_tpu_torch.profiling import PhaseTimers

        self.tolerance = int(tolerance)
        self.max_radius = int(max_radius)
        self.distance = distance
        if compact not in ("auto", "off"):
            raise ValueError(f"unknown compact {compact!r}")
        # 'auto': when the scene's counting pass engaged the overlay path's
        # crop-first two-stage split (pipeline.crop_compact_k: wide or
        # long-range scenes where most points fall outside the per-frame
        # crop), the device projections compact to the k1 crop survivors
        # before the per-point metric work runs, cutting it P/k1-fold.  The
        # kept-point set is unchanged (keep requires the crop box), so
        # every metric is unchanged.  'off' forces full-P projections.
        self.compact = compact
        # per-phase wall-clock like the pipeline's: print
        # evaluator.timers.report() after a run to see where an evaluation
        # spent its time (GT load, dispatch, fetch)
        self.timers = PhaseTimers()
        if backend not in ("device", "host"):
            raise ValueError(f"unknown backend {backend!r}")
        # 'host': NumPy/SciPy projections and metrics (frame_metrics_host,
        # instance_votes_host), with no tensor work.  Covers the full scene
        # surface with the default 'nearest' assignment; the 'dilate'
        # assignment stays device-only.
        self.backend = backend
        # pipeline -> {"bytes": int, "chunks": {(source, s): entry}}: the GT
        # fields whole-scene device evaluations keep on the device (_retain);
        # weak keys, so retired pipelines release their fields with them
        self._resident_fields = weakref.WeakKeyDictionary()
        # evaluate_scene_batch_sharded's steps, keyed by the mesh's layout
        self._sharded_steps = {}

    def instance_loader(self, pipeline, camera, image_idx):
        """Load and nearest-remap a `lane_ins_{camera}` instance-id PNG to
        the output size (the undistort remap with INTER_NEAREST).  Returns
        [H, W] int ids (0 = background) or None.  Served from the per-clip
        GT mask store (pipeline.gt_mask_cache) after the first decode, once
        the PNG is found on disk.  The chunk loader (_chunk_gt) calls it
        only for rows its bulk read of the store cannot serve: a store hit
        there reads with no path check."""
        import cv2

        scene = pipeline.scene
        ms = scene.sync_ms[camera][image_idx]
        path = f"{scene.clip_path}/lane_ins_{camera}/{ms}.png"
        if not os.path.exists(path):  # absent masks are routine (not every
            return None               # clip ships GT)
        c = scene.camera_list.index(camera)
        cache = pipeline.gt_mask_cache()
        if cache is not None:
            cached = cache.get(image_idx, c)
            if cached is not None:
                return cached  # read-only mmap view; callers copy into stacks
        raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        if raw is None:
            return None
        h, w = scene.output_size
        mapx, mapy = pipeline.remaps.get(
            camera, scene.K_orig[c], scene.d[c], scene.K_scaled[c], (h, w)
        )
        ids = cv2.remap(raw, mapx, mapy, interpolation=cv2.INTER_NEAREST)
        if cache is not None:
            # own=True: the freshly remapped ids are never mutated (metric
            # consumers stack/copy); skips the store's defensive copy
            cache.put(image_idx, c, ids.astype(np.uint16, copy=False),
                      own=True)
        return ids

    def mask_loader(self, pipeline, camera, image_idx):
        """Binary-mask view of instance_loader. Returns [H, W] bool or None."""
        ids = self.instance_loader(pipeline, camera, image_idx)
        return None if ids is None else ids > 0

    def _camera_ids(self, pipeline, image_idx):
        """Instance-id images for every camera (GT store views), or None if
        any is missing."""
        ids = []
        for camera in pipeline.scene.camera_list:
            m = self.instance_loader(pipeline, camera, image_idx)
            if m is None:
                return None
            ids.append(m)
        return ids

    def _chunk_gt(self, pipes, idxs):
        """GT instance-id stack of one chunk, whose row kk is frame idxs[kk]
        (None: no frame) of the pipeline pipes[kk].

        Returns (ids_b [K, C, H, W] uint16, zeros for rows without GT;
        fv [K] float32 row validity; evaluated (row, frame index) list), or
        (None, fv, []) when no row in the chunk has GT masks (the chunk's
        metric work is skipped entirely).  uint16 holds any id cv2 can read
        from a lane_ins PNG (8- or 16-bit).  For a device evaluator on the
        card the stack lies in page-locked memory, which device_ids sends
        as it stands.

        Rows whose frames are complete in the GT store (every camera's slot
        a hit; FrameCache.complete) are taken in runs: consecutive frames
        of one pipeline in consecutive rows.  A run is one bulk read
        straight into its rows (FrameCache.read_into), with no lookup of
        any lane_ins file: the refresh at the entry re-signed the PNGs and
        keys the store by them, so a valid slot proves its PNG is there.
        Every other row (a miss, a pipeline without a store) goes through
        _camera_ids.  self.timers counts eval_gt_store_rows and
        eval_gt_store_reads (rows and reads of the bulk path) and
        eval_gt_decoded_rows (rows that took _camera_ids)."""
        K = len(idxs)
        ids_b = None
        fv = np.zeros((K,), np.float32)
        evaluated = []
        kk = 0
        while kk < K:
            pipe, i0 = pipes[kk], idxs[kk]
            if i0 is None:
                kk += 1
                continue
            pinned = self.backend == "device" and pipe.device.type == "cuda"
            store = pipe.gt_mask_cache()
            n = 0
            while (store is not None and kk + n < K and pipes[kk + n] is pipe
                   and idxs[kk + n] == i0 + n and store.complete(i0 + n)):
                n += 1
            if n:
                if ids_b is None:
                    ids_b = _id_stack((K,) + store.shape[1:], pinned)
                store.read_into(i0, ids_b[kk:kk + n])
                self.timers.add("eval_gt_store_rows", 0.0, n)
                self.timers.add("eval_gt_store_reads", 0.0)
                fv[kk:kk + n] = 1.0
                evaluated.extend((kk + j, i0 + j) for j in range(n))
                kk += n
                continue
            self.timers.add("eval_gt_decoded_rows", 0.0)
            ids = self._camera_ids(pipe, i0)
            if ids is not None:
                if ids_b is None:
                    ids_b = _id_stack((K, len(ids)) + ids[0].shape, pinned)
                for c, m in enumerate(ids):
                    ids_b[kk, c] = m
                fv[kk] = 1.0
                evaluated.append((kk, i0))
            kk += 1
        if not evaluated:
            return None, fv, []
        ids_b[fv == 0] = 0  # the stack starts uninitialised
        return ids_b, fv, evaluated

    def _chunk_layout(self, pipeline, source):
        """Chunk row layout: yields (s, idxs) for the chunk that starts at
        frame s, idxs[kk] the frame index of row kk or None (an invalid
        frame or padding).  A MultiScenePipeline's chunks hold `chunk` rows
        of each member carrying `source`, one member after another."""
        from cama_tpu_torch.pipeline import MultiScenePipeline

        if isinstance(pipeline, MultiScenePipeline):
            fms, Fs, _A, _B, fv = pipeline._stacked(source)
            n = int(fv.shape[1])
        else:
            fm, _A, _B, fv, F = pipeline._chunked_AB(source)
            fms, Fs, n = [fm], [F], len(fv)
        K = pipeline.chunk
        for s in range(0, n, K):
            yield s, [int(fm.frame_indices[k])
                      if k < F and fm.frame_valid[k] else None
                      for fm, F in zip(fms, Fs) for k in range(s, s + K)]

    def _stack_scenes(self, msp, pipes, source):
        """A fleet's geometry: (points [S, P, 3], valid [S, P], A, B: the
        members' points padded with invalid points to a common P and their
        stacked frame matrices, on the device; k1).  k1 compacts to the
        members' largest crop-survivor sizing when every member's counting
        pass engaged the split (mixed or unsized fleets stay full-P), the
        already-known-only rule of the solo path (pipeline.crop_compact_k
        never runs the counting pass)."""
        tens = [p.scene_tensors(source) for p in pipes]
        P = max(int(t.points.shape[0]) for t in tens)
        points = torch.stack([torch.nn.functional.pad(
            t.points, (0, 0, 0, P - t.points.shape[0])) for t in tens])
        valid = torch.stack([torch.nn.functional.pad(
            t.valid, (0, P - t.valid.shape[0])) for t in tens])
        _fms, _Fs, A, B, _fv = msp._stacked(source)
        k1 = None
        if self.compact == "auto":
            ks = [p.crop_compact_k(source) for p in pipes]
            if all(k is not None for k in ks) and max(ks) * 2 <= P:
                k1 = max(ks)
        return points, valid, A, B, k1

    def _evaluate(self, pipeline, source, frames, metrics, votes,
                  assignment):
        """The one chunk loop: binary metrics when `metrics`, instance votes
        when `votes`, over the chunks of _chunk_layout (the rows of `frames`
        alone, when given).

        pipeline: a ClipPipeline, or a MultiScenePipeline (whose members
        carrying `source` are evaluated side by side).  Per chunk,
        _chunk_gt loads the rows' GT ids (eval_gt_load) and a chunk without
        any is skipped.  Then the step (eval_dispatch): device_ids sends
        the ids to the card in one copy, the GT fields are derived there
        (_gt_fields: _dist_field for the metrics, _vote_field for the
        votes) and sampled at the projected points, by _eval_core for one
        scene, by _sample_fields per row for a fleet.  Partials come back
        in one _fetch_partials after the last chunk (eval_fetch), votes
        through _drain_votes every MAX_PENDING_CHUNKS chunks.  The host
        backend runs the same loop on NumPy/SciPy (eval_host).

        A whole scene on the device keeps each chunk's fields under the GT
        store's content key, so regenerated masks drop them with the store
        (_resident_fields, RESIDENT_BUDGET_MB), and a later pass that needs
        no other field serves them (_eval_chunk_serve) without loading or
        sending any GT.

        Returns one result dict per evaluated scene."""
        from cama_tpu_torch.pipeline import (
            MultiScenePipeline,
            _host_project_chunk,
            _host_project_compact_chunk,
        )

        host = self.backend == "host"
        if votes and host and assignment != "nearest":
            # here, not in the loop: there it would fire only on a chunk
            # with GT, and a GT-less clip would return empty results
            raise ValueError("backend='host' supports assignment='nearest'")
        fleet = isinstance(pipeline, MultiScenePipeline)
        pipes = ([pipeline.pipelines[i] for i in pipeline.members(source)]
                 if fleet else [pipeline])
        device, K = pipeline.device, pipeline.chunk
        caps = (self.max_radius, self.tolerance, self.distance)
        with self.timers.phase("eval_gt_refresh"):
            for p in pipes:
                p.refresh_gt_cache()  # pick up regenerated GT masks
            gt_store = (None if fleet or host or frames is not None
                        else pipeline.gt_mask_cache())
        store = (None if gt_store is None else self._resident_fields
                 .setdefault(pipeline, {"bytes": 0, "chunks": {}}))
        with self.timers.phase("eval_layout"):
            layout = list(self._chunk_layout(pipeline, source))
            h, w = pipes[0].scene.output_size
            lo, hi = pipes[0]._crop_lo, pipes[0]._crop_hi
            if host:
                _fm, A, B, fv_all, _F = pipeline._chunked_AB(source)
                points, valid = (pipeline.scene.flat[source].points,
                                 pipeline.scene.flat[source].valid)
            elif fleet:
                points, valid, A, B, k1 = self._stack_scenes(pipeline, pipes,
                                                             source)
            else:
                st = pipeline.scene_tensors(source)
                points, valid, A, B = st.points, st.valid, st.A, st.B
                k1 = (pipeline.crop_compact_k(source)
                      if self.compact == "auto" else None)
        if frames is not None:
            wanted = set(frames)
            layout = [(s, [i if i in wanted else None for i in idxs])
                      for s, idxs in layout]
        row_pipes = [p for p in pipes for _ in range(K)]
        if votes:  # each scene's point instance ids, padded to the fleet's P
            P = max(len(p.scene.flat[source].inst) for p in pipes)
            insts = [np.pad(np.asarray(p.scene.flat[source].inst),
                            (0, P - len(p.scene.flat[source].inst)))
                     for p in pipes]
        need = ((("dist", "gtp") if metrics else ())
                + ((("votes", assignment),) if votes else ()))
        partials, pending = [], []
        sinks = [{"mi": [], "gi": []} for _ in pipes]
        visible = [set() for _ in pipes]
        n_evaluated = [0] * len(pipes)
        for s, idxs in layout:
            sl = slice(s, s + K)
            key = (source, s)
            entry = (None if store is None
                     else self._kept(store, key, gt_store.key, need))
            if entry is None:
                with self.timers.phase("eval_gt_load"):
                    ids_b, fv, evaluated = self._chunk_gt(row_pipes, idxs)
                if ids_b is None:
                    if store is not None:  # kept: the chunk has no GT
                        store["chunks"][key] = {"gt_key": gt_store.key,
                                                "fields": None, "bytes": 0}
                    continue
                vis = ([np.unique(b[b > 0]) for b in np.split(ids_b,
                                                              len(pipes))]
                       if votes else None)
            elif entry["fields"] is None:
                continue
            else:
                evaluated, vis = entry["evaluated"], entry["visible"]
            if host:
                with self.timers.phase("eval_host"):
                    # crop-first when compact='auto', unconditionally:
                    # padding is local to the chunk, and wide scenes cut the
                    # f64 per-point work by the crop ratio
                    if self.compact == "auto":
                        vu, keep, sel = _host_project_compact_chunk(
                            points, valid, A[sl], B[sl], fv_all[sl], w, h,
                            lo, hi)
                    else:
                        vu, keep = _host_project_chunk(
                            points, valid, A[sl], B[sl], fv_all[sl], w, h,
                            lo, hi)
                        sel = None
                    for kk, _image_idx in evaluated:
                        if metrics:
                            partials.append((frame_metrics_host(
                                ids_b[kk] > 0, vu[kk], keep[kk], *caps),
                                None))
                        if votes:
                            _fold_votes(sinks[0], insts[0] if sel is None
                                        else insts[0][sel[kk]],
                                        instance_votes_host(
                                            ids_b[kk], vu[kk], keep[kk],
                                            self.tolerance), keep[kk])
            else:
                with self.timers.phase("eval_dispatch"):
                    if entry is not None:
                        got = {n: entry["fields"][n] for n in need}
                        p, v, keep, sel = _eval_chunk_serve(
                            points, valid, A[sl], B[sl], entry["fvb"],
                            got.get("dist"), got.get("gtp"),
                            got.get(("votes", assignment)), w, h, lo, hi,
                            k1, *caps)
                    elif fleet:
                        fvb = _upload(fv > 0, device).reshape(-1, K)
                        gt_mask, dist_fd, vote_fd = _gt_fields(
                            device_ids(ids_b, device, self.timers), *caps,
                            assignment, metrics, votes)
                        if k1 is not None:
                            vu, keep, sel = _project_compact_scenes(
                                points, valid, A[:, sl], B[:, sl], fvb, w, h,
                                lo, hi, k1)
                            sel = sel.flatten(0, 1)
                        else:
                            vu, keep = _project_scenes(
                                points, valid, A[:, sl], B[:, sl], fvb, w, h,
                                lo, hi)
                            sel = None
                        vu, keep = vu.flatten(0, 1), keep.flatten(0, 1)
                        p, v = _sample_fields(gt_mask, dist_fd, vote_fd, vu,
                                              keep, *caps)
                    else:
                        fvb = _upload(fv > 0, device)
                        p, v, keep, sel, *fields = _eval_chunk_build(
                            points, valid, A[sl], B[sl], fvb,
                            device_ids(ids_b, device, self.timers), w, h,
                            lo, hi, k1, *caps, assignment, votes, metrics)
                if store is not None and entry is None:
                    self._retain(store, key, gt_store.key, fvb, evaluated,
                                 vis, dict(zip(("dist", "gtp",
                                                ("votes", assignment)),
                                               fields)))
                if metrics:
                    partials.append((p, evaluated if fleet else None))
                if votes:
                    self._push_votes(pending, (v, keep, sel, [
                        (kk, insts[kk // K], sinks[kk // K])
                        for kk, _image_idx in evaluated]), device)
            for kk, _image_idx in evaluated:
                n_evaluated[kk // K] += 1
            for m, ids in enumerate(vis or ()):
                visible[m].update(ids.tolist())
        self._drain_votes(pending, device)
        with self.timers.phase("eval_host" if host else "eval_fetch"):
            fetched = [p for p, _rows in partials]
            if not host:
                fetched = _fetch_partials(fetched)
            per_scene = [[] for _ in pipes]
            for f, (_p, rows) in zip(fetched, partials):
                if rows is None:  # one scene's chunk sum, or a host row
                    per_scene[0].append(f)
                for kk, _image_idx in rows or ():
                    per_scene[kk // K].append(
                        {k2: v[kk] for k2, v in f.items()})
            outs = [reduce_metrics(rows) if metrics else {}
                    for rows in per_scene]
        for out, sink, vis_m, n in zip(outs, sinks, visible, n_evaluated):
            if votes:
                assoc = self._associate(sink, vis_m)
                out.update(assoc if assoc is not None
                           else self._EMPTY_ASSOCIATION)
            out["frames_evaluated"] = n
        return outs

    @staticmethod
    def _kept(store, key, gt_key, need):
        """The kept entry of chunk `key` when it serves a pass that needs
        the fields named in `need`: one that holds them all, or one kept
        for a chunk with no GT (fields None); else None.  An entry of
        regenerated masks is dropped."""
        entry = store["chunks"].get(key)
        if entry is not None and entry["gt_key"] != gt_key:
            store["bytes"] -= store["chunks"].pop(key)["bytes"]
            return None
        if (entry is None or entry["fields"] is None
                or all(n in entry["fields"] for n in need)):
            return entry
        return None

    def _retain(self, store, key, gt_key, fvb, evaluated, vis, fields):
        """Keep a built chunk's fields (those not None) with any an earlier
        pass kept for it, unless that takes the store past
        RESIDENT_BUDGET_MB: then the chunk keeps none."""
        old = store["chunks"].pop(key, None) or {"fields": {}, "bytes": 0,
                                                 "visible": None}
        store["bytes"] -= old["bytes"]
        fields = {**old["fields"],
                  **{n: t for n, t in fields.items() if t is not None}}
        nbytes = sum(t.numel() * t.element_size() for t in fields.values())
        if store["bytes"] + nbytes <= self.RESIDENT_BUDGET_MB * 1e6:
            store["chunks"][key] = {
                "gt_key": gt_key, "fvb": fvb, "evaluated": evaluated,
                "visible": old["visible"] if vis is None else vis,
                "fields": fields, "bytes": nbytes}
            store["bytes"] += nbytes

    def evaluate_scene(self, pipeline, source="cama", frames=None):
        """SRE, precision, recall and F1 over all valid frames that have GT
        masks (those in `frames` alone, when given), chunk by chunk
        (pipeline.chunk frames at a time, so memory stays bounded for long
        scenes; _evaluate)."""
        return self._evaluate(pipeline, source, frames, True, False,
                              "nearest")[0]

    def evaluate_scene_instances(self, pipeline, source="cama", frames=None,
                                 assignment="nearest"):
        """Instance-level association quality over all valid frames with GT
        instance masks: each map instance's projected points vote on a GT
        instance id (for the Euclidean-nearest instance within tolerance by
        default, see instance_votes_chunk); reports precision/recall/purity
        (see instance_association)."""
        return self._evaluate(pipeline, source, frames, False, True,
                              assignment)[0]

    def evaluate_scene_all(self, pipeline, source="cama", frames=None,
                           assignment="nearest"):
        """Scene metrics and instance association in one pass: the GT is
        read and sent once a chunk, the projections run once a chunk, and
        both metric families sample fields of the same ids.  The result
        dict is the union of the two single-metric methods' outputs."""
        return self._evaluate(pipeline, source, frames, True, True,
                              assignment)[0]

    def _drain_votes(self, pending, device):
        """Fetch the queued chunks' device votes, keep masks and selections
        in one wave of pinned copies and fold each evaluated row's vote
        pairs into its scene's sink.  pending: list of (votes [R, C, P'],
        keep [R, C, P'], sel [R, P'] or None, rows), rows a list of (row,
        its scene's point instance ids, its scene's sink); with a compacted
        projection, sel maps each row's point axis back to the scene's."""
        if not pending:
            return
        with self.timers.phase("eval_fetch"):
            hosts, done = _fetch_optional(
                [t for item in pending for t in item[:3]],
                device.type == "cuda")
            if done is not None:
                done.synchronize()
            fetched = [None if t is None else t.numpy() for t in hosts]
        for i, (_, _, _, rows) in enumerate(pending):
            g_at, keep_np, sel_np = fetched[3 * i:3 * i + 3]
            for kk, inst, sink in rows:
                _fold_votes(sink, inst if sel_np is None else inst[sel_np[kk]],
                            g_at[kk], keep_np[kk])
        pending.clear()

    def _push_votes(self, pending, item, device):
        """Queue one chunk's device votes, draining when the backlog bound
        is hit (keeps the device busy without unbounded buffers)."""
        pending.append(item)
        if len(pending) >= self.MAX_PENDING_CHUNKS:
            self._drain_votes(pending, device)

    @staticmethod
    def _associate(sink, visible):
        if not sink["mi"]:
            return None
        return instance_association(np.concatenate(sink["mi"]),
                                    np.concatenate(sink["gi"]),
                                    gt_ids_visible=visible)

    def evaluate_scene_batch(self, pipelines, source="cama", instances=False,
                             assignment="nearest"):
        """Fleet evaluation: every scene's metric work batched into one wave
        per chunk, riding MultiScenePipeline's stacked frame matrices
        (scenes pad to a common (P, F); the batching the CLI uses for
        overlay videos).  Per-scene results come from per-row partials
        grouped on the host, so each scene still gets its own metric dict.

        pipelines: list of ClipPipeline (same output size, lane and device)
            or a MultiScenePipeline.
        instances: also run association voting per scene.
        Returns: list aligned with the input pipelines: a result dict per
        scene, or None for scenes that lack the source or have no GT.
        """
        from cama_tpu_torch.pipeline import MultiScenePipeline

        if self.backend == "host":
            # the fleet path exists to batch device work; the host backend
            # has none, so route per scene through the host evaluators
            # (same full surface)
            pipes_list = (pipelines.pipelines
                          if isinstance(pipelines, MultiScenePipeline)
                          else list(pipelines))
            if not any(source in p.scene.flat for p in pipes_list):
                # same failure mode as the device route (which raises via
                # MultiScenePipeline._stacked), not a silent all-None list
                raise ValueError(f"no member scene carries source {source!r}")
            results = []
            for p in pipes_list:
                if source not in p.scene.flat:
                    results.append(None)
                    continue
                r = (self.evaluate_scene_all(p, source, assignment=assignment)
                     if instances else self.evaluate_scene(p, source))
                results.append(r if r.get("frames_evaluated") else None)
            return results

        msp = (pipelines if isinstance(pipelines, MultiScenePipeline)
               else MultiScenePipeline(pipelines, source=source))
        outs = self._evaluate(msp, source, None, True, instances, assignment)
        results = [None] * len(msp.pipelines)
        for gi, out in zip(msp.members(source), outs):
            if out["frames_evaluated"]:
                results[gi] = out
        return results

    def evaluate_scene_batch_sharded(self, pipelines, mesh, source="cama"):
        """Fleet evaluation with the scene batch sharded over a ('scenes',
        'frames') mesh of ranks (parallel.make_scene_mesh): each rank owns
        whole scenes' point tensors plus a shard of each chunk's frame
        rows, and per-scene metric partials come back summed over the
        frames axis only (parallel.sharded_scene_batch_metrics).

        SPMD: every rank of the mesh calls this with the same pipelines,
        loads the ground truth of its own (scene, frame row) shard only,
        and returns the same full list.  Binary metrics only (association
        voting keeps the single-device fleet path); results match
        evaluate_scene_batch per scene.  The scene axis pads to
        mesh.shape['scenes'] with all-invalid dummy scenes, frame chunks
        pad to a multiple of mesh.shape['frames'].

        pipelines: list of ClipPipeline (same output size) or a
            MultiScenePipeline.
        Returns: list aligned with the input pipelines: a result dict per
        scene, or None for scenes lacking the source or GT.
        """
        import torch.distributed as dist

        from cama_tpu_torch.parallel.sharding import (
            LocalBlock, mesh_max, sharded_scene_batch_metrics)
        from cama_tpu_torch.pipeline import MultiScenePipeline

        if self.backend == "host":
            raise ValueError(
                "evaluate_scene_batch_sharded is a multi-device program; "
                "backend='host' has no mesh to shard over; use "
                "evaluate_scene_batch (which routes host per scene) or "
                "backend='device'")
        msp = (pipelines if isinstance(pipelines, MultiScenePipeline)
               else MultiScenePipeline(pipelines, source=source))
        members = msp.members(source)
        fms, Fs, A, B, fv = (v if isinstance(v, list) else v.cpu().numpy()
                             for v in msp._stacked(source))
        pipes = [msp.pipelines[i] for i in members]
        with self.timers.phase("eval_gt_refresh"):
            for p in pipes:
                p.refresh_gt_cache()  # pick up regenerated GT masks
        h, w = pipes[0].scene.output_size
        lo, hi = pipes[0]._crop_lo, pipes[0]._crop_hi
        S = len(pipes)
        n_scene_shards = mesh.shape["scenes"]
        n_frame_shards = mesh.shape["frames"]
        Sp = -(-S // n_scene_shards) * n_scene_shards
        # frame-chunk rows per dispatch: the fleet chunk, padded to shard
        K = max(msp.chunk, n_frame_shards)
        K = -(-K // n_frame_shards) * n_frame_shards

        flats = [p.scene.flat[source] for p in pipes]
        P = max(len(f.points) for f in flats)
        pts = np.zeros((Sp, P, 3), np.float32)
        valid = np.zeros((Sp, P), bool)
        for i, f in enumerate(flats):
            pts[i, :len(f.points)] = f.points
            valid[i, :len(f.valid)] = f.valid

        def padS(a):
            return np.pad(a, [(0, Sp - S)] + [(0, 0)] * (a.ndim - 1))

        A_p, B_p, fv_p = padS(A), padS(B), padS(fv)
        padF = (-fv_p.shape[1]) % K  # frame axis to a chunk multiple
        if padF:
            A_p = np.pad(A_p, [(0, 0), (0, padF)] + [(0, 0)] * (A_p.ndim - 2))
            A_p[:, -padF:] = np.eye(4)  # keep pad matrices well-formed
            B_p = np.pad(B_p, [(0, 0), (0, padF)] + [(0, 0)] * (B_p.ndim - 2))
            fv_p = np.pad(fv_p, [(0, 0), (0, padF)])

        # fleet-wide crop compaction, same consult-only rule as the other
        # forms (pipeline.crop_compact_k never dispatches counting)
        k1 = None
        if self.compact == "auto":
            ks = [p.crop_compact_k(source) for p in pipes]
            if ks and all(k is not None for k in ks):
                k1 = max(ks)
                if k1 * 2 > P:
                    k1 = None
        # key the step by the mesh's SHAPE, ranks and device, not id(): a
        # collected mesh's id can be reused by a differently laid out
        # successor, which would be served a step built for the old axis
        # extents.  The step runs its collectives on the groups of the mesh
        # it was built with, so an entry serves a later mesh only while
        # that mesh has the same group objects (a process group destroyed
        # and started again hands out new ones)
        mesh_key = (tuple(mesh.shape.items()), mesh.ranks, str(mesh.device))
        step_key = (mesh_key, w, h, self.max_radius, self.tolerance,
                    self.distance, k1)
        groups = tuple(mesh.group(a) for a in mesh.axis_names)
        built_on, step = self._sharded_steps.get(step_key, ((), None))
        if step is None or any(g is not o for g, o in zip(groups, built_on)):
            step = sharded_scene_batch_metrics(
                mesh, w, h, self.max_radius, self.tolerance, self.distance,
                k1=k1)
            self._sharded_steps[step_key] = groups, step

        # this rank's block of (scene, frame row) pairs
        S_l, K_l = Sp // n_scene_shards, K // n_frame_shards
        s_lo, r_lo = mesh.coord("scenes") * S_l, mesh.coord("frames") * K_l
        sums = np.zeros((S_l, len(PARTIAL_KEYS)))
        counts = np.zeros(S_l)
        C = len(pipes[0].scene.camera_list)
        for s in range(0, fv_p.shape[1], K):
            # GT rows of this rank's block only; row validity = frame valid
            # AND complete GT (GT-less rows contribute nothing, matching
            # evaluate_scene_batch's skip)
            gt = np.zeros((S_l, K_l, C, h, w), bool)
            rv = np.zeros((S_l, K_l), bool)
            with self.timers.phase("eval_gt_load"):
                for i in range(min(S_l, S - s_lo)):
                    fm, F = fms[s_lo + i], Fs[s_lo + i]
                    for j in range(K_l):
                        fidx = s + r_lo + j
                        if fidx >= F or not fm.frame_valid[fidx]:
                            continue
                        ids = self._camera_ids(
                            pipes[s_lo + i], int(fm.frame_indices[fidx]))
                        if ids is None:
                            continue
                        gt[i, j] = np.stack(ids) > 0
                        rv[i, j] = True
                        counts[i] += 1
            # every rank takes the same branch: a chunk is skipped only
            # when no rank holds ground truth in it
            if not mesh_max(mesh, torch.tensor(rv.any()))[0]:
                continue
            with self.timers.phase("eval_dispatch"):
                sl = slice(s, s + K)
                p = step(pts, valid, LocalBlock(gt), A_p[:, sl], B_p[:, sl],
                         LocalBlock(rv), lo, hi)
            with self.timers.phase("eval_fetch"):
                sums += torch.stack([p[k2] for k2 in PARTIAL_KEYS],
                                    dim=1).cpu().numpy()
        # the scene blocks' sums (the same on every rank of a frames line)
        # and counts (this rank's rows only) -> the whole fleet everywhere
        counts_t = mesh.all_reduce(torch.from_numpy(counts).to(mesh.device),
                                   dist.ReduceOp.SUM, ("frames",))
        block = torch.cat([torch.from_numpy(sums).to(mesh.device),
                           counts_t[:, None]], dim=1)
        fleet = mesh.gather(block, "scenes").cpu().numpy()

        results = [None] * len(msp.pipelines)
        for mi_s, gi in enumerate(members):
            n_eval = int(fleet[mi_s, -1])
            if n_eval == 0:
                continue
            out = reduce_metrics([dict(zip(PARTIAL_KEYS, fleet[mi_s, :-1]))])
            out["frames_evaluated"] = n_eval
            results[gi] = out
        return results


def main(argv=None):
    """Map-quality evaluation script: SRE, precision, recall, F1-score, and
    with --instances the association metrics, as one JSON line."""
    import argparse
    import json
    import math

    from cama_tpu_torch.pipeline import ClipPipeline

    parser = argparse.ArgumentParser(description="SRE / precision / recall / F1 map evaluation")
    parser.add_argument("--clip", required=True, help="clip directory")
    parser.add_argument("--source", default="cama", choices=["cama", "nuscenes"])
    parser.add_argument("--tolerance", type=int, default=5, help="hit radius (px)")
    parser.add_argument("--max-radius", type=int, default=20, help="SRE distance cap (px)")
    parser.add_argument("--distance", default="chebyshev",
                        choices=["chebyshev", "euclidean"],
                        help="point->mask metric: chebyshev (dilation rounds, "
                             "cheapest) or euclidean (exact EDT)")
    parser.add_argument("--instances", action="store_true",
                        help="also report instance-level association metrics")
    parser.add_argument("--backend", default="device",
                        choices=["device", "host"],
                        help="'host' = NumPy/SciPy evaluation (no tensor "
                             "work); full surface incl. --instances with "
                             "the default 'nearest' assignment")
    parser.add_argument("--compact", default="auto",
                        choices=["auto", "off"],
                        help="'auto' (default) bounds per-point metric work "
                             "to the per-frame crop survivors on long-range "
                             "scenes (metrics identical); 'off' forces "
                             "full-P projections")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    pipe = ClipPipeline(clip_path=args.clip, device=args.device)
    ev = MapEvaluator(tolerance=args.tolerance, max_radius=args.max_radius,
                      distance=args.distance, backend=args.backend,
                      compact=args.compact)
    if args.instances:  # one pass computes both metric families
        result = ev.evaluate_scene_all(pipe, args.source)
    else:
        result = ev.evaluate_scene(pipe, args.source)
    # NaN (no frames/points evaluated) must serialize as null: bare NaN
    # tokens are not valid JSON and break strict consumers
    print(json.dumps({
        k: (None if isinstance(v, float) and not math.isfinite(v)
            else round(v, 4) if isinstance(v, float) else v)
        for k, v in result.items()}))


if __name__ == "__main__":
    main()
