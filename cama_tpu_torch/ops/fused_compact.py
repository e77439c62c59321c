"""Fused project + dedup + compact: the overlay front end for a batch of
frames.

Counterpart of cama_tpu/ops/fused_compact.py.  For every frame of a chunk it
projects the scene's points into all cameras, applies the crop box and the
image bounds, drops a point whose original-order successor is kept on the
same pixel, and stably compacts the points kept by any camera into a union
list: vals[f, r, c] = enc + 1 for camera c (0 = not kept by c), with
enc = pix * MAX_CLS + cls, in original point order (row = paint priority);
count[f] is the true number of rows, also when it exceeds k_cap.

`fused_compact_project` launches the hand-written CUDA kernel
(csrc/fused_compact.cu) for CUDA tensors, and uses the plain PyTorch version
`fused_compact_project_ref` only for CPU tensors.  Both project with
ops.geometry.project_frames' elementwise order, so they agree exactly on the
card.
"""
from __future__ import annotations

import torch

from cama_tpu_torch.ops.geometry import check_frame_inputs, project_frames, route
from cama_tpu_torch.ops.raster import (MAX_CLS, compact_rows,
                                       rasterize_from_compact)

# launches of each CUDA entry point, counted by its wrapper (plain-version
# calls on CPU tensors do not count)
LAUNCHES = {"fused_compact_project": 0, "count_union": 0}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _pixels(points, ok, A, B, width, height, crop_lo, crop_hi):
    """Pixel codes [C, P] int32 of one frame (-1 = not kept); `ok` [P] is
    the point validity already combined with the frame's."""
    vu, keep = project_frames(points, ok, A[None], B[None],
                              torch.ones(1, dtype=torch.bool, device=ok.device),
                              width, height, crop_lo, crop_hi)
    pix = vu[0, ..., 0].to(torch.int32) * width + vu[0, ..., 1].to(torch.int32)
    return torch.where(keep[0], pix, -1)


def _effective(points, valid, cls, A, B, fv, width, height, crop_lo, crop_hi):
    """Per-camera payload [C, P] int32 (enc + 1, or 0) and the union mask
    [P] of one frame."""
    pix = _pixels(points, valid & fv, A, B, width, height, crop_lo, crop_hi)
    succ = torch.cat([pix[:, 1:], torch.full_like(pix[:, :1], -1)], dim=1)
    eff = (pix >= 0) & (succ != pix)
    val = torch.where(eff, pix * MAX_CLS + cls[None, :] + 1, 0)
    return val, eff.any(dim=0)


def fused_compact_project_ref(points, valid, cls, A, B, frame_valid, width,
                              height, crop_lo, crop_hi, k_cap):
    """Plain PyTorch version of the fused kernel (any device).

    Args:
        points [P, 3] f32, valid [P] bool, cls [P] int32 (< MAX_CLS)
        A [F, 4, 4] f32 world -> chassis, B [F, C, 3, 4] f32 world -> pixel
        frame_valid [F] bool
        width/height: output image size; crop_lo/crop_hi: [3] chassis box
        k_cap: rows of the union list
    Returns:
        vals [F, k_cap, C] int32 (rows >= count are 0), count [F] int32.
    """
    P, F, C = check_frame_inputs(points, valid, A, B, frame_valid, cls)
    vals = torch.zeros((F, k_cap, C), dtype=torch.int32, device=points.device)
    count = torch.zeros(F, dtype=torch.int32, device=points.device)
    for f in range(F):
        val, union = _effective(points, valid, cls, A[f], B[f], frame_valid[f],
                                width, height, crop_lo, crop_hi)
        idx = torch.nonzero(union).squeeze(1)   # ascending: stable
        count[f] = idx.numel()
        rows = val[:, idx[:k_cap]].T
        vals[f, :rows.shape[0]] = rows
    return vals, count


def count_union_ref(points, valid, cls, A, B, frame_valid, width, height,
                    crop_lo, crop_hi):
    """Plain PyTorch version of the counting half: count [F] int32."""
    P, F, C = check_frame_inputs(points, valid, A, B, frame_valid, cls)
    return torch.stack([
        _effective(points, valid, cls, A[f], B[f], frame_valid[f], width,
                   height, crop_lo, crop_hi)[1].sum().to(torch.int32)
        for f in range(F)])


def _launch(entry, points, valid, cls, A, B, frame_valid, width, height,
            crop_lo, crop_hi, k_cap=None):
    """Launch one CUDA entry point on the current stream: one memset of
    its scratch (the look-back descriptors and the ticket) or of the counts,
    then one kernel.  Raises on any launch error.  Returns (vals or None,
    count)."""
    from cama_tpu_torch import _build

    P, F, C = check_frame_inputs(points, valid, A, B, frame_valid, cls)
    lib = _build.load()
    dev = points.device
    pts = points.contiguous()
    # bool is one byte: viewed as uint8, no cast kernel
    valid_u8 = valid.contiguous().view(torch.uint8)
    fv_u8 = frame_valid.contiguous().view(torch.uint8)
    cls_c, A_c, B_c = cls.contiguous(), A.contiguous(), B.contiguous()
    count = torch.empty(F, dtype=torch.int32, device=dev)
    geo = [P, F, C, int(width), int(height),
           *(float(v) for v in crop_lo), *(float(v) for v in crop_hi)]
    ins = [t.data_ptr() for t in (pts, valid_u8, cls_c, fv_u8, A_c, B_c)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if entry == "count_union":
            err = lib.cama_fc_count(*ins, *geo, count.data_ptr(), stream)
            vals = None
        else:
            scratch = torch.empty(lib.cama_fc_scratch_words(P, F),
                                  dtype=torch.int64, device=dev)
            vals = torch.empty((F, k_cap, C), dtype=torch.int32, device=dev)
            err = lib.cama_fc_project(*ins, *geo, int(k_cap),
                                      scratch.data_ptr(), vals.data_ptr(),
                                      count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err}")
    LAUNCHES[entry] += 1
    return vals, count


def fused_compact_project(points, valid, cls, A, B, frame_valid, width, height,
                          crop_lo, crop_hi, k_cap):
    """Fused project + dedup + compact over a chunk of frames.

    Same arguments as fused_compact_project_ref.  Returns vals [F, k_cap, C]
    int32 (rows >= count are unspecified on the card: mask by count) and
    count [F] int32 — the true survivor total, so count > k_cap reports an
    overflowed list.  CUDA tensors launch the kernel (or raise); CPU tensors
    run the plain version."""
    if route(points, "fused_compact") == "cpu":
        return fused_compact_project_ref(points, valid, cls, A, B, frame_valid,
                                         width, height, crop_lo, crop_hi,
                                         k_cap)
    return _launch("fused_compact_project", points, valid, cls, A, B,
                   frame_valid, width, height, crop_lo, crop_hi, k_cap)


def count_union(points, valid, cls, A, B, frame_valid, width, height,
                crop_lo, crop_hi):
    """Union survivor count [F] int32 per frame — the fused kernel's tile
    body without the writes, which sizes k_cap.  CUDA tensors
    launch the kernel (or raise); CPU tensors run the plain version."""
    if route(points, "fused_compact") == "cpu":
        return count_union_ref(points, valid, cls, A, B, frame_valid, width,
                               height, crop_lo, crop_hi)
    return _launch("count_union", points, valid, cls, A, B, frame_valid,
                   width, height, crop_lo, crop_hi)[1]


def _live_entries(vals, count):
    """[..., K, C] bool: the entries of the union list that a camera keeps,
    on rows below count (rows past it are unspecified on the card)."""
    rows = torch.arange(vals.shape[-2], dtype=torch.int32, device=vals.device)
    return (rows[:, None] < count[..., None, None]) & (vals > 0)


def sparse_from_union(vals, count, k):
    """The sparse lane's lists from the union list: per (frame, camera), a
    stable compaction of the entries that camera keeps to k slots.

    vals [F, K, C] int32 and count [F] from fused_compact_project (with
    count <= K: an overflowed union list is incomplete).  Returns
    vals [F, C, k] int32 (encodings pix * MAX_CLS + cls in point order, -1
    past the count) and counts [F, C] int32, the per-camera totals (count
    > k: the first k entries are kept).  Equals ops.raster.compact_points
    over project_frames' projection of the same points, which the JAX
    package's sparse program (cama_tpu/pipeline.py:_project_compact_chunk)
    computes; it works over the K union rows instead of all P points."""
    F, K, C = vals.shape
    live = _live_entries(vals, count).transpose(1, 2).reshape(F * C, K)
    enc = (vals - 1).transpose(1, 2).reshape(F * C, K)
    lists = compact_rows(enc, live, k).reshape(F, C, k)
    return lists, live.sum(dim=-1, dtype=torch.int32).reshape(F, C)


def camera_counts(vals, count):
    """Per-camera effective counts [F, C] int32 of a union list
    vals [F, K, C] with union counts count [F] <= K."""
    return _live_entries(vals, count).sum(dim=-2, dtype=torch.int32)


def rasterize_from_union(vals, count, width, height, prio_offset=0):
    """Dense packed raster [..., C, H, W] int32 from the union list
    vals [..., K, C] int32 and count [...]: rows >= count and zero entries
    become -1 (absent), then ops.raster.rasterize_from_compact paints with
    prio_offset + the row index as priority (a point-sharded caller passes
    shard_index * K: the kernel's compaction is stable, so the shards'
    partial rasters keep the global paint order under elementwise max)."""
    cvals = torch.where(_live_entries(vals, count), vals - 1,
                        -1).transpose(-1, -2)
    return rasterize_from_compact(cvals.contiguous(), width, height,
                                  prio_offset=prio_offset)
